"""Streaming runners: dispatch-efficient block processing.

The interactive Pipeline (tetraear_tpu.api) issues one jitted step per
block — right for real-time sources; offline decode pays a host round
trip and a dispatch per block that way.
``ScanRunner`` fuses S demod blocks into ONE device program with
``lax.scan`` carrying the demod state; ``DecodeRunner`` additionally
fuses the dense frame layer (sync correlation + burst CRC,
dsp.framescan) into the same program with a carried on-device bit tail,
so an offline capture goes IQ -> CRC-checked frame candidates in len/S
dispatches.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from tetraear_tpu.dsp import kernels


# hard-symbol transfer packing (sparse mode): 2-bit symbols ride 4 to a
# byte to the host, which expands them via one table lookup.  The
# valid plane never crosses at all — validity is contiguous from index
# 0 by construction (dsp.timing), so the per-carrier count suffices.
_SYM_LUT = np.stack([(np.arange(256, dtype=np.uint16) >> (2 * j)) & 3
                     for j in range(4)], axis=1).astype(np.uint8)


def pack_syms(h: jnp.ndarray) -> jnp.ndarray:
    """(C, K) uint8 symbols in [0, 4) -> (C, ceil(K/4)) uint8,
    little-endian 2-bit lanes within each byte.  Traceable."""
    c, k = h.shape
    hp = jnp.pad(h, ((0, 0), (0, -k % 4))).reshape(
        c, -1, 4).astype(jnp.int32)
    packed = (hp[..., 0] | (hp[..., 1] << 2) | (hp[..., 2] << 4)
              | (hp[..., 3] << 6))
    return packed.astype(jnp.uint8)


def unpack_syms(packed: np.ndarray, k: int) -> np.ndarray:
    """Host inverse of pack_syms: (C, ceil(K/4)) -> (C, k) uint8."""
    p = np.asarray(packed)
    return _SYM_LUT[p].reshape(len(p), -1)[:, :k]


def masked_pack(hard: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """pack_syms of the validity-masked symbol block (traceable) — the
    device half of the sparse-mode block transfer, shared by
    DecodeRunner and the streaming Pipeline."""
    return pack_syms(jnp.where(valid, hard, 0).astype(jnp.uint8))


def unpack_block(packed: np.ndarray, n_valid: np.ndarray,
                 k: int) -> tuple:
    """Host inverse of the sparse-mode block transfer: packed symbols +
    per-carrier valid counts -> ((C, k) uint8 masked symbols, (C, k)
    bool validity plane, contiguous from index 0)."""
    hard = unpack_syms(packed, k)
    valid = np.arange(k)[None, :] < np.asarray(n_valid)[:, None]
    return hard, valid


class LazySoftRows:
    """Device-resident soft-symbol view over [tail ++ block] rows.

    The dense voice-fleet fetch is the (C, K, 2) float soft plane
    (~220 MB/block at C=10240) while only the decoded frames' 255-
    symbol windows are ever read.  This view leaves both the current
    and previous block's soft planes ON DEVICE and fetches whole rows
    for exactly the carriers that decoded frames — one padded gather
    dispatch per source per block.

    Coordinate contract (same as frame.batch.SoftView): ``slice(ci,
    a)`` returns what ``concat([tail, block])[ci, a:a+n]`` would.  In
    steady state the T-symbol tail equals the previous block's last T
    VALID symbols, i.e. prev[ci, o_prev[ci]-T : o_prev[ci]] (tail
    update rule in frame.batch.BatchedFrameDecoder.assemble), which
    requires the per-block valid count to stay >= T — the constructor
    caller guards that (DecodeRunner: k_max - 2 >= batch.T).

    ``prefetch(pairs)`` must be called with every (carrier, a) that
    will be sliced; it issues the batched row gathers.  slice() then
    serves from the row cache (with a single-row fetch fallback).
    Values are bitwise identical to the dense fetch — same device
    arrays, fetched whole.
    """

    def __init__(self, prev, cur, o_prev: np.ndarray, t: int):
        self.prev = prev                  # device (C, K, 2) or None
        self.cur = cur                    # device (C, K, 2)
        # (C,) prev-block valid counts (None only at the stream head,
        # where the tail region is zeros and gated off anyway)
        self.o_prev = None if o_prev is None else np.asarray(o_prev)
        self.T = int(t)
        self._rows: dict = {}             # (src, ci) -> (K, 2) np row

    @staticmethod
    def _gather(src, rows: list) -> list:
        """One padded row gather + fetch; returns np rows in order."""
        uniq = sorted(set(rows))
        pad = 1 << max(0, (len(uniq) - 1).bit_length())
        idx = np.asarray(uniq + [uniq[0]] * (pad - len(uniq)), np.int32)
        got = np.asarray(src[jnp.asarray(idx)])
        return {r: got[i] for i, r in enumerate(uniq)}

    def prefetch(self, pairs) -> None:
        need = {0: [], 1: []}             # 0 = prev, 1 = cur
        for ci, a in pairs:
            ci = int(ci)
            if a < self.T and (0, ci) not in self._rows:
                need[0].append(ci)
            if (1, ci) not in self._rows:
                need[1].append(ci)
        if need[0] and self.prev is not None:
            for r, row in self._gather(self.prev, need[0]).items():
                self._rows[(0, r)] = row
        if need[1]:
            for r, row in self._gather(self.cur, need[1]).items():
                self._rows[(1, r)] = row

    def _row(self, src: int, ci: int) -> np.ndarray:
        key = (src, ci)
        if key not in self._rows:        # fallback: single-row fetch
            arr = self.prev if src == 0 else self.cur
            self._rows[key] = np.asarray(arr[ci])
        return self._rows[key]

    def slice(self, ci: int, a: int, n: int = 255) -> np.ndarray:
        t = self.T
        if a >= t:
            return self._row(1, ci)[a - t:a - t + n]
        if self.prev is not None:
            o = int(self.o_prev[ci])
            tail = self._row(0, ci)[o - t:o]
        else:                    # stream head: tail region is zeros
            tail = np.zeros((t, 2), np.float32)
        if a + n <= t:
            return tail[a:a + n]
        return np.concatenate([tail[a:], self._row(1, ci)[:a + n - t]])


class ScanRunner:
    """Process many blocks per device dispatch via lax.scan."""

    def __init__(self, bank, blocks_per_dispatch: int = 16):
        self.bank = bank
        self.s = int(blocks_per_dispatch)
        self._scan = jax.jit(self._scan_impl)

    def _scan_impl(self, xs_r, state):
        def body(st, x_r):
            out, st2 = self.bank._step_impl(x_r, st)
            return st2, (out["hard"], out["soft"], out["valid"])
        state, (hard, soft, valid) = jax.lax.scan(body, state, xs_r)
        return state, hard, soft, valid

    def run(self, iq: np.ndarray, state=None) -> dict:
        """Decode a capture in S-block dispatches.

        Returns per-carrier symbol/soft streams (same layout as
        CarrierBankDemod.run) plus the final carried state.
        """
        iq = np.asarray(iq, np.complex64)
        bl = self.bank.block_len
        fresh = state is None
        state = state if state is not None else self.bank.init_state()
        c = self.bank.n_carriers
        hards = [[] for _ in range(c)]
        softs = [[] for _ in range(c)]
        # drop the first differential output only on a fresh state (it
        # references the zero-filled initial prev symbol)
        first_block = fresh

        pos = 0
        while pos + bl <= len(iq):
            take = min(self.s, (len(iq) - pos) // bl)
            xs = iq[pos:pos + take * bl].reshape(take, bl)
            xs_r = jnp.asarray(kernels.c2r_np(xs))
            state, hard, soft, valid = self._scan(xs_r, state)
            hard = np.asarray(hard)      # (take, C, K)
            soft = np.asarray(soft)
            valid = np.asarray(valid).astype(bool)
            for b in range(take):
                for ci in range(c):
                    h = hard[b, ci][valid[b, ci]]
                    s = soft[b, ci][valid[b, ci]]
                    if first_block:
                        h, s = h[1:], s[1:]
                    hards[ci].append(h)
                    softs[ci].append(s)
                first_block = False
            pos += take * bl
        return {
            "symbols": [np.concatenate(h) if h else np.zeros(0, np.uint8)
                        for h in hards],
            "soft_bits": [np.concatenate(s) if s else
                          np.zeros((0, 2), np.float32) for s in softs],
            "state": state,
        }


class DecodeRunner:
    """IQ -> CRC-checked frames, S blocks per device dispatch.

    One ``lax.scan`` program per S blocks runs the demodulator AND the
    dense frame layer (dsp.framescan packed sync + burst CRC conv) with
    an on-device carried bit tail, mirroring the host assembly of
    frame.batch.BatchedFrameDecoder exactly (same tail length, same
    zero-padded layout), so the host-side selection
    (``BatchedFrameDecoder.select_and_decode``) consumes the device
    outputs directly and stays O(hits).

    Used by the offline CLI decode path (cli.cmd_decode_file): one
    dispatch and one host round trip per S blocks instead of per block.
    """

    def __init__(self, bank, batch, blocks_per_dispatch: int = 16,
                 fetch_soft: bool = True, sparse: bool | None = None,
                 sparse_k: int | None = None):
        from tetraear_tpu.dsp import framescan
        from tetraear_tpu.dsp.pipeline import TAILBITS
        self.bank = bank
        self.batch = batch
        self.s = int(blocks_per_dispatch)
        # soft planes are only read by the voice path; skipping their
        # materialization avoids a (S, C, K, 2) float fetch per
        # dispatch (~170 MB/block at C=10240)
        self.fetch_soft = bool(fetch_soft)
        # sparse hit extraction (framescan.sparse_hits, the default):
        # the dense corr/crc planes (~268 MB per block at C=10240)
        # compact to ~C*(K+1) int32s on device; the host decodes them to
        # flat per-hit arrays and selects in O(hits)
        # (batch.process_scanned_sparse).  sparse=False keeps the
        # dense-plane fetch as the differential-test oracle.
        self.sparse = True if sparse is None else bool(sparse)
        self.sparse_k = int(sparse_k if sparse_k is not None
                            else framescan.SPARSE_K)
        self.k = bank.k_max
        if 2 * batch.T != TAILBITS:
            raise ValueError(f"frame layer tail {2 * batch.T} bits != "
                             f"device tail {TAILBITS}")
        self.t2 = TAILBITS                    # carried tail bits
        # in sparse mode the soft planes STAY on device and decoded
        # frames' rows are gathered lazily (LazySoftRows); requires the
        # per-block valid count to cover the tail (k_max - 2 >= T)
        self.lazy_soft = (self.sparse and self.fetch_soft
                          and self.k - 2 >= batch.T)
        self._prev_soft = None                # device (C, K, 2) ref
        self._prev_nc = None                  # (C,) valid counts
        self._pe_n, self._pc_n = framescan.plane_dims(
            self.t2 + 2 * self.k)
        # even-position scan; batch.select_and_decode maps indices via
        # its scan_stride (frame starts are symbol-aligned — framescan
        # .frame_scan_packed_even)
        assert batch.scan_stride == 2
        self._scan = jax.jit(self._scan_impl)
        self.dispatches = 0
        self._tail_bits = None         # persists across run() calls
        # the device tail replicates the host tail; the first-diff-symbol
        # drop is skipped on both sides (one garbage symbol at the stream
        # head cannot form a frame)
        batch._first = False

    def _scan_impl(self, xs_r, state, tail_bits):
        from tetraear_tpu.dsp.pipeline import block_step_scan

        def body(carry, x_r):
            st, tail = carry
            res, st2, tail2, n_c, out = block_step_scan(self.bank, x_r, st,
                                                        tail)
            scan_out = self._scan_outputs(res)
            if self.sparse:
                # compact transfer: packed symbols + valid COUNTS (the
                # masked symbols and the contiguous-validity invariant
                # make the host reconstruction exact — see pack_syms)
                return (st2, tail2), (masked_pack(out["hard"],
                                                  out["valid"]),
                                      out["soft"], n_c, *scan_out)
            return (st2, tail2), (out["hard"], out["soft"], out["valid"],
                                  *scan_out)

        (state, tail_bits), ys = jax.lax.scan(body, (state, tail_bits),
                                              xs_r)
        return state, tail_bits, ys

    def reset_stream(self, batch) -> None:
        """Restart the decode stream on a FRESH batch layer (clean bit
        tails, dedup watermarks and per-carrier protocol state) while
        keeping the compiled device program — e.g. between independent
        captures, or after a warm-up pass."""
        assert 2 * batch.T == self.t2, (batch.T, self.t2)
        batch._first = False                # __init__ docstring: the
        self.batch = batch                  # device tail replaces the drop
        self._tail_bits = None
        self._prev_soft = None
        self._prev_nc = None

    def _scan_outputs(self, res: dict) -> tuple:
        """Per-block scan results to fetch: dense verdict planes, or the
        compacted top-K hit keys + counts in sparse mode (traceable;
        trace-time shape check against the host reconstruction dims)."""
        if not self.sparse:
            return (res["corr"], res["crc_err"])
        assert res["corr"].shape[1] == self._pe_n, (
            res["corr"].shape, self._pe_n)
        from tetraear_tpu.dsp import framescan
        keys, counts = framescan.sparse_hits(res["corr"], res["crc_err"],
                                             self.sparse_k)
        return (keys, counts)

    def run(self, iq: np.ndarray, state=None, on_frames=None) -> dict:
        """Decode a capture; returns {"frames": [...], "state": ...}.

        ``on_frames(list)`` fires per block so callers can stream."""
        iq = np.asarray(iq, np.complex64)
        bl = self.bank.block_len
        if state is None:
            state = self.bank.init_state()
        if self._tail_bits is None:
            self._tail_bits = jnp.zeros(
                (self.bank.n_carriers, self.t2), jnp.uint8)
        tail_bits = self._tail_bits
        frames_all = []

        def parse(take, ys):
            # np.asarray blocks until the dispatch completes; with the
            # NEXT dispatch already issued (async JAX dispatch), the
            # device computes batch k+1 while the host parses batch k
            hard_d, soft_d, valid_d, scan_a, scan_b = ys
            hard = np.asarray(hard_d)         # symbols | packed symbols
            soft = (np.asarray(soft_d)
                    if self.fetch_soft and not self.lazy_soft else None)
            valid = np.asarray(valid_d)       # bool plane | valid counts
            scan_a = np.asarray(scan_a)       # corr | sparse keys
            scan_b = np.asarray(scan_b)       # crc_err | hit counts
            for b in range(take):
                if self.sparse:
                    hard_b, valid_b = unpack_block(hard[b], valid[b],
                                                   self.k)
                    if self.lazy_soft:
                        soft_b = LazySoftRows(self._prev_soft,
                                              soft_d[b], self._prev_nc,
                                              self.batch.T)
                        # device slice-copy of just this block's plane,
                        # so the rest of ys can free after the batch
                        self._prev_soft = soft_d[b]
                        self._prev_nc = valid[b]
                    else:
                        soft_b = soft[b] if soft is not None else None
                    frames = self.batch.process_scanned_sparse(
                        hard_b, soft_b,
                        valid_b, scan_a[b], scan_b[b],
                        self._pe_n, self._pc_n)
                else:
                    frames = self.batch.process_scanned(
                        hard[b], soft[b] if soft is not None else None,
                        valid[b].astype(bool), scan_a[b], scan_b[b])
                if frames and on_frames:
                    on_frames(frames)
                frames_all.extend(frames)

        pending = None                 # (take, ys) not yet host-parsed
        pos = 0
        while pos + bl <= len(iq):
            take = min(self.s, (len(iq) - pos) // bl)
            xs = iq[pos:pos + take * bl].reshape(take, bl)
            xs_r = jnp.asarray(kernels.c2r_np(xs))
            state, tail_bits, ys = self._scan(xs_r, state, tail_bits)
            self.dispatches += 1
            if pending is not None:
                parse(*pending)
            pending = (take, ys)
            pos += take * bl
        if pending is not None:
            parse(*pending)
        self._tail_bits = tail_bits
        return {"frames": frames_all, "state": state}
