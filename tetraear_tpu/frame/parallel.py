"""Carrier-sharded per-hit frame layer over worker processes.

The per-hit host path is embarrassingly parallel over carriers: every
piece of its state (MacParser fragmentation, SYSINFO identity, the
emitted-frame dedup watermark) is per-carrier.  This module shards the
WHOLE per-block host path — candidate collection, the native hitparse
batch call and the stateful decode (frame.batch.collect_rows /
decode_candidates) — across spawn-based worker processes.  The parent
only: assembles tails (vectorized), prefilters active rows (one
rowmax pass), ships each shard its active rows, reattaches
soft_symbols, and finishes deferred decryption.

Per-block IPC is O(active rows) down ((row arrays: symbols, corr, crc
planes for rows whose scan found anything) and O(frames) up; idle
carriers never cross the process boundary, and the bulky (C, W, 2)
soft planes never leave the parent.

Division of labour (docs/ARCHITECTURE.md "host envelope"): one parent
core feeds N worker cores; the parent's per-block work is a handful of
vectorized passes, so throughput scales with workers until assembly
saturates.

Workers never open an accelerator: they start with JAX_PLATFORMS=cpu
in their environment, so even an accidental JAX import stays on the
host and the parent remains the one process on the card (a JAX process
reserves most of a card's memory when it first touches it).  Deferred
decryption returns to the parent as
``decryption_pending`` frames and is finished there with ONE device
keys x payloads search per block (crypto.batch), exactly like the
in-process layer.

Equivalence with the in-process BatchedFrameDecoder is pinned by
tests/unit/test_parallel_frames.py.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os

import numpy as np

from tetraear_tpu.frame.decoder import TetraDecoder
from tetraear_tpu.frame.batch import (BatchedFrameDecoder, TAIL_SYMS,
                                      decode_candidates, soft_slice)


class _LazyDecoders:
    """Per-carrier TetraDecoder map, constructed on first use."""

    def __init__(self, key_file=None, auto_decrypt=True, keys=()):
        self._m: dict = {}
        self._key_file = key_file
        self._auto = auto_decrypt
        self._keys = tuple(keys)

    def _make(self):
        km = None
        if self._key_file:
            from tetraear_tpu.crypto.tea import TetraKeyManager
            km = TetraKeyManager()
            km.load_key_file(self._key_file)
        d = TetraDecoder(key_manager=km, auto_decrypt=self._auto)
        d.defer_decrypt = True
        if self._keys:
            d.set_keys(list(self._keys))
        return d

    def __getitem__(self, ci: int) -> TetraDecoder:
        d = self._m.get(ci)
        if d is None:
            d = self._m[ci] = self._make()
        return d

    def set_keys(self, keys) -> None:
        """Runtime key load: applies to every already-built decoder and
        to all future ones (reference decoder.py:101 set_keys)."""
        self._keys = tuple(keys)
        for d in self._m.values():
            d.set_keys(list(keys))


class _Emitted(dict):
    """Sparse emitted_until watermark map (missing carrier -> 0)."""

    def __missing__(self, key):
        return 0


def _worker_block(decoders, emitted, msg) -> list:
    """Full per-block host path on this shard's ACTIVE rows: candidate
    collection, the native batch parse, stateful decode.  The worker's
    ``emitted`` map is the authoritative dedup state for its carriers
    (the parent keeps an exactly-reproducible mirror from the emitted
    frames)."""
    from tetraear_tpu.frame import hitparse
    from tetraear_tpu.frame.batch import collect_rows

    (carriers, syms_rows, n_valid_rows, vstart_rows, sym_base_rows,
     corr_rows, crc_rows, scan_stride) = msg
    cands = collect_rows(carriers, syms_rows, n_valid_rows, vstart_rows,
                         sym_base_rows, emitted, scan_stride, corr_rows,
                         crc_rows=crc_rows)
    if not cands:
        return []
    hb = (hitparse.parse_windows(np.stack([c[3] for c in cands]))
          if hitparse.available() else None)
    row_of = {int(c): i for i, c in enumerate(carriers)}
    hints = [bool(crc_rows[row_of[ci], start // scan_stride] <= 2)
             for ci, start, _a, _w in cands]
    return decode_candidates(decoders, emitted, cands, hb, hints)


def _worker_block_hits(decoders, emitted, msg) -> list:
    """_worker_block fed by flat sparse-hit arrays (batch.collect_hits)
    instead of dense plane rows — the sparse-mode worker path."""
    from tetraear_tpu.frame import hitparse
    from tetraear_tpu.frame.batch import collect_hits

    (carriers, syms_rows, n_valid_rows, vstart_rows, sym_base_rows,
     rows_l, pe_h, corr_h, crc_h, scan_stride) = msg
    cands, hints = collect_hits(carriers, syms_rows, n_valid_rows,
                                vstart_rows, sym_base_rows, emitted,
                                scan_stride, rows_l, pe_h, corr_h, crc_h)
    if not cands:
        return []
    hb = (hitparse.parse_windows(np.stack([c[3] for c in cands]))
          if hitparse.available() else None)
    return decode_candidates(decoders, emitted, cands, hb, hints)


def _worker_main(conn, key_file, auto_decrypt, keys):
    decoders = _LazyDecoders(key_file, auto_decrypt, keys)
    emitted = _Emitted()
    while True:
        msg = conn.recv()
        if msg is None:
            conn.close()
            return
        kind = msg[0]
        if kind == "set_emitted":
            emitted.update(msg[1])
            continue
        if kind == "set_keys":
            decoders.set_keys(msg[1])
            continue
        try:
            if kind == "block":
                frames = _worker_block(decoders, emitted, msg[1:])
            elif kind == "block_hits":
                frames = _worker_block_hits(decoders, emitted, msg[1:])
            else:                       # "cands": pre-collected windows
                meta, wins, hb, hints = msg[1:]
                cands = [(ci, start, abs_sym, wins[i])
                         for i, (ci, start, abs_sym) in enumerate(meta)]
                frames = decode_candidates(decoders, emitted, cands, hb,
                                           list(hints))
                for f in frames:
                    f.pop("bits", None)   # parent reattaches by position
        except Exception:                 # propagate with context
            import traceback
            conn.send(("err", traceback.format_exc()))
            continue
        conn.send(("ok", frames))


@contextlib.contextmanager
def _host_only_env():
    """JAX_PLATFORMS=cpu in os.environ while a worker is spawned: the
    spawned interpreter inherits the environment of the moment it
    starts.  The parent's own JAX read its platform setting at import,
    so the parent is unaffected."""
    old = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        yield
    finally:
        if old is None:
            del os.environ["JAX_PLATFORMS"]
        else:
            os.environ["JAX_PLATFORMS"] = old


class ShardedFrameLayer:
    """Drop-in BatchedFrameDecoder with pass-2 sharded over workers.

    Same process(hard, soft, valid) / select_and_decode interface and
    identical output frames (ordering: carrier-ascending, as shards
    are contiguous carrier ranges merged in order).
    """

    def __init__(self, n_carriers: int, n_workers: int = 2,
                 key_file=None, key_manager=None, auto_decrypt=True,
                 keys=(), tail_syms: int = TAIL_SYMS):
        if key_manager is not None:
            raise ValueError(
                "ShardedFrameLayer cannot ship a live TetraKeyManager to "
                "worker processes; pass key_file= and/or keys= instead")
        # parent-side vectorized bookkeeping reuses BatchedFrameDecoder
        # (its per-carrier decoders stay UNUSED in pass 2; the parent
        # only runs assemble/collection + the decrypt finishing)
        self._inner = BatchedFrameDecoder(
            n_carriers,
            decoders=_LazyDecoders(key_file, auto_decrypt, keys),
            key_manager=key_manager, auto_decrypt=auto_decrypt,
            tail_syms=tail_syms)
        self.n_carriers = n_carriers
        self.n_workers = max(1, int(n_workers))
        bounds = np.linspace(0, n_carriers, self.n_workers + 1).astype(int)
        self._bounds = bounds
        self._spawn_args = (key_file, auto_decrypt, tuple(keys))
        self._ctx = mp.get_context("spawn")
        self._conns = [None] * self.n_workers
        self._procs = [None] * self.n_workers
        for w in range(self.n_workers):
            self._spawn(w)
        # parent-side decrypt finishing needs the same key config
        self._decrypt_template = _LazyDecoders(key_file, auto_decrypt,
                                               keys)

    def _spawn(self, w: int) -> None:
        # close stale handles from a previous incarnation (respawn
        # path) so repeated worker deaths don't leak pipe fds
        if self._conns[w] is not None:
            try:
                self._conns[w].close()
            except OSError:
                pass
        if self._procs[w] is not None:
            try:
                self._procs[w].close()
            except Exception:
                pass
        pc, cc = self._ctx.Pipe()
        p = self._ctx.Process(target=_worker_main,
                              args=(cc,) + self._spawn_args,
                              daemon=True)
        with _host_only_env():
            p.start()
        cc.close()
        self._conns[w] = pc
        self._procs[w] = p

    # -- lifecycle -----------------------------------------------------

    def set_keys(self, keys) -> None:
        """Runtime key load across the worker fleet (reference Load-Keys
        button -> TetraDecoder.set_keys): live workers get a set_keys
        message, future respawns inherit via _spawn_args, and the
        parent-side decrypt finishing template follows."""
        keys = tuple(keys)
        kf, auto, _old = self._spawn_args
        self._spawn_args = (kf, auto, keys)
        self._inner.decoders.set_keys(keys)
        self._decrypt_template.set_keys(keys)
        for w in range(self.n_workers):
            self._send_with_respawn(w, ("set_keys", list(keys)))

    def close(self):
        for c in self._conns:
            try:
                c.send(None)
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=10)
        self._conns, self._procs = [], []

    def __del__(self):  # best-effort
        try:
            self.close()
        except Exception:
            pass

    # -- the sharded block step -----------------------------------------

    def _send_with_respawn(self, w: int, msg) -> None:
        try:
            self._conns[w].send(msg)
        except (BrokenPipeError, OSError):
            # dead worker noticed at send time: respawn first
            import logging
            logging.getLogger(__name__).warning(
                "frame worker %d pipe broken; respawning", w)
            self._respawn(w)
            self._conns[w].send(msg)

    def _respawn(self, w: int) -> None:
        """Restart worker w and restore its dedup watermarks from the
        parent's exactly-reproducible mirror (collection now lives in
        the worker, so its emitted state must be authoritative again
        after a crash — SURVEY.md section 5.3 recovery).  Shard-local
        MacParser fragment chains are lost: the same bound as a
        reference restart."""
        try:
            self._procs[w].join(timeout=5)
        except Exception:
            pass
        self._spawn(w)
        lo, hi = self._bounds[w], self._bounds[w + 1]
        em = self._inner._emitted_until
        self._conns[w].send(("set_emitted",
                             {int(c): int(em[c]) for c in range(lo, hi)
                              if em[c] > 0}))

    def select_and_decode(self, syms, softs, n_valid, valid_start_bits,
                          corr, crc_err) -> list:
        inner = self._inner

        # parent does only the vectorized prefilter: rows whose scan
        # found anything (rowmax >= 0.75).  Each worker receives ITS
        # shard's active rows and runs the full host path (collection,
        # native batch parse, stateful decode) locally.
        row_max = corr.max(axis=1) if corr.shape[1] else np.zeros(
            len(corr))
        active = np.flatnonzero(row_max >= 0.75)
        busy = []
        for w in range(self.n_workers):
            lo, hi = self._bounds[w], self._bounds[w + 1]
            rows = active[(active >= lo) & (active < hi)]
            if not len(rows):
                continue
            msg = ("block", rows.astype(np.int64), syms[rows],
                   n_valid[rows], valid_start_bits[rows],
                   inner._sym_base[rows], corr[rows], crc_err[rows],
                   inner.scan_stride)
            self._send_with_respawn(w, msg)
            busy.append((w, msg))
        return self._finish_block(busy, softs)

    def select_and_decode_hits(self, syms, softs, n_valid,
                               valid_start_bits, rows_h, pe_h, corr_h,
                               crc_h) -> list:
        """Sparse-mode sharded selection: each worker receives its
        shard's rows-with-hits plus their flat hit arrays (O(hits)
        IPC — no dense plane rows) and runs batch.collect_hits +
        decode locally.  Same worker state, watermarks and recovery as
        select_and_decode."""
        inner = self._inner
        urows = np.unique(rows_h)          # rows with any fetched hit
        busy = []
        for w in range(self.n_workers):
            lo, hi = self._bounds[w], self._bounds[w + 1]
            rows = urows[(urows >= lo) & (urows < hi)]
            if not len(rows):
                continue
            sel = (rows_h >= lo) & (rows_h < hi)
            # remap global row ids to indices into the shipped rows
            local_r = np.searchsorted(rows, rows_h[sel])
            msg = ("block_hits", rows.astype(np.int64), syms[rows],
                   n_valid[rows], valid_start_bits[rows],
                   inner._sym_base[rows], local_r, pe_h[sel],
                   corr_h[sel], crc_h[sel], inner.scan_stride)
            self._send_with_respawn(w, msg)
            busy.append((w, msg))
        return self._finish_block(busy, softs)

    def _finish_block(self, busy, softs) -> list:
        inner = self._inner
        frames_out = []
        for w, msg in busy:
            try:
                status, payload = self._conns[w].recv()
            except (EOFError, ConnectionResetError):
                # the worker DIED mid-block (OOM kill, crash): respawn,
                # restore its watermarks, replay the block — no
                # duplicate frames (the restored watermarks gate the
                # replayed collection exactly).
                import logging
                logging.getLogger(__name__).warning(
                    "frame worker %d died; respawning and replaying "
                    "the block", w)
                self._respawn(w)
                self._conns[w].send(msg)
                status, payload = self._conns[w].recv()
            if status != "ok":
                raise RuntimeError(
                    f"frame worker {w} failed:\n{payload}")
            frames_out.extend(payload)
        frames_out.sort(key=lambda f: (f["carrier"], f["position"]))

        if frames_out and hasattr(softs, "prefetch"):
            # device-backed lazy view: batch the row gathers
            softs.prefetch([(f["carrier"], f["position"] // 2)
                            for f in frames_out])
        # parent-side bookkeeping: the dedup watermark is reproducible
        # from the emitted frames, so the parent mirror stays exact
        for f in frames_out:
            inner._emitted_until[f["carrier"]] = max(
                inner._emitted_until[f["carrier"]],
                f["stream_symbol"] + 255)
            ci, start = f["carrier"], f["position"]
            f["soft_symbols"] = soft_slice(softs, ci, start // 2)

        if any(f.get("decryption_pending") for f in frames_out):
            from tetraear_tpu.crypto.batch import batch_decrypt_frames
            batch_decrypt_frames(self._decrypt_template, frames_out)
        return frames_out

    # -- BatchedFrameDecoder-compatible surface --------------------------

    @property
    def scan_stride(self):
        return self._inner.scan_stride

    @property
    def T(self):
        return self._inner.T

    @property
    def kernel(self):
        return self._inner.kernel

    @property
    def _sym_base(self):
        return self._inner._sym_base

    @_sym_base.setter
    def _sym_base(self, v):
        self._inner._sym_base = v

    @property
    def _first(self):
        return self._inner._first

    @_first.setter
    def _first(self, v):
        self._inner._first = v

    @property
    def _emitted_until(self):
        # checkpoint surface (api.Pipeline.save/load_checkpoint)
        return self._inner._emitted_until

    @_emitted_until.setter
    def _emitted_until(self, v):
        # collection runs IN the workers, so a restored watermark must
        # reach their authoritative copies too
        self._inner._emitted_until = np.asarray(v, np.int64)
        em = self._inner._emitted_until
        for w in range(self.n_workers):
            lo, hi = self._bounds[w], self._bounds[w + 1]
            self._send_with_respawn(
                w, ("set_emitted",
                    {int(c): int(em[c]) for c in range(lo, hi)}))

    def assemble(self, hard, soft, valid):
        return self._inner.assemble(hard, soft, valid)

    def process_scanned(self, hard, soft, valid, corr, crc_err) -> list:
        # canonical body (assemble -> sharded select -> base advance)
        return BatchedFrameDecoder.process_scanned(
            self, hard, soft, valid, corr, crc_err)

    def process_scanned_sparse(self, hard, soft, valid, keys, counts,
                               pe_n: int, pc_n: int) -> list:
        # canonical body: key decode + overflow recompute happen in the
        # parent; selection dispatches to THIS class's
        # select_and_decode_hits, which ships each worker its shard's
        # flat hit arrays (O(hits) IPC, no dense plane rows)
        return BatchedFrameDecoder.process_scanned_sparse(
            self, hard, soft, valid, keys, counts, pe_n, pc_n)

    def process(self, hard, soft, valid) -> list:
        # one shared implementation: BatchedFrameDecoder.process only
        # touches assemble/kernel/select_and_decode/_sym_base/T, all of
        # which this class provides (select_and_decode is the sharded
        # one), so the canonical body runs unmodified
        return BatchedFrameDecoder.process(self, hard, soft, valid)
