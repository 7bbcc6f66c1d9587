"""Multi-chip sharding: carriers x time over a jax.sharding.Mesh.

Two parallel axes (SURVEY.md section 2.3 / 5.7):

  * ``carrier`` — embarrassingly parallel channels (the DP analogue): each
    device owns a slice of the carrier bank; no communication.
  * ``time`` — the IQ sample axis (the sequence/context-parallel analogue):
    a long capture is split into segments, and each shard needs the tail of
    its left neighbour's segment (filter memory) — an overlap-save halo
    moved with ``ppermute`` between neighbouring devices.

Inside a shard the demod is *stateless given the halo*: FIR memory comes
from the halo samples, and the NCO phase at a segment boundary is computed
in closed form with exact integer-cycle arithmetic (int32), so no state has
to flow sequentially between time shards.  Aggregate sync statistics are
``psum``-ed across the mesh.

This is the offline/throughput path (BASELINE configs 3-5).  The streaming
path with carried state (real-time, single time shard) lives in
tetraear_tpu.runtime.stream.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tetraear_tpu.dsp import design, kernels, sync, timing


def _global_device_put(x_np: np.ndarray, sharding: NamedSharding):
    """device_put that also works in multi-process (DCN) runs: each
    process materializes only its addressable shards by slicing the
    host-global array (every host holds the full input; a production
    fleet would slice its SDR band feed the same way)."""
    if jax.process_count() > 1:
        return jax.make_array_from_callback(
            x_np.shape, sharding,
            lambda idx: np.ascontiguousarray(x_np[idx]))
    return jax.device_put(jnp.asarray(x_np), sharding)


def _fetch_global(tree):
    """Fetch possibly multi-process-sharded outputs to host numpy:
    single-process -> plain np.asarray; multi-process -> allgather the
    non-addressable shards across hosts so every process returns the
    full result."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        return multihost_utils.process_allgather(tree, tiled=True)
    return jax.tree_util.tree_map(np.asarray, tree)


def make_mesh(n_carrier_shards: int, n_time_shards: int,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    need = n_carrier_shards * n_time_shards
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    dev = np.asarray(devices[:need]).reshape(n_carrier_shards, n_time_shards)
    return Mesh(dev, axis_names=("carrier", "time"))


def plan_input_halo(plan: design.ResamplePlan, rrc_len: int,
                    granularity: int, warmup_symbols: int = 16) -> int:
    """Overlap-save halo in *input-rate* samples covering every stage's
    filter memory + RRC + timing warmup, rounded up to the block
    granularity.  Off-by-one here silently corrupts sync rates
    (SURVEY.md section 7 hard parts), so everything rounds up."""
    halo = 0.0
    decim = 1.0
    for st in plan.stages:
        h = math.ceil((len(st.taps) - 1) / st.up)
        halo += h * decim
        decim *= st.down / st.up
    halo += (rrc_len - 1) * decim                 # RRC at the output rate
    halo += warmup_symbols * design.SPS * decim   # timing + interp warmup
    return int(math.ceil(halo / granularity)) * granularity


class ShardedDemod:
    """Carrier+time sharded demod over a mesh (offline/batch mode).

    Input: (C, N) per-carrier IQ (or (N,) broadcast wideband on the host
    side), C divisible by mesh carrier axis, N divisible by time axis *
    granularity.  Output per shard covers its own segment; the halo region
    is demodulated twice (left shard's tail, right shard's warmup) and the
    frame layer dedups by sync position.
    """

    def __init__(self, fs: float, freqs_hz, mesh: Mesh,
                 seg_len: int, sps: int = design.SPS):
        self.fs = float(fs)
        self.freqs_hz = np.atleast_1d(np.asarray(freqs_hz, np.float64))
        self.n_carriers = len(self.freqs_hz)
        self.mesh = mesh
        self.n_time = mesh.shape["time"]
        self.n_cshard = mesh.shape["carrier"]
        if self.n_carriers % self.n_cshard:
            raise ValueError("carriers must divide carrier-shard count")
        self.sps = sps
        self.plan = design.build_resample_plan(self.fs,
                                               design.SYMBOL_RATE * sps)
        self.rrc = design.rrc_taps(sps=sps).astype(np.float32)
        import math as _m
        gran = 1
        for st in self.plan.stages:
            gran = gran * st.down // _m.gcd(gran, st.down)
        lcm_l = 1
        for st in self.plan.stages:
            lcm_l = lcm_l * st.up // _m.gcd(lcm_l, st.up)
        need = sps * lcm_l // _m.gcd(sps, lcm_l)
        k = 1
        up = down = 1
        for st in self.plan.stages:
            up *= st.up
            down *= st.down
        while (k * gran * up) % (down * need) != 0:
            k += 1
        self.granularity = k * gran
        if seg_len % self.granularity:
            raise ValueError(f"seg_len {seg_len} % granularity "
                             f"{self.granularity} != 0")
        self.seg_len = seg_len
        self.halo = plan_input_halo(self.plan, len(self.rrc),
                                    self.granularity)
        self.block_len = self.halo + seg_len       # per-shard processed span
        self.nco = kernels.nco_tables(self.freqs_hz, self.fs, self.block_len)
        # exact per-carrier cycle advance for one segment (for closed-form
        # boundary phase): (seg_len * f) mod fs as int32
        fs_i = int(round(self.fs))
        fi = np.round(self.freqs_hz).astype(np.int64)
        self.seg_step = ((seg_len % fs_i) * (fi % fs_i) % fs_i).astype(
            np.int32)
        self.halo_cycles = ((int(self.halo) % fs_i) * (fi % fs_i)
                            % fs_i).astype(np.int32)
        self._step = jax.jit(
            jax.shard_map(
                self._shard_step, mesh=self.mesh,
                in_specs=(P("carrier", "time"), P("carrier"), P("carrier")),
                out_specs=(P("carrier", "time"), P("carrier", "time"),
                           P("carrier", "time"), P()),
            ))

    def _n_out_syms(self, n_in: int) -> int:
        """Symbols produced from n_in input-rate samples (plan ratio)."""
        n = n_in
        for st in self.plan.stages:
            n = n * st.up // st.down
        return n // self.sps

    # -- per-shard computation (runs under shard_map) -----------------------

    def _shard_step(self, x_r, seg_step, halo_cycles):
        """x_r: (C_local, seg_len, 2) — this shard's IQ segment."""
        x = kernels.r2c(x_r)
        c_local = x.shape[0]
        t_idx = jax.lax.axis_index("time")

        # overlap-save halo: receive the left neighbour's tail
        tail = x[:, -self.halo:]
        n_time = jax.lax.axis_size("time")
        left = jax.lax.ppermute(
            tail, "time", [(i, i + 1) for i in range(n_time - 1)])
        xx = jnp.concatenate([left, x], axis=1)     # (C_local, halo+seg)

        # closed-form NCO phase at (segment start - halo), exact int32
        fs_i = jnp.int32(int(round(self.fs)))
        start_cycles = (t_idx.astype(jnp.int32) * seg_step) % fs_i
        start_cycles = (start_cycles - halo_cycles) % fs_i
        cycles0 = start_cycles.astype(jnp.float32)

        coarse = jnp.asarray(self.nco["coarse"])
        fine = jnp.asarray(self.nco["fine"])
        step_tab = jnp.asarray(self.nco["block_step"])
        # carrier-shard the NCO tables by slicing with the carrier index
        c_idx = jax.lax.axis_index("carrier")
        c0 = c_idx * c_local
        coarse_l = jax.lax.dynamic_slice_in_dim(coarse, c0, c_local, 0)
        fine_l = jax.lax.dynamic_slice_in_dim(fine, c0, c_local, 0)
        step_l = jax.lax.dynamic_slice_in_dim(step_tab, c0, c_local, 0)

        y, _ = kernels.nco_mix(xx, cycles0, coarse_l, fine_l, step_l,
                               self.nco["fs"])
        hists = [jnp.zeros((c_local, kernels.stage_history_len(st)),
                           jnp.complex64) for st in self.plan.stages]
        y, _ = kernels.plan_apply(self.plan, y, hists)
        y, _ = kernels.fir_apply(
            self.rrc, y,
            jnp.zeros((c_local, len(self.rrc) - 1), jnp.complex64))
        tstate = {
            "tail": jnp.zeros((c_local, timing.TAIL), jnp.complex64),
            "next_t": jnp.full((c_local,), float(timing.TAIL), jnp.float32),
            "acc": jnp.zeros((c_local,), jnp.complex64),
        }
        syms, valid, _ = timing.timing_recover(y, tstate)
        hard, soft, _ = timing.dqpsk_demod(
            syms, valid, jnp.zeros((c_local,), jnp.complex64))

        # fleet-wide sync statistics (the psum analogue of the
        # reference's protocol.stats counters)
        bits = jnp.repeat(hard, 2, axis=1)
        bits = bits.at[:, 0::2].set(hard >> 1)
        bits = bits.at[:, 1::2].set(hard & 1)
        corr = sync.sync_correlate(bits)
        hits = jnp.sum(corr >= 0.90, axis=1)
        total_hits = jax.lax.psum(jnp.sum(hits), ("carrier", "time"))

        return (hard[:, None, :], soft[:, None, :, :], valid[:, None, :],
                total_hits)

    # -- host API ------------------------------------------------------------

    def run(self, iq: np.ndarray) -> dict:
        """Demod a capture of length n_time * seg_len (per-carrier shared
        wideband input broadcast on the carrier axis)."""
        iq = np.asarray(iq, np.complex64)
        need = self.n_time * self.seg_len
        if len(iq) < need:
            raise ValueError(f"need {need} samples, got {len(iq)}")
        x = np.broadcast_to(iq[None, :need], (self.n_carriers, need))
        x_r = kernels.c2r_np(np.ascontiguousarray(x))
        sh = NamedSharding(self.mesh, P("carrier", "time"))
        xd = _global_device_put(x_r, sh)
        hard, soft, valid, hits = _fetch_global(self._step(
            xd, jnp.asarray(self.seg_step),
            jnp.asarray(self.halo_cycles)))
        return {
            "hard": np.asarray(hard),    # (C, n_time, K)
            "soft": np.asarray(soft),
            "valid": np.asarray(valid),
            "sync_hits": int(np.asarray(hits)),
        }


class ShardedFFTDemod:
    """Carrier x time sharded demod using the FFT channelizer frontend.

    The scale path for BASELINE configs 4-5: each time shard processes one
    wideband segment (left halo arrives via ``ppermute``), runs the pow2
    overlap-save channelizer for its *local* slice of the carrier bank,
    and the polyphase/timing/demod back half — so a mesh splits 10k+
    carriers over the carrier axis and the capture over the time axis
    with no sequential dependencies (closed-form integer NCO phase at
    segment boundaries, as in ShardedDemod).
    """

    def __init__(self, fs: float, freqs_hz, mesh: Mesh,
                 sps: int = design.SPS):
        from tetraear_tpu.dsp import channelizer as chan_mod

        self.fs = float(fs)
        self.freqs_hz = np.atleast_1d(np.asarray(freqs_hz, np.float64))
        self.n_carriers = len(self.freqs_hz)
        self.mesh = mesh
        self.n_time = mesh.shape["time"]
        self.n_cshard = mesh.shape["carrier"]
        if self.n_carriers % self.n_cshard:
            raise ValueError("carriers must divide carrier-shard count")
        self.sps = sps
        decim = chan_mod.choose_decim(self.fs)
        self.plan = design.build_resample_plan(self.fs / decim,
                                               design.SYMBOL_RATE * sps)
        import math as _m
        g = 1
        for st in self.plan.stages:
            g = g * st.down // _m.gcd(g, st.down)
        lcm_l = 1
        for st in self.plan.stages:
            lcm_l = lcm_l * st.up // _m.gcd(lcm_l, st.up)
        need = sps * lcm_l // _m.gcd(sps, lcm_l)
        k = 1
        up = down = 1
        for st in self.plan.stages:
            up *= st.up
            down *= st.down
        while (k * g * up) % (down * need) != 0:
            k += 1
        # the time mesh axis IS this path's segmentation (each shard
        # transforms its own window)
        self.chan = chan_mod.FFTChannelizer(self.fs, self.freqs_hz,
                                            back_granularity=k * g)
        self.seg_len = self.chan.block_len
        self.rrc = design.rrc_taps(sps=sps).astype(np.float32)
        self.plan_gran = k * g

        # Channel-rate halo for the back half.  The wideband ppermute halo
        # (ch.overlap) only covers the h1 channelizer filter; the resample
        # plan + RRC + timing warmup would otherwise start cold at every
        # time-shard boundary and corrupt the symbols there.  Each shard
        # therefore also receives the left neighbour's channelized output
        # tail (overlap-save at the channel rate) sized to cover the back-
        # half memory PLUS a full 255-symbol slot, so frames straddling a
        # segment boundary are double-covered (clean in the right shard's
        # exposed halo) and the frame layer dedups by sync position —
        # the same contract as ShardedDemod.
        self.back_halo = plan_input_halo(self.plan, len(self.rrc),
                                         self.plan_gran,
                                         warmup_symbols=300)
        # corrupted-prefix length in output symbols (filter memory only;
        # everything past it inside the halo is exact and stays exposed)
        mem = plan_input_halo(self.plan, len(self.rrc), 1,
                              warmup_symbols=4)
        self.n_bad_syms = self._out_len(mem) // sps + 4
        # time shard 0 has no left neighbour: its halo input is zeros, so
        # its whole halo span (not just the filter memory) is masked
        self.halo_syms = self._out_len(self.back_halo) // sps + 8

        # closed-form per-segment cycle step for every carrier (int32,
        # exact): (k_c * seg_len) mod nfft
        nfft = self.chan.nfft
        self.seg_cycles = ((self.chan.k_c % nfft)
                           * (self.seg_len % nfft) % nfft).astype(np.int32)

        self._step = jax.jit(
            jax.shard_map(
                self._shard_step, mesh=self.mesh,
                in_specs=(P("time"), P("carrier")),
                out_specs=(P("carrier", "time"), P("carrier", "time"), P()),
            ))

    def _out_len(self, n_in: int) -> int:
        n = n_in
        for st in self.plan.stages:
            n = n * st.up // st.down
        return n

    def _shard_step(self, x_r, seg_cycles_local):
        """x_r: (seg_len, 2) — this time shard's wideband segment.
        seg_cycles_local: (C_local,) int32 per-carrier segment cycle step.
        """
        from tetraear_tpu.dsp import kernels, timing
        ch = self.chan
        c_local = seg_cycles_local.shape[0]
        x = kernels.r2c(x_r)

        # overlap-save halo from the left time-neighbour
        n_time = jax.lax.axis_size("time")
        tail = kernels.c2r(x[-ch.overlap:])
        left = jax.lax.ppermute(
            tail, "time", [(i, i + 1) for i in range(n_time - 1)])

        # closed-form phase at this segment's start (exact int32 mod)
        t_idx = jax.lax.axis_index("time").astype(jnp.int32)
        nfft_i = jnp.int32(ch.nfft)
        cycles = (t_idx * seg_cycles_local) % nfft_i

        # carrier-local slices of the channelizer tables
        c_idx = jax.lax.axis_index("carrier")
        c0 = c_idx * c_local
        if ch.aligned:
            row_idx = jax.lax.dynamic_slice_in_dim(
                jnp.asarray(ch.row_idx), c0, c_local, 0)
        else:
            starts = jax.lax.dynamic_slice_in_dim(
                jnp.asarray(ch.band_start), c0, c_local, 0)

        xx = jnp.concatenate([kernels.r2c(left), x])
        big_x = jnp.fft.fft(xx)
        x_ext = jnp.concatenate([big_x, big_x[:ch.n_band]])
        if ch.aligned:
            rows = x_ext.reshape(-1, 128)
            nat = rows[row_idx].reshape(c_local, ch.n_band)
        else:
            idx = (starts[:, None]
                   + jnp.arange(ch.n_band, dtype=jnp.int32)[None, :])
            nat = x_ext[idx]
        # natural-order synthesis: ch.h1_band is a rolled table and the
        # ifft + the (-1)^k sign replace the per-block fftshift (see
        # FFTChannelizer.step)
        band = nat * jnp.asarray(ch.h1_band)[None, :]
        y = jnp.fft.ifft(band, axis=1) * jnp.float32(1.0 / ch.decim)
        y = y[:, ch.drop:ch.drop + ch.n_out]
        y = y * jnp.asarray(ch.sign)[None, :]
        ang = cycles.astype(jnp.float32) * jnp.float32(
            2.0 * np.pi / ch.nfft)
        y = y * jax.lax.complex(jnp.cos(ang), -jnp.sin(ang))[:, None]

        # channel-rate overlap-save halo for the back half: receive the
        # left neighbour's channelized tail.  Both sides are
        # phase-corrected to GLOBAL phase above, so the concatenation is
        # sample-continuous; the back half then has real filter history
        # and this shard's exposed output double-covers the boundary.
        halo_y = kernels.c2r(y[:, y.shape[1] - self.back_halo:])
        left_y = jax.lax.ppermute(
            halo_y, "time", [(i, i + 1) for i in range(n_time - 1)])
        y = jnp.concatenate([kernels.r2c(left_y), y], axis=1)

        hists = [jnp.zeros((c_local, kernels.stage_history_len(st)),
                           jnp.complex64) for st in self.plan.stages]
        y, _ = kernels.plan_apply(self.plan, y, hists)
        y, _ = kernels.fir_apply(
            self.rrc, y,
            jnp.zeros((c_local, len(self.rrc) - 1), jnp.complex64))
        n72 = y.shape[1] - (y.shape[1] % self.sps)
        y = y[:, :n72]
        tstate = {
            "tail": jnp.zeros((c_local, timing.TAIL), jnp.complex64),
            "next_t": jnp.full((c_local,), float(timing.TAIL), jnp.float32),
            "acc": jnp.zeros((c_local,), jnp.complex64),
        }
        syms, valid, _ = timing.timing_recover(y, tstate)
        hard, soft, _ = timing.dqpsk_demod(
            syms, valid, jnp.zeros((c_local,), jnp.complex64))
        # mask the filter-memory transient at the head of the halo region
        # (duplicated warmup — the left shard owns those symbols cleanly);
        # shard 0 received zeros, so it masks the entire halo span
        n_bad = jnp.where(t_idx == 0, jnp.int32(self.halo_syms),
                          jnp.int32(self.n_bad_syms))
        bad = jnp.arange(valid.shape[1]) < n_bad
        valid = valid & ~bad[None, :]

        bits = jnp.repeat(hard, 2, axis=1)
        bits = bits.at[:, 0::2].set(hard >> 1)
        bits = bits.at[:, 1::2].set(hard & 1)
        corr = sync.sync_correlate(bits)
        hits = jnp.sum(corr >= 0.90)
        total_hits = jax.lax.psum(hits, ("carrier", "time"))
        return hard[:, None, :], valid[:, None, :], total_hits

    def run(self, iq: np.ndarray) -> dict:
        from tetraear_tpu.dsp import kernels
        iq = np.asarray(iq, np.complex64)
        need = self.n_time * self.seg_len
        if len(iq) < need:
            raise ValueError(f"need {need} samples, got {len(iq)}")
        x_r = kernels.c2r_np(iq[:need])
        sh_x = NamedSharding(self.mesh, P("time"))
        xd = _global_device_put(x_r, sh_x)
        sc = jnp.asarray(self.seg_cycles)
        hard, valid, hits = _fetch_global(self._step(xd, sc))
        return {
            "hard": np.asarray(hard),
            "valid": np.asarray(valid),
            "sync_hits": int(np.asarray(hits)),
        }
