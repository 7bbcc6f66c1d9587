"""Carrier-bank demodulator: the jitted device block step + host assembly.

One jit-compiled step takes a wideband IQ block (shared by all carriers or
per-carrier) and the carried state pytree, and produces masked symbol/soft
outputs for every carrier at once:

  (C, N) IQ -> NCO mix -> polyphase resample -> RRC -> timing -> DQPSK
  -> hard symbols (C, K), soft bits (C, K, 2), valid mask (C, K)

All shapes are static; per-carrier state (NCO cycles, filter halos, timing
phase, previous symbol) is a pytree threaded through the step, which is what
lets the runtime scan it over time blocks and shard carriers across a mesh
(tetraear_tpu.runtime).

This replaces the reference's single-carrier, stateless chunk processing
(tetraear/signal/processor.py:221-273; state loss documented at
tetraear/ui/modern.py:1908-1910).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from tetraear_tpu.dsp import design, framescan, kernels, timing

# carried bit tail between blocks: 2 * frame.batch.TAIL_SYMS, the host
# assembly's tail, so device verdicts index the same bit rows
TAILBITS = 1200


class CarrierBankDemod:
    """Demodulate C TETRA carriers from a shared wideband capture.

    Args:
        fs: input sample rate (integer Hz).
        freqs_hz: (C,) carrier offsets from the capture centre (integer Hz).
        block_len: input samples per step; must be a multiple of the plan
            granularity (``self.granularity``).
    """

    def __init__(self, fs: float, freqs_hz, block_len: int | None = None,
                 sps: int = design.SPS, frontend: str = "conv",
                 afc: bool = False, afc_gain: float = 0.3,
                 nfft: int | None = None):
        self.fs = float(fs)
        self.freqs_hz = np.atleast_1d(np.asarray(freqs_hz, dtype=np.float64))
        self.n_carriers = len(self.freqs_hz)
        self.sps = sps
        self.frontend = frontend
        self.afc = afc
        self.afc_gain = float(afc_gain)
        self.rrc = design.rrc_taps(sps=sps).astype(np.float32)
        if frontend == "fft":
            # wideband FFT channelizer to fs/2^m, then a rational clean-up
            # stage to 72 kHz per carrier (dsp/channelizer.py); the
            # channelizer owns the block size (pow2 nfft minus overlap)
            from tetraear_tpu.dsp import channelizer as chan_mod
            decim = chan_mod.choose_decim(self.fs)
            self.plan = design.build_resample_plan(
                self.fs / decim, design.SYMBOL_RATE * sps)
            # fold the RRC matched filter into the final resample stage
            # (noble identity): one fewer pass over every carrier stream.
            # With NO resample stage (72 kHz-family fs: channel rate ==
            # symbol-grid rate) fold it into the channelizer's band
            # spectrum instead: one multiply on the extracted band
            # rather than a per-carrier time-domain conv.
            self._rrc_folded = True
            chan_fir = None
            if self.plan.stages:
                stages = list(self.plan.stages)
                stages[-1] = design.fold_fir_into_stage(stages[-1],
                                                        self.rrc)
                self.plan = design.ResamplePlan(
                    in_rate=self.plan.in_rate, out_rate=self.plan.out_rate,
                    stages=tuple(stages))
            else:
                chan_fir = self.rrc
            g_back = self._granularity()
            self.channelizer = chan_mod.FFTChannelizer(
                self.fs, self.freqs_hz, block_len,
                back_granularity=g_back, fold_fir=chan_fir, nfft=nfft)
            self.granularity = g_back * self.channelizer.decim
            self.block_len = self.channelizer.block_len
            self.nco = None
        else:
            self.channelizer = None
            self.plan = design.build_resample_plan(self.fs,
                                                   design.SYMBOL_RATE * sps)
            self.granularity = self._granularity()
            if block_len is None:
                block_len = 60 * self.granularity
            if block_len % self.granularity:
                raise ValueError(
                    f"block_len {block_len} not a multiple of granularity "
                    f"{self.granularity}")
            self.block_len = block_len
            self.nco = kernels.nco_tables(self.freqs_hz, self.fs, block_len)
        self.n_out72 = self._out_len(
            self.block_len if frontend != "fft"
            else self.block_len // self.channelizer.decim)
        self.k_max = self.n_out72 // sps + 1
        self._step = jax.jit(self._step_impl)

    # -- shape bookkeeping -------------------------------------------------

    def _granularity(self) -> int:
        import math
        n = 1
        for st in self.plan.stages:
            n = n * st.down // math.gcd(n, st.down)
        up = down = 1
        for st in self.plan.stages:
            up *= st.up
            down *= st.down
        k = 1
        # output block must divide by sps AND by every stage's L (the
        # phase-interleave reshape in kernels.stage_apply needs it)
        lcm_l = 1
        for st in self.plan.stages:
            lcm_l = lcm_l * st.up // math.gcd(lcm_l, st.up)
        need = self.sps * lcm_l // math.gcd(self.sps, lcm_l)
        while (k * n * up) % (down * need) != 0:
            k += 1
        return k * n

    def _out_len(self, n_in: int) -> int:
        n = n_in
        for st in self.plan.stages:
            n = n * st.up // st.down
        return n

    # -- state -------------------------------------------------------------

    def init_state(self) -> dict:
        """Initial carried state.  All complex quantities are stored in
        real [re, im] form, the jit-boundary convention of this package
        (see kernels.c2r)."""
        c = self.n_carriers
        extra = ({"channelizer": self.channelizer.init_state()}
                 if self.channelizer is not None else {})
        return {
            **extra,
            "nco_cycles": jnp.zeros((c,), jnp.float32),
            "stage_hist": [
                jnp.zeros((c, kernels.stage_history_len(st), 2), jnp.float32)
                for st in self.plan.stages],
            "rrc_hist": jnp.zeros((c, len(self.rrc) - 1, 2), jnp.float32),
            "timing": {
                "tail": jnp.zeros((c, timing.TAIL, 2), jnp.float32),
                "next_t": jnp.full((c,), float(timing.TAIL), jnp.float32),
                "acc": jnp.zeros((c, 2), jnp.float32),
            },
            "prev_sym": jnp.zeros((c, 2), jnp.float32),
            "afc_omega": jnp.zeros((c,), jnp.float32),
            "afc_phase": jnp.zeros((c,), jnp.float32),
        }

    # -- the jitted block step ----------------------------------------------

    def _step_impl(self, x_r: jnp.ndarray, state: dict) -> tuple:
        """x_r: (N, 2) shared wideband block or (C, N, 2) per-carrier, real
        [re, im] form; state as produced by init_state (real form)."""
        x = kernels.r2c(x_r)
        chan_state = {}
        if self.channelizer is not None:
            if x.ndim != 1:
                raise ValueError("fft frontend takes a shared wideband "
                                 "block")
            y, cstate = self.channelizer.step(x, state["channelizer"])
            chan_state = {"channelizer": cstate}
            nco_cycles = state["nco_cycles"]
        else:
            if x.ndim == 1:
                x = jnp.broadcast_to(x[None, :],
                                     (self.n_carriers, x.shape[0]))
            y, nco_cycles = kernels.nco_mix(
                x, state["nco_cycles"],
                jnp.asarray(self.nco["coarse"]),
                jnp.asarray(self.nco["fine"]),
                jnp.asarray(self.nco["block_step"]), self.nco["fs"])
        y, stage_hist = kernels.plan_apply(
            self.plan, y, [kernels.r2c(h) for h in state["stage_hist"]])
        if getattr(self, "_rrc_folded", False):
            rrc_hist = kernels.r2c(state["rrc_hist"])     # unused, carried
        else:
            y, rrc_hist = kernels.fir_apply(self.rrc, y,
                                            kernels.r2c(state["rrc_hist"]))
        tstate_c = {
            "tail": kernels.r2c(state["timing"]["tail"]),
            "next_t": state["timing"]["next_t"],
            "acc": kernels.r2c(state["timing"]["acc"]),
        }
        syms, valid, tstate = timing.timing_recover(y, tstate_c)
        if self.afc:
            # closed-loop per-carrier frequency tracking (d^4 detector)
            syms, afc_phase = timing.apply_freq_correction(
                syms, state["afc_omega"], state["afc_phase"],
                n_valid=jnp.sum(valid, axis=1))
            err = timing.afc_error(syms, valid)
            afc_omega = state["afc_omega"] + self.afc_gain * err
        else:
            afc_omega = state["afc_omega"]
            afc_phase = state["afc_phase"]
        hard, soft, prev = timing.dqpsk_demod(
            syms, valid, kernels.r2c(state["prev_sym"]))
        new_state = {
            **chan_state,
            "nco_cycles": nco_cycles,
            "stage_hist": [kernels.c2r(h) for h in stage_hist],
            "rrc_hist": kernels.c2r(rrc_hist),
            "timing": {
                "tail": kernels.c2r(tstate["tail"]),
                "next_t": tstate["next_t"],
                "acc": kernels.c2r(tstate["acc"]),
            },
            "prev_sym": kernels.c2r(prev),
            "afc_omega": afc_omega,
            "afc_phase": afc_phase,
        }
        out = {"hard": hard, "soft": soft, "valid": valid,
               "baseband": kernels.c2r(y)}
        return out, new_state

    def step(self, x, state) -> tuple:
        """One jitted block step; x (N,) or (C, N) complex64 (host side)."""
        x = np.asarray(x)
        if np.iscomplexobj(x):
            x_r = kernels.c2r_np(x)
        else:
            x_r = np.asarray(x, np.float32)
        return self._step(jnp.asarray(x_r), state)

    # -- host-side convenience: full-capture demod ---------------------------

    def run(self, iq: np.ndarray) -> dict:
        """Demod a full capture; returns per-carrier symbol/soft streams.

        Drops the first differential output (it references the zero-filled
        initial prev symbol), matching the oracle's first-block semantics.
        """
        iq = np.asarray(iq, dtype=np.complex64)
        n_blocks = len(iq) // self.block_len
        state = self.init_state()
        hards = [[] for _ in range(self.n_carriers)]
        softs = [[] for _ in range(self.n_carriers)]
        power_acc = np.zeros(self.n_carriers, np.float64)
        first = True
        for b in range(n_blocks):
            x = iq[b * self.block_len:(b + 1) * self.block_len]
            out, state = self.step(x, state)
            hard = np.asarray(out["hard"])
            soft = np.asarray(out["soft"])
            valid = np.asarray(out["valid"])
            bb = np.asarray(out["baseband"])        # (C, n72, 2)
            power_acc += np.mean(bb[..., 0] ** 2 + bb[..., 1] ** 2, axis=1)
            for ci in range(self.n_carriers):
                v = valid[ci]
                h = hard[ci][v]
                s = soft[ci][v]
                if first:
                    h, s = h[1:], s[1:]
                hards[ci].append(h)
                softs[ci].append(s)
            first = False
        return {
            "symbols": [np.concatenate(h) if h else np.zeros(0, np.uint8)
                        for h in hards],
            "soft_bits": [np.concatenate(s) if s else np.zeros((0, 2),
                                                              np.float32)
                          for s in softs],
            # mean per-carrier channelized band power (linear); real signal
            # power, unlike anything derivable from unit-normalized softs
            "power": power_acc / max(n_blocks, 1),
        }


def block_step_scan(bank: CarrierBankDemod, x_r, state, bit_tail_bits):
    """One block through the demod AND the on-device frame scan (traceable).

    bank._step_impl, then the 2-bit interleave of the masked symbols, the
    carried-tail concat and framescan.frame_scan_packed_even over
    [tail ++ block bits]; the next tail is the last TAILBITS VALID bits.
    One traced program per block: a split demod-then-scan formulation
    pays a second dispatch and a (C, 2W) bit-plane transfer.

    bit_tail_bits: (C, TAILBITS) uint8.  Returns (scan dict, new bank
    state, new tail bits, (C,) valid counts, demod outputs).
    """
    k = bank.k_max
    out, st2 = bank._step_impl(x_r, state)
    valid = out["valid"]
    n_c = jnp.sum(valid, axis=1)                  # (C,), in {K-1, K}
    h = jnp.where(valid, out["hard"], 0).astype(jnp.uint8)
    bits = jnp.repeat(h, 2, axis=1)
    bits = bits.at[:, 0::2].set(h >> 1)
    bits = bits.at[:, 1::2].set(h & 1)
    z = jnp.concatenate([bit_tail_bits, bits], axis=1)
    scan = framescan.frame_scan_packed_even(z)
    # new tail = last TAILBITS valid bits; the per-row start 2*n_c is in
    # {2K-4, 2K-2, 2K} (timing.timing_recover bounds the count): three
    # static slices + a select chain, no gather
    tl2 = jax.lax.slice_in_dim(z, 2 * k - 4, 2 * k - 4 + TAILBITS, 1,
                               axis=1)
    for d in (1, 2):
        cand = jax.lax.slice_in_dim(
            z, 2 * k - 4 + 2 * d, 2 * k - 4 + 2 * d + TAILBITS, 1,
            axis=1)
        tl2 = jnp.where((n_c == k - 2 + d)[:, None], cand, tl2)
    return scan, st2, tl2, n_c, out


def symbols_to_bits(symbols: np.ndarray) -> np.ndarray:
    s = np.asarray(symbols, dtype=np.uint8)
    bits = np.empty(2 * len(s), dtype=np.uint8)
    bits[0::2] = (s >> 1) & 1
    bits[1::2] = s & 1
    return bits
