"""Overlap-save FFT channelizer: all carriers from one wideband FFT.

The conv frontend (kernels.nco_mix + first polyphase stage) costs
O(C x N) at the full input rate — fine for tens of carriers, ruinous for
thousands.  This frontend computes ONE forward FFT of the wideband block
and extracts every carrier as a band of bins:

    x (nfft,) --FFT--> X --band gather + H1 + IFFT--> (C, n_band) @ fs/D

per-carrier cost collapses to a small IFFT at the channel rate, so total
work is O(N log N + C * N/D) (SURVEY.md section 7, BASELINE configs 3-5).

Sizing: **nfft and n_band are powers of two.**  Consequences:

  * decim = 2^m with fs/decim in [72, 160] kHz; the polyphase back half
    resamples the odd channel rate (75/120/... kHz) to 72 kHz.
  * carrier offsets are rounded to the nearest FFT bin (<= fs/2nfft,
    ~4.6 Hz).  A few Hz of residual offset rotates the constellation once
    every ~0.2 s — invisible to differential demod (0.002 rad/symbol) —
    so no residual NCO is needed.

Other correctness notes:
  * The channel-select lowpass h1 is applied in the frequency domain
    (FFT of h1 sampled at band-relative bins), making the extraction an
    exact overlap-save of conv(x, h1) + decimation; the circular-wrap
    corrupt region ((len(h1)-1)/decim output samples) is covered by the
    overlap.
  * Band extraction re-references phase to each block's start; a per-block
    rotation with integer cycle counters (mod nfft, carried in float32)
    restores global phase continuity so downstream filter state carries
    across blocks.
"""

from __future__ import annotations

import math

import numpy as np

import jax
import jax.numpy as jnp

from tetraear_tpu.dsp import design

TARGET_CHANNEL_RATE = 96_000.0


def choose_decim(fs: float) -> int:
    """Power-of-two decimation keeping the channel rate in [72k, 160k],
    preferring the rate whose 72 kHz resample ratio has the smallest
    polyphase interpolation factor (each of the L sub-filters becomes a
    separate conv in the back half; L in the hundreds would bloat the
    compiled step).  fs = 72 kHz * 2^m yields L = 1 (no back stage)."""
    from fractions import Fraction
    best, best_l = None, 1 << 30
    d = 1
    while fs / d > 160_000.0:
        d *= 2
    while fs / d >= 72_000.0:
        rate = fs / d
        if abs(rate - round(rate)) < 1e-6:
            frac = Fraction(72_000, int(round(rate)))
            # prefer fewer sub-filters; on ties, the lower channel rate
            if frac.numerator <= best_l:
                best, best_l = d, frac.numerator
        d *= 2
    if best is None or best_l > 64:
        raise ValueError(
            f"no power-of-two channel rate from fs={fs:g} gives a "
            f"tractable 72 kHz resample ratio (best L={best_l}); use an "
            f"fs of the form 72000*2^m (e.g. 2.304/4.608/9.216/36.864 "
            f"MHz) or a standard SDR rate like 2.4 Msps")
    return best


def choose_nfft(fs: float) -> int:
    """Smallest power of two covering ~0.1 s of input."""
    return 2 ** int(math.ceil(math.log2(max(fs * 0.1, 1024.0))))


class FFTChannelizer:
    """Streaming overlap-save channelizer fs -> fs/decim per carrier."""

    def __init__(self, fs: float, freqs_hz: np.ndarray,
                 block_len: int | None = None,
                 back_granularity: int | None = None,
                 fold_fir=None, nfft: int | None = None):
        self.fs = float(fs)
        self.freqs_hz = np.asarray(freqs_hz, np.float64)
        self.decim = choose_decim(self.fs)
        self.nfft = choose_nfft(self.fs) if nfft is None else int(nfft)
        self.n_band = self.nfft // self.decim
        self.out_rate = self.fs / self.decim

        # channel-select lowpass at the input rate; its stopband starts
        # inside the extracted band so decimation cannot fold interference
        h1 = design.kaiser_lowpass(
            13_000.0, self.out_rate / 2.0 - 14_000.0, self.fs,
            atten_db=60.0)
        self.h1_len = len(h1)
        # optional OUTPUT-rate FIR (the RRC matched filter when the back
        # half has no resample stage to fold it into) applied in the band
        # frequency domain: one more multiply on the already-extracted
        # spectrum instead of a time-domain conv per carrier.  Exact
        # linear conv provided the overlap also covers its memory (below).
        self.fold_fir = None if fold_fir is None else np.asarray(
            fold_fir, np.float64)
        fir_mem = (0 if self.fold_fir is None
                   else (len(self.fold_fir) - 1) * self.decim)

        # overlap: >= h1 (+ folded output FIR) memory, and block = nfft -
        # overlap must divide by decim * back_granularity (the 72 kHz
        # back half's block quantum); the smallest such multiple
        g = int(back_granularity) if back_granularity else 1
        quantum = self.decim * g
        overlap = self.nfft % quantum
        while overlap < max(self.h1_len + fir_mem, self.decim):
            overlap += quantum
        self.overlap = overlap
        if overlap * 2 >= self.nfft:
            raise ValueError(
                f"overlap {overlap} >= nfft/2 ({self.nfft}): filter "
                f"memory too large for the transform at fs={fs:g}")
        self.block_len = self.nfft - overlap
        if block_len is not None and block_len != self.block_len:
            raise ValueError(
                f"fft frontend requires block_len={self.block_len} at "
                f"fs={fs:g} (got {block_len})")
        self.drop = self.overlap // self.decim
        self.n_out = self.block_len // self.decim

        bin_hz = self.fs / self.nfft
        # offsets round to the nearest bin (<= bin/2 ~ Hz-scale residual;
        # harmless to differential demod — see module docstring)
        self.k_c = np.round(self.freqs_hz / bin_hz).astype(np.int64)
        self.residual_hz = self.freqs_hz - self.k_c * bin_hz

        H1 = np.fft.fft(h1, self.nfft)
        firF = (np.ones(self.n_band) if self.fold_fir is None
                else np.fft.fft(self.fold_fir, self.n_band))
        j = np.arange(self.n_band)
        j_signed = np.where(j < self.n_band // 2, j, j - self.n_band)
        self.h1_band = (H1[j_signed % self.nfft]
                        * firF[j % self.n_band]).astype(np.complex64)
        # per-carrier band start in the wrap-extended spectrum (each band
        # is one contiguous slice of length n_band in natural order)
        self.band_start = ((self.k_c - self.n_band // 2)
                           % self.nfft).astype(np.int32)
        # 128-bin-aligned starts (e.g. the 12.5+25 kHz channel grid at
        # fs in the 10.24 MHz * 2^j family) allow extraction as a ROW
        # gather of the (nfft/128, 128)-reshaped spectrum: contiguous
        # 128-bin rows instead of one index per element
        self.aligned = bool(np.all(self.band_start % 128 == 0)
                            and self.n_band % 128 == 0)
        # QUANTIZED row gather: when starts are NOT row-aligned (e.g. fs
        # in the 72 kHz * 2^m family, whose bin grid is incommensurate
        # with the 25 kHz channel grid for any pow2 nfft), extract from
        # the row-aligned start s = 128*floor(start/128) below the band and
        # repair the d = start - s (in [0,128)) bin shift exactly:
        #   * the channel-select filter is applied as H1 rolled by d
        #     (only 128 distinct rolls -> a (128, n_band) host table);
        #     the d wrap bins fall >= out_rate/2 - 128*bin_hz into the
        #     filter stopband and are zeroed (the quantized band misses
        #     them; they carry <= -60 dB energy);
        #   * extraction centred d bins low leaves the channel modulated
        #     by +d*bin_hz; a per-d complex ramp exp(-2pi j d D(drop+n)
        #     / nfft) (again a 128-row table) removes it.  Cross-block
        #     phase continuity holds because the total per-block phase
        #     advance (k_c - d)*block + d*block = k_c*block matches the
        #     existing integer cycle counters, which are unchanged.
        self.quantized = bool(not self.aligned and self.n_band % 128 == 0)
        if self.aligned or self.quantized:
            rows = self.n_band // 128
            start_al = (self.band_start // 128) * 128
            self.row_idx = (start_al[:, None] // 128
                            + np.arange(rows)[None, :]).astype(np.int32)
        if self.quantized:
            self.d_shift = (self.band_start - start_al).astype(np.int32)
            nb = self.n_band
            j = np.arange(nb)
            j_signed = np.where(j < nb // 2, j, j - nb)      # FFT order
            d_col = np.arange(128)[:, None]
            rel = j_signed[None, :] - d_col                  # (128, nb)
            h1_roll = H1[rel % self.nfft] * firF[rel % nb]
            h1_roll[rel < -(nb // 2)] = 0.0                  # missing bins
            self.h1_roll = h1_roll.astype(np.complex64)
            ang = (2.0 * np.pi * d_col * self.decim
                   * (self.drop + np.arange(self.n_out))[None, :]
                   / self.nfft)
            self.ramp = np.exp(-1j * ang).astype(np.complex64)

        # NATURAL-ORDER synthesis: the per-block fftshift (rolling every
        # extracted band by n_band/2 to FFT order) was a full-array
        # shuffle costing its own HBM round trip at fleet scale.  Roll
        # the FILTER tables once at build time instead and feed the
        # natural-order product straight to the inverse transform:
        #   ifft(roll(B, -half))[k] = (-1)^k * ifft(B)[k],
        # so the only runtime cost is a (-1)^k sign on the synthesis
        # output — folded into the quantized ramp table, or one fused
        # broadcast multiply on the other paths.
        half = self.n_band // 2
        self.h1_band = np.roll(self.h1_band, -half)
        if self.quantized:
            self.h1_roll = np.roll(self.h1_roll, -half, axis=1)
        self.sign = np.where(
            (self.drop + np.arange(self.n_out)) % 2 == 0,
            np.float32(1.0), np.float32(-1.0))
        if self.quantized:
            # fold the sign into the ramp table (one fewer multiply);
            # step() then skips the standalone sign pass on this path
            self.ramp = (self.ramp
                         * self.sign[None, :]).astype(np.complex64)

        # per-block phase-correction step: (k_c * block_len) mod nfft.
        # float32 holds these integers exactly below 2^24; at nfft 2^25
        # and above an odd step rounds by one cycle (2 pi / nfft rad)
        self.cycle_step = ((self.k_c % self.nfft)
                           * (self.block_len % self.nfft)
                           % self.nfft).astype(np.float32)

    def init_state(self) -> dict:
        return {
            "tail": jnp.zeros((self.overlap, 2), jnp.float32),
            "cycles": jnp.zeros((len(self.k_c),), jnp.float32),
        }

    def step(self, x: jnp.ndarray, state: dict) -> tuple:
        """x: (block_len,) complex64 new wideband samples.

        Returns ((C, n_out) complex64 channel blocks @ out_rate,
        new_state)."""
        from tetraear_tpu.dsp import kernels

        tail = kernels.r2c(state["tail"])
        xx = jnp.concatenate([tail, x])               # (nfft,)
        big_x = jnp.fft.fft(xx)
        # wrap-extend so every band is one contiguous slice
        x_ext = jnp.concatenate([big_x, big_x[:self.n_band]])
        if self.aligned or self.quantized:
            rows = x_ext.reshape(-1, 128)             # (.., 128) rows
            nat = rows[jnp.asarray(self.row_idx)]     # (C, nb/128, 128)
            nat = nat.reshape(len(self.k_c), self.n_band)
        else:
            idx = (jnp.asarray(self.band_start)[:, None]
                   + jnp.arange(self.n_band, dtype=jnp.int32)[None, :])
            nat = x_ext[idx]                          # (C, n_band) centred
        # natural-order band product (the fftshift lives in the rolled
        # filter tables + the (-1)^k sign on the synthesis output)
        if self.quantized:
            band = nat * jnp.asarray(self.h1_roll)[jnp.asarray(
                self.d_shift)]
        else:
            band = nat * jnp.asarray(self.h1_band)[None, :]
        y = jnp.fft.ifft(band, axis=1)
        y = y * jnp.float32(1.0 / self.decim)
        y = y[:, self.drop:self.drop + self.n_out]
        if self.quantized:
            # remove the +d-bin modulation left by the aligned
            # extraction (ramp table carries the (-1)^k sign)
            y = y * jnp.asarray(self.ramp)[jnp.asarray(self.d_shift)]
        else:
            y = y * jnp.asarray(self.sign)[None, :]

        # restore global phase continuity (see module docstring)
        nfft_f = jnp.float32(self.nfft)
        ang = state["cycles"] * jnp.float32(2.0 * np.pi) / nfft_f
        rot = jax.lax.complex(jnp.cos(ang), -jnp.sin(ang))
        y = y * rot[:, None]
        new_cycles = jnp.mod(state["cycles"] + jnp.asarray(self.cycle_step),
                             nfft_f)
        new_state = {
            "tail": kernels.c2r(xx[xx.shape[0] - self.overlap:]),
            "cycles": new_cycles,
        }
        return y.astype(jnp.complex64), new_state
