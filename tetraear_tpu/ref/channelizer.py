"""NumPy oracle of one FFT-channelizer block (dsp.channelizer).

Same tables and the same overlap-save block semantics as
FFTChannelizer.step, computed in float64 with numpy.fft: a forward FFT of
the window, per-carrier band extraction (row-aligned start + rolled
filter + residual ramp on the quantized path), inverse FFT, scale, drop,
sign/ramp and the carried-phase rotation.  The device output must agree
with this to float32 rounding (max abs error a small fraction of the
output RMS).
"""

from __future__ import annotations

import numpy as np


def channelize_block(ch, window: np.ndarray, cycles=None,
                     carriers=None) -> np.ndarray:
    """window: (nfft,) complex samples, the carried tail ++ the block.
    cycles: (C,) carried integer phase counters (state["cycles"]), zeros
    for the first block.  carriers: indices to compute (default all).
    Returns (len(carriers), n_out) complex128."""
    nb = ch.n_band
    carriers = (range(len(ch.k_c)) if carriers is None
                else list(carriers))
    cycles = (np.zeros(len(ch.k_c)) if cycles is None
              else np.asarray(cycles, np.float64))
    spec = np.fft.fft(np.asarray(window, np.complex128))
    ext = np.concatenate([spec, spec[:nb]])
    out = []
    for c in carriers:
        start = int(ch.band_start[c])
        if ch.quantized:
            d = int(ch.d_shift[c])
            band = ext[start - d:start - d + nb] * ch.h1_roll[d]
        else:
            band = ext[start:start + nb] * ch.h1_band
        y = np.fft.ifft(band)[ch.drop:ch.drop + ch.n_out] / ch.decim
        y = y * (ch.ramp[d] if ch.quantized else ch.sign)
        out.append(y * np.exp(-2j * np.pi * cycles[c] / ch.nfft))
    return np.stack(out)
