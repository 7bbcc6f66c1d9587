"""Batched symbol-timing recovery + differential demod (JAX).

Vectorized over carriers; fixed-shape outputs with validity masks so the
whole step jits cleanly (no data-dependent shapes — XLA requirement).

Algorithm identical to the NumPy oracle (tetraear_tpu.ref.demod):
Oerder-Meyr square-law timing phasor with an IIR-smoothed accumulator,
nearest-wrap snap of the symbol clock, Catmull-Rom interpolation at
symbol instants, then pi/4-DQPSK differential demod with quadrant
decisions and soft bits.

At sps=4 the O&M twiddles exp(-j 2 pi n / 4) are exactly {1,-j,-1,j}, so
the timing metric reduces to four strided power sums — elementwise
reductions, no transcendentals.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

SPS = 4
TAIL = 4                       # carried samples for cubic interpolation
TWO_PI = 2.0 * np.pi


def init_timing_state(n_carriers: int) -> dict:
    return {
        "tail": jnp.zeros((n_carriers, TAIL), jnp.complex64),
        "next_t": jnp.full((n_carriers,), float(TAIL), jnp.float32),
        "acc": jnp.zeros((n_carriers,), jnp.complex64),
    }


def _om_phasor(y: jnp.ndarray) -> jnp.ndarray:
    """Oerder-Meyr timing phasor per carrier; y is (C, N), N % 4 == 0."""
    p = (y.real * y.real + y.imag * y.imag)          # |y|^2, (C, N)
    c, n = p.shape
    p4 = p.reshape(c, n // SPS, SPS)
    s = jnp.sum(p4, axis=1)                          # (C, 4) per-phase power
    # sum_n |y|^2 e^{-j 2 pi n / 4}: twiddles 1, -j, -1, j
    return jax.lax.complex(s[:, 0] - s[:, 2], s[:, 3] - s[:, 1])


def _catmull_rom_rows(z: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Per-row cubic interpolation: z (C, L) complex, t (C, K) positions."""
    i = jnp.floor(t).astype(jnp.int32)
    f = (t - i).astype(jnp.float32)
    idx = jnp.clip(i, 1, z.shape[1] - 3)
    p0 = jnp.take_along_axis(z, idx - 1, axis=1)
    p1 = jnp.take_along_axis(z, idx, axis=1)
    p2 = jnp.take_along_axis(z, idx + 1, axis=1)
    p3 = jnp.take_along_axis(z, idx + 2, axis=1)
    f2 = f * f
    f3 = f2 * f
    out = 0.5 * (2.0 * p1
                 + (p2 - p0) * f
                 + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * f2
                 + (3.0 * (p1 - p2) + p3 - p0) * f3)
    return out.astype(jnp.complex64)


def timing_recover(y: jnp.ndarray, state: dict,
                   acc_decay: float = 0.5) -> tuple:
    """(C, N) matched-filtered samples -> masked symbol-spaced samples.

    Returns (symbols (C, K), valid (C, K) bool, new_state) with
    K = N//SPS + 1 (fixed shape; the true count varies by +-1 per block).

    Gather-free interpolation: symbol instants are t_k = next_t + 4k, so
    the fractional part is constant per carrier and the four cubic taps
    are stride-4 slices of z at one of four integer base offsets —
    static slices + a 4-way select instead of per-element gathers.
    """
    c, n = y.shape
    if n % SPS != 0:
        raise ValueError(f"block length {n} not divisible by sps={SPS}")
    k_max = n // SPS + 1

    acc = acc_decay * state["acc"] + _om_phasor(y)
    mu = jnp.mod(-jnp.angle(acc) / TWO_PI * SPS, SPS)     # (C,)

    next_t = state["next_t"]
    cur_frac = jnp.mod(next_t - TAIL, SPS)
    delta = jnp.mod(mu - cur_frac + SPS / 2.0, SPS) - SPS / 2.0
    next_t = next_t + delta
    next_t = jnp.where(next_t < 1.0, next_t + SPS, next_t)

    t_max = jnp.float32(TAIL + n - 3)
    t_k = next_t[:, None] + SPS * jnp.arange(k_max, dtype=jnp.float32)[None]
    valid = t_k <= t_max                                   # (C, K)

    # per-row integer base b = floor(next_t) - 1 in {0..3}, fraction f
    i0 = jnp.clip(jnp.floor(next_t).astype(jnp.int32), 1, SPS)
    b = i0 - 1                                             # (C,)
    f = (next_t - i0.astype(jnp.float32))[:, None]         # (C, 1)

    # one fused concat (tail + block + pad) — a separate z then z_p
    # costs an extra full-array round trip per block
    z_p = jnp.concatenate(
        [state["tail"], y, jnp.zeros((c, SPS + 4), y.dtype)], axis=1)
    # taps[j] = z[:, b + j + 4k] for b in {0..3}: ONE phase-major
    # transpose (C, L) -> (C, 4, L/4) turns every (b, j) candidate into
    # a contiguous slice of plane (b+j) % 4 at offset (b+j) // 4 instead
    # of 16 stride-4 minor-dim slices.
    # Only q = b + j in [0, 6] distinct plane slices exist — build the 7
    # once and select per tap.
    L = z_p.shape[1]
    zr = jnp.transpose(z_p.reshape(c, L // SPS, SPS), (0, 2, 1))
    u = [jax.lax.slice_in_dim(zr[:, q % SPS], q // SPS,
                              q // SPS + k_max, 1, axis=1)
         for q in range(2 * SPS - 1)]                      # (C, K) each
    taps = []
    for j in range(4):
        sel = u[j]
        for bb in range(1, SPS):
            sel = jnp.where((b == bb)[:, None], u[bb + j], sel)
        taps.append(sel)
    p0, p1, p2, p3 = taps

    f2 = f * f
    f3 = f2 * f
    syms = (0.5 * (2.0 * p1
                   + (p2 - p0) * f
                   + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * f2
                   + (3.0 * (p1 - p2) + p3 - p0) * f3)).astype(jnp.complex64)
    n_valid = jnp.sum(valid, axis=1)                       # (C,)

    new_next = next_t + SPS * n_valid.astype(jnp.float32) - jnp.float32(n)
    new_state = {
        "tail": y[:, n - TAIL:],
        "next_t": new_next,
        "acc": acc,
    }
    return syms, valid, new_state


def afc_error(symbols: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Per-carrier frequency error in rad/symbol from the d^4 detector.

    Every legal pi/4-DQPSK transition satisfies 4*dphi = pi (mod 2pi), so
    with a residual rotation eps per symbol, E[d^4] = |d|^4 e^{j(pi+4eps)}
    — data-independent.  Returns (C,) estimated eps.  New capability: the
    reference has only a coarse FFT-peak AFC at the capture level
    (tetraear/ui/modern.py:1960-1967, 5135-5169), nothing per carrier.
    """
    d = symbols[:, 1:] * jnp.conj(symbols[:, :-1])
    m = jnp.abs(d) + 1e-12
    d4 = (d / m) ** 4
    w = (valid[:, 1:] & valid[:, :-1]).astype(jnp.float32)
    acc = jnp.sum(d4 * w, axis=1)
    # angle(-acc) measures (angle(acc) - pi) without the +-pi wrap
    # discontinuity that sits exactly at the zero-error operating point
    return jnp.angle(-acc) / 4.0


def apply_freq_correction(symbols: jnp.ndarray, omega: jnp.ndarray,
                          phase0: jnp.ndarray,
                          n_valid: jnp.ndarray | None = None) -> tuple:
    """Derotate symbol-spaced samples by a per-carrier frequency omega
    (rad/symbol) with carried phase.  Returns (corrected, new_phase0).

    ``n_valid`` is the per-carrier count of real symbols in this block
    (timing_recover's mask sum).  The carried phase advances by
    omega * n_valid — advancing by the padded slot count K instead would
    over-rotate the next block's first symbol by omega*(K - n_valid)
    whenever a block yields fewer than K symbols.
    """
    k = jnp.arange(symbols.shape[1], dtype=jnp.float32)[None, :]
    ang = phase0[:, None] + omega[:, None] * k
    rot = jax.lax.complex(jnp.cos(ang), -jnp.sin(ang))
    if n_valid is None:
        n_valid = jnp.full(symbols.shape[:1], symbols.shape[1],
                           jnp.float32)
    new_phase0 = jnp.mod(
        phase0 + omega * n_valid.astype(jnp.float32),
        jnp.float32(TWO_PI))
    return symbols * rot, new_phase0


def dqpsk_demod(symbols: jnp.ndarray, valid: jnp.ndarray,
                prev: jnp.ndarray) -> tuple:
    """Differential demod on masked symbol rows.

    symbols: (C, K) complex, valid: (C, K) bool — valid entries are
    contiguous from index 0 (timing_recover guarantees this).
    prev: (C,) last valid symbol from the previous block.

    Returns (hard (C, K) uint8, soft (C, K, 2) float32, new_prev (C,)).
    """
    seq = jnp.concatenate([prev[:, None], symbols], axis=1)   # (C, K+1)
    d = seq[:, 1:] * jnp.conj(seq[:, :-1])
    msb = (d.imag < 0).astype(jnp.uint8)
    lsb = (d.real < 0).astype(jnp.uint8)
    hard = (msb << 1) | lsb
    mag = jnp.abs(d) + 1e-12
    soft = jnp.stack([-d.imag / mag, -d.real / mag], axis=-1)

    # last valid symbol per carrier without a gather: valid entries are
    # contiguous from 0, so the last one is where valid & ~valid_next
    n_valid = jnp.sum(valid, axis=1)
    valid_next = jnp.concatenate(
        [valid[:, 1:], jnp.zeros_like(valid[:, :1])], axis=1)
    edge = valid & ~valid_next                             # one-hot row
    last = jnp.sum(jnp.where(edge, symbols, 0), axis=1)
    new_prev = jnp.where(n_valid > 0, last, prev)
    return hard, soft.astype(jnp.float32), new_prev
