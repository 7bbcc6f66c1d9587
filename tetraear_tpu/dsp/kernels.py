"""JAX kernels for the carrier-bank demod chain (batched over carriers).

Device formulations of the chain in tetraear_tpu.ref.demod:

  * NCO mixing uses *exact integer cycle arithmetic in float32*: all cycle
    counters are integers < fs < 2^24, which float32 represents exactly, so
    the phase never loses precision over arbitrarily long streams (the
    reference recomputes exp(-j 2 pi f t) with t from 0 every chunk,
    tetraear/signal/processor.py:97-100, and is only phase-continuous by
    luck).  Tables are (coarse + fine) outer sums, no gathers, no scan.
  * Polyphase resampling stages are per-phase strided 1-D convolutions
    (lax.conv_general_dilated) over a real/imag-stacked batch.
  * Same taps and same block/halo semantics as the NumPy oracle, so outputs
    agree to float32 rounding and symbol decisions agree exactly.  The
    float convolutions ask for Precision.HIGHEST: left at the default, a
    GPU may run float32 products in TF32 (~3 decimal digits), which breaks
    that agreement.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from tetraear_tpu.dsp.design import ResamplePlan, ResampleStage

FINE = 256            # fine-table size for the NCO outer sum
HIGHEST = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Real <-> complex boundary helpers
#
# Every jitted entry point of this package takes/returns float32 arrays
# with a trailing [re, im] axis and reassembles complex64 immediately
# inside the jit; complex math happens only inside.
# ---------------------------------------------------------------------------

def c2r(z: jnp.ndarray) -> jnp.ndarray:
    """complex (..., N) -> float32 (..., N, 2)."""
    return jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)


def r2c(a: jnp.ndarray) -> jnp.ndarray:
    """float32 (..., N, 2) -> complex64 (..., N)."""
    return jax.lax.complex(a[..., 0], a[..., 1]).astype(jnp.complex64)


def c2r_np(z: np.ndarray) -> np.ndarray:
    return np.stack([z.real, z.imag], axis=-1).astype(np.float32)


def r2c_np(a: np.ndarray) -> np.ndarray:
    return (a[..., 0] + 1j * a[..., 1]).astype(np.complex64)


# ---------------------------------------------------------------------------
# NCO tables (host-side, exact integer arithmetic)
# ---------------------------------------------------------------------------

def nco_tables(freqs_hz: np.ndarray, fs: float, block_len: int) -> dict:
    """Per-carrier NCO cycle tables for blocks of ``block_len`` samples.

    Returns float32 arrays whose entries are exact integers (< fs):
      coarse: (C, ceil(block_len/FINE)) — cycles at sample index i*FINE
      fine:   (C, FINE)                 — cycles at sample index j
      block_step: (C,)                  — cycle advance per block
    Sample n's phase (in cycles) = (state + coarse[n//FINE] + fine[n%FINE])
    mod fs, scaled by 1/fs.
    """
    fs_i = int(round(fs))
    freqs = np.asarray(freqs_hz)
    if not np.allclose(freqs, np.round(freqs)):
        raise ValueError("NCO frequencies must be integer Hz")
    freqs_i = np.round(freqs).astype(np.int64)
    n_coarse = math.ceil(block_len / FINE)
    i = np.arange(n_coarse, dtype=np.int64)
    j = np.arange(FINE, dtype=np.int64)
    coarse = ((i[None, :] * FINE) * freqs_i[:, None]) % fs_i
    fine = (j[None, :] * freqs_i[:, None]) % fs_i
    step = (np.int64(block_len) * freqs_i) % fs_i
    return {
        "coarse": coarse.astype(np.float32),
        "fine": fine.astype(np.float32),
        "block_step": step.astype(np.float32),
        "fs": float(fs_i),
        "block_len": block_len,
    }


def nco_mix(x: jnp.ndarray, cycles: jnp.ndarray, coarse: jnp.ndarray,
            fine: jnp.ndarray, block_step: jnp.ndarray,
            fs: float) -> tuple:
    """Mix (C, N) complex blocks down by each carrier's frequency.

    cycles: (C,) float32 exact-integer cycle state. Returns (y, new_cycles).
    """
    c, n = x.shape
    n_coarse = coarse.shape[1]
    # (C, n_coarse, FINE) exact-integer cycle counts, then mod fs.
    ph = (cycles[:, None, None] + coarse[:, :, None] + fine[:, None, :])
    ph = jnp.mod(ph, fs)
    ph = ph.reshape(c, n_coarse * FINE)[:, :n]
    ang = ph * jnp.float32(2.0 * np.pi / fs)
    osc = jax.lax.complex(jnp.cos(ang), -jnp.sin(ang))
    new_cycles = jnp.mod(cycles + block_step, fs)
    return (x * osc).astype(jnp.complex64), new_cycles


# ---------------------------------------------------------------------------
# Polyphase stage as strided convolutions
# ---------------------------------------------------------------------------

def _phase_bank(stage: ResampleStage) -> np.ndarray:
    h = stage.taps_array
    L = stage.up
    P = math.ceil(len(h) / L)
    bank = np.zeros((L, P), dtype=np.float32)
    for p in range(L):
        sub = h[p::L]
        bank[p, :len(sub)] = sub
    return bank


def stage_history_len(stage: ResampleStage) -> int:
    return math.ceil((len(stage.taps) - 1) / stage.up)


def _conv1d_strided(x: jnp.ndarray, taps_rev: jnp.ndarray,
                    stride: int) -> jnp.ndarray:
    """(B, len) real x, correlation with reversed taps, VALID, stride."""
    lhs = x[:, None, :]
    rhs = taps_rev[None, None, :]
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(stride,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"), precision=HIGHEST)
    return out[:, 0, :]


def stage_apply(stage: ResampleStage, x: jnp.ndarray,
                history: jnp.ndarray) -> tuple:
    """One polyphase stage on a (C, N) complex block with (C, H) history.

    Same output values as tetraear_tpu.ref.polyphase.stage_apply (float32
    rounding aside).  Returns (y (C, N*L//M), new_history).
    """
    L, M = stage.up, stage.down
    H = stage_history_len(stage)
    c, n = x.shape
    if (n * L) % M != 0:
        raise ValueError(f"block length {n} incompatible with L={L} M={M}")
    n_out = n * L // M
    if n_out % L != 0:
        raise ValueError(f"output length {n_out} not divisible by L={L}")

    xx = jnp.concatenate([history, x], axis=1)          # (C, H+N)
    xr = jnp.concatenate([xx.real, xx.imag], axis=0)    # (2C, H+N) float32
    bank = _phase_bank(stage)                           # (L, P)
    P = bank.shape[1]

    if L == 1:
        # plain FIR/decimator: one single-channel strided conv
        start = H - (P - 1)
        need = start + (n_out - 1) * M + P
        seg = jax.lax.dynamic_slice_in_dim(xr, start, need - start, axis=1)
        yr = _conv1d_strided(seg, jnp.asarray(bank[0][::-1].copy()), M)
    else:
        # All L output phases in ONE multi-channel strided conv: output
        # channel m0 carries branch p=(m0*M)%L's reversed taps placed at
        # intra-stride offset n0=floor(m0*M/L) inside a widened kernel,
        # so every phase shares the same stride-M window walk: one read
        # of the input instead of L, and one (2C, L, P') x window
        # contraction.  The "NHC"
        # output layout yields (2C, T, L) so phase de-interleaving is a
        # free reshape, not a transpose pass.
        deltas = [(m0 * M) // L for m0 in range(L)]
        P2 = P + max(deltas)
        rhs_np = np.zeros((L, 1, P2), np.float32)
        for m0 in range(L):
            p = (m0 * M) % L
            d = deltas[m0]
            rhs_np[m0, 0, d:d + P] = bank[p][::-1]
        start = H - (P - 1)
        T = n_out // L
        need = start + (T - 1) * M + P2
        seg = jax.lax.dynamic_slice_in_dim(xr, start, need - start, axis=1)
        out = jax.lax.conv_general_dilated(
            seg[:, None, :], jnp.asarray(rhs_np),
            window_strides=(M,), padding="VALID",
            dimension_numbers=("NCH", "OIH", "NHC"),
            precision=HIGHEST)                          # (2C, T, L)
        yr = out.reshape(2 * c, n_out)
    y = jax.lax.complex(yr[:c], yr[c:])
    new_hist = xx[:, xx.shape[1] - H:] if H > 0 else xx[:, :0]
    return y.astype(jnp.complex64), new_hist


def plan_apply(plan: ResamplePlan, x: jnp.ndarray,
               histories: list) -> tuple:
    y = x
    new_hists = []
    for st, hist in zip(plan.stages, histories):
        y, h2 = stage_apply(st, y, hist)
        new_hists.append(h2)
    return y, new_hists


def fir_apply(taps: np.ndarray, x: jnp.ndarray,
              history: jnp.ndarray) -> tuple:
    """Streaming causal FIR (L=M=1) on (C, N) blocks."""
    st = ResampleStage(up=1, down=1,
                       taps=tuple(np.asarray(taps, np.float32).tolist()))
    return stage_apply(st, x, history)


def init_plan_histories(plan: ResamplePlan, n_carriers: int) -> list:
    return [jnp.zeros((n_carriers, stage_history_len(st)), jnp.complex64)
            for st in plan.stages]
