"""Streaming polyphase rational resampling — NumPy oracle implementation.

This is the bit-exactness contract for the JAX device kernels in
``tetraear_tpu.dsp``: identical taps, identical windowing, identical
block/halo semantics.  The JAX path must produce the same outputs (to float32
tolerance) for the same blocks.

Semantics (shared with the device path):

  For a stage (L, M, taps h[T]) the conceptual operation is: zero-stuff the
  input by L, filter causally with h, keep every M-th output.  A block of N
  input samples (with N*L % M == 0) produces N*L//M outputs.  Streaming
  continuity requires H = ceil((T-1)/L) input samples of history carried
  between blocks — the "overlap-save halo" that becomes a ``ppermute``
  exchange when the time axis is sharded across devices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from tetraear_tpu.dsp.design import ResamplePlan, ResampleStage


def stage_history_len(stage: ResampleStage) -> int:
    return int(math.ceil((len(stage.taps) - 1) / stage.up))


def polyphase_bank(stage: ResampleStage) -> np.ndarray:
    """Taps rearranged as an (L, P) bank; h_p[j] = h[j*L + p], zero-padded."""
    h = stage.taps_array
    L = stage.up
    P = int(math.ceil(len(h) / L))
    bank = np.zeros((L, P), dtype=np.float32)
    for p in range(L):
        sub = h[p::L]
        bank[p, : len(sub)] = sub
    return bank


def stage_apply(stage: ResampleStage, x: np.ndarray,
                history: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Apply one resampling stage to a block.

    Args:
        x: input block, shape (N,), complex64; N * L must be divisible by M.
        history: (H,) complex64 carried from the previous block (zeros for the
            first block).

    Returns:
        (y, new_history): y has shape (N*L//M,); new_history is the last H
        input samples of this block, to prepend to the next.
    """
    L, M = stage.up, stage.down
    H = stage_history_len(stage)
    n = len(x)
    if (n * L) % M != 0:
        raise ValueError(f"block length {n} incompatible with L={L} M={M}")
    n_out = n * L // M

    xx = np.concatenate([history, x])
    bank = polyphase_bank(stage)            # (L, P)
    P = bank.shape[1]

    # Output m taps phase p = (m*M) % L and input base n0 = (m*M - p)//L;
    # y[m] = sum_j bank[p, j] * xx[H + n0 - j].
    m = np.arange(n_out)
    p = (m * M) % L
    n0 = (m * M - p) // L
    # Window rows: xx[H + n0 - P + 1 : H + n0 + 1], then reversed dot.
    win = np.lib.stride_tricks.sliding_window_view(xx, P)  # (len-P+1, P)
    rows = win[H + n0 - P + 1]               # (n_out, P), ascending index
    taps = bank[p][:, ::-1]                  # reversed so taps[j] hits x[n0-j]
    y = np.einsum("np,np->n", rows, taps).astype(xx.dtype)

    new_hist = xx[len(xx) - H:] if H > 0 else xx[:0]
    return y, new_hist


@dataclass
class PlanState:
    """Carried filter histories for every stage of a plan."""
    histories: list = field(default_factory=list)

    @staticmethod
    def init(plan: ResamplePlan, dtype=np.complex64) -> "PlanState":
        return PlanState([
            np.zeros(stage_history_len(st), dtype=dtype) for st in plan.stages
        ])


def plan_apply(plan: ResamplePlan, x: np.ndarray,
               state: PlanState) -> tuple[np.ndarray, PlanState]:
    """Run a block through every stage of a resampling plan, streaming."""
    y = x
    new_hists = []
    for st, hist in zip(plan.stages, state.histories):
        y, h2 = stage_apply(st, y, hist)
        new_hists.append(h2)
    return y, PlanState(new_hists)


def fir_stream(taps: np.ndarray, x: np.ndarray,
               history: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Streaming causal FIR (L=M=1 special case), same halo semantics."""
    st = ResampleStage(up=1, down=1,
                       taps=tuple(np.asarray(taps, np.float32).tolist()))
    return stage_apply(st, x, history)


def fir_history_len(taps: np.ndarray) -> int:
    return len(taps) - 1
