"""Batched ETSI speech channel decoding on device (JAX).

The C++ codec decodes one 432-soft-bit block at a time on the host
(voice/csrc/channel.cpp).  At fleet scale — every traffic slot of
thousands of carriers — voice channel decoding must batch onto the
accelerator (SURVEY.md §2.2).  This module decodes (B, 432) blocks in one jitted
program:

  * deinterleave + class-0 split: static index maps, no gathers;
  * 16-state Viterbi over the 184-step RCPC trellis as a ``lax.scan``:
    path metrics (B, 16) int32, the two predecessors of each state are
    static slices, branch metrics come from a precomputed (STEPS, 3)
    puncture schedule and (16, 2, 3) expected-sign table;
  * traceback as a reverse ``lax.scan`` over the stored per-state
    predecessor-parity decisions;
  * CRC-8 recheck as a GF(2) matmul -> per-block BFI.

BIT-EXACT vs the C++ decoder for any input (same int32 metrics, same
first-max tie-break: on equal metrics the even predecessor wins), which
is itself verified against the ETSI reference binaries
(tests/codec/test_etsi_oracle.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tetraear_tpu.voice import etsi_tables as T

_STATES = 16


def _expected_signs() -> np.ndarray:
    """(16, 2, 3) int32: for post-state ns and predecessor parity p, the
    expected +-1 symbol of V1/V2/V3 (window w = (ns<<1)|p)."""
    e = np.zeros((_STATES, 2, 3), np.int32)
    for ns in range(_STATES):
        for p in range(2):
            w = (ns << 1) | p
            for j, g in enumerate((T.G1, T.G2, T.G3)):
                e[ns, p, j] = -1 if T.parity(w & g) else 1
    return e


def _code_step_index() -> tuple:
    """(STEPS, 3) index into the 330-bit code stream (post-class-0) for
    each step's V1/V2/V3, and the (STEPS, 3) presence mask."""
    pres = T.puncture_schedule()
    idx = np.zeros((T.STEPS, 3), np.int32)
    j = 0
    for i in range(T.STEPS):
        for s in range(3):
            if pres[i, s]:
                idx[i, s] = j
                j += 1
    return idx, pres


_DEINT = T.interleave_index()          # transmitted[i] = encoded[DEINT[i]]
_REINT = np.argsort(_DEINT)            # encoded[k] = transmitted[REINT[k]]
_SIGNS = _expected_signs()
_STEP_IDX, _STEP_PRES = _code_step_index()
_CRC_M = T.crc_matrix()

# predecessors of post-state ns: s0 = 2*(ns & 7), s1 = s0 + 1
_PRED0 = np.array([2 * (ns & 7) for ns in range(_STATES)], np.int32)


def channel_decode_batch_traced(soft: jnp.ndarray) -> tuple:
    """(B, 432) int soft bits -> (ordered (B, 286) uint8, bfi (B,) bool).

    Traceable; ``ordered`` is the spec's ordered array (class0 | class1 |
    class2 | crc | tail-region zeros).
    """
    soft = soft.astype(jnp.int32)
    de = soft[:, jnp.asarray(_REINT)]          # undo block interleave
    class0 = (de[:, :T.N0] < 0).astype(jnp.uint8)
    code = de[:, T.N0:]                        # (B, 330)

    # per-step received symbols, zeroed where punctured: (B, STEPS, 3)
    r = code[:, jnp.asarray(_STEP_IDX)] * jnp.asarray(_STEP_PRES)[None]

    signs = jnp.asarray(_SIGNS)                # (16, 2, 3)
    pred0 = jnp.asarray(_PRED0)                # (16,)
    neg = jnp.int32(-(1 << 28))

    def vit_step(metrics, r_i):
        # metrics (B, 16); r_i (B, STEPS-slice) -> (B, 3)
        m_pred = metrics[:, pred0]             # (B, 16) even predecessor
        m_pred1 = metrics[:, pred0 + 1]        # odd predecessor
        # branch metric for parity p: sum_j r_j * sign[ns, p, j]
        bm = jnp.einsum("bj,npj->bnp", r_i, signs)   # (B, 16, 2)
        c0 = m_pred + bm[:, :, 0]
        c1 = m_pred1 + bm[:, :, 1]
        take1 = c1 > c0                        # strict: ties keep even
        new = jnp.where(take1, c1, c0)
        return new, take1.astype(jnp.uint8)

    init = jnp.full((soft.shape[0], _STATES), neg, jnp.int32)
    init = init.at[:, 0].set(0)
    _, decisions = jax.lax.scan(
        lambda m, r_i: vit_step(m, r_i), init,
        jnp.transpose(r, (1, 0, 2)), unroll=4)  # (STEPS, B, 16)

    st_iota = jnp.arange(_STATES, dtype=jnp.int32)[None, :]

    def tb_step(state, dec_i):
        # state (B,) post-step state; dec_i (B, 16) parity decisions.
        # One-hot masked reduce instead of a per-step take_along_axis
        # gather inside the sample scan (same fix as jspeech._pred_lt)
        bit = (state >> 3).astype(jnp.uint8)
        sel = st_iota == state[:, None]
        par = jnp.sum(jnp.where(sel, dec_i.astype(jnp.int32), 0),
                      axis=1)
        prev = 2 * (state & 7) + par
        return prev, bit

    state0 = jnp.zeros((soft.shape[0],), jnp.int32)   # zero tail
    _, bits_rev = jax.lax.scan(tb_step, state0, decisions[::-1],
                               unroll=8)
    conv_bits = bits_rev[::-1].T               # (B, STEPS)

    ordered = jnp.concatenate(
        [class0, conv_bits.astype(jnp.uint8)], axis=1)   # (B, 286)

    # CRC recheck over [class2 | crc]
    c2crc = ordered[:, 214:282].astype(jnp.int32)
    syndrome = (c2crc @ jnp.asarray(_CRC_M.T, jnp.int32)) & 1
    bfi = jnp.any(syndrome != 0, axis=1)
    return ordered, bfi


_decode_jit = jax.jit(channel_decode_batch_traced)


def _unbuild(ordered: np.ndarray) -> np.ndarray:
    """(B, 286) ordered -> (B, 2, 137) frame bits (A, B)."""
    b = ordered.shape[0]
    frames = np.zeros((b, 2, 137), np.uint8)
    pos = np.concatenate([T.TAB0, T.TAB1, T.TAB2]) - 1
    # ordered pairs: [2k] frame A, [2k+1] frame B, k over TAB0|TAB1|TAB2
    frames[:, 0, pos] = ordered[:, 0:274:2]
    frames[:, 1, pos] = ordered[:, 1:274:2]
    return frames


def channel_decode_batch(soft: np.ndarray) -> dict:
    """Host entry: (B, 432) soft blocks -> frames + BFI.

    Returns {"frames": (B, 2, 137) uint8, "bfi": (B,) bool}.
    """
    soft = np.atleast_2d(np.asarray(soft, np.int32))
    ordered, bfi = _decode_jit(jnp.asarray(soft))
    return {"frames": _unbuild(np.asarray(ordered)),
            "bfi": np.asarray(bfi)}
