"""Batched training-sequence sync correlation + CRC on device (JAX).

The reference scans for the 22-bit TS1/TS2 sync words with a per-position
Python loop (tetraear/core/decoder.py:231-259).  Here the same correlation
is one strided conv over (C, N) bit planes — thousands of carriers at once —
and burst CRC checking is a GF(2) matrix multiply (int32 matmul mod 2).

Host-side peak selection (threshold cascade, skip-ahead dedup) stays in
tetraear_tpu.frame.decoder: it is O(hits), data-dependent, and tiny.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tetraear_tpu.frame import burst as burst_mod
from tetraear_tpu.frame import crc as crc_mod

SYNC_LEN = 22

_PATTERNS = np.stack([burst_mod.SYNC_CONTINUOUS_DOWNLINK,
                      burst_mod.SYNC_DISCONTINUOUS_DOWNLINK]).astype(
                          np.float32)


def sync_correlate(bits: jnp.ndarray) -> jnp.ndarray:
    """(C, N) bits in {0,1} -> (C, N-21) best TS1/TS2 agreement ratio.

    agreement = (corr_pm + 22) / 44 where corr_pm is the +-1 correlation:
    one conv with 2 output channels, then a max.
    """
    x = bits.astype(jnp.float32) * 2.0 - 1.0          # {0,1} -> {-1,+1}
    pat = jnp.asarray(_PATTERNS) * 2.0 - 1.0          # (2, 22)
    out = jax.lax.conv_general_dilated(
        x[:, None, :], pat[:, None, :], window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"))       # (C, 2, N-21)
    best = jnp.max(out, axis=1)
    return (best + SYNC_LEN) / (2.0 * SYNC_LEN)


def crc16_batch_device(bits: jnp.ndarray) -> jnp.ndarray:
    """(B, L) bit rows -> (B, 16) CRC-16-CCITT bits, as an int32 matmul.

    Same GF(2)-affine formulation as tetraear_tpu.frame.crc.crc16_matrix.
    """
    m, c0 = crc_mod.crc16_matrix(int(bits.shape[1]))
    prod = jnp.dot(bits.astype(jnp.int32), jnp.asarray(m.T, jnp.int32),
                   preferred_element_type=jnp.int32)
    return (prod & 1).astype(jnp.uint8) ^ jnp.asarray(c0, jnp.uint8)[None, :]


def crc_error_counts(data_bits: jnp.ndarray) -> jnp.ndarray:
    """(B, 216) burst data views -> (B,) min CRC bit-error count.

    Device formulation of the soft CRC gate
    (tetraear/core/protocol.py:292-329): compares the computed CRC of the
    payload (and of the reversed payload) against the received tail and
    returns the smaller Hamming distance.  Callers apply the <=2 budget.
    """
    payload = data_bits[:, :-16]
    received = data_bits[:, -16:].astype(jnp.uint8)
    fwd = crc16_batch_device(payload)
    rev = crc16_batch_device(payload[:, ::-1])
    e_fwd = jnp.sum(fwd ^ received, axis=1)
    e_rev = jnp.sum(rev ^ received, axis=1)
    errs = jnp.minimum(e_fwd, e_rev).astype(jnp.int32)
    # degenerate all-0/all-1 rows never pass
    ones = jnp.sum(data_bits, axis=1)
    degenerate = (ones == 0) | (ones == data_bits.shape[1])
    return jnp.where(degenerate, jnp.int32(99), errs)
