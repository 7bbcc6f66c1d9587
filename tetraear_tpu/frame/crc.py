"""CRC-16-CCITT (poly 0x1021, init 0xFFFF) over bit vectors.

Matches the reference's bitwise implementation
(tetraear/core/protocol.py:331-347) and additionally provides a GF(2)
matrix formulation: for a fixed message length L,

    crc(bits) = (M_L @ bits) xor c0_L   over GF(2)

which turns batched CRC checking into an int8 matmul — the form the device
path uses to CRC-check thousands of bursts per step.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

_POLY = 0x1021
_INIT = 0xFFFF


def crc16_bits(bits) -> np.ndarray:
    """Bitwise CRC over a single bit vector; returns 16 bits, MSB first."""
    crc = _INIT
    for b in np.asarray(bits, dtype=np.uint8):
        crc ^= int(b) << 15
        if crc & 0x8000:
            crc = ((crc << 1) ^ _POLY) & 0xFFFF
        else:
            crc = (crc << 1) & 0xFFFF
    return np.array([(crc >> i) & 1 for i in range(15, -1, -1)],
                    dtype=np.uint8)


@lru_cache(maxsize=64)
def crc16_matrix(length: int) -> tuple:
    """(M, c0): crc(bits) = (bits @ M.T ^ c0) mod 2 for messages of `length`.

    M is (16, length) uint8; c0 is the CRC of the all-zeros message (the
    affine part contributed by the 0xFFFF preset).
    """
    c0 = crc16_bits(np.zeros(length, dtype=np.uint8))
    m = np.zeros((16, length), dtype=np.uint8)
    for i in range(length):
        e = np.zeros(length, dtype=np.uint8)
        e[i] = 1
        m[:, i] = crc16_bits(e) ^ c0
    return (m, c0)


def crc16_batch(bits: np.ndarray) -> np.ndarray:
    """CRC of a (N, L) batch of bit vectors -> (N, 16) bits."""
    bits = np.asarray(bits, dtype=np.uint8)
    if bits.ndim == 1:
        bits = bits[None, :]
    m, c0 = crc16_matrix(bits.shape[1])
    out = (bits.astype(np.int32) @ m.T.astype(np.int32)) & 1
    return (out.astype(np.uint8) ^ c0[None, :])


def soft_crc_check(data_bits: np.ndarray, max_errors: int = 2) -> bool:
    """The reference's lenient CRC gate (tetraear/core/protocol.py:292-329).

    The payload is everything but the last 16 bits; accept if the computed
    CRC differs from the received one by <= max_errors bits, also trying the
    bit-reversed payload; reject degenerate all-0/all-1 inputs.
    """
    bits = np.asarray(data_bits, dtype=np.uint8)
    if len(bits) < 16:
        return False
    ones = int(bits.sum())
    if ones == 0 or ones == len(bits):
        return False
    payload, received = bits[:-16], bits[-16:]
    calc = crc16_batch(payload)[0]
    if int(np.sum(calc != received)) <= max_errors:
        return True
    calc_rev = crc16_batch(payload[::-1])[0]
    return int(np.sum(calc_rev != received)) <= max_errors


def append_crc(payload_bits: np.ndarray) -> np.ndarray:
    """payload -> payload || crc16(payload); used by the signal generator so
    golden frames pass the burst CRC gate."""
    payload_bits = np.asarray(payload_bits, dtype=np.uint8)
    return np.concatenate([payload_bits, crc16_batch(payload_bits)[0]])
