"""Device frame scan: sync correlation + dense burst CRC in one conv.

The reference finds frames with a per-position Python loop and then CRC-
checks each candidate with a per-bit Python loop on the host
(tetraear/core/decoder.py:231-259, core/protocol.py:292-347).  Round 1
moved the demodulator onto the device but left this frame layer as a
per-carrier host pass — the dominant cost at fleet scale.

Here the whole frame layer's *dense* half runs on device, for every
carrier at once:

  * sync correlation: one 2-channel length-22 conv over the (C, N) bit
    planes (tetraear_tpu.dsp.sync.sync_correlate);
  * burst CRC at EVERY candidate frame start: the CRC-16-CCITT of a
    burst's data view is affine over GF(2) in the frame's bits, so the
    error count at all N positions is ONE 33-output-channel conv of
    kernel length 230 (16 forward-CRC taps, 16 reversed-payload taps,
    1 degenerate-row counter) followed by elementwise mod-2/XOR —
    matmul-shaped work, no gathers.

Host-side selection (threshold cascade, skip-ahead dedup, MAC/SDS
parsing) stays O(hits) — see tetraear_tpu.frame.batch.

Alignment contract
------------------
For an input bit matrix ``bits`` of shape (C, N):

  * ``corr[c, p]``    — best TS1/TS2 agreement of bits[c, p:p+22]
                        (shape (C, N-21), same as decoder.sync_correlate);
  * ``crc_err[c, q]`` — min(forward, reversed) CRC bit-error count of the
                        normal-burst data view of the frame *starting* at
                        bit q, i.e. data = bits[q:q+108] ++ bits[q+122:q+230]
                        (burst.extract_data_bits), shape (C, N-229);
                        degenerate all-0/all-1 data views read 99.

A sync hit at position p corresponds to frame start q = p - 216
(decoder.TS_OFFSET_BITS), so ``crc_err[:, p - 216]`` is that frame's
burst-CRC error count and ``crc_err <= 2`` reproduces
frame.crc.soft_crc_check exactly (tests/unit/test_framescan.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tetraear_tpu.frame import burst as burst_mod
from tetraear_tpu.frame import crc as crc_mod

SYNC_LEN = 22
TS_OFFSET_BITS = 216          # sync position - frame start (decoder.py)
FRAME_BITS = 510
DATA_BITS = 216               # burst data view length
CRC_SPAN = 230                # last frame bit the CRC view touches

_PATTERNS = np.stack([burst_mod.SYNC_CONTINUOUS_DOWNLINK,
                      burst_mod.SYNC_DISCONTINUOUS_DOWNLINK]).astype(
                          np.float32)

# burst data view: frame-relative bit offsets (burst.extract_data_bits)
_DATA_OFFSETS = np.concatenate([np.arange(0, 108), np.arange(122, 230)])


def _crc_conv_kernel() -> tuple:
    """(kernel (33, 1, 230) float32, c0 (16,) uint8).

    SYNDROME formulation: channels 0..15 carry the forward-CRC parity
    taps PLUS a tap on the received CRC bit itself (data-view offset
    200+j -> frame offset 214+j), so (conv mod 2) xor c0 IS the
    syndrome bit — no separate received-bit extraction or XOR pass.
    Channels 16..31: same for the reversed payload.  Channel 32: ones
    count over the 216-bit data view (degenerate-row rejection in
    crc.soft_crc_check).
    """
    m, c0 = crc_mod.crc16_matrix(DATA_BITS - 16)       # (16, 200)
    payload_off = _DATA_OFFSETS[:DATA_BITS - 16]       # frame offsets
    recv_off = _DATA_OFFSETS[DATA_BITS - 16:]          # frame 214..229
    k = np.zeros((33, 1, CRC_SPAN), np.float32)
    for i, off in enumerate(payload_off):
        k[0:16, 0, off] = m[:, i]
        # reversed payload: column i of M multiplies payload[199 - i]
        k[16:32, 0, payload_off[len(payload_off) - 1 - i]] = m[:, i]
    for j, off in enumerate(recv_off):
        k[j, 0, off] += 1.0
        k[16 + j, 0, off] += 1.0
    for off in _DATA_OFFSETS:
        k[32, 0, off] += 1.0
    return k, c0


_CRC_KERNEL, _CRC_C0 = _crc_conv_kernel()


def sync_corr(bits: jnp.ndarray) -> jnp.ndarray:
    """(C, N) bits {0,1} -> (C, N-21) best TS1/TS2 agreement ratio.

    Bit-exact (at float32) vs decoder.sync_correlate: integer agreement
    counts divide by 22 the same way on both paths, and the decision
    thresholds sit >= 0.009 away from the 1/22 quantization grid.
    """
    x = bits.astype(jnp.float32) * 2.0 - 1.0
    pat = jnp.asarray(_PATTERNS) * 2.0 - 1.0
    out = jax.lax.conv_general_dilated(
        x[:, None, :], pat[:, None, :], window_strides=(1,),
        padding="VALID", dimension_numbers=("NCH", "OIH", "NCH"))
    best = jnp.max(out, axis=1)
    return (best + SYNC_LEN) / (2.0 * SYNC_LEN)


def crc_err_all(bits: jnp.ndarray, rev: bool = True) -> jnp.ndarray:
    """(C, N) bits -> (C, N-229) min CRC error count per frame start.

    Reproduces crc.soft_crc_check's decision inputs (forward + reversed
    payload, degenerate rejection) densely at every position.
    ``rev=False`` checks the forward orientation only — the reference
    semantics of the production even/fused scans, whose reversed check
    is completed on host per sync hit (frame.burst.parse_burst).
    """
    x = bits.astype(jnp.float32)
    out = jax.lax.conv_general_dilated(
        x[:, None, :], jnp.asarray(_CRC_KERNEL), window_strides=(1,),
        padding="VALID", dimension_numbers=("NCH", "OIH", "NCH"))
    out_i = jnp.round(out).astype(jnp.int32)           # exact small ints
    # syndrome bits: (parity of taps incl. the received bit) xor c0
    c0_2 = jnp.concatenate([jnp.asarray(_CRC_C0, jnp.int32)] * 2)
    syn = (out_i[:, 0:32] & 1) ^ c0_2[None, :, None]
    e_fwd = jnp.sum(syn[:, 0:16], axis=1)
    ones = out_i[:, 32]                                # (C, P)
    if rev:
        e_rev = jnp.sum(syn[:, 16:32], axis=1)
        err = jnp.minimum(e_fwd, e_rev)
    else:
        err = e_fwd
    degenerate = (ones == 0) | (ones == DATA_BITS)
    return jnp.where(degenerate, jnp.int32(99), err)


def frame_scan(bits: jnp.ndarray, rev: bool = True) -> dict:
    """Full dense frame scan of a (C, N) bit matrix (traceable).

    Returns {"corr": (C, N-21) float32, "crc_err": (C, N-229) int32}.
    """
    return {"corr": sync_corr(bits),
            "crc_err": crc_err_all(bits, rev=rev)}


# ---------------------------------------------------------------------------
# Packed dense scan: one conv for sync + CRC.
#
# The plain formulation is two narrow convs (2 sync channels, 33 CRC
# channels) over every bit position.  The packed layout strides the conv
# by 8 and gives each stride phase its own copy of all 35 base rows (2
# sync rows recast to the {0,1} plane + 33 CRC rows), i.e. one conv with
# 280 output channels and kernel length 237 — identical arithmetic, one
# wide contraction instead of two narrow ones.  Inputs/kernels are cast
# to bfloat16: every value is a sum of at most 237 {0,+-1} products
# (accumulated in f32), so the integer results are exact.
# ---------------------------------------------------------------------------

PACK_STRIDE = 8
_KPACK = CRC_SPAN + PACK_STRIDE - 1                  # 237


def _packed_kernel(step: int = 1, rev: bool = True) -> tuple:
    """((rpp * 8/step, 1, 237) bf16 kernel, sync zero-counts (2,) f32).

    Channel layout: ch = i * rpp + r for stride phase d = step * i in
    [0,8) and base row r.  With ``rev`` (reference semantics) rpp = 35:
    rows 0..32 the CRC rows of _CRC_KERNEL (16 forward + 16 reversed +
    ones), rows 33..34 the two sync patterns recast for a {0,1} input:
    agreement(b, pat) = conv(b, 2*pat - 1) + (# zeros in pat).  With
    ``rev=False`` (the production fleet paths) rpp = 19: the 16
    reversed-payload rows are dropped — they would double the dense
    matmul cost fleet-wide for a case the host completes in O(sync
    hits) instead (frame.burst.parse_burst re-checks both orientations
    whenever the device hint is not a definite pass).
    ``step=2`` keeps only the even stride phases (symbol-aligned
    positions; the source of frame_scan_packed_even's tables).
    """
    rows = ([*range(0, 33)] if rev
            else [*range(0, 16), 32])            # fwd + ones
    rpp = len(rows) + 2
    base = np.zeros((rpp, _KPACK), np.float32)
    base[0:len(rows), 0:CRC_SPAN] = _CRC_KERNEL[rows, 0, :]
    base[len(rows):rpp, 0:SYNC_LEN] = 2.0 * _PATTERNS - 1.0
    phases = range(0, PACK_STRIDE, step)
    k = np.zeros((rpp * len(phases), 1, _KPACK), np.float32)
    for i, d in enumerate(phases):
        k[i * rpp:(i + 1) * rpp, 0, d:] = base[:, :_KPACK - d]
    zeros_in_pat = (SYNC_LEN - _PATTERNS.sum(axis=1)).astype(np.float32)
    return k.astype(jnp.bfloat16), zeros_in_pat


_PACKED_KERNEL, _SYNC_ZEROS = _packed_kernel()
_PACKED_KERNEL_EVEN_FWD, _ = _packed_kernel(step=2, rev=False)


def _even_scan_tables() -> tuple:
    """(k3 (384, 1600), rsyn (1600, 128), crow (1, 128)) float32 tables
    of frame_scan_packed_even.

    k3 evaluates the whole even-position forward scan of a 3-row
    (384-bit) sliding window in ONE matmul: columns are [ones 64 in a
    128 block | TS1 | TS2 | conv 16*76], where conv column 384 + t*76 +
    ch carries the even-phase forward-only packed taps of channel
    ch = i*19 + r shifted by 8*t (window shift t in [0,16) inside the
    128-bit row; the reversed-payload check is completed on host in
    O(sync hits) — _packed_kernel docstring).  rsyn is the SIGNED
    syndrome selector with the expected-parity comparison folded in:
    with par in {0,1}, |par - c0| = par*(1 - 2*c0) + c0, so
    e = par @ ((1-2*c0)*rsyn0) + (c0 @ rsyn0) — the second term is the
    constant row crow, and the (rows, 1600) |par - c0| plane is never
    built.  rsyn's reversed half duplicates the forward columns so
    min(e_fwd, e_rev) reduces to e_fwd.  Values stay exact small
    integers."""
    kk = _PACKED_KERNEL_EVEN_FWD[:, 0, :].astype(np.float32)  # (76, 237)
    n_cols = 384 + 16 * 76
    k3 = np.zeros((384, n_cols), np.float32)
    rsyn = np.zeros((n_cols, 128), np.float32)
    c0v = np.zeros((1, n_cols), np.float32)
    c0 = _CRC_C0.astype(np.float32)
    for t in range(16):
        k3[8 * t:8 * t + _KPACK, 384 + t * 76:384 + (t + 1) * 76] = kk.T
        for i in range(4):
            q = t * 4 + i
            k3[8 * t:8 * t + _KPACK, q] = kk[i * 19 + 16]         # ones
            k3[8 * t:8 * t + _KPACK, 128 + q] = kk[i * 19 + 17]   # TS1
            k3[8 * t:8 * t + _KPACK, 256 + q] = kk[i * 19 + 18]   # TS2
            rows = 384 + t * 76 + i * 19
            c0v[0, rows:rows + 16] = c0
            rsyn[rows:rows + 16, q] = 1.0
            rsyn[rows:rows + 16, 64 + q] = 1.0
    crow = c0v @ rsyn
    return k3, (1.0 - 2.0 * c0v.T) * rsyn, crow


_EVEN_K3, _EVEN_RSYN, _EVEN_CROW = _even_scan_tables()


def frame_scan_packed(bits: jnp.ndarray) -> dict:
    """Dense frame scan via the packed 280-channel conv (traceable).

    Same contract and bit-identical values as ``frame_scan``:
    {"corr": (C, N-21) float32, "crc_err": (C, N-229) int32}.

    The syndrome/corr reductions run in the conv's NATIVE packed layout
    (C, 8, 35, J): elementwise ops + a 16-element channel reduction fuse
    into the single pass that reads the bf16 conv output, and only the
    small (C, 8, J) results are transposed to linear-position order,
    so the full 280-channel tensor is never relaid out.  Exactness: every conv output is an integer <= 237, exact in bf16
    (8 mantissa bits cover ints to 256) and in f32; parity is
    v - 2*floor(v/2) and XOR of {0,1} values is |a - b|.
    """
    corr, errl = _conv_and_reduce(bits, _PACKED_KERNEL, PACK_STRIDE)
    n = bits.shape[1]
    return {"corr": corr[:, :n - SYNC_LEN + 1],
            "crc_err": errl[:, :n - CRC_SPAN + 1].astype(jnp.int32)}


def frame_scan_packed_even(bits: jnp.ndarray) -> dict:
    """Dense frame scan restricted to EVEN bit positions (traceable).

    The demod emits two bits per pi/4-DQPSK symbol and every assembly
    step (tail carry, first-block drop, realignment) moves in whole
    symbols, so a real frame start — hence a real sync hit — can only
    sit at an even bit index.  Scanning only those positions halves the
    conv channels and the reduction traffic.  Deliberate deviation from
    the reference, which slides its host sync search one BIT at a time
    (tetraear/core/decoder.py:231-259): on its own symbol-aligned bit
    stream the extra odd positions can only produce false candidates
    (noise correlations that a symbol-aligned transmission cannot
    generate), so dropping them is a bug fix, not a capability loss.

    Formulation: two bf16 matmuls over 128-bit rows.  The bits are
    zero-padded and reshaped to (C, R, 128); each output row m sees the
    3-row window [row m | row m+1 | row m+2] (M = R - 2 rows), and
    ONE (C*M, 384) x (384, 1600) product evaluates the packed conv for
    all 16 within-row shifts plus the ones/sync selections
    (_even_scan_tables); the CRC error count is a second product
    against the signed syndrome selector.  Element [m, 4t + i] is even
    bit position 64 m + 4 t + i, so the (M, 64) planes flatten to pe
    order.  All values are integer counts <= 237, exact in bf16 with
    f32 accumulation.  On the H100 this measured 3.9 ms against 15.2 ms
    for the equivalent strided conv at (10240, 5272) bits (PERF.md).

    Returns {"corr": (C, (N-22)//2 + 1) float32,
             "crc_err": (C, (N-230)//2 + 1) int32} where element pe
    describes bit position p = 2 * pe; values equal
    frame_scan(bits, rev=False)[...][:, ::2] exactly.
    """
    c, n = bits.shape
    pad = 256 + (-(n + 256) % 128)
    x = jnp.pad(bits, ((0, 0), (0, pad))).reshape(c, -1, 128).astype(
        jnp.bfloat16)
    m = x.shape[1] - 2
    v3 = jnp.concatenate([x[:, 0:m], x[:, 1:m + 1], x[:, 2:m + 2]], axis=2)
    out = jnp.dot(v3, jnp.asarray(_EVEN_K3, jnp.bfloat16),
                  preferred_element_type=jnp.float32)     # (C, M, 1600)
    par = out - 2.0 * jnp.floor(out * 0.5)                # v mod 2
    e = jnp.dot(par.astype(jnp.bfloat16),
                jnp.asarray(_EVEN_RSYN, jnp.bfloat16),
                preferred_element_type=jnp.float32) + jnp.asarray(_EVEN_CROW)
    best = jnp.maximum(out[..., 128:192] + _SYNC_ZEROS[0],
                       out[..., 256:320] + _SYNC_ZEROS[1])
    corr = best / jnp.float32(SYNC_LEN)
    ones = out[..., 0:64]
    err = jnp.minimum(e[..., 0:64], e[..., 64:128])
    err = jnp.where((ones == 0.0) | (ones == float(DATA_BITS)),
                    jnp.float32(99), err)
    return {"corr": corr.reshape(c, -1)[:, :(n - SYNC_LEN) // 2 + 1],
            "crc_err": jnp.round(err).astype(jnp.int32).reshape(c, -1)[
                :, :(n - CRC_SPAN) // 2 + 1]}


def _conv_and_reduce(bits: jnp.ndarray, kernel: np.ndarray,
                     nph: int, rpp: int = 35) -> tuple:
    """Shared packed-conv + native-layout reduction.

    kernel: (nph * rpp, 1, 237) stride-phase-packed taps (phase of
    channel i*rpp+r is d = i * (8 // nph); rpp = 35 with the reversed
    CRC rows, 19 forward-only).  Returns (corr, err) as
    (C, J * nph) arrays linear in phase-index space: element
    jj * nph + i is bit position 8 * jj + i * (8 // nph).
    """
    c, n = bits.shape
    # 256 zero-pad bits: strided-valid coverage past every real position
    # (J*8 = ((n + 19) // 8 + 1) * 8 >= n + 20 > n - 21); padded-window
    # outputs are sliced off by the callers
    x = jnp.pad(bits.astype(jnp.bfloat16), ((0, 0), (0, 256)))
    out = jax.lax.conv_general_dilated(
        x[:, None, :], jnp.asarray(kernel),
        window_strides=(PACK_STRIDE,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"))     # (C, nph*rpp, J)
    j = out.shape[2]
    # keep the big tensor bf16 end to end: slice (free) THEN cast per
    # branch, so each consumer fuses its elementwise work + channel
    # reduction into its read of the conv output instead of paying a
    # whole-tensor astype(f32) pass.  All values are integers <= 237,
    # exact in bf16, so parity/min/compare stay exact.
    g = out.reshape(c, nph, rpp, j)
    n_crc = rpp - 3                                       # 32 or 16
    sync = g[:, :, rpp - 2:rpp, :]                        # (C, nph, 2, J)
    corr_p = jnp.max(
        sync + jnp.asarray(_SYNC_ZEROS, jnp.bfloat16)[None, None, :, None],
        axis=2)                                           # (C, nph, J)
    crc = g[:, :, 0:n_crc, :]
    par = crc - 2.0 * jnp.floor(crc * 0.5)                # v mod 2
    c0f = jnp.asarray(
        np.concatenate([_CRC_C0] * (n_crc // 16)), jnp.bfloat16)
    syn = jnp.abs(par - c0f[None, None, :, None])         # xor on {0,1}
    e_fwd = jnp.sum(syn[:, :, 0:16], axis=2)              # (C, nph, J)
    ones = g[:, :, rpp - 3, :]
    if n_crc == 32:
        e_rev = jnp.sum(syn[:, :, 16:32], axis=2)
        err = jnp.minimum(e_fwd, e_rev)
    else:
        err = e_fwd
    degenerate = (ones == 0.0) | (ones == float(DATA_BITS))
    err = jnp.where(degenerate, jnp.bfloat16(99), err)
    # linearize the small per-phase planes: (C, nph, J) -> (C, J*nph)
    corr = jnp.transpose(corr_p, (0, 2, 1)).reshape(c, j * nph)
    errl = jnp.transpose(err, (0, 2, 1)).reshape(c, j * nph)
    corr = corr.astype(jnp.float32) / jnp.float32(SYNC_LEN)
    return corr, errl


# ---------------------------------------------------------------------------
# Sparse hit extraction (SURVEY §7 "ship compact per-hit indices+bits").
#
# The dense verdict planes are ~(C, Pe) float32 + int32 — ~268 MB per
# block at C=10240 to fetch, while the host selection only ever
# READS O(hits) entries (frame.batch.collect_rows probes positions above
# its cascade threshold, plus each hit's frame-start CRC verdict).  Here
# the compaction runs on device: each possible hit packs into ONE int32
#
#     key = (Pe - pe) << 11  |  min(crc_at_sync, 63) << 5  |  n_agree
#
# (rank field: ascending position = descending key, so lax.top_k returns
# the first K hits in position order; n_agree = corr * 22, an exact
# small integer; crc_at_sync = the frame-start CRC error count aligned
# to the sync position, i.e. dense column pe - TS_OFFSET_BITS//2).  The
# host decodes the keys to flat per-hit arrays (hits_from_keys) and
# selects in O(hits) (frame.batch.collect_hits); unpack_hits_to_planes,
# the virtual-plane reconstruction, is kept as the equivalence oracle
# for the tests.
#
# Superset-by-construction: the device threshold backs off the host
# cascade (closed form in frame.batch.collect_rows: 0.90 if rowmax >=
# 0.90 else max(0.75, rowmax - 0.02), float64) by ~2e-3 — far below the
# 1/22 correlation grid step (~0.045), so every host-selectable position
# is fetched and only exact row-max ties / >= 20-of-22 positions ride
# along.  Rows with more than K hits (counts > K) are flagged and
# recomputed exactly on the host from their bits (host_scan_rows_even).
# ---------------------------------------------------------------------------

SPARSE_K = 32                 # default per-carrier hit budget per block
_RANK_SHIFT = 11
_CRC_SHIFT = 5
_CRC_CLAMP = 63


def plane_dims(n_bits: int) -> tuple:
    """(pe_n, pc_n) even-position scan plane widths for an assembled
    bit row of ``n_bits`` — the single source of the width formulas the
    sparse consumers (DecodeRunner, Pipeline) validate against."""
    return ((n_bits - SYNC_LEN) // 2 + 1, (n_bits - CRC_SPAN) // 2 + 1)


def sparse_hits(corr: jnp.ndarray, crc_err: jnp.ndarray,
                kh: int = SPARSE_K) -> tuple:
    """Compact a dense even-position scan into per-carrier hit keys.

    corr (C, Pe) float32 and crc_err (C, Pc) as returned by
    frame_scan_packed_even (element pe <-> bit position 2*pe).  Returns
    (keys (C, kh) int32 — descending, 0 = no hit — and counts (C,)
    int32, the TOTAL above-threshold positions for overflow detection).
    Traceable; meant to run inside the per-block jit so only ~C*(kh+1)
    int32s cross to the host instead of the dense planes.
    """
    c, pe_n = corr.shape
    if pe_n >= (1 << (31 - _RANK_SHIFT)):
        raise ValueError(f"scan width {pe_n} overflows the rank field")
    n_agree = jnp.round(corr * SYNC_LEN).astype(jnp.int32)
    crcc = jnp.clip(crc_err.astype(jnp.int32), 0, _CRC_CLAMP)
    off = TS_OFFSET_BITS // 2
    pad_r = max(0, pe_n - off - crcc.shape[1])
    crc_at = jnp.pad(crcc, ((0, 0), (off, pad_r)),
                     constant_values=_CRC_CLAMP)[:, :pe_n]
    rowmax = jnp.max(corr, axis=1)
    thr = jnp.where(rowmax >= 0.8999, jnp.float32(0.8999),
                    jnp.maximum(jnp.float32(0.7499),
                                rowmax - jnp.float32(0.0221)))
    mask = corr >= thr[:, None]
    pe = jax.lax.iota(jnp.int32, pe_n)[None, :]
    key = ((pe_n - pe) << _RANK_SHIFT) | (crc_at << _CRC_SHIFT) | n_agree
    key = jnp.where(mask, key, 0)
    keys, _ = jax.lax.top_k(key, kh)
    counts = jnp.sum(mask.astype(jnp.int32), axis=1)
    return keys, counts


def unpack_hits_to_planes(keys: np.ndarray, counts: np.ndarray,
                          pe_n: int, pc_n: int, bits_rows_fn) -> tuple:
    """Host side of the sparse scan: keys -> virtual dense planes.

    Returns (corr (C, pe_n) float32, crc_err (C, pc_n) int32) whose
    values at every position frame.batch reads are DECISION-equivalent
    to the dense scan's: CRC verdicts are bitwise (clamped to 63, same
    <= 2 outcome); corr is rebuilt from the exact integer agreement
    count as f32(n)/f32(22), bitwise the device plane's value — every
    cascade comparison
    in frame.batch.collect_rows has >= 0.008 margin to the 1/22 value
    grid except exact row-max ties, which the injective n -> corr map
    preserves.  Sub-threshold filler is 0.0 / 99.  Rows whose hit count
    overflowed the device budget are recomputed exactly from their
    assembled bits: ``bits_rows_fn(row_indices) -> (R, N) uint8``.
    """
    keys = np.asarray(keys)
    counts = np.asarray(counts)
    c, kh = keys.shape
    corr = np.zeros((c, pe_n), np.float32)
    crc = np.full((c, pc_n), 99, np.int32)
    r, i = np.nonzero(keys > 0)
    kv = keys[r, i]
    pe = pe_n - (kv >> _RANK_SHIFT)
    corr[r, pe] = ((kv & ((1 << _CRC_SHIFT) - 1))
                   .astype(np.float32) / np.float32(SYNC_LEN))
    qc = pe - TS_OFFSET_BITS // 2
    ok = (qc >= 0) & (qc < pc_n)
    crc[r[ok], qc[ok]] = (kv[ok] >> _CRC_SHIFT) & _CRC_CLAMP
    over = np.flatnonzero(counts > kh)
    if len(over):
        co, ce = host_scan_rows_even(bits_rows_fn(over))
        corr[over] = co[:, :pe_n]
        crc[over] = ce[:, :pc_n]
    return corr, crc


def hits_from_keys(keys: np.ndarray, counts: np.ndarray, pe_n: int,
                   pc_n: int, bits_rows_fn) -> tuple:
    """Host side of the sparse scan, O(hits) flat form.

    Decodes the packed keys into flat per-hit arrays sorted by (row,
    position): (rows int64, pe int64, corr float32, crc int32).  corr
    is rebuilt from the exact agreement count (decision-equivalent to
    the device plane — unpack_hits_to_planes docstring); crc is the
    frame-start verdict aligned to the sync position, 63 when the
    frame-start column falls outside the crc plane.  Rows whose hit
    count overflowed the device budget are recomputed exactly from
    their bits and their entries replaced by that row's full
    host-cascade selection set (a superset of anything the downstream
    cascade can pick, so selection equality is preserved).

    Preferred over unpack_hits_to_planes at fleet scale: materializing
    and re-scanning the virtual (C, Pe) planes costs ~0.5 s/block at
    C=10240 on the host — more than the block's realtime budget —
    while this path touches only the hits.
    """
    keys = np.asarray(keys)
    counts = np.asarray(counts)
    kh = keys.shape[1]
    r, i = np.nonzero(keys > 0)
    kv = keys[r, i]
    pe = (pe_n - (kv >> _RANK_SHIFT)).astype(np.int64)
    corr = ((kv & ((1 << _CRC_SHIFT) - 1))
            .astype(np.float32) / np.float32(SYNC_LEN))
    crc = ((kv >> _CRC_SHIFT) & _CRC_CLAMP).astype(np.int32)
    r = r.astype(np.int64)
    over = np.flatnonzero(counts > kh)
    if len(over):
        keep = ~np.isin(r, over)
        r, pe, corr, crc = r[keep], pe[keep], corr[keep], crc[keep]
        co, ce = host_scan_rows_even(bits_rows_fn(over))
        off = TS_OFFSET_BITS // 2
        add = [[], [], [], []]
        for k2, ri in enumerate(over):
            row = co[k2][:pe_n].astype(np.float64)
            rm = row.max() if row.size else 0.0
            if rm < 0.75:
                continue
            thr = 0.90 if rm >= 0.90 else max(0.75, rm - 0.02)
            sel = np.flatnonzero(row >= thr)
            qc = sel - off
            inb = (qc >= 0) & (qc < pc_n)
            cv = np.full(len(sel), _CRC_CLAMP, np.int32)
            cv[inb] = np.minimum(ce[k2][qc[inb]], _CRC_CLAMP)
            add[0].append(np.full(len(sel), ri, np.int64))
            add[1].append(sel.astype(np.int64))
            add[2].append(co[k2][:pe_n][sel])
            add[3].append(cv)
        if add[0]:
            r = np.concatenate([r, *add[0]])
            pe = np.concatenate([pe, *add[1]])
            corr = np.concatenate([corr, *add[2]]).astype(np.float32)
            crc = np.concatenate([crc, *add[3]])
            order = np.lexsort((pe, r))
            r, pe, corr, crc = r[order], pe[order], corr[order], crc[order]
    return r, pe, corr, crc


def host_scan_rows_even(bits: np.ndarray) -> tuple:
    """Exact NumPy even-position scan of a few rows (overflow fallback).

    Same values as frame_scan_packed_even: corr = n_agree/22 at
    float32, crc_err =
    forward-orientation syndrome weight with degenerate rows pinned to
    99, bitwise equal.  All sums are exact small integers (f64 dot of
    {0,1} vectors) — tests/unit/test_sparse_hits.py.
    """
    bits = np.asarray(bits, np.uint8)
    rr, n = bits.shape
    pe_n = (n - SYNC_LEN) // 2 + 1
    pc_n = (n - CRC_SPAN) // 2 + 1
    swv = np.lib.stride_tricks.sliding_window_view
    x = bits.astype(np.float64) * 2.0 - 1.0
    win = swv(x, SYNC_LEN, axis=1)[:, ::2][:, :pe_n]       # (R, Pe, 22)
    pat = _PATTERNS.astype(np.float64) * 2.0 - 1.0
    n_agree = ((win @ pat.T).max(axis=2) + SYNC_LEN) / 2.0
    corr = n_agree.astype(np.float32) / np.float32(SYNC_LEN)
    k = _CRC_KERNEL[:, 0, :].astype(np.float64)            # (33, 230)
    winb = swv(bits.astype(np.float64), CRC_SPAN, axis=1)[:, ::2][:, :pc_n]
    out_i = np.rint(winb @ k.T).astype(np.int64)           # (R, Pc, 33)
    syn = (out_i[..., 0:16] & 1) ^ _CRC_C0.astype(np.int64)[None, None, :]
    e_fwd = syn.sum(axis=2)
    ones = out_i[..., 32]
    err = np.where((ones == 0) | (ones == DATA_BITS), 99, e_fwd)
    return corr, err.astype(np.int32)


class FrameScanKernel:
    """Jitted standalone wrapper (the Pipeline's per-block dispatch).

    ``packed=True`` (default) uses the packed conv;
    ``packed=False`` the plain 2-conv reference formulation (same
    values; kept as the oracle for the packing tests).
    ``even_only=True`` scans only symbol-aligned (even) bit positions
    (frame_scan_packed_even; outputs indexed by p // 2 — callers must
    scale, e.g. frame.batch with scan_stride=2).
    """

    def __init__(self, packed: bool = True, even_only: bool = False):
        self.stride = 2 if even_only else 1
        self._scan = jax.jit(
            frame_scan_packed_even if even_only
            else frame_scan_packed if packed else frame_scan)

    def scan(self, bits: np.ndarray) -> dict:
        out = self._scan(jnp.asarray(np.asarray(bits, np.uint8)))
        return {key: np.asarray(val) for key, val in out.items()}
