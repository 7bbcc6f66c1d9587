"""Device frame-scan kernel vs the host oracle: bit-exact decisions.

The batched frame layer stands on two exactness contracts:
  * device sync correlation == decoder.sync_correlate (same thresholds
    fire at every position);
  * device dense CRC == crc.soft_crc_check at every frame start.
"""

import numpy as np
import pytest

from tetraear_tpu.dsp import framescan
from tetraear_tpu.frame import crc as crc_mod
from tetraear_tpu.frame import decoder as dec_mod
from tetraear_tpu.frame.burst import extract_data_bits, BurstType


def _random_bits(c, n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 2, (c, n)).astype(np.uint8)


@pytest.mark.unit
def test_sync_corr_matches_host():
    bits = _random_bits(3, 1500, seed=1)
    # plant exact sync words so the 1.0 end of the range is exercised
    from tetraear_tpu.frame.burst import SYNC_CONTINUOUS_DOWNLINK as TS1
    from tetraear_tpu.frame.burst import SYNC_DISCONTINUOUS_DOWNLINK as TS2
    bits[0, 300:322] = TS1
    bits[1, 700:722] = TS2
    dev = framescan.FrameScanKernel(packed=False).scan(bits)
    for c in range(bits.shape[0]):
        host = dec_mod.sync_correlate(bits[c])
        assert dev["corr"][c].shape == host.shape
        # integer agreement counts divide identically on both paths
        np.testing.assert_allclose(dev["corr"][c], host, atol=1e-6)
        # decision equivalence at every cascade threshold
        for thr in (0.90, 0.85, 0.80, 0.75):
            assert np.array_equal(dev["corr"][c] >= thr, host >= thr)


@pytest.mark.unit
def test_crc_err_matches_soft_crc_check():
    rng = np.random.default_rng(2)
    c, n = 2, 2000
    bits = _random_bits(c, n, seed=2)
    # plant frames whose data view passes CRC exactly and with 1..3 errors
    for ci, q, n_err in [(0, 100, 0), (0, 800, 1), (1, 300, 2), (1, 1200, 3)]:
        payload = rng.integers(0, 2, 200).astype(np.uint8)
        data = crc_mod.append_crc(payload)            # 216 bits
        bits[ci, q:q + 108] = data[:108]
        bits[ci, q + 122:q + 230] = data[108:]
        # flip bits of the RECEIVED CRC (data view bits 200..215 = frame
        # offsets 214..229): each flip adds exactly one error bit
        for f in rng.choice(16, size=n_err, replace=False):
            bits[ci, q + 214 + f] ^= 1
    # degenerate all-zero view
    bits[1, 1600:1830] = 0

    dev = framescan.FrameScanKernel(packed=False).scan(bits)
    assert dev["crc_err"].shape == (c, n - 229)
    for ci in range(c):
        for q in range(0, n - 229, 37):
            data = extract_data_bits(bits[ci, q:q + 510],
                                     BurstType.NormalDownlink)
            want = crc_mod.soft_crc_check(data)
            got = dev["crc_err"][ci, q] <= 2
            assert got == want, (ci, q, dev["crc_err"][ci, q])
    # the planted frames read their exact error counts
    assert dev["crc_err"][0, 100] == 0
    assert dev["crc_err"][0, 800] == 1
    assert dev["crc_err"][1, 300] == 2
    assert dev["crc_err"][1, 1200] >= 3
    assert dev["crc_err"][1, 1600] == 99


@pytest.mark.unit
def test_crc_err_reversed_payload_accept():
    """soft_crc_check also accepts when the REVERSED payload matches —
    the device kernel must reproduce that branch too."""
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 2, 200).astype(np.uint8)
    crc = crc_mod.crc16_batch(payload[::-1])[0]      # CRC of reversed
    data = np.concatenate([payload, crc])
    bits = _random_bits(1, 600, seed=4)
    q = 50
    bits[0, q:q + 108] = data[:108]
    bits[0, q + 122:q + 230] = data[108:]
    assert crc_mod.soft_crc_check(
        extract_data_bits(bits[0, q:q + 510], BurstType.NormalDownlink))
    dev = framescan.FrameScanKernel(packed=False).scan(bits)
    assert dev["crc_err"][0, q] <= 2

@pytest.mark.unit
def test_packed_scan_matches_reference():
    """frame_scan_packed (one MXU-packed bf16 280-channel conv) is
    bit-identical to the plain two-conv formulation: same corr values
    (integer agreement counts, exact in bf16 since every sum is < 256
    with f32 accumulation) and same crc_err at every position."""
    c, n = 4, 3000
    bits = _random_bits(c, n, seed=7)
    # plant full golden slots (sync word + CRC-consistent data view —
    # ref.golden solves the slot-bit 216..229 sync/CRC overlay)
    from tetraear_tpu.ref import golden
    plants = [(0, 120), (0, 1400), (1, 600), (2, 2200), (3, 40)]
    for ci, q in plants:
        slot = golden.build_slot(golden.build_mac_resource_data_bits(
            b"PACKED", address=0x1000 + 7 * ci + q))
        bits[ci, q:q + 510] = slot
    # degenerate all-zero region exercises the 99 path
    bits[1, 2400:2700] = 0

    dense = framescan.FrameScanKernel(packed=False).scan(bits)
    pk = framescan.FrameScanKernel(packed=True).scan(bits)

    assert pk["corr"].shape == dense["corr"].shape
    assert pk["crc_err"].shape == dense["crc_err"].shape
    np.testing.assert_allclose(pk["corr"], dense["corr"], atol=1e-6)
    np.testing.assert_array_equal(pk["crc_err"], dense["crc_err"])
    # the planted frames pass the <=2-error budget on the packed path
    for ci, q in plants:
        assert pk["crc_err"][ci, q] <= 2
    # odd length (stride-edge coverage): same equality on a ragged n
    bits2 = _random_bits(2, 2001, seed=9)
    d2 = framescan.FrameScanKernel(packed=False).scan(bits2)
    p2 = framescan.FrameScanKernel(packed=True).scan(bits2)
    np.testing.assert_allclose(p2["corr"], d2["corr"], atol=1e-6)
    np.testing.assert_array_equal(p2["crc_err"], d2["crc_err"])


@pytest.mark.unit
def test_even_scan_matches_dense_even_positions():
    """frame_scan_packed_even == frame_scan at every EVEN position:
    same corr values, same crc_err (FORWARD-only — the production even
    scan drops the reversed-payload channels; the host completes that
    check per sync hit), with element pe <-> bit 2*pe."""
    import jax.numpy as jnp
    c, n = 3, 3000
    bits = _random_bits(c, n, seed=11)
    from tetraear_tpu.ref import golden
    plants = [(0, 120), (1, 602), (2, 2200)]       # even starts only
    for ci, q in plants:
        slot = golden.build_slot(golden.build_mac_resource_data_bits(
            b"EVENSCAN", address=0x2000 + ci))
        bits[ci, q:q + 510] = slot
    dense = {k: np.asarray(v) for k, v in framescan.frame_scan(
        jnp.asarray(bits), rev=False).items()}
    ev = framescan.FrameScanKernel(even_only=True).scan(bits)
    assert ev["corr"].shape[1] == (n - framescan.SYNC_LEN) // 2 + 1
    assert ev["crc_err"].shape[1] == (n - framescan.CRC_SPAN) // 2 + 1
    np.testing.assert_allclose(ev["corr"],
                               dense["corr"][:, ::2][:, :ev["corr"]
                                                     .shape[1]],
                               atol=1e-6)
    np.testing.assert_array_equal(
        ev["crc_err"],
        dense["crc_err"][:, ::2][:, :ev["crc_err"].shape[1]])
    for ci, q in plants:
        assert ev["crc_err"][ci, q // 2] <= 2
        # the sync hit lands at bit q+216 -> even element (q+216)//2
        assert ev["corr"][ci, (q + framescan.TS_OFFSET_BITS) // 2] >= 0.999
    # odd length
    bits2 = _random_bits(2, 2001, seed=12)
    d2 = {k: np.asarray(v) for k, v in framescan.frame_scan(
        jnp.asarray(bits2), rev=False).items()}
    e2 = framescan.FrameScanKernel(even_only=True).scan(bits2)
    np.testing.assert_allclose(
        e2["corr"], d2["corr"][:, ::2][:, :e2["corr"].shape[1]],
        atol=1e-6)
    np.testing.assert_array_equal(
        e2["crc_err"], d2["crc_err"][:, ::2][:, :e2["crc_err"].shape[1]])


@pytest.mark.unit
def test_reversed_payload_recovered_by_host_completion():
    """A reversed-payload frame reads high on the forward-only even
    scan, but parse_burst's host completion (the O(sync hits) reversed
    re-check) still accepts it — end semantics match the reference's
    both-orientation check."""
    from tetraear_tpu.frame.burst import parse_burst
    from tetraear_tpu.ref import golden
    rng = np.random.default_rng(5)
    payload = rng.integers(0, 2, 200).astype(np.uint8)
    crc = crc_mod.crc16_batch(payload[::-1])[0]
    data = np.concatenate([payload, crc])
    slot = golden.build_slot(golden.build_mac_resource_data_bits(
        b"REVHOST", address=0x3000))
    slot[0:108] = data[:108]
    slot[122:230] = data[108:]                     # reversed-CRC view
    bits = _random_bits(1, 1200, seed=6)
    q = 100
    bits[0, q:q + 510] = slot
    ev = framescan.FrameScanKernel(even_only=True).scan(bits)
    # forward-only device verdict does NOT pass...
    assert ev["crc_err"][0, q // 2] > 2
    # ...but the host burst parse with a non-pass hint re-checks fully
    syms = (bits[0, q:q + 510:2] << 1) | bits[0, q + 1:q + 510:2]
    burst = parse_burst(syms, crc_hint=False)
    assert burst is not None and burst.crc_ok


@pytest.mark.unit
def test_sync_cascade_stride():
    """sync_cascade on an even-subsampled corr returns the same BIT
    positions as on the dense array when all hits are even-aligned."""
    corr = np.zeros(4000, np.float32)
    for p in (300, 1400, 1404, 2900):              # 1404 deduped (gap)
        corr[p] = 0.95
    dense_pos = dec_mod.sync_cascade(corr)
    even_pos = dec_mod.sync_cascade(corr[::2], stride=2)
    assert dense_pos == even_pos == [300, 1400, 2900]


@pytest.mark.unit
@pytest.mark.parametrize("n", [230, 231, 510, 1201, 2547, 5270])
def test_even_scan_matches_host_scan_at_widths(n):
    """The kept device formulation (frame_scan_packed_even, packed bf16
    conv) gives bit-identical verdicts to the exact NumPy even-position
    scan at widths around the pad/stride boundaries."""
    import jax.numpy as jnp
    bits = _random_bits(3, n, seed=n)
    if n >= 510:
        from tetraear_tpu.ref import golden
        bits[1, :510] = golden.build_slot(
            golden.build_mac_resource_data_bits(b"WIDTHS"))
    dev = framescan.frame_scan_packed_even(jnp.asarray(bits))
    corr, err = framescan.host_scan_rows_even(bits)
    np.testing.assert_array_equal(np.asarray(dev["corr"]), corr)
    np.testing.assert_array_equal(np.asarray(dev["crc_err"]), err)
