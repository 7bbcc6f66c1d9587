"""Sparse device hit extraction == dense verdict planes.

SURVEY §7 "ship compact per-hit indices+bits to host": the device
compacts the dense even-position scan into per-carrier top-K packed hit
keys (dsp.framescan.sparse_hits); the host scatters them back into
virtual planes whose values at every read position are bit-identical to
the dense scan's (unpack_hits_to_planes), so the selection layer
(frame.batch) is provably unchanged.  These tests pin:

  * the NumPy overflow-fallback scan == the device even scan, bitwise;
  * superset-by-construction: every position the host cascade can
    select is present in the reconstruction with exact corr/crc values;
  * DecodeRunner(sparse=True) emits the identical frame stream to the
    dense path on a golden capture, including under forced overflow.
"""

import numpy as np
import pytest

from tetraear_tpu.dsp import framescan


def _random_bits(c, n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 2, (c, n)).astype(np.uint8)


def _planted_bits(c, n, seed=1):
    """Random bits with sync patterns planted at symbol-aligned spots."""
    bits = _random_bits(c, n, seed)
    pat = framescan._PATTERNS.astype(np.uint8)
    rng = np.random.default_rng(seed + 1)
    for ci in range(c):
        for pos in rng.integers(260, n - 320, 4):
            pos = int(pos) & ~1                    # even (symbol-aligned)
            bits[ci, pos:pos + 22] = pat[ci % 2]
    return bits


def test_host_scan_rows_even_matches_device():
    bits = _planted_bits(3, 1700, seed=7)
    dev = framescan.frame_scan_packed_even(bits)
    corr_h, crc_h = framescan.host_scan_rows_even(bits)
    # corr and crc: bitwise (both divide the exact integer agreement
    # count by 22 in float32)
    np.testing.assert_array_equal(np.asarray(dev["corr"]), corr_h)
    np.testing.assert_array_equal(np.asarray(dev["crc_err"]), crc_h)
    # the integer agreement counts themselves are exact
    np.testing.assert_array_equal(
        np.rint(np.asarray(dev["corr"]) * 22), np.rint(corr_h * 22.0))


def test_sparse_reconstruction_covers_host_selection():
    bits = _planted_bits(4, 2100, seed=3)
    dense = framescan.frame_scan_packed_even(bits)
    corr_d = np.asarray(dense["corr"])
    crc_d = np.asarray(dense["crc_err"])
    keys, counts = framescan.sparse_hits(
        dense["corr"], dense["crc_err"], 32)
    assert int(np.max(np.asarray(counts))) <= 32   # no overflow here
    corr_r, crc_r = framescan.unpack_hits_to_planes(
        keys, counts, corr_d.shape[1], crc_d.shape[1],
        lambda rows: bits[rows])
    off = framescan.TS_OFFSET_BITS // 2
    for ci in range(len(bits)):
        rm = float(corr_d[ci].max())
        if rm < 0.75:
            assert not (corr_r[ci] > 0).any()
            continue
        thr = 0.90 if rm >= 0.90 else max(0.75, rm - 0.02)
        sel = np.flatnonzero(corr_d[ci].astype(np.float64) >= thr)
        assert len(sel)
        # every host-selectable position carries its values (exact
        # integer agreement counts; crc bitwise modulo the 63 clamp)
        np.testing.assert_allclose(corr_r[ci, sel], corr_d[ci, sel],
                                   atol=1e-6)
        qc = sel - off
        inb = (qc >= 0) & (qc < crc_d.shape[1])
        np.testing.assert_array_equal(
            crc_r[ci, qc[inb]], np.minimum(crc_d[ci, qc[inb]], 63))
        # reconstruction adds nothing ABOVE the host threshold beyond
        # the dense plane's own values (superset only of sub-threshold)
        extra = np.flatnonzero(corr_r[ci] > 0)
        np.testing.assert_allclose(corr_r[ci, extra],
                                   corr_d[ci, extra], atol=1e-6)


def test_sparse_overflow_rows_recomputed_exactly():
    """A row with more hits than the device budget falls back to the
    exact host recompute: the virtual planes equal the dense ones."""
    bits = _planted_bits(2, 1700, seed=11)
    # saturate row 0 with back-to-back sync patterns -> dozens of hits
    pat = framescan._PATTERNS.astype(np.uint8)[0]
    for pos in range(240, 1400, 24):
        bits[0, pos:pos + 22] = pat
    dense = framescan.frame_scan_packed_even(bits)
    corr_d = np.asarray(dense["corr"])
    crc_d = np.asarray(dense["crc_err"])
    kh = 4
    keys, counts = framescan.sparse_hits(
        dense["corr"], dense["crc_err"], kh)
    counts = np.asarray(counts)
    assert counts[0] > kh                        # overflow triggered
    corr_r, crc_r = framescan.unpack_hits_to_planes(
        keys, counts, corr_d.shape[1], crc_d.shape[1],
        lambda rows: bits[rows])
    np.testing.assert_allclose(corr_r[0], corr_d[0], atol=1e-6)
    np.testing.assert_array_equal(crc_r[0], crc_d[0])


def test_pack_syms_round_trip():
    """2-bit symbol packing survives non-multiple-of-4 widths."""
    from tetraear_tpu.runtime.stream import pack_syms, unpack_syms
    for k in (1, 4, 7, 255, 256):
        h = np.random.default_rng(k).integers(
            0, 4, (3, k)).astype(np.uint8)
        packed = np.asarray(pack_syms(h))
        assert packed.shape == (3, -(-k // 4))
        np.testing.assert_array_equal(unpack_syms(packed, k), h)


@pytest.mark.integration
def test_decode_runner_sparse_matches_dense():
    """Full path: DecodeRunner in sparse mode (compact hit keys over
    the fetch boundary) decodes the identical frame stream to the dense
    mode, both at the default budget and under forced overflow."""
    from tetraear_tpu.dsp.pipeline import CarrierBankDemod
    from tetraear_tpu.frame.batch import BatchedFrameDecoder
    from tetraear_tpu.runtime.stream import DecodeRunner
    from tetraear_tpu.ref import golden

    payloads = [golden.sds_text_payload("SPARSE HIT KEYS")] * 8
    iq = golden.golden_iq(payloads, fs=2.4e6, snr_db=25, seed=41)

    def frames(sparse, sparse_k=None):
        bank = CarrierBankDemod(fs=2.4e6, freqs_hz=[0.0],
                                block_len=48_000)
        runner = DecodeRunner(
            bank, BatchedFrameDecoder(1, auto_decrypt=False),
            blocks_per_dispatch=4, sparse=sparse, sparse_k=sparse_k)
        out = runner.run(iq)
        return [(f["stream_symbol"], f["burst_crc"],
                 f.get("sds_message")) for f in out["frames"]]

    dense = frames(False)
    assert sum(1 for f in dense if f[1]) >= 6
    assert frames(True) == dense
    # kh=1 starves the budget -> overflow fallback on busy blocks
    assert frames(True, sparse_k=1) == dense


def test_sparse_selection_differential_fuzz():
    """collect_hits (sparse) == collect_rows + plane hints (dense) on
    random bit planes across budgets — the structured-signal tests pin
    the happy path; this pins the equivalence on arbitrary content,
    including budget overflow and sync-dense adversarial rows."""
    from tetraear_tpu.frame.batch import collect_rows, collect_hits

    rng = np.random.default_rng(99)
    pat = framescan._PATTERNS.astype(np.uint8)
    for it in range(12):
        c, n = 5, int(rng.integers(900, 2400)) & ~1
        bits = rng.integers(0, 2, (c, n)).astype(np.uint8)
        # adversarial rows: planted syncs, back-to-back sync bursts
        for ci in range(c):
            for pos in rng.integers(0, n - 30, rng.integers(0, 6)):
                bits[ci, pos & ~1:(pos & ~1) + 22] = pat[ci % 2]
        if it % 3 == 0:
            for pos in range(2, n - 30, 26):
                bits[0, pos & ~1:(pos & ~1) + 22] = pat[0]
        dense = framescan.frame_scan_packed_even(bits)
        corr_d = np.asarray(dense["corr"])
        crc_d = np.asarray(dense["crc_err"])
        kh = int(rng.choice([2, 8, 32]))
        keys, counts = framescan.sparse_hits(dense["corr"],
                                             dense["crc_err"], kh)
        rows_h, pe_h, corr_h, crc_h = framescan.hits_from_keys(
            np.asarray(keys), np.asarray(counts),
            corr_d.shape[1], crc_d.shape[1], lambda r: bits[r])
        syms = ((bits[:, 0::2] << 1) | bits[:, 1::2]).astype(np.uint8)
        nv = np.full(c, syms.shape[1], np.int64)
        vs = np.zeros(c, np.int64)
        base = np.zeros(c, np.int64)
        emitted = np.zeros(c, np.int64)
        ref = collect_rows(np.arange(c), syms, nv, vs, base, emitted,
                           2, corr_d, crc_rows=crc_d)
        got, hints = collect_hits(np.arange(c), syms, nv, vs, base,
                                  emitted, 2, rows_h, pe_h, corr_h,
                                  crc_h)
        assert len(got) == len(ref), (it, kh, len(got), len(ref))
        for (gc, gs, ga, gw), (rc_, rs, ra, rw), hint in zip(
                got, ref, hints):
            assert (gc, gs, ga) == (rc_, rs, ra)
            np.testing.assert_array_equal(gw, rw)
            scol = gs // 2           # frame-start column (start bits/2)
            assert hint == bool(0 <= scol < crc_d.shape[1]
                                and crc_d[gc, scol] <= 2)


@pytest.mark.integration
def test_decode_runner_lazy_soft_matches_dense():
    """Sparse mode leaves the soft planes on device and row-gathers
    only decoded frames' carriers (stream.LazySoftRows); the attached
    soft_symbols must be bitwise identical to the dense fetch,
    including windows straddling into the previous block's data."""
    from tetraear_tpu.dsp.pipeline import CarrierBankDemod
    from tetraear_tpu.frame.batch import BatchedFrameDecoder
    from tetraear_tpu.runtime.stream import DecodeRunner
    from tetraear_tpu.ref import golden

    payloads = [golden.sds_text_payload("LAZY SOFT ROWS")] * 12
    iq = golden.golden_iq(payloads, fs=2.4e6, snr_db=25, seed=47)

    def frames(sparse):
        bank = CarrierBankDemod(fs=2.4e6, freqs_hz=[0.0],
                                block_len=131_200)
        runner = DecodeRunner(
            bank, BatchedFrameDecoder(1, auto_decrypt=False),
            blocks_per_dispatch=3, sparse=sparse, fetch_soft=True)
        if sparse:
            assert runner.lazy_soft      # K - 2 >= T at this block_len
        return runner.run(iq)["frames"]

    dense = frames(False)
    sparse = frames(True)
    assert len(dense) == len(sparse) >= 6
    # at least one window reads the carried tail (previous block data)
    assert any(f["position"] // 2 < 600 for f in sparse)
    for a, b in zip(dense, sparse):
        assert (a["stream_symbol"], a["burst_crc"]) == \
            (b["stream_symbol"], b["burst_crc"])
        np.testing.assert_array_equal(a["soft_symbols"],
                                      b["soft_symbols"])


@pytest.mark.integration
def test_pipeline_sparse_matches_dense(tmp_path):
    """Streaming Pipeline with sparse hit fetch == dense, in-process
    and through the row-sharded worker layer (the reconstruction runs
    before the shard split, so workers see ordinary dense rows)."""
    from tetraear_tpu.api import Pipeline, PipelineConfig
    from tetraear_tpu.ref import golden

    payloads = [golden.sds_text_payload("PIPE SPARSE")] * 8
    iq = golden.golden_iq(payloads, fs=2.4e6, snr_db=25, seed=43)

    def frames(sparse, workers=0):
        got = []
        cfg = PipelineConfig(carrier_offsets_hz=(0.0,), detect_gate=False,
                             voice=False, auto_decrypt=False,
                             validate=False, block_len=48_000,
                             sparse_hits=sparse, frame_workers=workers)
        pipe = Pipeline(cfg, on_frame=got.append)
        try:
            for b in range(len(iq) // pipe.block_len):
                pipe.process_block(
                    iq[b * pipe.block_len:(b + 1) * pipe.block_len])
        finally:
            if workers:
                pipe.batch.close()
        return [(f["stream_symbol"], f["burst_crc"],
                 f.get("sds_message")) for f in got]

    dense = frames(False)
    assert sum(1 for f in dense if f[1]) >= 6
    assert frames(True) == dense
    assert frames(True, workers=2) == dense
