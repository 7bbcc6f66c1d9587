"""Unit test: ScanRunner (multi-block-per-dispatch) exactness."""

import numpy as np

from tetraear_tpu.dsp.pipeline import CarrierBankDemod
from tetraear_tpu.ref import modulator
from tetraear_tpu.runtime.stream import ScanRunner


def test_scan_runner_matches_per_block():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, 8000).astype(np.uint8)
    iq = modulator.generate_carrier(bits, fs=2.4e6, snr_db=18,
                                    rng=np.random.default_rng(2))
    ref = CarrierBankDemod(fs=2.4e6, freqs_hz=[0.0],
                           block_len=48_000).run(iq)["symbols"][0]
    bank = CarrierBankDemod(fs=2.4e6, freqs_hz=[0.0], block_len=48_000)
    out = ScanRunner(bank, blocks_per_dispatch=3).run(iq)
    got = out["symbols"][0]
    assert len(got) == len(ref)
    assert np.array_equal(got, ref)
    # resumed run continues without re-dropping the diff reference
    out2 = ScanRunner(bank, blocks_per_dispatch=2).run(
        iq[:96_000], state=None)
    assert len(out2["symbols"][0]) > 0


def test_decode_runner_matches_streaming_pipeline():
    """Fused runner (demod + frame scan in one lax.scan) finds the same
    CRC-passing frames as the per-block streaming Pipeline, in len/S
    dispatches."""
    from tetraear_tpu.api import Pipeline, PipelineConfig
    from tetraear_tpu.frame.batch import BatchedFrameDecoder
    from tetraear_tpu.runtime.stream import DecodeRunner
    from tetraear_tpu.ref import golden

    payloads = [golden.sds_text_payload("FUSED RUNNER TEST")] * 8
    iq = golden.golden_iq(payloads, fs=2.4e6, snr_db=25, seed=31)

    cfg = PipelineConfig(carrier_offsets_hz=(0.0,), detect_gate=False,
                         voice=False, auto_decrypt=False, validate=False,
                         block_len=48_000)
    got_stream = []
    pipe = Pipeline(cfg, on_frame=got_stream.append)
    n_blocks = len(iq) // pipe.block_len
    for b in range(n_blocks):
        pipe.process_block(iq[b * pipe.block_len:(b + 1) * pipe.block_len])

    bank = __import__("tetraear_tpu.dsp.pipeline",
                      fromlist=["CarrierBankDemod"]).CarrierBankDemod(
        fs=2.4e6, freqs_hz=[0.0], block_len=48_000)
    runner = DecodeRunner(bank, BatchedFrameDecoder(1, auto_decrypt=False),
                          blocks_per_dispatch=4)
    out = runner.run(iq[:n_blocks * 48_000])
    assert runner.dispatches == -(-n_blocks // 4)     # len/S dispatches

    ref = [(f["stream_symbol"], f["burst_crc"], f.get("sds_message"))
           for f in got_stream if f["burst_crc"]]
    got = [(f["stream_symbol"], f["burst_crc"], f.get("sds_message"))
           for f in out["frames"] if f["burst_crc"]]
    # both paths carry the device bit tail and skip the first-diff-
    # symbol drop, so stream positions align exactly
    assert got == ref
    assert len(ref) >= 6


def test_decode_runner_no_soft_fetch():
    """fetch_soft=False skips materializing the soft planes (the voice
    path is the only consumer): identical frames, soft_symbols None."""
    from tetraear_tpu.frame.batch import BatchedFrameDecoder
    from tetraear_tpu.runtime.stream import DecodeRunner
    from tetraear_tpu.ref import golden

    payloads = [golden.sds_text_payload("NO SOFT FETCH")] * 6
    iq = golden.golden_iq(payloads, fs=2.4e6, snr_db=25, seed=52)

    def run(fetch_soft):
        bank = CarrierBankDemod(fs=2.4e6, freqs_hz=[0.0],
                                block_len=48_000)
        runner = DecodeRunner(bank, BatchedFrameDecoder(
            1, auto_decrypt=False), blocks_per_dispatch=3,
            fetch_soft=fetch_soft)
        return runner.run(iq)["frames"]

    with_soft = run(True)
    without = run(False)
    assert len(with_soft) == len(without) >= 5
    for a, b in zip(with_soft, without):
        assert a["soft_symbols"] is not None
        assert b["soft_symbols"] is None
        ka = {k: v for k, v in a.items()
              if k not in ("soft_symbols", "bits")}
        kb = {k: v for k, v in b.items()
              if k not in ("soft_symbols", "bits")}
        assert ka == kb
        assert np.array_equal(a["bits"], b["bits"])
