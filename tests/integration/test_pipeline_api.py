"""Integration: streaming Pipeline API, sources, tools, checkpoint, CLI."""

import json

import numpy as np
import pytest

from tetraear_tpu.api import Pipeline, PipelineConfig
from tetraear_tpu.runtime.sources import (FileIQSource, SyntheticTetraSource,
                                          open_source, write_capture)


@pytest.fixture
def synth_source():
    return SyntheticTetraSource(sample_rate=2.4e6, snr_db=25, seed=1)


def test_pipeline_end_to_end(synth_source):
    frames = []
    cfg = PipelineConfig(sample_rate=2.4e6, detect_gate=False, voice=False,
                         expected_mcc=260)
    pipe = Pipeline(cfg, on_frame=frames.append)
    stats = pipe.run(synth_source, max_blocks=4)
    assert stats.frames >= 8
    assert stats.crc_pass >= stats.frames - 2
    texts = [f.get("sds_message") for f in frames
             if f.get("type_name") == "MAC-RESOURCE"]
    assert any(t == "[TXT] HELLO HELLO" for t in texts)
    # SYSINFO decoded -> network identity propagates
    mccs = {(f.get("call_metadata") or {}).get("mcc") for f in frames}
    assert 260 in mccs
    # validation passes once the network is known
    assert stats.valid_frames > 0


def test_pipeline_no_duplicate_frames(synth_source):
    frames = []
    cfg = PipelineConfig(sample_rate=2.4e6, detect_gate=False, voice=False)
    Pipeline(cfg, on_frame=frames.append).run(synth_source, max_blocks=4)
    positions = [f["stream_symbol"] for f in frames]
    assert len(positions) == len(set(positions))
    # consecutive frames at least a slot apart per carrier
    diffs = np.diff(sorted(positions))
    assert np.all(diffs >= 200)


def test_pipeline_frames_generator(synth_source):
    cfg = PipelineConfig(sample_rate=2.4e6, detect_gate=False, voice=False)
    pipe = Pipeline(cfg)
    got = list(pipe.frames(synth_source, max_blocks=2))
    assert len(got) >= 3


def test_pipeline_jsonl_records(tmp_path, synth_source):
    cfg = PipelineConfig(sample_rate=2.4e6, detect_gate=False, voice=False,
                         records_dir=str(tmp_path))
    Pipeline(cfg).run(synth_source, max_blocks=2)
    files = list(tmp_path.glob("frames_*.jsonl"))
    assert files
    lines = files[0].read_text().strip().splitlines()
    assert len(lines) >= 3
    rec = json.loads(lines[0])
    assert "type_name" in rec and "bits" not in rec


def test_pipeline_checkpoint_resume(tmp_path):
    src = SyntheticTetraSource(sample_rate=2.4e6, snr_db=25, seed=7)
    cfg = PipelineConfig(sample_rate=2.4e6, detect_gate=False, voice=False)
    pipe = Pipeline(cfg)
    pipe.run(src, max_blocks=2)
    ck = tmp_path / "state.npz"
    pipe.save_checkpoint(ck)

    pipe2 = Pipeline(cfg)
    pipe2.load_checkpoint(ck)
    # state restored: same pytree shapes, stream continues without re-warmup
    a = np.asarray(pipe.state["nco_cycles"])
    b = np.asarray(pipe2.state["nco_cycles"])
    assert np.array_equal(a, b)


def test_pipeline_checkpoint_with_frame_workers(tmp_path):
    """Checkpoint save/load works when the per-hit layer is sharded
    over worker processes (the dedup watermark lives behind a property
    on ShardedFrameLayer)."""
    src = SyntheticTetraSource(sample_rate=2.4e6, snr_db=25, seed=9)
    cfg = PipelineConfig(sample_rate=2.4e6, detect_gate=False,
                         voice=False, frame_workers=2)
    pipe = Pipeline(cfg)
    try:
        pipe.run(src, max_blocks=2)
        ck = tmp_path / "state_workers.npz"
        pipe.save_checkpoint(ck)
        pipe2 = Pipeline(cfg)
        try:
            pipe2.load_checkpoint(ck)
            np.testing.assert_array_equal(
                np.asarray(pipe.batch._emitted_until),
                np.asarray(pipe2.batch._emitted_until))
            # the setter routes to the inner layer, not a shadow attr
            assert pipe2.batch._inner._emitted_until is \
                pipe2.batch._emitted_until
        finally:
            pipe2.batch.close()
    finally:
        pipe.batch.close()


# -- sources ---------------------------------------------------------------

@pytest.mark.parametrize("ext", [".cfile", ".cs16", ".cu8", ".npy"])
def test_file_source_roundtrip(tmp_path, ext, rng):
    iq = (rng.standard_normal(5000)
          + 1j * rng.standard_normal(5000)).astype(np.complex64) * 0.15
    path = tmp_path / f"cap{ext}"
    write_capture(path, iq)
    src = FileIQSource(path, sample_rate=2.4e6)
    assert src.open()
    back = src.read_samples(5000)
    assert len(back) == 5000
    tol = {".cfile": 1e-7, ".npy": 1e-7, ".cs16": 1e-4, ".cu8": 1e-2}[ext]
    assert np.max(np.abs(back - iq)) < tol
    assert len(src.read_samples(100)) == 0          # EOF
    assert src.exhausted


def test_file_source_missing(tmp_path):
    src = FileIQSource(tmp_path / "nope.cfile")
    assert not src.open()


def test_open_source_factory(tmp_path):
    from tetraear_tpu.runtime.sources import (RTLSDRSource,
                                              SyntheticTetraSource)
    assert isinstance(open_source("rtlsdr"), RTLSDRSource)
    s = open_source("synthetic:12500,-12500")
    assert isinstance(s, SyntheticTetraSource)
    assert s.offsets_hz == [12_500.0, -12_500.0]
    p = tmp_path / "x.cfile"
    write_capture(p, np.zeros(10, np.complex64))
    assert isinstance(open_source(str(p)), FileIQSource)


def test_rtlsdr_source_gated():
    from tetraear_tpu.runtime import sources
    src = sources.RTLSDRSource()
    if not sources.RTL_SDR_AVAILABLE:
        assert not src.open()          # graceful degradation, no raise


def test_pipeline_from_file_capture(tmp_path):
    """decode-file path: write a golden capture, decode it offline."""
    from tetraear_tpu.ref import golden
    payloads = [golden.sds_text_payload("FILE TEST FILE")] * 4
    iq = golden.golden_iq(payloads, fs=2.4e6, snr_db=25, seed=44)
    path = tmp_path / "cap.cfile"
    write_capture(path, iq)

    frames = []
    cfg = PipelineConfig(sample_rate=2.4e6, detect_gate=False, voice=False,
                         block_len=32_000)
    pipe = Pipeline(cfg, on_frame=frames.append)
    pipe.run(FileIQSource(path, sample_rate=2.4e6))
    texts = [f.get("sds_message") for f in frames]
    assert any(t == "[TXT] FILE TEST FILE" for t in texts)


def test_cli_decode_uses_fused_dispatches(tmp_path, capsys):
    """The offline `decode` subcommand must go through the fused
    S-blocks-per-dispatch runner: a capture of N blocks decodes in
    ceil(N/S) device dispatches, not N (CLAUDE.md rule 4)."""
    import json as _json
    from tetraear_tpu import cli
    from tetraear_tpu.ref import golden
    payloads = [golden.sds_text_payload("DISPATCH COUNT")] * 6
    iq = golden.golden_iq(payloads, fs=2.4e6, snr_db=25, seed=45)
    path = tmp_path / "cap.cfile"
    write_capture(path, iq)
    rc = cli.main(["decode", "--source", str(path), "-s", "2.4",
                   "--show-invalid", "--dispatch-blocks", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    summary = _json.loads(out[out.index("{"):])
    n_blocks = summary["blocks"]
    assert n_blocks >= 2
    assert summary["device_dispatches"] == -(-n_blocks // 4)
    assert summary["crc_pass"] >= 4
    assert "DISPATCH COUNT" in out


# -- tools ----------------------------------------------------------------

def test_generate_common_keys(capsys):
    from tetraear_tpu.tools import generate_common_keys
    assert generate_common_keys.main([]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines()
             if ln and not ln.startswith("#")]
    assert len(lines) >= 150
    assert all(":" in ln for ln in lines)
    # every key parses
    for ln in lines[:20]:
        alg, _, hexkey = ln.split(":")
        bytes.fromhex(hexkey)


def test_analyze_text_tool(tmp_path, capsys):
    from tetraear_tpu.tools import analyze_text
    log = tmp_path / "frames.jsonl"
    log.write_text(
        json.dumps({"sds_message": "[TXT] Hello operational message"})
        + "\n" + json.dumps({"decoded_text": "\x01\x02\x03"}) + "\n")
    assert analyze_text.main([str(log)]) == 0
    out = capsys.readouterr().out
    assert "Hello operational" in out


def test_bruteforce_keys_tool(tmp_path, capsys):
    from tetraear_tpu.crypto.tea import TEADecryptor
    from tetraear_tpu.tools import bruteforce_keys
    key = bytes.fromhex("00112233445566778899AABBCCDDEEFF")
    clear = b"Status report all units OK over "
    cipher = TEADecryptor(key, "TEA2").encrypt(clear)
    log = tmp_path / "frames.jsonl"
    log.write_text(json.dumps({
        "encrypted": True,
        "mac_pdu": {"data": cipher.hex()},
    }) + "\n")
    keyfile = tmp_path / "keys.txt"
    keyfile.write_text("TEA2:0:00112233445566778899AABBCCDDEEFF\n"
                       "TEA2:0:FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF\n")
    assert bruteforce_keys.main([str(log), "-k", str(keyfile)]) == 0
    out = capsys.readouterr().out
    assert "Status report" in out
    # the keys x frames product runs on device (one dispatch per family)
    assert "device search" in out


# -- CLI ------------------------------------------------------------------

def test_cli_help(capsys):
    from tetraear_tpu import cli
    assert cli.main([]) == 0
    assert "tetraear_tpu" in capsys.readouterr().out


def test_cli_listen_synthetic(capsys):
    from tetraear_tpu import cli
    rc = cli.main(["listen", "--source", "synthetic", "--max-blocks", "2",
                   "--expected-mcc", "260"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "MAC-RESOURCE" in out
    assert "HELLO HELLO" in out


# -- settings / logging ----------------------------------------------------

def test_settings_manager(tmp_path):
    from tetraear_tpu.utils.settings import SettingsManager
    sm = SettingsManager(path=tmp_path / "settings.json")
    assert sm.get("gain") == "auto"
    sm.set("gain", 28.0)
    sm2 = SettingsManager(path=tmp_path / "settings.json")
    assert sm2.get("gain") == 28.0


def test_frequency_manager(tmp_path):
    from tetraear_tpu.utils.settings import FrequencyManager
    fm = FrequencyManager(path=tmp_path / "freqs.json")
    n0 = len(fm.frequencies)
    fm.add("test", 391.2e6)
    fm2 = FrequencyManager(path=tmp_path / "freqs.json")
    assert len(fm2.frequencies) == n0 + 1
    fm2.remove("test")
    assert len(fm2.frequencies) == n0


def test_setup_logging(tmp_path):
    import logging
    from tetraear_tpu.utils.logging import setup_logging
    run_dir = setup_logging(verbose=False, log_dir=tmp_path)
    logging.getLogger("tetraear_tpu.frame.decoder").info("decoder line")
    logging.getLogger("tetraear_tpu.api").info("app line")
    for h in logging.getLogger().handlers:
        h.flush()
    assert (run_dir / "all.log").exists()
    assert "decoder line" in (run_dir / "decoder.log").read_text()
    assert "decoder line" not in (run_dir / "app.log").read_text()
    # reset handlers so later tests aren't affected
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)


# -- audio export ----------------------------------------------------------

def test_wav_roundtrip(tmp_path):
    from tetraear_tpu.voice.export import read_wav, write_wav
    audio = np.sin(np.linspace(0, 100, 8000)).astype(np.float32) * 0.5
    write_wav(tmp_path / "a.wav", audio)
    back, rate = read_wav(tmp_path / "a.wav")
    assert rate == 8000
    assert len(back) == 8000


def test_wav_recorder_deletes_silence(tmp_path):
    from tetraear_tpu.voice.export import WavRecorder
    rec = WavRecorder(tmp_path / "s.wav")
    rec.write(np.zeros(1000, np.float32))
    assert rec.close() is None
    assert not (tmp_path / "s.wav").exists()

    rec = WavRecorder(tmp_path / "v.wav")
    rec.write(np.ones(1000, np.float32) * 0.5)
    assert rec.close() is not None
    assert (tmp_path / "v.wav").exists()


def test_voice_accumulator(tmp_path):
    from tetraear_tpu.voice.export import VoiceAccumulator
    acc = VoiceAccumulator(tmp_path, gap_s=3.0, min_call_s=0.1)
    t = 1000.0
    acc.add(101, np.ones(4000, np.float32) * 0.3, now=t)
    acc.add(101, np.ones(4000, np.float32) * 0.3, now=t + 1)
    assert acc.poll(now=t + 2) == []              # gap not reached
    done = acc.poll(now=t + 5)
    assert len(done) == 1
    assert "tg101" in done[0].name


def test_pipeline_raw_fm_hook(synth_source):
    chunks = []
    cfg = PipelineConfig(sample_rate=2.4e6, detect_gate=False, voice=False,
                         raw_fm=True)
    pipe = Pipeline(cfg, on_raw_audio=chunks.append)
    pipe.run(synth_source, max_blocks=2)
    assert len(chunks) == 2
    assert len(chunks[0]) == pipe.block_len
    assert np.isfinite(chunks[0]).all()


def test_pipeline_device_scan_equivalence():
    """The fused per-block step (device_scan=True, demod + scan in one
    dispatch) finds the same CRC-passing frames as the split
    demod-then-FrameScanKernel path, modulo the one-symbol stream
    offset from the first-diff-symbol convention."""
    from tetraear_tpu.ref import golden

    payloads = [golden.sds_text_payload("SCAN PATH EQ")] * 6
    iq = golden.golden_iq(payloads, fs=2.4e6, snr_db=25, seed=44)

    def run(device_scan):
        got = []
        cfg = PipelineConfig(sample_rate=2.4e6, detect_gate=False,
                             voice=False, auto_decrypt=False,
                             validate=False, block_len=48_000,
                             device_scan=device_scan)
        pipe = Pipeline(cfg, on_frame=got.append)
        n_blocks = len(iq) // pipe.block_len
        for b in range(n_blocks):
            pipe.process_block(
                iq[b * pipe.block_len:(b + 1) * pipe.block_len])
        return [(f["stream_symbol"], f.get("sds_message"))
                for f in got if f["burst_crc"]]

    fused = run(True)
    split = run(False)
    # split path drops the first diff symbol -> positions shift by one
    assert [(p - 1, m) for p, m in fused] == split
    assert len(fused) >= 4


def _oracle_crc_messages(iq, fs, offset):
    """CRC-passing SDS messages of the NumPy oracle decode, in order."""
    from tetraear_tpu.frame.decoder import TetraDecoder
    from tetraear_tpu.ref import demod
    syms = demod.OracleDemod(fs=fs, freq_offset_hz=offset).run(
        iq)["symbols"]
    return [f.get("sds_message") for f in
            TetraDecoder(auto_decrypt=False).decode(syms)
            if f.get("burst_crc")]


def _fft_family_config(fs, **kw):
    """fft frontend on a 72 kHz-family rate (no back-half resample
    stage), carrier AFC off — the fleet-scale configuration."""
    return PipelineConfig(sample_rate=fs, carrier_offsets_hz=(12_500.0,),
                          frontend="fft", carrier_afc=False,
                          detect_gate=False, voice=False,
                          auto_decrypt=False, validate=False, **kw)


def test_pipeline_fused_backhalf_equivalence():
    """The streaming Pipeline on the fft frontend at a 72 kHz-family
    rate yields the CRC-passing frames of the NumPy oracle decode
    (ref.demod.OracleDemod + TetraDecoder) on the same capture."""
    from tetraear_tpu.ref import golden

    fs = 2.304e6                       # 72 kHz * 32
    payloads = [golden.sds_text_payload(f"FUSED PIPE {i}")
                for i in range(8)]
    iq = golden.golden_iq(payloads, fs=fs, freq_offset_hz=12_500.0,
                          snr_db=25, seed=31)
    got = []
    pipe = Pipeline(_fft_family_config(fs, block_len=48_000),
                    on_frame=got.append)
    assert not pipe.bank.plan.stages
    n_blocks = len(iq) // pipe.block_len
    for b in range(n_blocks):
        pipe.process_block(iq[b * pipe.block_len:(b + 1) * pipe.block_len])
    msgs = [f.get("sds_message") for f in got if f.get("burst_crc")]
    want = _oracle_crc_messages(iq[:n_blocks * pipe.block_len], fs,
                                12_500.0)
    assert len(msgs) >= 6
    assert msgs == want[:len(msgs)]
    assert len(want) - len(msgs) <= 1      # a slot cut by the last block


def test_pipeline_fused_checkpoint_roundtrip(tmp_path):
    """Seamless checkpoint on the fft-frontend streaming path: a
    save/restore between blocks reproduces the uninterrupted run."""
    from tetraear_tpu.ref import golden

    fs = 2.304e6
    payloads = [golden.sds_text_payload("FUSED CKPT")] * 8
    iq = golden.golden_iq(payloads, fs=fs, freq_offset_hz=12_500.0,
                          snr_db=25, seed=32)
    cfg = _fft_family_config(fs, block_len=48_000)

    def key(frames):
        return [(f["stream_symbol"], f.get("burst_crc"),
                 f.get("sds_message")) for f in frames]

    base = []
    pipe = Pipeline(cfg, on_frame=base.append)
    blocks = [iq[b * pipe.block_len:(b + 1) * pipe.block_len]
              for b in range(len(iq) // pipe.block_len)]
    for b in blocks:
        pipe.process_block(b)

    got = []
    p1 = Pipeline(cfg, on_frame=got.append)
    for b in blocks[:2]:
        p1.process_block(b)
    p1.save_checkpoint(tmp_path / "f.npz")
    p2 = Pipeline(cfg, on_frame=got.append)
    p2.load_checkpoint(tmp_path / "f.npz")
    for b in blocks[2:]:
        p2.process_block(b)
    assert key(got) == key(base)
    assert sum(1 for _, crc, _ in key(base) if crc) >= 6


def test_pipeline_fused_with_frame_workers():
    """fft-frontend streaming path + the carrier-sharded worker frame
    layer (frame_workers > 0) yields the same frames as the in-process
    layer."""
    from tetraear_tpu.ref import golden

    fs = 2.304e6
    payloads = [golden.sds_text_payload(f"FUSED WORKERS {i}")
                for i in range(8)]
    iq = golden.golden_iq(payloads, fs=fs, freq_offset_hz=12_500.0,
                          snr_db=25, seed=77)

    def run(workers):
        got = []
        pipe = Pipeline(_fft_family_config(fs, frame_workers=workers),
                        on_frame=got.append)
        try:
            for b in range(len(iq) // pipe.block_len):
                pipe.process_block(
                    iq[b * pipe.block_len:(b + 1) * pipe.block_len])
        finally:
            if workers:
                pipe.batch.close()
        return [(f["stream_symbol"], f.get("burst_crc"),
                 f.get("sds_message")) for f in got]

    inproc = run(0)
    sharded = run(2)
    assert inproc == sharded
    assert sum(1 for _, crc, _ in inproc if crc) >= 6
