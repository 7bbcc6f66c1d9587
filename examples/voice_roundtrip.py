"""Full voice chain: PCM -> ACELP -> RF -> demod -> ACELP -> WAV.

Synthesises speech-like PCM, encodes it with the native codec, transmits
it as pi/4-DQPSK traffic slots, then receives and decodes it back to a
playable WAV — the loop the reference never closed (its codec was four
opaque Windows .exes and it had no transmitter)::

    python examples/voice_roundtrip.py [out.wav]

Requires the codec library: make -C tetraear_tpu/voice/csrc
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import tempfile  # noqa: E402

import numpy as np

from tetraear_tpu.voice import codec


def synth_speech(n_slots: int, pitch: int = 57) -> np.ndarray:
    rng = np.random.default_rng(0)
    n = n_slots * 480
    exc = np.zeros(n)
    exc[::pitch] = 1.0
    exc += 0.05 * rng.standard_normal(n)
    y = np.zeros(n)
    for i in range(n):
        y[i] = exc[i]
        if i > 0:
            y[i] += 1.2 * y[i - 1]
        if i > 1:
            y[i] += -0.8 * y[i - 2]
        if i > 2:
            y[i] += 0.3 * y[i - 3]
    return (y / np.max(np.abs(y)) * 8000).astype(np.int16)


def main() -> int:
    from tetraear_tpu.runtime.cache import enable_compile_cache
    enable_compile_cache()
    if not codec.VoiceProcessor().working:
        print("codec library missing — build with: "
              "make -C tetraear_tpu/voice/csrc")
        return 1

    from tetraear_tpu.api import Pipeline, PipelineConfig
    from tetraear_tpu.ref import golden
    from tetraear_tpu.runtime.sources import FileIQSource, write_capture
    from tetraear_tpu.voice.export import write_wav

    out = Path(sys.argv[1]) if len(sys.argv) > 1 else Path("roundtrip.wav")
    pcm = synth_speech(6)
    iq = golden.golden_voice_iq(pcm, fs=2.4e6, snr_db=25, seed=5)
    cap = Path(tempfile.mkdtemp()) / "voice.cfile"
    write_capture(cap, iq)
    print(f"[*] transmitted {len(pcm)} PCM samples as "
          f"{len(iq)} IQ samples")

    chunks = []
    cfg = PipelineConfig(sample_rate=2.4e6, detect_gate=False, voice=True,
                         validate=False, block_len=32_000)
    pipe = Pipeline(cfg, on_audio=chunks.append)
    pipe.run(FileIQSource(cap, sample_rate=2.4e6))

    audio = np.concatenate(chunks) if chunks else np.zeros(0)
    write_wav(out, audio)
    print(f"[*] decoded {pipe.stats.voice_frames} voice slots -> "
          f"{len(audio)} samples -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
