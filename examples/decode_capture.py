"""Offline decode of an IQ capture with the streaming Pipeline API.

Generates a synthetic TETRA carrier (so the example is self-contained),
writes it as a .cfile, then decodes it exactly as you would a real
capture::

    python examples/decode_capture.py [capture.cfile]

Pass a path to decode your own capture (complex64 .cfile, .cs16, .cu8 or
.npy — sample rate is assumed 2.4 Msps unless you edit the config).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import tempfile  # noqa: E402

from tetraear_tpu.api import Pipeline, PipelineConfig
from tetraear_tpu.runtime.sources import FileIQSource, write_capture


def make_demo_capture(path: Path) -> None:
    from tetraear_tpu.ref import golden, modulator
    payloads = [golden.sds_text_payload("EXAMPLE CAPTURE")] * 4
    bits = golden.build_stream(payloads, seed=1, sysinfo_every=4)
    iq = modulator.generate_carrier(bits, fs=2.4e6)
    import numpy as np
    iq = modulator.add_awgn(iq, 20, np.random.default_rng(1))
    write_capture(path, iq)


def main() -> int:
    from tetraear_tpu.runtime.cache import enable_compile_cache
    enable_compile_cache()
    if len(sys.argv) > 1:
        path = Path(sys.argv[1])
    else:
        path = Path(tempfile.mkdtemp()) / "demo.cfile"
        make_demo_capture(path)
        print(f"[*] wrote demo capture: {path}")

    def on_frame(frame):
        line = (f"#{frame['number']:<3} {frame['type_name']:<14} "
                f"crc={'ok' if frame.get('burst_crc') else 'FAIL'}")
        if frame.get("sds_message"):
            line += f"  {frame['sds_message']}"
        print(line)

    cfg = PipelineConfig(sample_rate=2.4e6, detect_gate=False)
    pipe = Pipeline(cfg, on_frame=on_frame)
    stats = pipe.run(FileIQSource(path, sample_rate=2.4e6))
    print(f"[*] {stats.frames} frames, {stats.crc_pass} CRC-valid, "
          f"{stats.sds_messages} SDS messages")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
