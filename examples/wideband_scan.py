"""One-shot wideband scan: find every TETRA channel in a capture.

Builds a 2.4 MHz band with three active carriers at arbitrary offsets,
then runs the WidebandScanner, which channelizes the whole band through
the FFT frontend and sync/CRC-verifies every 25 kHz channel at once::

    python examples/wideband_scan.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import numpy as np

from tetraear_tpu.ref import golden, modulator
from tetraear_tpu.scan.scanner import WidebandScanner


def main() -> int:
    from tetraear_tpu.runtime.cache import enable_compile_cache
    enable_compile_cache()
    fs = 2.4e6
    center = 392.5e6
    # channel grid is 25 kHz with half-channel offset (..., 12.5k, 37.5k, ...)
    active = (-287.5e3, 37.5e3, 462.5e3)
    rng = np.random.default_rng(0)
    parts = []
    for k, off in enumerate(active):
        bits = golden.build_stream(
            [golden.sds_text_payload("SCAN ME")] * 4, seed=k)
        parts.append(modulator.generate_carrier(bits, fs=fs,
                                                freq_offset_hz=off))
    n = min(len(p) for p in parts)
    iq = np.sum([p[:n] for p in parts], axis=0).astype(np.complex64)
    iq = modulator.add_awgn(iq, 20, rng)

    ws = WidebandScanner(fs=fs)
    results = ws.scan(iq, center_freq_hz=center)
    hits = [r for r in results if r["is_tetra"]]
    print(f"{'MHz':>10}  {'corr':>6}  {'CRC':>5}")
    for r in hits:
        print(f"{r['frequency_mhz']:10.4f}  {r['sync_correlation']:6.2f}"
              f"  {r['crc_pass_rate']:5.2f}")
    expect = sorted((center + o) / 1e6 for o in active)
    got = sorted(r["frequency_mhz"] for r in hits)
    print(f"[*] expected {expect} -> found {got}")
    return 0 if len(hits) == len(active) else 1


if __name__ == "__main__":
    raise SystemExit(main())
