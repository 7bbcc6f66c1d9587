"""Decode the checked-in recorded-style capture end to end.

Demonstrates the offline workflow on a realistic impaired recording
(LO offset + clock drift + multipath + noise, int16 wire format):
the S-blocks-per-dispatch runner, auto-decryption of the
TEA1-encrypted carrier, and the per-carrier summaries.

Run:  PYTHONPATH=. python examples/offair_fixture.py
(add JAX_PLATFORMS=cpu to run it without a GPU)
"""

import collections
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from tetraear_tpu.api import Pipeline, PipelineConfig
from tetraear_tpu.runtime.sources import FileIQSource

FIXTURE = pathlib.Path(__file__).parents[1] / "tests" / "fixtures" / \
    "offair_2carrier.cs16"


def main():
    from tetraear_tpu.runtime.cache import enable_compile_cache
    enable_compile_cache()
    frames = []
    cfg = PipelineConfig(
        sample_rate=2.4e6, frequency=392.5e6,
        carrier_offsets_hz=(12_500.0, -287_500.0),
        detect_gate=False, voice=False, auto_decrypt=True)
    pipe = Pipeline(cfg, on_frame=frames.append)
    pipe.run_offline(FileIQSource(FIXTURE, sample_rate=2.4e6),
                     blocks_per_dispatch=8)

    print(f"{len(frames)} frames in {pipe.dispatches} device dispatches")
    by_carrier = collections.defaultdict(list)
    for f in frames:
        by_carrier[f["carrier"]].append(f)
    for ci, fs in sorted(by_carrier.items()):
        crc = sum(1 for f in fs if f.get("burst_crc"))
        dec = sum(1 for f in fs if f.get("decrypted"))
        texts = {f.get("sds_message") for f in fs if f.get("sds_message")}
        print(f"carrier {ci} @ {fs[0]['frequency'] / 1e6:.4f} MHz: "
              f"{len(fs)} frames, {crc} CRC-pass, {dec} decrypted")
        for t in sorted(texts):
            print(f"   {t}")


if __name__ == "__main__":
    main()
