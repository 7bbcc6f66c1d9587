"""Dense-fleet host path: worker-sharded frame layer on mixed traffic.

Generates a multi-carrier capture (clear SDS on three channels, a
TEA1-encrypted channel decrypted automatically with a common key),
decodes it through the offline S-blocks-per-dispatch runner with the per-hit frame
layer sharded over worker processes (frame.parallel.ShardedFrameLayer —
what `--frame-workers N` enables on the CLI), and prints the traffic
grouped by carrier.

Run:  PYTHONPATH=. python examples/dense_fleet.py
(add JAX_PLATFORMS=cpu to run it without a GPU)
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tetraear_tpu.crypto.tea import TEADecryptor  # noqa: E402
from tetraear_tpu.dsp.pipeline import CarrierBankDemod
from tetraear_tpu.frame.parallel import ShardedFrameLayer
from tetraear_tpu.ref import golden, modulator
from tetraear_tpu.runtime.stream import DecodeRunner


def main():
    from tetraear_tpu.runtime.cache import enable_compile_cache
    enable_compile_cache()
    fs = 2.304e6
    offsets = [(i - 3) * 25_000 + 12_500.0 for i in range(6)]
    texts = {0: "ENGINE 4 ON SCENE", 2: "BACKUP SECTOR 2",
             4: "UNITS HOLD POS"}
    key = bytes.fromhex("0123456789ABCDEF0123")      # a common TEA1 key
    secret = b"\x82COVERT OPS GO"
    cipher = TEADecryptor(key, "TEA1").encrypt(
        secret + b"\x00" * ((-len(secret)) % 8))

    streams = []
    for c in range(6):
        if c in texts:
            streams.append(golden.build_stream(
                [golden.sds_text_payload(texts[c])] * 4))
        elif c == 5:
            slots = [golden.build_slot(golden.build_mac_resource_data_bits(
                cipher, enc_mode=1, rng=np.random.default_rng(40 + i)))
                for i in range(4)]
            streams.append(np.concatenate(slots))
        else:
            streams.append(np.random.default_rng(50 + c).integers(
                0, 2, 2040).astype(np.uint8))
    iq = modulator.generate_multi_carrier(
        streams, fs=fs, offsets_hz=offsets, snr_db=25,
        rng=np.random.default_rng(60))

    bank = CarrierBankDemod(fs=fs, freqs_hz=offsets, frontend="fft")
    if len(iq) < 2 * bank.block_len:
        pad = 0.001 * np.random.default_rng(61).standard_normal(
            2 * bank.block_len - len(iq))
        iq = np.concatenate([iq, pad.astype(np.complex64)])

    layer = ShardedFrameLayer(len(offsets), n_workers=3,
                              auto_decrypt=True)
    try:
        runner = DecodeRunner(bank, layer, blocks_per_dispatch=2)
        out = runner.run(iq)
    finally:
        layer.close()

    by_carrier: dict = {}
    for f in out["frames"]:
        if not f.get("burst_crc"):
            continue          # noise decodes via the adaptive cascade
        by_carrier.setdefault(f["carrier"], []).append(f)
    for ci in sorted(by_carrier):
        fl = by_carrier[ci]
        msgs = sorted({f.get("sds_message") for f in fl
                       if f.get("sds_message")})
        dec = sum(1 for f in fl if f.get("decrypted"))
        print(f"carrier {ci} ({offsets[ci]/1e3:+.1f} kHz): "
              f"{len(fl)} frames"
              + (f", {dec} decrypted" if dec else ""))
        for m in msgs:
            print(f"    {m}")
    total = sum(len(v) for v in by_carrier.values())
    print(f"\n{total} frames across {len(by_carrier)} carriers "
          f"({runner.dispatches} device dispatches, 3 frame workers)")


if __name__ == "__main__":
    main()
