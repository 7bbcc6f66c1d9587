"""Multi-device deployment: the carrier x time shard_map demodulator.

Demonstrates the production scaling path (runtime/sharding.py): carriers
sharded across one mesh axis, the time stream across the other, input
halos exchanged with ppermute between neighbouring devices.  Runs anywhere
by simulating an 8-device mesh on CPU — on a multi-GPU host, drop the two
environment overrides and the identical code spreads across the cards::

    python examples/sharded_deployment.py
"""

import os

# Simulate 8 devices on CPU so the example runs on any machine.
# On a multi-GPU host, delete these two lines.
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402


def main() -> int:
    from tetraear_tpu.runtime.cache import enable_compile_cache
    enable_compile_cache()
    import jax

    # The env vars above are enough on a vanilla install, but some site
    # configs register an accelerator regardless — force the simulated
    # CPU mesh unless the user asks for real devices with --real.
    if "--real" not in sys.argv:
        jax.config.update("jax_platforms", "cpu")

    from tetraear_tpu.ref import golden, modulator
    from tetraear_tpu.runtime.sharding import ShardedFFTDemod, make_mesh

    devs = jax.devices()
    print(f"[*] {len(devs)} devices: {devs[0].platform}")

    # 2 carrier shards x 4 time shards over the 8 devices
    mesh = make_mesh(2, 4)

    fs = 2.4e6
    offsets = (-300e3, -25e3, 25e3, 300e3)
    rng = np.random.default_rng(0)
    parts = []
    for k, off in enumerate(offsets):
        bits = golden.build_stream(
            [golden.sds_text_payload("SHARDED DECODE")] * 4, seed=k)
        parts.append(modulator.generate_carrier(bits, fs=fs,
                                                freq_offset_hz=off))
    n = min(len(p) for p in parts)
    iq = np.sum([p[:n] for p in parts], axis=0).astype(np.complex64)
    iq = modulator.add_awgn(iq, 20, rng)

    demod = ShardedFFTDemod(fs=fs, freqs_hz=offsets, mesh=mesh)
    need = demod.n_time * demod.seg_len
    if len(iq) < need:   # pad the demo capture to a whole mesh block
        tail = 0.001 * (rng.standard_normal(need - len(iq)) * (1 + 1j))
        iq = np.concatenate([iq, tail.astype(np.complex64)])
    out = demod.run(iq[:need])
    print(f"[*] hard symbols {out['hard'].shape} "
          f"(carrier x time-shard x sym) across a "
          f"{dict(mesh.shape)} mesh, {out['sync_hits']} sync hits")

    # --- the voice fleet axis: shard the ACELP slot bank ------------
    # Voice scales by devices: the pool's slot axis shards over a
    # mesh with zero collectives in the decode body, PCM bit-identical
    # at any mesh size.
    from jax.sharding import Mesh
    from tetraear_tpu.voice.jspeech_pool import DeviceSpeechPool

    vmesh = Mesh(np.array(devs[:8]), ("voice",))
    pool = DeviceSpeechPool(slots=8, mesh=vmesh)
    frames = np.zeros((3, 138), np.int16)
    frames[:, 1:] = rng.integers(0, 2, (3, 137))
    pcm = pool.synthesize([(0, frames)])[0]
    print(f"[*] voice: {len(pcm)} PCM samples decoded on the "
          f"{vmesh.shape['voice']}-device voice mesh")

    # --- fleet decrypt: keys x frames sharded over the mesh ---------
    from tetraear_tpu.crypto.batch import tea_key_search

    payloads = rng.integers(0, 256, (64, 16), dtype=np.uint8)
    keys = [bytes(rng.integers(0, 256, 10, dtype=np.uint8).tolist())
            for _ in range(8)]
    res = tea_key_search(payloads, keys, "TEA1", mesh=vmesh)
    print(f"[*] crypto: {len(keys)} keys x {len(payloads)} frames "
          f"searched on the mesh, best scores "
          f"{res['best_score'][:4].tolist()} ...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
