"""Worker process for the real 2-process multi-host execution test.

Each process owns 2 local CPU devices; jax.distributed (gloo CPU
collectives) joins them into a 4-device global mesh.  make_host_mesh
lays carriers across processes (communication-free) and time inside
each process (halos stay inside a host), exactly the layout documented
in runtime/distributed.py.  The final sync-stat psum is the one
collective that crosses processes.

Run (from the test, one invocation per process, JAX_PLATFORMS=cpu):
    python tests/integration/dcn_worker.py <pid> <nproc> <coordinator>
"""

import os
import sys


def main() -> int:
    pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ.pop("XLA_FLAGS", None)       # no virtual-device override
    import jax
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.config.update("jax_num_cpu_devices", 2)

    sys.path.insert(0, os.path.join(os.path.dirname(__file__),
                                    "..", ".."))
    import numpy as np
    from tetraear_tpu.ref import modulator
    from tetraear_tpu.runtime import distributed
    from tetraear_tpu.runtime.sharding import ShardedDemod

    assert distributed.init_distributed(coord, nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 2 * nproc

    mesh = distributed.make_host_mesh(carriers_per_host=1)
    assert dict(mesh.shape) == {"carrier": nproc, "time": 2}, mesh.shape
    # carrier rows must be process-local device rows (time inside host)
    for r, row in enumerate(np.asarray(mesh.devices)):
        owners = {d.process_index for d in row}
        assert owners == {r}, (r, owners)

    # deterministic golden capture — identical on every process
    rng = np.random.default_rng(0)
    c = nproc
    offsets = [(i - c // 2) * 25_000 + 12_500 for i in range(c)]
    bits = [rng.integers(0, 2, 4600).astype(np.uint8) for _ in range(c)]
    iq = modulator.generate_multi_carrier(
        bits, fs=2.4e6, offsets_hz=offsets, snr_db=25,
        rng=np.random.default_rng(1))

    sd = ShardedDemod(fs=2.4e6, freqs_hz=offsets, mesh=mesh,
                      seg_len=72_000)
    out = sd.run(iq)

    # bit-exactness beyond warmup, same contract as test_sharding.py
    per_seg = int(sd.seg_len / 2.4e6 * 18_000)
    warmup = 64
    checked = 0
    for ci in range(c):
        tx = modulator.bits_to_symbols(bits[ci])
        for t in range(sd.n_time):
            v = out["valid"][ci, t].astype(bool)
            seg = out["hard"][ci, t][v]
            base = t * per_seg - 43
            for k in range(warmup, len(seg)):
                if 0 <= base + k < len(tx):
                    assert seg[k] == tx[base + k], (ci, t, k)
                    checked += 1
    assert checked > 1500, checked
    # random payload bits carry no training sequences; the psum itself
    # (crossing the process boundary via gloo) is the thing exercised
    assert out["sync_hits"] >= 0
    print(f"DCN OK pid={pid} mesh={dict(mesh.shape)} "
          f"checked={checked} sync_hits={out['sync_hits']}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
