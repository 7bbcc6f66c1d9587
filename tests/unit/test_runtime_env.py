"""Runtime environment: compile-cache location, device peak table, and
host-only frame workers."""

import multiprocessing as mp

import pytest

from tetraear_tpu.runtime import cache, profiling


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.compile_cache_dir()
    assert path == str(cache.CHECKOUT / ".jax_cache")
    assert (cache.CHECKOUT / "tetraear_tpu" / "__init__.py").is_file()


@pytest.mark.parametrize("kind", sorted(profiling.DEVICE_PEAKS))
def test_device_peaks_known_kinds(kind):
    p = profiling.device_peaks(kind)
    assert p["source"]
    assert p["bf16_flops"] > p["tf32_flops"] > p["fp32_flops"] > 0
    assert p["hbm_bytes_per_s"] > 1e12


def test_device_peaks_unknown_kind_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        profiling.device_peaks("Unlisted Accelerator 9000")


def test_roofline_fraction_uses_peak_table():
    kind = "NVIDIA H100 80GB HBM3"
    r = profiling.roofline_fraction(1024, 36.864e6, 1.0, kind)
    peaks = profiling.device_peaks(kind)
    est = profiling.roofline_estimate(1024, 36.864e6)
    want = 100.0 * max(est["flops_per_s"] / peaks["fp32_flops"],
                       est["hbm_bytes_per_s"] / peaks["hbm_bytes_per_s"])
    assert r["roofline_pct"] == pytest.approx(want)
    assert r["peaks_source"] == peaks["source"]
    with pytest.raises(ValueError):
        profiling.roofline_fraction(1024, 36.864e6, 1.0, "cpu")


def test_frame_workers_spawn_host_only(monkeypatch):
    """Frame workers start with JAX_PLATFORMS=cpu (they must never open
    the accelerator the parent process holds), and the parent's own
    environment is restored afterwards."""
    from tetraear_tpu.frame.parallel import ShardedFrameLayer
    import os
    seen = []
    orig = mp.context.SpawnProcess.start

    def start(self):
        seen.append(os.environ.get("JAX_PLATFORMS"))
        return orig(self)

    monkeypatch.setattr(mp.context.SpawnProcess, "start", start)
    monkeypatch.setenv("JAX_PLATFORMS", "gpu")
    layer = ShardedFrameLayer(4, n_workers=2, auto_decrypt=False)
    try:
        assert seen == ["cpu", "cpu"]
        assert os.environ["JAX_PLATFORMS"] == "gpu"
    finally:
        layer.close()
