"""bench.py off the card: it refuses a non-GPU backend and lets any
failure surface as a non-zero exit (no fallback number)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def test_bench_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / "bench.py")], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "metric" not in r.stdout
    assert "needs a GPU backend" in r.stderr


def test_bench_failure_propagates(monkeypatch):
    sys.path.insert(0, str(REPO))
    import bench
    import jax

    def boom(*a, **k):
        raise RuntimeError("compile failed")

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(bench, "_card", lambda: "NVIDIA H100, 700.00 W")
    monkeypatch.setattr(bench, "run_bench", boom)
    with pytest.raises(RuntimeError, match="compile failed"):
        bench.main()
