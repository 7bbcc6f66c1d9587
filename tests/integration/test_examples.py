"""The examples/ scripts stay runnable (subprocess, CPU)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

ENV = {**os.environ, "JAX_PLATFORMS": "cpu",
       "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}


def _run(script: str, *argv: str):
    return subprocess.run(
        [sys.executable, str(REPO / "examples" / script), *argv],
        capture_output=True, text=True, timeout=600, env=ENV)


@pytest.mark.slow
def test_decode_capture_example():
    r = _run("decode_capture.py")
    assert r.returncode == 0, r.stderr
    assert "EXAMPLE CAPTURE" in r.stdout
    assert "SDS messages" in r.stdout


@pytest.mark.slow
def test_sharded_deployment_example():
    r = _run("sharded_deployment.py")
    assert r.returncode == 0, r.stderr
    assert "8 devices" in r.stdout
    assert "sync hits" in r.stdout


@pytest.mark.slow
def test_offair_fixture_example():
    r = _run("offair_fixture.py")
    assert r.returncode == 0, r.stderr
    assert "FIXTURE CAPTURE OK" in r.stdout
    assert "SECRET FIX MSG" in r.stdout
    assert "decrypted" in r.stdout


@pytest.mark.slow
def test_dense_fleet_example():
    r = _run("dense_fleet.py")
    assert r.returncode == 0, r.stderr
    assert "COVERT OPS GO" in r.stdout
    assert "ENGINE 4 ON SCENE" in r.stdout
    assert "3 frame workers" in r.stdout
