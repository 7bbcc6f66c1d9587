"""Single-file executable build (tools/build_exe.py).

Parity: the reference ships a PyInstaller onefile build
(tetraear/tools/build_exe.py:34-60).  Here the zipapp onefile must
build, carry both native engines, and run the CLI with the natives
extracted and loaded from the per-version cache.
"""

import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
# build_zipapp bundles "what exists": without a compiler the archive
# legitimately carries no natives, so the native assertions skip with
# the build command in the reason (repo convention)
_HAVE_CXX = bool((shutil.which("g++") or shutil.which("c++"))
                 and shutil.which("make"))
needs_cxx = pytest.mark.skipif(
    not _HAVE_CXX,
    reason="no C++ toolchain: natives not bundled "
           "(make -C tetraear_tpu/{voice,frame}/csrc)")


@pytest.fixture(scope="module")
def app(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist") / "tetraear"
    r = subprocess.run(
        [sys.executable, "tools/build_exe.py", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return out


def test_onefile_contains_package(app):
    names = zipfile.ZipFile(app).namelist()
    assert "__main__.py" in names
    assert "tetraear_tpu/cli.py" in names
    assert os.access(app, os.X_OK)


@needs_cxx
def test_onefile_contains_natives(app):
    names = zipfile.ZipFile(app).namelist()
    assert "_natives/libtetracodec.so" in names
    assert "_natives/libhitparse.so" in names


def test_onefile_runs_cli(app, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XDG_CACHE_HOME=str(tmp_path / "cache"))
    r = subprocess.run([sys.executable, str(app), "--help"],
                       capture_output=True, text=True, timeout=120,
                       env=env, cwd=str(tmp_path))
    assert r.returncode == 0
    assert "decode" in r.stdout and "scan" in r.stdout
    if _HAVE_CXX:
        # the bootstrap must have extracted the bundled natives
        caches = list((tmp_path / "cache" / "tetraear-tpu")
                      .glob("*/*.so"))
        assert {p.name for p in caches} >= {"libtetracodec.so",
                                            "libhitparse.so"}
