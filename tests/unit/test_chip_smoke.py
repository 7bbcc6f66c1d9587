"""chip_smoke.py off the card: refusal paths, the result line, and the
CPU exactness of the formulations and traffic it uses on the card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _run(script: Path, cwd: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_cpu_backend():
    r = _run(REPO / "chip_smoke.py", REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU backend" in r.stderr


def test_refuses_outside_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_contract_line_shape():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.contract_line([Dev()] * 4)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


@pytest.mark.parametrize("n", [231, 1201, 2547, 5270])
def test_conv_scan_bit_identical(n):
    """The strided-conv frame scan compared in phase F gives the kept
    two-matmul formulation's verdicts bit for bit."""
    import jax.numpy as jnp
    from tetraear_tpu.dsp import framescan
    bits = jnp.asarray(np.random.default_rng(n).integers(
        0, 2, (3, n)).astype(np.uint8))
    want = framescan.frame_scan_packed_even(bits)
    got = chip_smoke.conv_scan(bits)
    for k in ("corr", "crc_err"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]))


@pytest.mark.parametrize("lg", [12, 15])
def test_four_step_fft_matches_numpy(lg):
    import jax.numpy as jnp
    rng = np.random.default_rng(lg)
    x = (rng.standard_normal(1 << lg)
         + 1j * rng.standard_normal(1 << lg)).astype(np.complex64)
    got = np.asarray(chip_smoke.four_step_fft(jnp.asarray(x)))
    assert chip_smoke.rel_err(got, np.fft.fft(x)) < 1e-5


def test_einsum_synth_matches_numpy_ifft():
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    band = (rng.standard_normal((3, 1024))
            + 1j * rng.standard_normal((3, 1024))).astype(np.complex64)
    got = np.asarray(chip_smoke.einsum_synth(jnp.asarray(band)))
    assert chip_smoke.rel_err(got, np.fft.ifft(band, axis=1)) < 1e-5


def test_band_plan_spread_and_seeded():
    plan = chip_smoke.band_plan(200, 26, 4, seed=5)
    keyed = sorted(plan["carriers"])
    assert len(keyed) >= 24 and keyed[0] == 0 and keyed[-1] == 199
    enc = [ci for ci, s in plan["carriers"].items() if s["key"]]
    assert len(enc) == 4 and 0 not in enc and 199 not in enc
    assert {0, 199} <= set(plan["compared"]) <= set(keyed)
    assert all(15.0 <= s["snr_db"] <= 25.0
               for s in plan["carriers"].values())
    assert plan == chip_smoke.band_plan(200, 26, 4, seed=5)


def test_aligned_equal_finds_lag_and_rejects_mismatch():
    rng = np.random.default_rng(0)
    ora = rng.integers(0, 4, 2000).astype(np.uint8)
    dev = ora[7:].copy()
    assert chip_smoke.aligned_equal(dev, ora) > 1500
    dev[900] ^= 1
    with pytest.raises(AssertionError, match="differ"):
        chip_smoke.aligned_equal(dev, ora)


def test_band_capture_keys_intended_channels():
    """The seeded band generator puts each keyed carrier's power in its
    own 25 kHz channel at the requested SNR over unit-power noise, and
    leaves the other channels at the noise floor; same seed, same IQ."""
    from tetraear_tpu.runtime.sources import ArrayIQSource, band_capture
    fs, n = 2.304e6, 1 << 17
    offsets = chip_smoke.grid_offsets(16)
    bits = np.random.default_rng(0).integers(0, 2, 6000).astype(np.uint8)
    keyed = {3: 25.0, 12: 15.0}
    iq = band_capture(fs, [(offsets[ci], bits, snr)
                           for ci, snr in keyed.items()], n, seed=4)
    assert len(iq) >= n and iq.dtype == np.complex64
    spec = np.abs(np.fft.fft(iq[:n])) ** 2 / n
    freqs = np.fft.fftfreq(n, 1.0 / fs)
    for ci, off in enumerate(offsets):
        band = np.abs(freqs - off) < 9_000.0          # symbol-rate band
        p = spec[band].mean()                          # noise alone: ~1
        if ci in keyed:
            assert p > 10.0, (ci, p)
        else:
            assert p < 1.5, (ci, p)
    assert np.array_equal(iq, band_capture(
        fs, [(offsets[ci], bits, snr) for ci, snr in keyed.items()], n,
        seed=4))
    src = ArrayIQSource(iq[:1000], fs)
    assert len(src.read_samples(600)) == 600
    assert len(src.read_samples(600)) == 400
    assert len(src.read_samples(600)) == 0
