"""Tracing and per-stage throughput counters.

The reference has no profiling at all (SURVEY.md section 5.1); this module
provides the device-side equivalents:

  * Profiler — context manager around jax.profiler.trace writing
    TensorBoard-loadable traces (xplane) for kernel-level analysis;
  * StageTimers — host-side per-stage wall-time accounting with
    samples/s rates, for the streaming pipeline's steady-state numbers;
  * roofline_estimate — back-of-envelope FLOP/byte counts for the demod
    chain, to compare measured throughput against the HBM roofline;
  * DEVICE_PEAKS / device_peaks — published peak rates keyed by
    ``jax.devices()[0].device_kind``, the only denominators
    roofline_fraction divides by.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path


class Profiler:
    """jax.profiler wrapper: with Profiler('/tmp/trace'): run_workload()."""

    def __init__(self, trace_dir: str | Path = "/tmp/tetraear_trace"):
        self.trace_dir = str(trace_dir)

    def __enter__(self):
        import jax
        jax.profiler.start_trace(self.trace_dir)
        return self

    def __exit__(self, *exc):
        import jax
        jax.profiler.stop_trace()
        return False


class StageTimers:
    """Accumulate wall time per named stage; report rates."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.items = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
            self.items[name] += items

    def report(self) -> dict:
        out = {}
        for name, total in self.totals.items():
            entry = {
                "total_s": total,
                "calls": self.counts[name],
                "mean_ms": 1e3 * total / max(self.counts[name], 1),
            }
            if self.items[name]:
                entry["items_per_s"] = self.items[name] / max(total, 1e-12)
            out[name] = entry
        return out


def roofline_estimate(n_carriers: int, fs: float, frontend: str = "fft",
                      decim: int | None = None) -> dict:
    """Rough FLOPs and HBM bytes per input second for the demod chain.

    Used to sanity-check measured throughput: if achieved FLOP/s or
    bytes/s are far below chip peaks, the kernel is latency- or
    layout-bound, not roofline-bound.
    """
    import math
    decim = decim or max(1, int(round(fs / 96_000.0)))
    out96 = fs / decim
    out72 = 72_000.0
    c = n_carriers

    if frontend == "fft":
        nfft = fs / 10.0                       # 0.1 s blocks, amortized
        fft_flops = 5.0 * fs * math.log2(max(nfft, 2))      # forward, /s
        ifft_flops = c * 5.0 * out96 * math.log2(max(nfft / decim, 2))
        front_flops = fft_flops + ifft_flops + 6.0 * c * out96
        front_bytes = 8.0 * fs * 2 + c * out96 * 8.0 * 2
    else:
        # NCO (sincos ~ 20 flops) + stage-1 conv per carrier
        front_flops = c * fs * (20.0 + 8.0)
        front_bytes = c * fs * 8.0 * 2

    # back half per carrier: stage2 (~64 MAC/out at 72k), RRC (41 taps),
    # timing (~30 flops/sym), demod (~10)
    back_flops = c * (out72 * (64 + 41) * 2 + 18_000.0 * 40)
    back_bytes = c * out72 * 8.0 * 4
    # frame scan (dsp.framescan.frame_scan_sparse): dense 2x22 sync conv
    # at 36 kbit/s per carrier + CRC (33x230 matvec) at only the top-K
    # candidates per ~0.1 s block
    bits_per_s = 36_000.0
    k_cand_per_s = 64 / 0.1
    scan_flops = c * (bits_per_s * 2.0 * 2 * 22
                      + k_cand_per_s * 2.0 * 33 * 230)
    scan_bytes = c * (bits_per_s * (4.0 + 4.0) + k_cand_per_s * 230 * 4.0)
    return {
        "flops_per_s": front_flops + back_flops + scan_flops,
        "hbm_bytes_per_s": front_bytes + back_bytes + scan_bytes,
        "front_flops_per_s": front_flops,
        "scan_flops_per_s": scan_flops,
        "frontend": frontend,
    }


# Published dense peaks per device kind.  Source: NVIDIA H100 and H200
# Tensor Core GPU data sheets (SXM parts, no sparsity) and the Hopper
# architecture white paper.  fp32_flops is the non-tensor-core float32
# rate, the rate the Precision.HIGHEST float32 chain runs at.  These
# rates assume the card's full 700 W power limit.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12, "tf32_flops": 495e12, "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 SXM data sheet"},
    "NVIDIA H200": {
        "bf16_flops": 989e12, "tf32_flops": 495e12, "fp32_flops": 67e12,
        "hbm_bytes_per_s": 4.8e12,
        "source": "NVIDIA H200 SXM data sheet"},
}


def device_peaks(device_kind: str) -> dict:
    """Peak rates for ``device_kind``; an unknown device is an error."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add it "
            f"to runtime.profiling.DEVICE_PEAKS with its source") from None


def roofline_fraction(n_carriers: int, fs: float, rt_factor: float,
                      device_kind: str, frontend: str = "fft") -> dict:
    """Fraction of the device roofline the measured run achieves.

    rt_factor: measured realtime multiple (input seconds per wall
    second).  The denominators are device_peaks(device_kind): the
    float32 non-tensor rate (the chain runs float32 at HIGHEST
    precision) and the HBM bandwidth.
    """
    peaks = device_peaks(device_kind)
    peak_flops = peaks["fp32_flops"]
    peak_bw = peaks["hbm_bytes_per_s"]
    est = roofline_estimate(n_carriers, fs, frontend=frontend)
    flops = est["flops_per_s"]
    bbytes = est["hbm_bytes_per_s"]
    achieved_flops = flops * rt_factor
    achieved_bw = bbytes * rt_factor
    return {
        "roofline_pct": 100.0 * max(achieved_flops / peak_flops,
                                    achieved_bw / peak_bw),
        "achieved_tflops": achieved_flops / 1e12,
        "achieved_gbs": achieved_bw / 1e9,
        "bound": ("compute" if achieved_flops / peak_flops
                  >= achieved_bw / peak_bw else "memory"),
        "peaks_source": peaks["source"],
        "model_flops_per_input_s": flops,
        "model_bytes_per_input_s": bbytes,
    }
