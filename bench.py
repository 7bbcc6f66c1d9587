"""Benchmark: realtime TETRA carriers per card (one GPU).

Headline (the JSON line): END-TO-END IQ -> CRC-checked frame candidates.
The chained device program per block runs the full receive chain — FFT
channelizer (or NCO mix) -> polyphase resample -> RRC -> timing recovery
-> DQPSK -> bits -> sync correlation at every symbol-aligned position ->
burst CRC-16 error count at every possible frame start
(dsp.pipeline.block_step_scan) — with a carried on-device bit tail, and
reduces to per-block sync-hit / CRC-pass counters.

Timing: the per-block state is chained through S = BENCH_STEPS blocks in
one lax.scan (a data dependency the runtime cannot reorder), compiled
and warmed once, then timed on a second run that ends with fetching
values that depend on every block.  Host-side per-hit MAC/SDS parsing is
not in the loop: it is O(actual frames) and runs beside the device.

Extras: the demod-only chain, and a voice add-on (every carrier an
active call: two voice slots per carrier per block through the device
channel decoder and four speech frames through the device ACELP bank).

Environment: BENCH_CARRIERS (20480), BENCH_STEPS (20), BENCH_FRONTEND
(fft | conv), BENCH_MODE (both | e2e | demod | voice), BENCH_VOICE=0
(skip the voice add-on in both-mode), BENCH_NFFT_CAP (nfft cap,
default 2^26, 0 = none).

Refuses a backend other than "gpu".  Any failure exits non-zero.
Prints the card, platform, device_kind and device count, then ONE JSON
line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

UNIT = ("realtime carriers (25 kHz pi/4-DQPSK, IQ->sync+CRC-checked "
        "frames on device)")


def _make_bank(n_carriers: int, frontend: str):
    from tetraear_tpu.dsp import channelizer as chan_mod
    from tetraear_tpu.dsp.pipeline import CarrierBankDemod

    # capture bandwidth scales with the carrier count (25 kHz channel
    # grid + 15% guard); fs in the 72 kHz * 2^m family makes the channel
    # rate exactly 72 kHz, so the back half has no resample stage
    needed = max(9.216e6, n_carriers * 25_000 * 1.15)
    fs = 72_000.0 * 2 ** math.ceil(math.log2(needed / 72_000.0))
    offsets = [(i - n_carriers // 2) * 25_000 + 12_500
               for i in range(n_carriers)]
    # nfft cap: geometries past it run sequential overlap-save blocks of
    # the capped size (decode-equivalent, tests/unit/test_channelizer.py
    # ::test_nfft_cap_decode_equivalent)
    nfft = None
    if frontend == "fft":
        cap = int(os.environ.get("BENCH_NFFT_CAP", str(2 ** 26)))
        if cap and chan_mod.choose_nfft(fs) > cap:
            nfft = cap
    return CarrierBankDemod(fs=fs, freqs_hz=offsets, frontend=frontend,
                            nfft=nfft), fs


def _time_chain(chain_j, args, fetch) -> float:
    """Compile/warm once, then time a second run; fetch forces sync."""
    fetch(chain_j(*args))
    t0 = time.perf_counter()
    fetch(chain_j(*args))
    return time.perf_counter() - t0


def _scan_counters(scan):
    """(sync hits, sync hits whose frame start passes the CRC gate)."""
    import jax
    import jax.numpy as jnp
    from tetraear_tpu.dsp import framescan
    hits = scan["corr"] >= 0.90
    # sync at p <-> frame start p - 216: overlap of the two arrays
    off = framescan.TS_OFFSET_BITS // 2
    span = min(hits.shape[1] - off, scan["crc_err"].shape[1])
    sync_al = jax.lax.slice_in_dim(hits, off, off + span, 1, axis=1)
    crc_al = jax.lax.slice_in_dim(scan["crc_err"], 0, span, 1, axis=1)
    return (jnp.sum(hits.astype(jnp.int32)),
            jnp.sum((sync_al & (crc_al <= 2)).astype(jnp.int32)))


def run_bench(n_carriers: int, steps: int, frontend: str,
              mode: str) -> dict:
    import jax
    import jax.numpy as jnp
    from tetraear_tpu.dsp import kernels
    from tetraear_tpu.dsp.pipeline import TAILBITS, block_step_scan
    from tetraear_tpu.runtime.profiling import roofline_fraction

    bank, fs = _make_bank(n_carriers, frontend)
    block = bank.block_len
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(block)
         + 1j * rng.standard_normal(block)).astype(np.complex64)
    xd = jnp.asarray(kernels.c2r_np(x))
    tail0 = jnp.zeros((n_carriers, TAILBITS), jnp.uint8)
    block_s = block / fs
    res = {"n_carriers": n_carriers, "block_s": block_s, "steps": steps}

    def chain_e2e(x_r, state, tail, n):
        def body(carry, _):
            st, tl, nhit, nok = carry
            scan, st2, tl2, _n_c, _out = block_step_scan(bank, x_r, st, tl)
            h, k = _scan_counters(scan)
            return (st2, tl2, nhit + h, nok + k), None

        init = (state, tail, jnp.int32(0), jnp.int32(0))
        (st, _tl, nhit, nok), _ = jax.lax.scan(body, init, None, length=n)
        return st["timing"]["next_t"][0], nhit, nok

    def chain_demod(x_r, state, n):
        def body(st, _):
            out, st2 = bank._step_impl(x_r, st)
            return st2, out["hard"][:, 0]
        st, firsts = jax.lax.scan(body, state, None, length=n)
        return st["timing"]["next_t"][0], firsts[-1, 0]

    def chain_voice(x_r, state, tail, sstate, n):
        """e2e + sparse hit keys + two voice slots per carrier through
        jviterbi and four speech frames through jspeech, per block."""
        from tetraear_tpu.dsp.framescan import sparse_hits
        from tetraear_tpu.voice import jspeech, jviterbi
        from tetraear_tpu.voice.etsi_tables import TAB0, TAB1, TAB2

        pos = np.concatenate([TAB0, TAB1, TAB2]) - 1     # (137,)
        inv = jnp.asarray(np.argsort(pos).astype(np.int32))
        o1, o2 = 100, 500                                # slot offsets

        def unbuild(ordered, bfi):
            """(B, 286) ordered bits + (B,) bfi -> (B, 2, 138)."""
            fr = jnp.stack([ordered[:, 2 * inv], ordered[:, 2 * inv + 1]],
                           axis=1).astype(jnp.int32)
            b = jnp.broadcast_to(bfi[:, None, None].astype(jnp.int32),
                                 (fr.shape[0], 2, 1))
            return jnp.concatenate([b, fr], axis=2)

        def body(carry, _):
            st, tl, sst, nhit, nok, pacc = carry
            scan, st2, tl2, _n_c, out = block_step_scan(bank, x_r, st, tl)
            h, k = _scan_counters(scan)
            keys, counts = sparse_hits(scan["corr"], scan["crc_err"])
            soft = out["soft"]                           # (C, K, 2)
            s1 = jax.lax.slice_in_dim(soft, o1, o1 + 216, 1, axis=1)
            s2 = jax.lax.slice_in_dim(soft, o2, o2 + 216, 1, axis=1)
            sb = jnp.concatenate([s1, s2], axis=0)
            sb = jnp.round(sb.reshape(sb.shape[0], 432)
                           * 127.0).astype(jnp.int32)
            ordered, bfi = jviterbi.channel_decode_batch_traced(sb)
            c = n_carriers
            frames = jnp.concatenate([unbuild(ordered[:c], bfi[:c]),
                                      unbuild(ordered[c:], bfi[c:])],
                                     axis=1)                 # (C, 4, 138)
            sst2, pcm = jspeech.decode_block(sst, frames,
                                             jnp.ones((c, 4), bool))
            pacc = (pacc + jnp.sum(pcm[:, :, 0].astype(jnp.int32))
                    + keys[0, 0] + counts[0])
            return (st2, tl2, sst2, nhit + h, nok + k, pacc), None

        init = (state, tail, sstate, jnp.int32(0), jnp.int32(0),
                jnp.int32(0))
        (st, _tl, _s, nhit, nok, pacc), _ = jax.lax.scan(
            body, init, None, length=n)
        return st["timing"]["next_t"][0], nhit, nok, pacc

    def fetch(out):
        return [np.asarray(v) for v in out]

    if mode in ("e2e", "both"):
        elapsed = _time_chain(jax.jit(chain_e2e, static_argnums=3),
                              (xd, bank.init_state(), tail0, steps), fetch)
        res["rt_factor"] = steps * block_s / elapsed
        res["elapsed_s"] = elapsed
    if mode in ("demod", "both"):
        elapsed = _time_chain(jax.jit(chain_demod, static_argnums=2),
                              (xd, bank.init_state(), steps), fetch)
        res["demod_rt_factor"] = steps * block_s / elapsed
        if mode == "demod":
            res["rt_factor"] = res["demod_rt_factor"]
            res["elapsed_s"] = elapsed
    if mode == "voice" or (mode == "both"
                           and os.environ.get("BENCH_VOICE") != "0"):
        from tetraear_tpu.voice import jspeech
        elapsed = _time_chain(
            jax.jit(chain_voice, static_argnums=4),
            (xd, bank.init_state(), tail0, jspeech.init_state(n_carriers),
             steps), fetch)
        res["voice_rt_factor"] = steps * block_s / elapsed
        if mode == "voice":
            res["rt_factor"] = res["voice_rt_factor"]
            res["elapsed_s"] = elapsed
    res["input_msps"] = steps * block / res["elapsed_s"] / 1e6
    res["roofline"] = roofline_fraction(
        n_carriers, fs, res["rt_factor"], jax.devices()[0].device_kind,
        frontend=frontend)
    return res


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    import jax
    if jax.default_backend() != "gpu":
        print(f"bench: needs a GPU backend, JAX has "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    from tetraear_tpu.runtime.cache import enable_compile_cache
    enable_compile_cache()
    n_carriers = int(os.environ.get("BENCH_CARRIERS", "20480"))
    steps = int(os.environ.get("BENCH_STEPS", "20"))
    frontend = os.environ.get("BENCH_FRONTEND", "fft")
    mode = os.environ.get("BENCH_MODE", "both")
    dev = jax.devices()
    card = _card()
    print(f"card: {card}", flush=True)
    print(f"platform {dev[0].platform} device_kind {dev[0].device_kind!r} "
          f"count {len(dev)}", flush=True)

    r = run_bench(n_carriers, steps, frontend, mode)
    value = r["rt_factor"] * n_carriers
    line = {
        "metric": "realtime_tetra_carriers_per_card",
        "value": value,
        "unit": UNIT,
        "vs_baseline": value / 1.0,
        # carriers DEMONSTRATED in realtime: the C in the program, and
        # only when rt_factor >= 1 (value extrapolates the rate)
        "concurrent_carriers": n_carriers if r["rt_factor"] >= 1.0 else 0,
        "rt_factor": r["rt_factor"],
        "platform": dev[0].platform,
        "device_kind": dev[0].device_kind,
        "device_count": len(dev),
        "card": card,
        "roofline_pct": r["roofline"]["roofline_pct"],
        "roofline_peaks": r["roofline"]["peaks_source"],
    }
    if "demod_rt_factor" in r and mode == "both":
        line["demod_only_carriers"] = r["demod_rt_factor"] * n_carriers
    if "voice_rt_factor" in r:
        line["voice_carriers_rt"] = r["voice_rt_factor"] * n_carriers
    print(f"# n_carriers={n_carriers} rt_factor={r['rt_factor']:.3f} "
          f"input={r['input_msps']:.0f} Msps elapsed={r['elapsed_s']:.3f}s "
          f"steps={steps} ({r['roofline']['bound']}-bound model: "
          f"{r['roofline']['achieved_tflops']:.2f} TF/s, "
          f"{r['roofline']['achieved_gbs']:.0f} GB/s)", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
