"""Command-line interface.

Equivalent of the reference entry point (tetraear/ui/modern.py:5408-5569 +
tetraear/__main__.py): the same flags (-f/-g/-s/--scan/--auto-decrypt/-v)
plus subcommands exposing the headless workload tools that the reference
ships as root scripts (listen_clear.py, continuous_capture.py,
decrypt_capture.py, bruteforce_keys.py, ...).

Default command is ``listen`` — the CLI listener (modern.py:5334-5405):
colorized frame/status printout from the streaming pipeline.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

C_RESET = "\x1b[0m"
C_GREEN = "\x1b[32m"
C_YELLOW = "\x1b[33m"
C_RED = "\x1b[31m"
C_CYAN = "\x1b[36m"
C_MAGENTA = "\x1b[35m"
C_DIM = "\x1b[2m"


class CLIListener:
    """Colorized frame printer (modern.py:5334-5405)."""

    def __init__(self, show_invalid: bool = False):
        self.show_invalid = show_invalid
        self.count = 0

    def on_frame(self, frame: dict) -> None:
        self.count += 1
        if not self.show_invalid and frame.get("valid") is False:
            return
        crc = frame.get("burst_crc")
        crc_s = (f"{C_GREEN}CRC✓{C_RESET}" if crc
                 else f"{C_RED}CRC✗{C_RESET}")
        enc = frame.get("encrypted")
        if enc and frame.get("decrypted"):
            enc_s = f"{C_MAGENTA}DEC[{frame.get('encryption_algorithm')}]" \
                f"{C_RESET}"
        elif enc:
            enc_s = f"{C_YELLOW}ENC[{frame.get('encryption_algorithm')}]" \
                f"{C_RESET}"
        else:
            enc_s = f"{C_GREEN}CLR{C_RESET}"
        line = (f"#{self.count:<5} {frame.get('type_name', '?'):<14} "
                f"car{frame.get('carrier', 0)} {crc_s} {enc_s}")
        meta = frame.get("call_metadata")
        if meta:
            if meta.get("talkgroup_id"):
                line += f" TG={meta['talkgroup_id']}"
            if meta.get("source_ssi"):
                line += f" SSI={meta['source_ssi']}"
            if meta.get("mcc"):
                from tetraear_tpu.frame import mcc_mnc
                line += (f" {C_CYAN}"
                         f"{mcc_mnc.get_location_info(meta['mcc'], meta.get('mnc'))}"
                         f"{C_RESET}")
        sds = frame.get("sds_message")
        if sds:
            line += f"\n      {C_CYAN}💬 {sds}{C_RESET}"
        if frame.get("has_voice"):
            line += f" {C_GREEN}🔊{C_RESET}"
        print(line)

    def on_status(self, status: str) -> None:
        print(f"{C_DIM}[status] {status}{C_RESET}", file=sys.stderr)


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("-f", "--frequency", type=float, default=392.5,
                   help="centre frequency in MHz (default 392.5)")
    p.add_argument("-s", "--sample-rate", type=float, default=2.4,
                   help="sample rate in Msps (default 2.4)")
    p.add_argument("-g", "--gain", default="auto",
                   help="SDR gain ('auto' or dB)")
    p.add_argument("--source", default="rtlsdr",
                   help="IQ source: 'rtlsdr', 'synthetic[:off1,...]' or a "
                        "capture file path")
    p.add_argument("--offsets", default="0",
                   help="comma-separated carrier offsets in Hz to "
                        "demodulate (default: 0 = centre channel)")
    p.add_argument("--auto-decrypt", action="store_true", default=True)
    p.add_argument("--no-auto-decrypt", dest="auto_decrypt",
                   action="store_false")
    p.add_argument("-k", "--keys", help="key file (ALG:ID:HEX per line)")
    p.add_argument("--records-dir", help="directory for JSONL + raw dumps")
    p.add_argument("--expected-mcc", type=int,
                   help="expected country MCC for validation (e.g. 260)")
    p.add_argument("--frame-workers", type=int, default=0,
                   help="shard the per-hit frame layer over N worker "
                        "processes (0 = in-process)")
    p.add_argument("--voice-threads", type=int, default=0,
                   help="synthesize voice carriers on N threads "
                        "(0 = sequential)")
    p.add_argument("--max-blocks", type=int,
                   help="stop after N blocks (default: run to EOF)")
    p.add_argument("-v", "--verbose", action="store_true")


def _make_pipeline(args, on_frame=None, on_audio=None, on_status=None):
    from tetraear_tpu.api import Pipeline, PipelineConfig
    offsets = tuple(float(o) for o in str(args.offsets).split(","))
    cfg = PipelineConfig(
        sample_rate=args.sample_rate * 1e6,
        frequency=args.frequency * 1e6,
        carrier_offsets_hz=offsets,
        auto_decrypt=args.auto_decrypt,
        key_file=args.keys,
        records_dir=args.records_dir,
        expected_mcc=args.expected_mcc,
        detect_gate=args.source == "rtlsdr",
        frame_workers=getattr(args, "frame_workers", 0),
        voice_threads=getattr(args, "voice_threads", 0),
    )
    return Pipeline(cfg, on_frame=on_frame, on_audio=on_audio,
                    on_status=on_status)


def _open_source(args):
    from tetraear_tpu.runtime.sources import open_source
    return open_source(args.source, sample_rate=args.sample_rate * 1e6,
                       frequency=args.frequency * 1e6, gain=args.gain)


def cmd_listen(args) -> int:
    listener = CLIListener(show_invalid=args.show_invalid)
    pipe = _make_pipeline(args, on_frame=listener.on_frame,
                          on_status=listener.on_status)
    src = _open_source(args)
    print(f"Listening on {args.frequency:.4f} MHz "
          f"({len(pipe.bank.freqs_hz)} carrier(s), source={args.source}) — "
          f"Ctrl-C to stop")
    try:
        stats = pipe.run(src, max_blocks=args.max_blocks)
    except KeyboardInterrupt:
        stats = pipe.stats
        print("\nstopped")
    summary = stats.as_dict()
    summary["activity"] = pipe.aggregator.snapshot()
    summary["tdma"] = [t.stats() for t in pipe.trackers
                       if t.slot_counter]
    print(json.dumps(summary, indent=2, default=str))
    return 0


def cmd_scan(args) -> int:
    from tetraear_tpu.utils.logging import setup_logging
    setup_logging(args.verbose)
    if args.wideband:
        from tetraear_tpu.scan.scanner import WidebandScanner
        src = _open_source(args)
        with src:
            iq = src.read_samples(int(args.sample_rate * 1e6 * args.dwell))
        ws = WidebandScanner(fs=args.sample_rate * 1e6)
        results = ws.scan(np.asarray(iq), center_freq_hz=args.frequency * 1e6)
        hits = [r for r in results if r["is_tetra"]]
        print(f"{'MHz':>10}  {'corr':>6}  {'CRC':>5}  {'frames':>6}")
        for r in sorted(results, key=lambda r: -r["confidence"])[:20]:
            mark = " *" if r["is_tetra"] else ""
            print(f"{r['frequency_mhz']:10.4f}  {r['sync_correlation']:6.2f}"
                  f"  {r['crc_pass_rate']:5.2f}  {r['n_frames']:6d}{mark}")
        print(f"{len(hits)} active TETRA channel(s)")
        return 0
    from tetraear_tpu.scan.scanner import FrequencyScanner
    src = _open_source(args)
    if not src.open():
        print("failed to open source", file=sys.stderr)
        return 1
    try:
        sc = FrequencyScanner(src, sample_rate=args.sample_rate * 1e6)
        found = sc.scan_range(args.start * 1e6, args.stop * 1e6)
        sc.found_channels = found
        sc.print_found_channels()
        for ch in found:
            print(f"{ch['frequency_mhz']:.4f} MHz  power="
                  f"{ch['power_db']:.1f} dB  conf={ch['confidence']:.2f}")
    finally:
        src.close()
    return 0


def cmd_decode_file(args) -> int:
    """Offline decode of a recorded capture -> frames on stdout/JSONL.

    Uses the S-blocks-per-dispatch runner (Pipeline.run_offline) so long
    captures pay one dispatch and host round trip per S blocks."""
    listener = CLIListener(show_invalid=args.show_invalid)
    pipe = _make_pipeline(args, on_frame=listener.on_frame)
    src = _open_source(args)
    stats = pipe.run_offline(src, blocks_per_dispatch=args.dispatch_blocks,
                             max_blocks=args.max_blocks)
    summary = stats.as_dict()
    summary["device_dispatches"] = pipe.dispatches
    summary["activity"] = pipe.aggregator.snapshot()
    summary["tdma"] = [t.stats() for t in pipe.trackers
                       if t.slot_counter]
    print(json.dumps(summary, indent=2, default=str))
    return 0


def cmd_bench(args) -> int:
    # a child process: this parent must not open the device first (a
    # JAX process reserves most of the card's memory on first use)
    import subprocess
    return subprocess.call([sys.executable,
                            str(__import__("pathlib").Path(__file__)
                                .resolve().parents[1] / "bench.py")])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tetraear_tpu",
        description="TETRA IQ-processing framework on JAX accelerators")
    sub = parser.add_subparsers(dest="command")

    p_listen = sub.add_parser("listen", help="realtime/headless listener")
    _add_common(p_listen)
    p_listen.add_argument("--show-invalid", action="store_true")
    p_listen.set_defaults(func=cmd_listen)

    p_scan = sub.add_parser("scan", help="scan for TETRA channels")
    _add_common(p_scan)
    p_scan.add_argument("start", type=float, nargs="?", default=390.0,
                        help="start MHz")
    p_scan.add_argument("stop", type=float, nargs="?", default=395.0,
                        help="stop MHz")
    p_scan.add_argument("--wideband", action="store_true",
                        help="one-shot all-channel scan of a single capture")
    p_scan.add_argument("--dwell", type=float, default=0.2)
    p_scan.set_defaults(func=cmd_scan)

    p_dec = sub.add_parser("decode", help="offline decode of a capture file")
    _add_common(p_dec)
    p_dec.add_argument("--show-invalid", action="store_true")
    p_dec.add_argument("--dispatch-blocks", type=int, default=16,
                       help="blocks fused per device dispatch (default 16)")
    p_dec.set_defaults(func=cmd_decode_file)

    p_bench = sub.add_parser("bench", help="run the throughput benchmark")
    p_bench.set_defaults(func=cmd_bench)

    for name, module in [
            ("listen-clear", "listen_clear"),
            ("continuous-capture", "continuous_capture"),
            ("decrypt-capture", "decrypt_capture"),
            ("bruteforce-keys", "bruteforce_keys"),
            ("generate-keys", "generate_common_keys"),
            ("analyze-text", "analyze_text"),
            ("verify-codec", "verify_codec"),
            ("auto-capture", "auto_capture"),
            ("build-release", "build_release"),
    ]:
        p = sub.add_parser(name, help=f"tool: {module}", add_help=False)
        p.set_defaults(tool_module=module)

    args, rest = parser.parse_known_args(argv)
    if getattr(args, "tool_module", None):
        import importlib
        mod = importlib.import_module(
            f"tetraear_tpu.tools.{args.tool_module}")
        return mod.main(rest)
    if not getattr(args, "command", None):
        parser.print_help()
        return 0
    if getattr(args, "verbose", False):
        from tetraear_tpu.utils.logging import setup_logging
        setup_logging(True)
    if args.command != "bench":
        from tetraear_tpu.runtime.cache import enable_compile_cache
        enable_compile_cache()
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
