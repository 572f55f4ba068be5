#!/usr/bin/env python3
"""Offline scan of a recorded IQ capture through the PyTorch/CUDA port.

Drives the port's runtime (Scanner -> SdrDevice -> block steps ->
TransmissionTracker -> recorder slots; with --channels, WidebandScanner over
the polyphase channelizer) over a replayed file and reports the detected
transmissions; optionally writes each recording to a .cs8 file. The flags,
the JSON summary and the recording files are scripts/scan_file.py's.

Runs on the card; --cpu runs the plain PyTorch versions on the CPU.

Usage:
  python scripts/scan_file_torch.py --file x.cs8 --rate 2048000 --start 144e6
  python scripts/scan_file_torch.py --file x.cf32 --rate 256000 \
      --center 145e6 --out-dir recordings --json
  python scripts/scan_file_torch.py --file x.cs8 --rate 2048000 \
      --center 145e6 --channels 16 --json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--file", required=True, help="IQ capture path")
    parser.add_argument(
        "--format", default=None, choices=["cf32", "cs8", "cu8"],
        help="sample format (default: from file extension)",
    )
    parser.add_argument("--rate", type=float, required=True, help="sample rate [Hz]")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--start", type=float, help="range start [Hz] (stop = start+rate)")
    group.add_argument("--center", type=float, help="capture center [Hz]")
    parser.add_argument("--start-level", type=float, default=8.0, help="dB over noise to start")
    parser.add_argument("--stop-level", type=float, default=5.0, help="dB over noise to stop")
    parser.add_argument("--min-time-ms", type=int, default=1000)
    parser.add_argument("--max-noise-time-ms", type=int, default=2000)
    parser.add_argument("--recording-rate", type=int, default=16000, help="min_sample_rate")
    parser.add_argument("--recorders", type=int, default=2)
    parser.add_argument("--full-rows", action="store_true", help="full-row detection (parity mode)")
    parser.add_argument(
        "--channels", type=int, default=0,
        help="wideband mode: split the capture into N sub-bands scanned "
             "concurrently (polyphase channelizer)",
    )
    parser.add_argument(
        "--oversample", action="store_true",
        help="with --channels: 2x-oversampled bank (edge-flat sub-bands)",
    )
    parser.add_argument("--out-dir", default=None, help="write recordings as .cs8 files here")
    parser.add_argument("--json", action="store_true", help="print a JSON summary line")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (plain PyTorch versions)")
    args = parser.parse_args()

    import numpy as np

    from rtl_sdr_scanner_tpu_torch.runtime.config import Config, default_config_json
    from rtl_sdr_scanner_tpu_torch.runtime.data_controller import decode_transmission
    from rtl_sdr_scanner_tpu_torch.runtime.mqtt_client import NullMqtt
    from rtl_sdr_scanner_tpu_torch.runtime.scanner import Scanner
    from rtl_sdr_scanner_tpu_torch.runtime.wideband import WidebandScanner
    from rtl_sdr_scanner_tpu_torch.utils import logger
    from rtl_sdr_scanner_tpu_torch.utils.radio_utils import get_range_split_sample_rate

    device = "cpu" if args.cpu else None
    rate = int(args.rate)
    center = int(args.center) if args.center else int(args.start) + rate // 2
    # one parked hop (scanner.cpp:40-44): size the scanned range to the
    # band-hop split rate so the scanner never hops away mid-capture
    span = min(rate, get_range_split_sample_rate(rate))
    fmt = args.format or {
        ".cf32": "cf32", ".cs8": "cs8", ".cu8": "cu8", ".fc": "cf32",
    }.get(os.path.splitext(args.file)[1], "cf32")

    raw = default_config_json()
    raw["recording"] = {
        "max_noise_time_ms": args.max_noise_time_ms,
        "min_sample_rate": args.recording_rate,
        "min_time_ms": args.min_time_ms,
        "step": 2500,
    }
    raw["tunables"] = {"compact_detection": not args.full_rows}
    if args.channels >= 2:
        span = rate  # the channelizer watches the whole capture at once
        raw["tunables"]["channelizer_oversample"] = 2 if args.oversample else 1
    raw["devices"] = [
        {
            "enabled": True,
            "serial": os.path.basename(args.file),
            "driver": "replay",
            "sample_rate": rate,
            "start_recording_level": args.start_level,
            "stop_recording_level": args.stop_level,
            "gains": [],
            "ranges": [{"start": center - span // 2, "stop": center + span // 2}],
            "file": args.file,
            "file_format": fmt,
            "channels": args.channels,
        }
    ]
    raw["workers"] = args.recorders
    config = Config(raw)

    logger.configure()
    mqtt = NullMqtt()
    mqtt.keep_payloads = True
    kind = WidebandScanner if args.channels >= 2 else Scanner
    scanner = kind(config, config.devices[0], mqtt, recorders_count=args.recorders, device=device)
    scanner.run_to_completion()

    # group transmission payloads by recorded band
    by_band = {}
    for topic, payload in mqtt.published:
        if not topic.endswith("/transmission/uint8"):
            continue
        t0, start, stop, rec_rate, iq = decode_transmission(payload)
        entry = by_band.setdefault((start + stop) // 2, {"t0": t0, "chunks": [], "rate": rec_rate})
        entry["chunks"].append(iq)

    results = []
    for band_center, entry in sorted(by_band.items()):
        samples = np.concatenate(entry["chunks"]) if entry["chunks"] else np.empty((0, 2))
        seconds = len(samples) / entry["rate"]
        results.append(
            {
                "frequency": int(band_center),
                "first_ms": int(entry["t0"]),
                "seconds": round(seconds, 3),
                "samples": int(len(samples)),
                "sample_rate": int(entry["rate"]),
            }
        )
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            name = f"recording_{entry['t0']}_{band_center}Hz_{entry['rate']}.raw.cs8"
            samples.astype(np.int8).tofile(os.path.join(args.out_dir, name))
            results[-1]["file"] = os.path.join(args.out_dir, name)

    if args.json:
        print(json.dumps({"transmissions": results}))
    else:
        if not results:
            print("no transmissions detected")
        for r in results:
            line = (
                f"transmission @ {r['frequency']} Hz: {r['seconds']} s"
                f" ({r['samples']} samples @ {r['sample_rate']} Hz)"
            )
            if "file" in r:
                line += f" -> {r['file']}"
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
