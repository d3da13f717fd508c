"""Where the threaded runner's time goes, against the synchronous driver.

    python -m eskf_lio_torch.utils.stream_probe          # on the card, from the repo root

Drives the same sequence through `Odometry.run` and `StreamingRunner.run`
in turns (each round starts one variant later), each variant changing one
thing about the second thread, and prints one JSON line per run: the step's
average time (the driver's own timer, which ends after the read-back), the
wall time per scan between
`on_scan` calls, and their difference — the time a scan spends outside the
step (waiting for the queue, the coverage gate).  A measuring tool: nothing
in the package imports it.

Variants:
  sync                the synchronous driver
  sync+idle_thread    the same, with a second thread alive but blocked
  threaded            the runner as shipped (queue depth 4)
  threaded,depth=1    the ingest thread at most one scan ahead
  threaded,switch=0.5ms   the interpreter's switch interval cut from 5 ms
  threaded,paced      the source sleeps 5 ms before each scan record, so the
                      ingest thread is mostly asleep while a step runs
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import torch

from eskf_lio_torch.bench import bench_sequence
from eskf_lio_torch.config import Config, ImuConfig
from eskf_lio_torch.io.dataset import LidarRecord
from eskf_lio_torch.pipeline.odometry import Odometry
from eskf_lio_torch.pipeline.stream import StreamingRunner, merged_stream


def paced(source, seconds: float):
    for rec in source:
        if isinstance(rec, LidarRecord):
            time.sleep(seconds)
        yield rec


def run_variant(name: str, config: Config, seq, device) -> dict:
    stamps: list[float] = []

    def on_scan(_):
        stamps.append(time.perf_counter())

    depth = 1 if "depth=1" in name else 4
    before = sys.getswitchinterval()
    stop = threading.Event()
    idle = threading.Thread(target=stop.wait, daemon=True)
    try:
        if "switch=" in name:
            sys.setswitchinterval(0.0005)
        if "idle_thread" in name:
            idle.start()
        if name.startswith("sync"):
            odo = Odometry(config, device=device)
            summary = odo.run(seq, on_scan=on_scan)
        else:
            runner = StreamingRunner(config, scan_queue_depth=depth, device=device)
            source = merged_stream(seq)
            summary = runner.run(paced(source, 0.005) if "paced" in name else source,
                                 on_scan=on_scan)
    finally:
        sys.setswitchinterval(before)
        stop.set()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall_ms = 1e3 * (stamps[-1] - stamps[1]) / (len(stamps) - 2)  # update scans only
    return dict(
        variant=name, scans=summary["num_scans"], avg_step_ms=summary["avg_step_ms"],
        wall_ms_per_scan=wall_ms, outside_step_ms=wall_ms - summary["avg_step_ms"],
        scans_per_s=summary["scans_per_sec"], diverged=summary["diverged"],
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--small", action="store_true",
                    help="8 scans of 6,000 points at 1/16 of the capacities: a rehearsal "
                    "of the tool on the CPU, not a measurement")
    args = ap.parse_args(argv)
    scans, points, raw_cap, cap_log2 = (8, 6000, 8192, 16) if args.small else (40, 120000, 131072, 19)

    from eskf_lio_torch import device as device_policy

    device = device_policy.resolve(args.device)
    # the HEAVY size and the bench sequence of `chip_smoke.py`
    config = Config(
        imu=ImuConfig(gravity=(0.0, 0.0, -9.81)), translation_noise=1e-3, rotation_noise=3e-4,
        max_raw_points=raw_cap, max_scan_points=raw_cap // 4, max_imu_per_scan=64,
        hash_capacity_log2=cap_log2,
    )
    seq = bench_sequence(scans, points)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(0)}")
    run_variant("sync", config, seq, device)  # warm-up, not reported
    variants = ("sync", "threaded", "sync+idle_thread", "threaded,depth=1",
                "threaded,switch=0.5ms", "threaded,paced")
    for r in range(args.rounds):
        # each round starts one variant later, so that none keeps its place
        for name in variants[r % len(variants):] + variants[: r % len(variants)]:
            print(json.dumps(run_variant(name, config, seq, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
