"""The sharded step at D = 1, 2, 4 and 8 shards (port of
`tools/bench_scaling_mesh.py`), through `ShardedOdometry` in one process.

The JAX script spreads the shards over a virtual CPU mesh of D devices; the
port keeps every shard on its one device (`ShardedOdometry`, one process),
so on the card the time grows with D where each shard's work shrinks: this
is not a multi-chip curve, and every line says so
(`"shards_on_one_device": true`).  What it does show: each shard's slice
(`slice_capacity(N, D, slack)`) and map rows (C / D) scale as 1/D, and what
D shards cost one card.

    python -m eskf_lio_torch.tools.bench_scaling_mesh [--device cpu] [K]

The config and sequence are the JAX script's (16,384 raw / 8,192 scan
points, 48 IMU samples a chunk, a 2^16-row map; 1.6 s at 12,000 points a
sweep, seed 3).  Each D warms up on 3 scans (on the card: the step's
capture), then K (default 6) scans are timed on the host's clock, each
ending in `process_scan`'s read-back.  One JSON line per D: the JAX keys, plus
the capture's seconds and nodes, and the timed scans' kernel launches
counted on the device beside the GN iterations, scans and predict calls
(a scan's and an overflow pre-advance's) they must match.
Then the device line.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from eskf_lio_torch import bench, tools
from eskf_lio_torch import device as device_policy
from eskf_lio_torch.config import Config, ImuConfig
from eskf_lio_torch.io import dataset
from eskf_lio_torch.parallel import sharded_map as sh

DEVICES = (1, 2, 4, 8)
K = 6
WARM_SCANS = 3


def make_config() -> Config:
    return Config(imu=ImuConfig(gravity=(0.0, 0.0, -9.81)), max_raw_points=16384,
                  max_scan_points=8192, max_imu_per_scan=48, hash_capacity_log2=16)


def make_sequence() -> dataset.Sequence:
    return dataset.make_synthetic_sequence(duration=1.6, points_per_scan=12000, seed=3)


def static_line(config: Config, n_dev: int) -> dict:
    """The per-shard sizes the JAX script reports for D shards."""
    return {
        "per_device_slice": sh.slice_capacity(config.max_scan_points, n_dev, config.shard_slack),
        "per_device_map_rows": config.hash_capacity // n_dev,
    }


def run(config: Config, seq: dataset.Sequence, n_dev: int, k: int, dev: torch.device) -> dict:
    runner = sh.ShardedOdometry(config, n_devices=n_dev, device=dev)
    for rec in seq.imu:
        runner.feed_imu(rec)
    for rec in seq.scans[:WARM_SCANS]:
        runner.process_scan(rec)
    for kern in bench.KERNELS:
        kern.reset_launches()
    # the timed scans' overflow pre-advances, a predict call each
    pre_advances, predict_only = [0], runner.predict_only

    def counted_predict_only(*args):
        pre_advances[0] += 1
        return predict_only(*args)

    runner.predict_only = counted_predict_only
    timed = seq.scans[WARM_SCANS: WARM_SCANS + k]
    bench.synchronize(dev)
    t0 = time.perf_counter()
    for rec in timed:
        runner.process_scan(rec)
    dt = (time.perf_counter() - t0) / len(timed)
    graph = runner.scan_step.graphs[False] if runner.graphed else None
    return {
        "devices": n_dev,
        "ms_per_scan": round(dt * 1e3, 3),
        **static_line(config, n_dev),
        "shards_on_one_device": True,
        "capture_s": graph.capture_s if graph else None,
        "graph_nodes": graph.nodes if graph else None,
        "launches": {kern.name: kern.launch_count() for kern in bench.KERNELS},
        "gn_iterations": sum(int(d["icp_iterations"]) for d in runner.diags[-len(timed):]),
        "scans": len(timed),
        "predict_calls": len(timed) + pre_advances[0],
    }


def main(argv: list[str] | None = None, config: Config | None = None,
         seq: dataset.Sequence | None = None, devices: tuple[int, ...] = DEVICES) -> int:
    """`config`, `seq` and `devices` are the JAX script's by default; a test
    makes them small."""
    ap = tools.parser("The sharded step at D = 1, 2, 4 and 8 shards.")
    ap.add_argument("k", nargs="?", type=int, default=K, help="timed scans per D")
    args = ap.parse_args(argv)
    dev = device_policy.resolve(args.device)
    config = config or make_config()
    seq = seq or make_sequence()
    for n_dev in devices:
        tools.emit(run(config, seq, n_dev, args.k, dev))
        gc.collect()  # the runner's graphs and map go before the next D's
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    tools.report_device(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
