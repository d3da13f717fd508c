"""Worker for tests/test_torch_distributed.py: one process of a two-process
`torch.distributed` (gloo, CPU) run of the port's sharded odometry, two
local map shards each — the counterpart of `tests/_dist_worker.py`, at its
sizes.  Imports the port only.

Launched as:  python tests/_torch_dist_worker.py --coordinator localhost:PORT \
    --num-processes 2 --process-id I --out OUT.json --ckpt DIR
Every process saves its checkpoint to DIR_<I> (only process 0 may write one)
and all of them load DIR_0.

With `--graphed` instead of `--ckpt`, each process runs the sharded driver
over the 12 scans of `make_seq(GRAPHED_DURATION_S)` twice: on a
`GraphedShardedScanStep` whose graphs are stand-ins that call the function
a graph would capture (`graphed_on_cpu`: every branch and GN pass run, with
the all-reduce inside every pass, under `NoHostRead`), and on the eager
sharded step; it writes both runs' records (`run_record`).
"""

import argparse
import hashlib
import json
import sys

import numpy as np


def worker_config():
    from eskf_lio_torch.config import Config, ImuConfig

    return Config(
        imu=ImuConfig(gravity=(0.0, 0.0, -9.81)),
        translation_noise=1e-4,
        rotation_noise=3e-5,
        max_raw_points=2048,
        max_scan_points=1024,
        max_imu_per_scan=48,
        hash_capacity_log2=14,
    )


# 12 scans (the first one the init scan)
GRAPHED_DURATION_S = 1.3


def make_seq(duration: float = 1.2):
    from eskf_lio_torch.io import dataset

    return dataset.make_synthetic_sequence(duration=duration, points_per_scan=1800, seed=7)


def graphed_on_cpu(odo, no_read: bool = True):
    """Put in `odo`'s place a `GraphedShardedScanStep` over CPU buffers
    whose graphs are stand-ins for `StepGraph`: a replay calls the function
    the graph would capture; with `no_read`, in select mode (every branch
    and every GN pass run, merged by `torch.where`, so the all-reduce runs
    inside every pass) under `NoHostRead`, which fails on any read of a
    device value."""
    import torch

    from _torch_no_host_read import NoHostRead
    from eskf_lio_torch.parallel.sharded_map import GraphedShardedScanStep
    from eskf_lio_torch.pipeline import odometry
    from eskf_lio_torch.utils import graphs

    class Uncaptured:
        def __init__(self, fn, device, segscan_rows, pool=None, tracer=None, name="step"):
            self.fn = fn

        def __call__(self):
            if no_read:
                with graphs.select_branches(), NoHostRead():
                    self.fn()
            else:
                self.fn()

    held = odometry.StepGraph, torch.cuda.graph_pool_handle
    odometry.StepGraph, torch.cuda.graph_pool_handle = Uncaptured, lambda: None
    try:
        odo.scan_step = GraphedShardedScanStep(odo.config, odo.mesh)
    finally:
        odometry.StepGraph, torch.cuda.graph_pool_handle = held
    return odo


def run_record(odo) -> dict:
    """A run's trajectory, diagnostics and a sha1 of its gathered map (a
    collective), for comparison bit for bit."""
    h = hashlib.sha1()
    for x in odo.voxmap:
        h.update(np.ascontiguousarray(x.cpu().numpy()).tobytes())
    return {
        "positions": odo.positions.tolist(),
        "rotations_sha1": hashlib.sha1(np.stack(odo.trajectory_R).tobytes()).hexdigest(),
        "diags": [{k: int(v) for k, v in d.items()} for d in odo.diags],
        "map_sha1": h.hexdigest(),
    }


def state_digest(odo) -> str:
    """sha1 of everything a process holds replicated: the filter state and
    the pose carry, bit for bit."""
    h = hashlib.sha1()
    for x in (*odo.state, odo.prev_R, odo.prev_t):
        h.update(np.ascontiguousarray(x.cpu().numpy()).tobytes())
    return h.hexdigest()


def distinct_voxels(voxmap) -> int:
    """Exact host-side count over both tiers of the gathered map (a
    collective); `num_voxels()` assumes one globally sorted main tier."""
    keys = np.concatenate([voxmap.skey.cpu().numpy(), voxmap.d_skey.cpu().numpy()])
    return len(np.unique(keys[keys != np.iinfo(np.int32).max]))


def continue_run(odo, seq, start: int, stop: int) -> None:
    """Feed scans [start, stop) and the IMU after the filter clock to a
    restored driver, as `Odometry.run` would have."""
    imu = iter([r for r in seq.imu if r.t > odo.t_last_update])
    nxt = next(imu, None)
    for scan in seq.scans[start:stop]:
        while nxt is not None and nxt.t <= scan.end_time + 0.05:
            odo.feed_imu(nxt)
            nxt = next(imu, None)
        odo.process_scan(scan)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--out", required=True)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--ckpt")  # shared prefix, all processes
    mode.add_argument("--graphed", action="store_true")
    args = ap.parse_args()

    import torch

    torch.set_num_threads(2)

    from eskf_lio_torch.parallel import distributed as dist
    from eskf_lio_torch.parallel.sharded_map import ShardedOdometry
    from eskf_lio_torch.utils import checkpoint as ckpt

    n, i = dist.initialize(
        coordinator=args.coordinator, num_processes=args.num_processes,
        process_id=args.process_id, device="cpu", timeout_s=120.0,
    )
    assert n == args.num_processes, (n, args.num_processes)
    n_shards = 2 * n

    if args.graphed:
        seq = make_seq(GRAPHED_DURATION_S)
        runs = {}
        for name in ("graph", "eager"):
            odo = ShardedOdometry(worker_config(), n_devices=n_shards, device="cpu")
            if name == "graph":
                graphed_on_cpu(odo)
            odo.run(seq)
            runs[name] = run_record(odo)
        with open(args.out, "w") as f:
            json.dump({"process": i, "backend": torch.distributed.get_backend(), **runs}, f)
        dist.shutdown()
        return 0

    seq = make_seq()
    digests = []
    odo = ShardedOdometry(worker_config(), n_devices=n_shards, device="cpu")
    assert list(odo.mesh.local_shards) == [2 * i, 2 * i + 1]
    odo.run(seq, max_scans=6, on_scan=lambda o: digests.append(state_digest(o)))

    # checkpoint / resume across the process group: snapshot a 3-scan run
    # (a collective: the blocks are gathered; only process 0 writes), restore
    # into a fresh driver in every process, continue to scan 6
    b = ShardedOdometry(worker_config(), n_devices=n_shards, device="cpu")
    b.run(seq, max_scans=3)
    ckpt.save_checkpoint(f"{args.ckpt}_{i}", b)
    dist.barrier()  # all processes wait for process 0's write before loading
    c = ShardedOdometry(worker_config(), n_devices=n_shards, device="cpu")
    ckpt.load_checkpoint(f"{args.ckpt}_0", c)
    continue_run(c, seq, 3, 6)

    result = {
        "process": i,
        "num_processes": n,
        "backend": torch.distributed.get_backend(),
        "global_shards": n_shards,
        "positions": odo.positions.tolist(),
        "state_digests": digests,
        "icp_iterations": [int(d["icp_iterations"]) for d in odo.diags],
        "map_voxels": distinct_voxels(odo.voxmap),
        "diverged": bool(odo.diverged),
        "resumed_positions": c.positions.tolist(),
        "resumed_map_voxels": distinct_voxels(c.voxmap),
    }
    with open(args.out, "w") as f:
        json.dump(result, f)
    dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
