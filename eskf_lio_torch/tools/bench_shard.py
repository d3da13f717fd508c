"""The sharding machinery's overhead on one device (port of the mesh-of-one
half of `tools/bench_shard.py`): the sharded step over ONE shard against the
single-device step, on the same warm state.

With one shard the sharded step pays all its machinery (owner candidates,
the slice compaction sort, the shard sum) and gains nothing, so the
difference is what a sharded deployment must win back.

    python -m eskf_lio_torch.tools.bench_shard [--device cpu] [K]

The JAX script's workload: the bench's HEAVY config, 13 s at 120,000 points
a sweep (seed 11, noiseless IMU), 40 rows replayed to warm the map.  Each
step is then captured as one graph over the warm carry and fed row 40's
inputs K times (default 30), the carry moving from one step to the next as
in the JAX script's scan, best of two batches each started from the warm
carry, less K replays of a one-kernel graph (`bench.StageTimer`).  The
single-device step is `make_step_core`, the graph `Odometry` and the replay
capture; the sharded one `make_sharded_scan_step` over a one-shard mesh,
the graph `ShardedOdometry(n_devices=1)` captures.

Prints `{"stage", "ms_per_scan"}` for each step and
`{"stage": "sharding_overhead", "overhead_pct"}`, then the device line.
"""

from __future__ import annotations

import sys

import torch

from eskf_lio_torch import bench, tools
from eskf_lio_torch import device as device_policy
from eskf_lio_torch.config import Config
from eskf_lio_torch.io import dataset
from eskf_lio_torch.parallel import sharded_map as sh
from eskf_lio_torch.parallel.distributed import ShardMesh
from eskf_lio_torch.pipeline import odometry as odo
from eskf_lio_torch.pipeline import replay
from eskf_lio_torch.utils.graphs import assign

K = 30
N_WARM = 40


def make_sequence() -> dataset.Sequence:
    return dataset.make_synthetic_sequence(duration=13.0, points_per_scan=120000, seed=11)


def warm_carry(config: Config, seq: dataset.Sequence, n_warm: int, dev: torch.device):
    """The state, map and pose after `n_warm` rows of the replay (cloned:
    the replay's carry is its graph's buffers), and row `n_warm`'s chunk
    and scan."""
    packed = replay.pack_sequence(config, seq, max_scans=n_warm + 2, device=dev)
    step, carry = bench.start_replay(dev, config, packed[0])
    (state, voxmap, R, t), *_ = bench.run_rows(step, carry, packed, slice(0, n_warm))
    chunks, scans = packed[1], packed[2]
    return ((bench.clone(state), bench.clone(voxmap), R.clone(), t.clone()),
            type(chunks)(*(x[n_warm] for x in chunks)), type(scans)(*(x[n_warm] for x in scans)))


def step_ms(timer: bench.StageTimer, run, warm: tuple, k: int) -> float:
    """ms per step of `run(carry) -> carry` over buffers set to `warm`
    before each batch; every carry is (state, map blocks..., R, t)."""
    flat = [x.clone() for x in warm]

    def step():
        assign(flat, run(flat))

    return timer.measure(step, lambda: assign(flat, warm), k)[0]


def main(argv: list[str] | None = None, config: Config | None = None,
         seq: dataset.Sequence | None = None, n_warm: int = N_WARM) -> int:
    """`config`, `seq` and `n_warm` are the JAX script's by default; a test
    makes them small."""
    ap = tools.parser("The sharding machinery's overhead on one device.")
    ap.add_argument("k", nargs="?", type=int, default=K, help="steps per timing")
    args = ap.parse_args(argv)
    dev = device_policy.resolve(args.device)
    config = config or bench.heavy_config()
    seq = seq or make_sequence()
    (state, voxmap, R, t), chunk, scan = warm_carry(config, seq, n_warm, dev)
    n_s, n_m = len(state), len(voxmap)
    timer = bench.StageTimer(dev, config.max_raw_points)

    core = odo.make_step_core(config, dev)

    def plain(flat):
        carry = (type(state)(*flat[:n_s]), type(voxmap)(*flat[n_s:n_s + n_m]), *flat[-2:])
        (st, m, R2, t2), _ = core(carry, (chunk, scan, False))
        return (*st, *m, R2, t2)

    mesh = ShardMesh.create(1, dev)
    sharded = sh.make_sharded_scan_step(config, mesh)
    blocks = sh.ShardedVoxelMap.from_whole(voxmap, mesh).blocks

    def mesh1(flat):
        m = sh.ShardedVoxelMap([type(voxmap)(*flat[n_s:n_s + n_m])], mesh)
        st, m, R2, t2, _ = sharded(type(state)(*flat[:n_s]), m, *flat[-2:], chunk, scan, False)
        return (*st, *m.blocks[0], R2, t2)

    ms_plain = step_ms(timer, plain, (*state, *voxmap, R, t), args.k)
    tools.emit({"stage": "plain_step", "ms_per_scan": round(ms_plain, 3)})
    ms_shard = step_ms(timer, mesh1, (*state, *blocks[0], R, t), args.k)
    tools.emit({"stage": "sharded_step_mesh1", "ms_per_scan": round(ms_shard, 3)})
    tools.emit({"stage": "sharding_overhead",
                "overhead_pct": round((ms_shard / ms_plain - 1.0) * 100.0, 1)})
    tools.report_device(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
