"""A stress test of the captured steps on the card (no JAX counterpart: a
check of the port's CUDA graphs, `utils/graphs.py`, and of the eager steps
beside them).

    python -m eskf_lio_torch.utils.graph_stress            # small (20 rounds), then HEAVY (5)
    python -m eskf_lio_torch.utils.graph_stress --eager    # no graph: small (40), then HEAVY (6)

Every round builds fresh captured steps — `GraphedScanStep` and, with all
four shards on the one card, `GraphedShardedScanStep` — and runs them over
the same update scans as the eager steps (`make_step_core`,
`make_sharded_scan_step`), interleaved scan by scan on the same inputs; every
result (filter state, map, pose, diagnostics) must equal the eager one bit
for bit, after each scan and again after a `torch.cuda.synchronize()` at the
round's end.  Each round also drives the mechanisms that could leave a graph
or an eager step reading freed or shared memory, all on one thread, as the
port's drivers capture and replay:

* `order`: the two graphs of a step (with and without eviction) share one
  memory pool; the eviction flags make them replay in an order other than
  the one they were captured in (the first flag alternates between rounds);
* `recapture`: halfway, one graph of the live step is destroyed and captured
  again into the shared pool;
* `gc_in_capture`: the previous round's steps are left in a reference cycle
  whose last outside reference the first capture of this round drops before
  a `gc.collect()`, so their graphs are collected in the middle of another
  capture; in the other rounds they are dropped and collected between
  captures;
* `grown_scratch`: halfway, kernel B's capture scratch is reserved larger
  (`segscan.reserve_capture`) while graphs captured on the old buffer live
  on; a graph captured after that takes the new one.

`--eager` runs the same loop with both steps of every pair eager, no graph
captured and nothing compared (it looks for memory faults).  Run so, 40 small rounds and then HEAVY's in one process,
it met an illegal address in kernel B on the card: the halo warp of a last
tile with no row after it loaded 32 rows past the end of its values, which
faults only where the values end a mapped range, so only after the
allocator's layout had drifted (ROADMAP.md, queue 3).  Both runs are phases
of `chip_smoke.py`.

Prints one JSON line per round and a last `graph_stress {...}` line; exits
1 at the first difference.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time

import numpy as np
import torch

from eskf_lio_torch.config import Config, ImuConfig
from eskf_lio_torch.io import dataset
from eskf_lio_torch.map import voxel_map as vm
from eskf_lio_torch.models import eskf
from eskf_lio_torch.ops import segscan
from eskf_lio_torch.parallel import sharded_map as sm
from eskf_lio_torch.parallel.distributed import ShardMesh
from eskf_lio_torch.pipeline import odometry as odo
from eskf_lio_torch.pipeline import replay
from eskf_lio_torch.types import ImuChunk, Scan
from eskf_lio_torch.utils import graphs

N_SHARDS = 4
ROUNDS = {"small": 20, "heavy": 5}
# the eager loop: the small config's rounds then HEAVY's, in one process
EAGER_ROUNDS = {"small": 40, "heavy": 6}
# eviction close enough that it removes voxels of the synthetic room
EVICT_DISTANCE_M = 8.0
# the mechanisms a round may drive (the replay order always differs from the
# capture order); every capture and replay is on one thread, as the port's
# drivers do
DEFAULT_MECHANISMS = ("recapture", "gc_in_capture", "grown_scratch")


class Mismatch(AssertionError):
    pass


def make_config(size: str) -> Config:
    """`small`: the port's test size; `heavy`: HEAVY of `bench.py:79-82,
    102-112`, as `chip_smoke.py` drives it."""
    if size == "small":
        kw = dict(translation_noise=1e-4, rotation_noise=3e-5, max_raw_points=8192,
                  max_scan_points=4096, max_imu_per_scan=48, hash_capacity_log2=16)
    else:
        kw = dict(translation_noise=1e-3, rotation_noise=3e-4, max_raw_points=131072,
                  max_scan_points=32768, max_imu_per_scan=64, hash_capacity_log2=19)
    return Config(imu=ImuConfig(gravity=(0.0, 0.0, -9.81)),
                  remove_distance_threshold=EVICT_DISTANCE_M, **kw)


def make_sequence(size: str, n_scans: int):
    points = 8000 if size == "small" else 120000
    return dataset.make_synthetic_sequence(
        duration=(n_scans + 2) / 10.0 + 1e-6, points_per_scan=points, seed=11,
        imu_noise_gyro=4.9e-3, imu_noise_accel=0.0206,
        gyro_bias=np.array([0.002, -0.001, 0.0015]),
        accel_bias=np.array([0.02, -0.03, 0.01]),
    )


@dataclasses.dataclass
class Inputs:
    """The update scans on the device and the maps after the init scan."""

    chunks: list
    scans: list
    voxmap: vm.VoxelMap
    blocks: list
    mesh: ShardMesh


def prepare_inputs(config: Config, seq, dev, n_scans: int) -> Inputs:
    init_scan, chunks, scans, _, updates, _ = replay.pack_sequence(
        config, seq, max_scans=n_scans + 1, device=dev)
    if len(updates) != n_scans or not bool(updates.all()):
        raise RuntimeError(f"the stress sequence gave rows {updates.tolist()} "
                           f"for {n_scans} update scans")
    rows = range(n_scans)
    empty = vm.VoxelMap.create(config.hash_capacity, config.map_delta_capacity, device=dev)
    voxmap, _ = odo.make_init_step(config, dev)(empty, init_scan)
    mesh = ShardMesh.create(N_SHARDS, dev)
    blocks, _ = sm.make_sharded_init_step(config, mesh)(
        sm.ShardedVoxelMap.from_whole(empty, mesh), init_scan)
    return Inputs([ImuChunk(*(x[b] for x in chunks)) for b in rows],
                  [Scan(*(x[b] for x in scans)) for b in rows],
                  voxmap, blocks.blocks, mesh)


def evict_flags(n: int, first: bool) -> list[bool]:
    """Flags whose graphs are captured in one order and then replayed in
    another: first, not first, first, first, not first, not first, ..."""
    pattern = [first, not first, first, first, not first, not first]
    return [pattern[i % len(pattern)] for i in range(n)]


def start(config: Config, dev, inp: Inputs, sharded: bool):
    """(carry, eager step) from the maps after the init scan, each tensor
    a copy of its own."""
    state = eskf.init_state(config, dev)
    if sharded:
        voxmap = sm.ShardedVoxelMap([vm.VoxelMap(*(x.clone() for x in b)) for b in inp.blocks],
                                    inp.mesh)
        core = sm.make_sharded_scan_step(config, inp.mesh)
    else:
        voxmap = vm.VoxelMap(*(x.clone() for x in inp.voxmap))
        core = odo.make_step_core(config, dev)

        def core_step(core=core):
            def step(state, voxmap, R, t, chunk, scan, evict):
                (state, voxmap, R, t), diag = core((state, voxmap, R, t), (chunk, scan, evict))
                return state, voxmap, R, t, diag
            return step

        core = core_step()
    return [state, voxmap, torch.eye(3, device=dev), torch.zeros(3, device=dev)], core


def flat(out, keys) -> list[tuple[str, torch.Tensor]]:
    """A step's results as named tensors: state, map, pose, diagnostics."""
    state, voxmap, R, t, diag = out
    blocks = voxmap.blocks if isinstance(voxmap, sm.ShardedVoxelMap) else [voxmap]
    named = [(f"state.{f}", x) for f, x in zip(type(state)._fields, state)]
    named += [(f"map[{i}].{f}", x) for i, b in enumerate(blocks) for f, x in zip(vm.VoxelMap._fields, b)]
    named += [("R", R), ("t", t), ("diag", odo.diag_vector(diag, keys))]
    return named


def same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Equal bit for bit (a NaN equals the same NaN)."""
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    if x.is_floating_point():
        x, y = x.view(torch.int32), y.view(torch.int32)
    return torch.equal(x, y)


def differing(a, b) -> list[str]:
    return [na for (na, x), (_, y) in zip(a, b) if not same_bits(x, y)]


def make_step(config: Config, dev, inp: Inputs, sharded: bool):
    if sharded:
        return sm.GraphedShardedScanStep(config, inp.mesh)
    return odo.GraphedScanStep(config, dev)


def gc_inside_first_capture(step, held: list) -> None:
    """Make the step's next capture drop `held` (the last reference to a
    reference cycle) and collect garbage before and after its ops, inside
    the capture."""
    for graph in step.graphs.values():
        def fn(inner=graph.fn):
            held.clear()
            gc.collect()
            inner()
            gc.collect()
        graph.fn = fn


def run_pair(config, dev, inp: Inputs, sharded: bool, flags, mechanisms: dict,
             label: str, cycle: list, graphed: bool = True) -> dict:
    """One captured step beside the eager step over the scans, compared bit
    for bit; the halfway mechanisms in `mechanisms`; `cycle` holds the only
    reference to earlier steps in a reference cycle, which the first capture
    drops and collects.  With `graphed` False the captured step's place goes
    to a second eager step, built with its own copy of the maps as a graphed
    step is, and nothing is compared: a comparison's buffers would change
    the allocator's layout that the loop's faults depend on.  Returns what
    it saw."""
    keys = step_keys(sharded)
    step = (make_step(config, dev, inp, sharded) if graphed
            else start(config, dev, inp, sharded)[1])
    if mechanisms.get("gc_in_capture"):
        gc_inside_first_capture(step, cycle)
    g_carry, _ = start(config, dev, inp, sharded)
    e_carry, core = start(config, dev, inp, sharded)
    half = len(flags) // 2
    removed = 0
    for b, evict in enumerate(flags):
        if b == half:
            if mechanisms.get("grown_scratch"):
                rows = segscan._CAPTURE_TILES[dev.index] * segscan.KERNEL.query(
                    "segscan_tile_rows") + 1
                segscan.reserve_capture(dev, rows)
            if mechanisms.get("recapture"):
                # destroy the graph the next scan replays; it is captured again
                step.graphs[evict].graph = None
                gc.collect()
        g_out = step(*g_carry, inp.chunks[b], inp.scans[b], evict)
        e_out = core(*e_carry, inp.chunks[b], inp.scans[b], evict)
        named = flat(g_out, keys), flat(e_out, keys)
        bad = differing(*named) if graphed else []
        if bad:
            raise Mismatch(f"{label}: scan {b + 1} (evict {evict}): the step differs from "
                           f"the eager step in {bad[:6]}")
        removed += int(e_out[4]["removed_voxels"])
        g_carry, e_carry = list(g_out[:4]), list(e_out[:4])
    torch.cuda.synchronize(dev)
    named = flat((*g_carry, g_out[4]), keys), flat((*e_carry, e_out[4]), keys)
    bad = differing(*named) if graphed else []
    if bad:
        raise Mismatch(f"{label}: after the round's synchronize the step differs in {bad[:6]}")
    nodes = ({str(e): g.nodes for e, g in step.graphs.items() if g.graph is not None}
             if graphed else {})
    return {"step": step, "removed_voxels": removed, "nodes": nodes}


def step_keys(sharded: bool):
    return sm.SHARDED_DIAG_KEYS if sharded else odo.DIAG_KEYS


def stress(size: str, rounds: int, n_scans: int, dev, mechanisms=DEFAULT_MECHANISMS,
           graphed: bool = True) -> dict:
    """`rounds` rounds at config `size` with the named `mechanisms`; with
    `graphed` False both steps of a pair are eager and no graph is
    captured."""
    enabled = set(mechanisms) if graphed else set()
    config = make_config(size)
    t0 = time.perf_counter()
    inp = prepare_inputs(config, make_sequence(size, n_scans), dev, n_scans)
    setup_s = time.perf_counter() - t0
    held = None  # the previous round's steps
    run = compared = 0
    retired0 = len(segscan.KERNEL._retired)
    t_all = time.perf_counter()
    for r in range(rounds):
        t0 = time.perf_counter()
        parked0 = graphs._CAPTURES["parked"]
        flags = evict_flags(n_scans, first=r % 2 == 0)
        in_cycle = r % 2 == 1 and "gc_in_capture" in enabled
        mechanisms = {"order": graphed, "recapture": r % 3 != 2 and "recapture" in enabled,
                      "grown_scratch": r % 3 == 1 and "grown_scratch" in enabled,
                      "gc_in_capture": in_cycle and held is not None}
        cycle = []
        if held is not None:
            if in_cycle:
                # `cycle` alone holds a reference cycle around them: the first
                # capture below drops it and collects them inside the capture
                loop = [held]
                loop.append(loop)
                cycle.append(loop)
                del loop
            held = None
            if not in_cycle:
                gc.collect()  # dropped between captures
        used = [k for k, v in mechanisms.items() if v]
        seen = {}
        for sharded in (False, True):
            label = f"{size} round {r} {'sharded' if sharded else 'single'}"
            seen[sharded] = run_pair(config, dev, inp, sharded, flags, mechanisms, label,
                                     cycle, graphed)
            # the collection inside a capture is made by the first step only
            mechanisms["gc_in_capture"] = False
            run += n_scans
            compared += n_scans if graphed else 0
        held = [seen[False].pop("step"), seen[True].pop("step")]
        if graphs._PARKED:
            raise Mismatch(f"{size} round {r}: {len(graphs._PARKED)} graphs collected inside "
                           "a capture were not destroyed after it")
        if "gc_in_capture" in used and graphs._CAPTURES["parked"] == parked0:
            raise Mismatch(f"{size} round {r}: no graph was collected inside the capture")
        print(json.dumps({
            "config": size, "round": r, "graphed": graphed, "first_flag": flags[0],
            "mechanisms": used,
            "removed_voxels": {"single": seen[False]["removed_voxels"],
                               "sharded": seen[True]["removed_voxels"]},
            "nodes": {"single": seen[False]["nodes"], "sharded": seen[True]["nodes"]},
            # graphs collected inside a capture, destroyed once it ended
            "graphs_parked": graphs._CAPTURES["parked"] - parked0,
            "seconds": time.perf_counter() - t0,
        }), flush=True)
    del held
    gc.collect()
    torch.cuda.synchronize(dev)
    return dict(config=size, rounds=rounds, scans_a_round=n_scans, shards=N_SHARDS,
                graphed=graphed, mechanisms=sorted(enabled), scans_run=run, scans_compared=compared,
                retired_scratch_buffers=len(segscan.KERNEL._retired) - retired0,
                setup_s=setup_s, seconds=time.perf_counter() - t_all)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", choices=("small", "heavy", "both"), default="both")
    ap.add_argument("--rounds", type=int, default=None,
                    help="rounds at each config (default: small 20, heavy 5; with --eager "
                         "small 40, heavy 6)")
    ap.add_argument("--scans", type=int, default=6, help="update scans a round")
    ap.add_argument("--eager", action="store_true",
                    help="both steps of every pair eager, no graph, nothing compared")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("graph_stress: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"device: {torch.cuda.get_device_name(dev)}, torch {torch.__version__}", flush=True)
    sizes = ("small", "heavy") if args.config == "both" else (args.config,)
    default_rounds = EAGER_ROUNDS if args.eager else ROUNDS
    results = []
    try:
        for size in sizes:
            results.append(stress(size, args.rounds or default_rounds[size], args.scans, dev,
                                  graphed=not args.eager))
    except Mismatch as exc:
        print(f"graph_stress FAILED: {exc}", file=sys.stderr)
        return 1
    print("graph_stress " + json.dumps({"results": results, "ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
