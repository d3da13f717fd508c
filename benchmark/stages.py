"""Per-stage and per-kernel device times on the warm map after a window.

`StageTimer` is a copy of `eskf_lio_torch/bench.py::StageTimer`: a stage is
captured once into a CUDA graph (`utils.graphs.StepGraph`) and replayed k
times back to back between two CUDA events, best of two batches each
started from the probe, less k replays of a graph holding one tiny kernel.
torch.profiler is not used: it misses the kernels inside a WHILE body.  On
the CPU the same loops run eagerly under the host clock (tests only).

The probe is a real row of the window: the program's state, map and last
pose after the window, and the next row's IMU chunk and scan.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from benchmark import roofline

STAGE_ITERS = dict(predict=200, preprocess=30, align=20, insert=30, evict=20)
KERNEL_LAUNCHES = 20  # launches in one captured graph
KERNEL_REPLAYS = 20


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StageTimer:
    """ms per iteration of a stage: k iterations back to back, best of two
    batches, minus k iterations of a stage holding one tiny kernel."""

    def __init__(self, dev: torch.device, segscan_rows: int):
        self.dev = dev
        self.segscan_rows = segscan_rows
        self._empty = torch.zeros((), device=dev)
        self._baseline_s: dict[int, float] = {}

    def _best_s(self, fn: Callable[[], None], reset: Callable[[], None], k: int) -> float:
        from eskf_lio_torch.utils.graphs import StepGraph

        run = StepGraph(fn, self.dev, self.segscan_rows) if self.dev.type == "cuda" else fn
        reset()
        run()  # the capture and one replay
        _sync(self.dev)
        best = float("inf")
        for _ in range(2):
            reset()
            if self.dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(self.dev)
                start.record()
                for _ in range(k):
                    run()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                for _ in range(k):
                    run()
                best = min(best, time.perf_counter() - t0)
        return best

    def ms(self, fn: Callable[[], None], reset: Callable[[], None], k: int) -> float:
        """ms per iteration less the empty stage's, unrounded."""
        if k not in self._baseline_s:
            self._baseline_s[k] = self._best_s(
                lambda: self._empty.add_(1e-12), lambda: self._empty.zero_(), k)
        return max(self._best_s(fn, reset, k) - self._baseline_s[k], 0.0) / k * 1e3


def clone(fields):
    """A copy of a tuple of tensors (a state, a map) of the same type."""
    return type(fields)(*(x.clone() for x in fields))


def stage_ms(config, probe: dict, dev: torch.device) -> dict:
    """ms of predict, preprocess, align (over `align_capacity` rows),
    insert and evict on the probe."""
    from eskf_lio_torch.map import voxel_map as vm
    from eskf_lio_torch.models import eskf, registration
    from eskf_lio_torch.ops import preprocess
    from eskf_lio_torch.pipeline import odometry as odo
    from eskf_lio_torch.types import Pose, ProcessedScan
    from eskf_lio_torch.utils.graphs import assign

    timer = StageTimer(dev, config.max_raw_points)
    noise = eskf.make_noise_params(config, dev)
    T_il = odo.lidar_extrinsics(config, dev)
    state, voxmap, chunk, scan = probe["state"], probe["voxmap"], probe["chunk"], probe["scan"]
    out = {}

    state_buf = clone(state)

    def predict():
        base, _ = eskf.predict_chunk_prefix(state_buf, chunk, noise, base_mask=chunk.t_rel <= 0.0)
        assign(state_buf, base)

    out["predict"] = timer.ms(predict, lambda: assign(state_buf, state), STAGE_ITERS["predict"])
    base, hist = eskf.predict_chunk_prefix(state, chunk, noise, base_mask=chunk.t_rel <= 0.0)
    c = torch.zeros((), device=dev)  # a carried scalar the next iteration reads

    def prep():
        moved = scan._replace(points=scan.points + c * 1e-9)
        c.copy_(preprocess.preprocess(moved, hist, T_il, config).points[0, 0])

    out["preprocess"] = timer.ms(prep, c.zero_, STAGE_ITERS["preprocess"])
    processed = preprocess.preprocess(scan, hist, T_il, config)
    guess = eskf.pose_of(base)
    processed_a = ProcessedScan(*(x[: config.align_capacity] for x in processed))

    def align():
        moved = Pose(guess.R, guess.t + c * 1e-12)
        c.copy_(registration.align(processed_a, voxmap, moved, config).pose.t[0])

    out["align"] = timer.ms(align, c.zero_, STAGE_ITERS["align"])
    covs_packed = vm.pack_cov(processed.covs)
    map_buf = clone(voxmap)

    def insert():
        assign(map_buf, vm.insert(map_buf, processed.points, covs_packed, processed.valid,
                                  voxel_size=config.map_voxel_size,
                                  max_points_per_voxel=config.max_points_per_voxel)[0])

    def evict():
        assign(map_buf, vm.evict_beyond(map_buf, guess.t, voxel_size=config.map_voxel_size,
                                        distance_threshold=config.remove_distance_threshold,
                                        max_points_per_voxel=config.max_points_per_voxel)[0])

    def reset_map():
        assign(map_buf, voxmap)

    out["insert"] = timer.ms(insert, reset_map, STAGE_ITERS["insert"])
    out["evict"] = timer.ms(evict, reset_map, STAGE_ITERS["evict"])
    return out


def kernel_inputs(config, probe: dict, dev: torch.device) -> dict:
    """The kernels' own arguments on the probe's row: one eager step of the
    port (`odometry.make_step_core`) runs with `segscan.segsum_sorted` and
    `gn_normal_eq.normal_equations_rotated` wrapped, and the first call of
    each is kept: kernel B at the downsampler's shape (`max_raw_points`
    rows), kernel A at the first GN iteration (`align_capacity` rows)."""
    from eskf_lio_torch.ops import gn_normal_eq, segscan
    from eskf_lio_torch.pipeline import odometry as odo

    kept = {}

    def keep(name, fn, rows):
        def wrapped(*args):
            if name not in kept and args[0].shape[0] == rows:
                kept[name] = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
            return fn(*args)
        return wrapped

    originals = (segscan.segsum_sorted, gn_normal_eq.normal_equations_rotated)
    segscan.segsum_sorted = keep("segscan", originals[0], config.max_raw_points)
    gn_normal_eq.normal_equations_rotated = keep("gn_normal_eq", originals[1], config.align_capacity)
    try:
        carry = (clone(probe["state"]), clone(probe["voxmap"]), probe["R"], probe["t"])
        odo.make_step_core(config, dev)(carry, (probe["chunk"], probe["scan"], False))
    finally:
        segscan.segsum_sorted, gn_normal_eq.normal_equations_rotated = originals
    return kept


def kernel_ms(config, probe: dict, dev: torch.device) -> dict:
    """Each kernel's device ms a launch on the probe's inputs, its bound
    and the bound's share of the time: `KERNEL_LAUNCHES` launches in one
    captured graph, replayed `KERNEL_REPLAYS` times (L2-warm, as the step
    finds its inputs), less the empty graph's replay."""
    from eskf_lio_torch.ops import gn_normal_eq, segscan

    inputs = kernel_inputs(config, probe, dev)
    timer = StageTimer(dev, inputs["segscan"][1].shape[0])
    keys, vals = inputs["segscan"]
    gn_args = inputs["gn_normal_eq"]
    out = {}
    for name, fn, cost in (
        ("segscan", lambda: segscan.segsum_sorted(keys, vals),
         roofline.segscan_cost(*vals.shape)),
        ("gn_normal_eq", lambda: gn_normal_eq.normal_equations_rotated(*gn_args),
         roofline.gn_normal_eq_cost(gn_args[0].shape[0], int(gn_args[5].sum()))),
    ):
        def many(fn=fn):
            for _ in range(KERNEL_LAUNCHES):
                fn()

        ms = timer.ms(many, lambda: None, KERNEL_REPLAYS) / KERNEL_LAUNCHES
        b = roofline.bound_ms(*cost)
        out[name] = {"ms": ms, "bound_ms": b, "bytes": cost[0], "operations": cost[1],
                     "share_percent": roofline.share_percent(b, ms)}
    return out
