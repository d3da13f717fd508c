"""Benchmark of the port: the full LIO loop's throughput on the card (port
of the JAX package's `bench.py`).

    python -m eskf_lio_torch.bench                 # on the card
    python -m eskf_lio_torch.bench --device cpu    # the plain paths, for tests

Prints ONE JSON line per completed phase, each a superset of the one
before, so a run cut at any point leaves its most complete line last:

  phase 1  light series  (24,576 raw / 12,288 scan points)
  phase 2  heavy series  (the shipped `config/hilti.yaml` capacities,
                          131,072 / 32,768, a 2^19-row map: the headline
                          `value`)
  phase 3  per-stage breakdown on the heavy series' warm map
  phase 4  the C++ reference filter (`native/ref_filter.cpp`) on the same
           sequences: the measured `vs_baseline` denominator and
           `ate_vs_ref_cm`

Every line carries {"metric", "value", "unit", "vs_baseline"}, the phases
completed so far, and `device`: the card's nvidia-smi name and power limit
(or "cpu"), so that each number names the hardware it came from.  A
wall-clock budget (--budget-s N / ESKF_BENCH_BUDGET_S, default 1500 s)
skips the remaining phases when it runs out; ESKF_BENCH_ONLY=light stops
after phase 1; ESKF_GN_BACKEND sets the config's `gn_backend`.

Workload: the synthetic Hilti-class sequence of the JAX bench (13 s, seed
11, 10 Hz sweeps, 400 Hz IMU with datasheet-level noise and biases), copied
here with the same values, replayed by `pipeline/replay.py`: on the card
every row replays the captured step (`odometry.GraphedScanStep`).

Timing.  A series warms up on the first half of its rows (the kernels'
build, the init scan, every graph's capture and the rows themselves:
`compile_s`) and times the second half between two
`torch.cuda.synchronize()` calls; the launches of kernels A and B and of
the preprocessor's kernels in the timed half are counted on the device.
The replay returns the captured step's static buffers as its carry, so
the post-warm-up state and map are cloned for phase 3 before the timed
half moves them.  Phase 3 captures
each stage as one `utils.graphs.StepGraph` over buffers it carries from one
replay to the next (the state, the map, the step's carry, a moving guess:
the JAX bench's scan bodies), replays it k times back to back between two
CUDA events, best of two batches each started from the probe, and
subtracts k replays of a graph holding one tiny kernel (the JAX bench's
empty k-iteration dispatch).  torch.profiler is not used: it misses the
kernels inside a WHILE body.  On the CPU the same loops run eagerly under
the host clock.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from eskf_lio_torch import device as device_policy
from eskf_lio_torch.config import Config, ImuConfig
from eskf_lio_torch.io import dataset, native_runtime
from eskf_lio_torch.map import voxel_map as vm
from eskf_lio_torch.models import eskf, registration
from eskf_lio_torch.ops import _cuda, gn_normal_eq, gn_pass, imu_prefix, preprocess, segscan
from eskf_lio_torch.pipeline import odometry as odo
from eskf_lio_torch.pipeline import replay
from eskf_lio_torch.types import Pose, ProcessedScan
from eskf_lio_torch.utils import metrics
from eskf_lio_torch.utils.graphs import GRAPH_COND, StepGraph, assign

SCAN_RATE_HZ = 10.0  # Hesai Pandar real-time rate on exp21

# The JAX bench's workloads (`bench.py:68-87`), with the same values.
# ref_scans_per_sec: the denominator used when the reference filter cannot
# be built (no toolchain); phase 4 measures it on the bench's host.
HEAVY = dict(
    max_raw_points=131072, max_scan_points=32768, points_per_scan=120000,
    ref_scans_per_sec=22.12,
)
LIGHT = dict(
    max_raw_points=24576, max_scan_points=12288, points_per_scan=20000,
    ref_scans_per_sec=53.55,
)
SEQUENCE_S = 13.0
MIN_ROWS = 64  # the JAX bench's least sequence for a timed window
# iterations per timing of each stage (the JAX bench's k)
STAGE_ITERS = dict(predict=200, preprocess=30, align=20, insert=30, evict=20, full_step=30)
KERNELS = (gn_normal_eq.KERNEL, gn_pass.KERNEL, segscan.KERNEL, preprocess.KERNEL,
           imu_prefix.KERNEL)


def make_config(max_raw_points: int, max_scan_points: int,
                gn_backend: str | None = None) -> Config:
    """The bench's config; `gn_backend` None reads `ESKF_GN_BACKEND`."""
    return Config(
        imu=ImuConfig(gravity=(0.0, 0.0, -9.81)),
        translation_noise=1e-3,
        rotation_noise=3e-4,
        max_raw_points=max_raw_points,
        max_scan_points=max_scan_points,
        max_imu_per_scan=64,
        hash_capacity_log2=19,
        gn_backend=gn_backend or os.environ.get("ESKF_GN_BACKEND", "auto"),
    )


def make_sequence(points_per_scan: int, duration: float = SEQUENCE_S) -> dataset.Sequence:
    return dataset.make_synthetic_sequence(
        duration=duration, points_per_scan=points_per_scan, seed=11,
        # datasheet-level sensor noise and biases: the filter models them
        imu_noise_gyro=4.9e-3, imu_noise_accel=0.0206,
        gyro_bias=np.array([0.002, -0.001, 0.0015]),
        accel_bias=np.array([0.02, -0.03, 0.01]),
    )


def heavy_config() -> Config:
    """HEAVY with the Config's own `gn_backend`: `ESKF_GN_BACKEND` is the
    bench's knob and reaches its series only, not the other drivers of
    HEAVY (`chip_smoke.py`, `utils/graph_stress.py`)."""
    return make_config(HEAVY["max_raw_points"], HEAVY["max_scan_points"],
                       gn_backend=Config.gn_backend)


def bench_sequence(n_scans: int, points_per_scan: int = HEAVY["points_per_scan"]):
    """The bench's sequence cut in duration only, to `n_scans` scans."""
    return make_sequence(points_per_scan, duration=(n_scans + 1) / 10.0 + 1e-6)


class Series(NamedTuple):
    """One series: its config and sequence, the points a sweep holds and
    the denominator used when the reference filter cannot run."""

    config: Config
    seq: dataset.Sequence
    points_per_scan: int
    ref_scans_per_sec: float


def make_series(spec: dict) -> Series:
    """HEAVY or LIGHT as the JAX bench runs it."""
    return Series(make_config(spec["max_raw_points"], spec["max_scan_points"]),
                  make_sequence(spec["points_per_scan"]), spec["points_per_scan"],
                  spec["ref_scans_per_sec"])


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# the replay series
# ---------------------------------------------------------------------------


def start_replay(dev, config, init_scan, graphed: bool = True):
    """The user's entry points: the replay runner (None when not
    `graphed`) and the carry (state, map with the first scan inserted,
    prev_R, prev_t)."""
    init_step = odo.make_init_step(config, dev)
    step = replay.make_replay_step(config, dev) if graphed else None
    state = eskf.init_state(config, dev)
    voxmap = vm.VoxelMap.create(config.hash_capacity, config.map_delta_capacity, device=dev)
    voxmap, _ = init_step(voxmap, init_scan)
    return step, (state, voxmap, torch.eye(3, device=dev), torch.zeros(3, device=dev))


def run_rows(step, carry, packed, rows: slice):
    """Replay rows `rows` of the packed sequence; (carry, Rs, ts, diags)."""
    _, chunks, scans, evicts, updates, _ = packed
    *carry, Rs, ts, diags = step(
        *carry,
        type(chunks)(*(x[rows] for x in chunks)),
        type(scans)(*(x[rows] for x in scans)),
        evicts[rows], updates[rows],
    )
    return carry, Rs, ts, diags


def capture_graphs(step) -> None:
    """Capture every graph of a replay on the card that is not captured
    yet (the update step with and without eviction, the predict-only
    step).  A capture records and runs nothing: the timed rows then replay
    graphs only, whichever of them their rows take."""
    for graph in (*step.scan_step.graphs.values(), step.predict.graph):
        if graph.graph is None:
            graph.capture()


def clone(fields):
    """A copy of a tuple of tensors (a state, a map) of the same type."""
    return type(fields)(*(x.clone() for x in fields))


def run_series(config: Config, seq: dataset.Sequence, device="cuda") -> dict:
    """Timed replay: warm up on the first half of the rows, time the
    same-shaped second half.  Returns throughput and accuracy, the kernel
    launches of the timed half (counted on the device), and a warm probe
    (state, map, prev pose, the first timed row's chunk and scan, cloned
    before the timed half) for the stage breakdown."""
    dev = device_policy.resolve(device)
    packed = replay.pack_sequence(config, seq, device=dev)
    init_scan, chunks, scans, _, updates, _ = packed
    b_total = chunks.dt.shape[0]
    if b_total < MIN_ROWS:
        raise ValueError(f"sequence too short for a timed window: {b_total} rows < {MIN_ROWS}")
    n = b_total // 2

    # warm-up: the kernels' build, the init scan, the captures, the rows
    synchronize(dev)
    t_w = time.perf_counter()
    if dev.type == "cuda":
        _cuda.build([*KERNELS, GRAPH_COND])  # one nvcc per source, all at once
    step, carry = start_replay(dev, config, init_scan)
    carry, Rs_w, ts_w, diags_w = run_rows(step, carry, packed, slice(0, n))
    if dev.type == "cuda":
        capture_graphs(step)
    synchronize(dev)
    compile_s = time.perf_counter() - t_w
    state, voxmap, prev_R, prev_t = carry
    probe = dict(
        state=clone(state), voxmap=clone(voxmap), prev_R=prev_R.clone(), prev_t=prev_t.clone(),
        chunk=type(chunks)(*(x[n] for x in chunks)), scan=type(scans)(*(x[n] for x in scans)),
    )

    for k in KERNELS:
        k.reset_launches()
    synchronize(dev)
    t0 = time.perf_counter()
    carry, Rs_b, ts_b, diags_b = run_rows(step, carry, packed, slice(n, 2 * n))
    synchronize(dev)
    elapsed = time.perf_counter() - t0
    launches = {k.name: k.launch_count() for k in KERNELS}

    timed = np.asarray(updates[n: 2 * n])
    conv = diags_b["icp_converged"].cpu().numpy()[timed]
    # accuracy: ATE of the replayed trajectory against the synthetic ground
    # truth, so a speed change cannot trade accuracy away unseen
    est, _, _ = replay.collect(updates[: 2 * n], [Rs_w, Rs_b], [ts_w, ts_b], [diags_w, diags_b])
    gt = np.asarray(seq.gt_positions)[: est.shape[0]]
    ate_cm = metrics.ate_rmse(est, gt) * 100.0

    return {
        "scans_per_sec": round(n / elapsed, 2),
        "timed_scans": int(n),
        "icp_convergence_rate": round(float(conv.mean()), 3),
        "ate_rmse_cm": round(ate_cm, 2),
        "compile_s": round(compile_s, 1),
        # the timed half: kernel launches (on the card counted on the
        # device inside the graphs; 0 on the CPU's plain paths), the GN
        # iterations and update rows they must match
        "launches": launches,
        "gn_iterations": int(diags_b["icp_iterations"].cpu().numpy()[timed].sum()),
        "update_rows": int(timed.sum()),
        "_probe": probe,
        "_est_positions": est,
    }


# ---------------------------------------------------------------------------
# the reference filter
# ---------------------------------------------------------------------------


class ReferenceFilterFailed(RuntimeError):
    """The reference filter was built but its run failed."""


def run_reference_filter(seq, est_positions: np.ndarray) -> dict | None:
    """Run the native reference-algorithm filter (`native/ref_filter.cpp`,
    built by the port under `build/native/`) on the SAME sequence: (a) the
    baseline scans/s denominator on this host and (b) the reference
    trajectory for `ate_vs_ref_cm`.  None when the host has no toolchain
    (the caller falls back to the recorded constants); raises
    `ReferenceFilterFailed` when the built filter's run fails."""
    binpath = native_runtime.ref_filter_path()
    if binpath is None:
        return None
    try:
        with tempfile.TemporaryDirectory() as td:
            seq_bin = os.path.join(td, "seq.bin")
            traj_bin = os.path.join(td, "traj.bin")
            dataset.save_seq_bin(seq_bin, seq)
            out = subprocess.run(
                [binpath, seq_bin, traj_bin],
                capture_output=True, text=True, timeout=900, check=True,
            )
            stats = json.loads(out.stdout.strip().splitlines()[-1])
            with open(traj_bin, "rb") as f:
                n = int(np.fromfile(f, np.int64, 1)[0])
                np.fromfile(f, np.float64, n)  # times
                ref_xyz = np.fromfile(f, np.float64, 3 * n).reshape(n, 3)
    except subprocess.CalledProcessError as exc:
        tail = (exc.stderr or "").strip().splitlines()[-1:]
        raise ReferenceFilterFailed(f"exit {exc.returncode} {' '.join(tail)}".strip()) from exc
    except (OSError, subprocess.SubprocessError, ValueError, IndexError) as exc:
        raise ReferenceFilterFailed(f"{type(exc).__name__}: {exc}") from exc
    m = min(len(ref_xyz), len(est_positions))
    gt = np.asarray(seq.gt_positions)[:m]
    return {
        "ref_scans_per_sec": stats["ref_scans_per_sec"],
        "ref_threads": stats.get("threads"),
        "ref_stages_ms": stats.get("stages_ms"),
        "ref_gn_iters_avg": stats.get("gn_iters_avg"),
        # the reference algorithm's own accuracy on this sequence
        "ref_ate_rmse_cm": round(metrics.ate_rmse(ref_xyz[:m], gt) * 100.0, 2),
        # this trajectory scored against the reference trajectory
        "ate_vs_ref_cm": round(metrics.ate_rmse(est_positions[:m], ref_xyz[:m]) * 100.0, 2),
    }


def reference(seq, est_positions: np.ndarray) -> tuple[dict | None, str]:
    """`run_reference_filter`, and why it gave nothing: "no toolchain", or
    the run's failure, which is never reported as a missing toolchain."""
    try:
        return run_reference_filter(seq, est_positions), "no toolchain"
    except ReferenceFilterFailed as exc:
        return None, f"reference filter failed: {exc}"


# ---------------------------------------------------------------------------
# the stage breakdown
# ---------------------------------------------------------------------------


class StageTimer:
    """ms per iteration of a stage: k iterations back to back, best of two
    batches, minus k iterations of a stage holding one tiny kernel.  On the
    card the stage is one captured graph replayed k times between CUDA
    events; on the CPU `fn` runs eagerly under the host clock.  `fn()`
    reads and writes only buffers that `reset()` sets back to the probe
    before each batch."""

    def __init__(self, dev: torch.device, segscan_rows: int):
        self.dev = dev
        self.segscan_rows = segscan_rows
        self._empty = torch.zeros((), device=dev)
        self._baseline_s: dict[int, float] = {}

    def _best_s(self, fn: Callable[[], None], reset: Callable[[], None],
                k: int) -> tuple[float, float]:
        """(best seconds of k iterations, seconds of the first run: on the
        card the capture and one replay)."""
        run = StepGraph(fn, self.dev, self.segscan_rows) if self.dev.type == "cuda" else fn
        reset()
        synchronize(self.dev)
        t0 = time.perf_counter()
        run()  # the capture and one replay
        synchronize(self.dev)
        first_s = time.perf_counter() - t0
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
        return best, first_s

    def measure(self, fn: Callable[[], None], reset: Callable[[], None],
                k: int) -> tuple[float, float, float]:
        """(ms per iteration less the empty stage's, the same before that
        subtraction, seconds of the first run), unrounded."""
        if k not in self._baseline_s:
            self._baseline_s[k] = self._best_s(
                lambda: self._empty.add_(1e-12), lambda: self._empty.zero_(), k
            )[0]
        best, first_s = self._best_s(fn, reset, k)
        return max(best - self._baseline_s[k], 0.0) / k * 1e3, best / k * 1e3, first_s

    def ms(self, fn: Callable[[], None], reset: Callable[[], None], k: int) -> float:
        return round(self.measure(fn, reset, k)[0], 3)


def stage_breakdown(config: Config, probe: dict, budget_left: Callable[[], float],
                    device="cuda") -> dict:
    """Per-stage ms on the warm map of the probe (the reference's stage
    report, `Odometry.cpp:99-109`, measured per stage on the device),
    checking the budget between stages and naming the last one timed when
    it runs out."""
    dev = device_policy.resolve(device)
    timer = StageTimer(dev, config.max_raw_points)
    noise = eskf.make_noise_params(config, dev)
    T_il = odo.lidar_extrinsics(config, dev)
    state, voxmap = probe["state"], probe["voxmap"]
    chunk, scan = probe["chunk"], probe["scan"]
    out: dict = {}

    state_buf = clone(state)

    def predict():
        base, _hist = eskf.predict_chunk_prefix(state_buf, chunk, noise,
                                                base_mask=chunk.t_rel <= 0.0)
        assign(state_buf, base)

    out["predict"] = timer.ms(predict, lambda: assign(state_buf, state), STAGE_ITERS["predict"])
    del state_buf
    base, hist = eskf.predict_chunk_prefix(state, chunk, noise, base_mask=chunk.t_rel <= 0.0)

    c = torch.zeros((), device=dev)  # a carried scalar the next iteration reads

    def prep():
        moved = scan._replace(points=scan.points + c * 1e-9)
        c.copy_(preprocess.preprocess(moved, hist, T_il, config).points[0, 0])

    if budget_left() <= 0:
        out["skipped_after"] = "predict"
        return out
    out["preprocess"] = timer.ms(prep, c.zero_, STAGE_ITERS["preprocess"])
    processed = preprocess.preprocess(scan, hist, T_il, config)

    guess = eskf.pose_of(base)
    # align over the shipped correspondence budget (the step core's slice)
    processed_a = ProcessedScan(*(x[: config.align_capacity] for x in processed))

    def align():
        # a data-dependent carry: each iteration starts from a moved guess
        moved = Pose(guess.R, guess.t + c * 1e-12)
        c.copy_(registration.align(processed_a, voxmap, moved, config).pose.t[0])

    if budget_left() <= 0:
        out["skipped_after"] = "preprocess"
        return out
    out["align"] = timer.ms(align, c.zero_, STAGE_ITERS["align"])
    out["align_iters"] = int(registration.align(processed, voxmap, guess, config).iterations)

    covs_packed = vm.pack_cov(processed.covs)
    map_buf = clone(voxmap)

    def insert():
        assign(map_buf, vm.insert(
            map_buf, processed.points, covs_packed, processed.valid,
            voxel_size=config.map_voxel_size,
            max_points_per_voxel=config.max_points_per_voxel,
        )[0])

    def evict():
        assign(map_buf, vm.evict_beyond(
            map_buf, guess.t,
            voxel_size=config.map_voxel_size,
            distance_threshold=config.remove_distance_threshold,
            max_points_per_voxel=config.max_points_per_voxel,
        )[0])

    def reset_map():
        assign(map_buf, voxmap)

    if budget_left() <= 0:
        out["skipped_after"] = "align"
        return out
    out["insert"] = timer.ms(insert, reset_map, STAGE_ITERS["insert"])
    if budget_left() <= 0:
        out["skipped_after"] = "insert"
        return out
    out["evict"] = timer.ms(evict, reset_map, STAGE_ITERS["evict"])
    del map_buf

    core = odo.make_step_core(config, dev)
    carry = (clone(state), clone(voxmap), probe["prev_R"].clone(), probe["prev_t"].clone())

    def flat(c):  # (state, map, R, t) as one tuple of tensors
        return (*c[0], *c[1], c[2], c[3])

    def full_step():
        new, _diag = core(carry, (chunk, scan, False))
        assign(flat(carry), flat(new))

    def reset_carry():
        assign(flat(carry), flat((state, voxmap, probe["prev_R"], probe["prev_t"])))

    if budget_left() <= 0:
        out["skipped_after"] = "evict"
        return out
    out["full_step"] = timer.ms(full_step, reset_carry, STAGE_ITERS["full_step"])
    return out


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def emit(result: dict) -> None:
    """Print the line for what is known so far; later lines are supersets."""
    print(json.dumps(result), flush=True)


def main(argv: list[str] | None = None, series: dict[str, Series] | None = None) -> int:
    """The bench.  `series` replaces the LIGHT and HEAVY series (keys
    "light", "heavy"), so that a test can run it at a small size; by
    default each is made when its phase starts."""
    ap = argparse.ArgumentParser(description="Throughput and accuracy of the port on the card.")
    ap.add_argument(
        "--budget-s", type=float,
        default=float(os.environ.get("ESKF_BENCH_BUDGET_S", "1500")),
        help="wall-clock budget; remaining phases are skipped when exceeded",
    )
    ap.add_argument("--device", default=device_policy.DEFAULT_DEVICE,
                    help="'cuda' (default) or 'cpu' (the plain paths, for tests)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    def elapsed() -> float:
        return round(time.perf_counter() - t_start, 1)

    def budget_left() -> float:
        return args.budget_s - (time.perf_counter() - t_start)

    dev = device_policy.resolve(args.device)
    device_line = nvidia_smi_line() if dev.type == "cuda" else "cpu"
    series = dict(series or {})
    light_only = os.environ.get("ESKF_BENCH_ONLY") == "light"

    # ---- phase 1: light series ----------------------------------------------
    light_s = series.get("light") or make_series(LIGHT)
    light = run_series(light_s.config, light_s.seq, dev)
    light.pop("_probe")
    light_est = light.pop("_est_positions")
    light.update(max_raw_points=light_s.config.max_raw_points,
                 max_scan_points=light_s.config.max_scan_points)
    result = {
        # until the heavy series lands, the light number is the headline
        "metric": "lio_scans_per_sec_per_chip",
        "value": light["scans_per_sec"],
        "unit": "scans/s",
        "vs_baseline": round(light["scans_per_sec"] / light_s.ref_scans_per_sec, 2),
        "vs_realtime": round(light["scans_per_sec"] / SCAN_RATE_HZ, 2),
        "series": "light",
        "light": light,
        "gn_backend": light_s.config.gn_backend,
        "device": device_line,
        "elapsed_s": elapsed(),
    }
    emit(result)
    if light_only:
        return 0

    # ---- phase 2: heavy series (shipped capacities: the headline) ------------
    if budget_left() < 60:
        result["note"] = "budget exhausted before heavy series"
        emit(result)
        return 0
    heavy_s = series.get("heavy") or make_series(HEAVY)
    heavy = run_series(heavy_s.config, heavy_s.seq, dev)
    probe = heavy.pop("_probe")
    heavy_est = heavy.pop("_est_positions")
    shipped = (heavy_s.config.max_raw_points, heavy_s.config.max_scan_points) == (
        HEAVY["max_raw_points"], HEAVY["max_scan_points"])
    result.update(
        value=heavy["scans_per_sec"],
        vs_baseline=round(heavy["scans_per_sec"] / heavy_s.ref_scans_per_sec, 2),
        vs_realtime=round(heavy["scans_per_sec"] / SCAN_RATE_HZ, 2),
        series="heavy",
        workload={
            "max_raw_points": heavy_s.config.max_raw_points,
            "max_scan_points": heavy_s.config.max_scan_points,
            "points_per_scan": heavy_s.points_per_scan,
            "note": "shipped config/hilti.yaml capacities" if shipped else "a caller's series",
        },
        heavy=heavy,
        gn_backend=heavy_s.config.gn_backend,
        elapsed_s=elapsed(),
    )
    emit(result)

    # ---- phase 3: per-stage breakdown at the heavy shapes --------------------
    if budget_left() < 60:
        result["note"] = "budget exhausted before stage breakdown"
        emit(result)
        return 0
    result["stages_ms"] = stage_breakdown(heavy_s.config, probe, budget_left, dev)
    del probe
    result["elapsed_s"] = elapsed()
    emit(result)

    # ---- phase 4: the reference filter on the same data ----------------------
    # last, so that its CPU timing is not contended by the device phases
    if budget_left() < 90:
        result["note"] = "budget exhausted before reference filter"
        emit(result)
        return 0
    heavy_ref, why_not = reference(heavy_s.seq, heavy_est)
    if heavy_ref is not None:
        result["heavy_ref"] = heavy_ref
        result["vs_baseline"] = round(heavy["scans_per_sec"] / heavy_ref["ref_scans_per_sec"], 2)
        result["baseline_source"] = f"measured at bench time, {heavy_ref['ref_threads']} threads"
    else:
        result["baseline_source"] = f"recorded round-4 constants ({why_not})"
    if budget_left() > 30:
        light_ref, _ = reference(light_s.seq, light_est)
        if light_ref is not None:
            result["light_ref"] = light_ref
            result["light"]["vs_baseline_measured"] = round(
                light["scans_per_sec"] / light_ref["ref_scans_per_sec"], 2
            )
    result["elapsed_s"] = elapsed()
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
