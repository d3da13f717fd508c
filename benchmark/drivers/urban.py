"""The closed-loop replay of a car's drive (`traffic/urban.py`): the replay
driver's run (`drivers/replay.py`) over a stream whose sweeps are cast
rays, checked against the coordinate-map reference (`check_coord.py`).

Set-up: the kernels' build, the stream (a ramp from rest and one lap),
packed once by the port's `replay.pack_sequence`, the init scan, then the
ramp's rows and the lap's up to the seed's phase through the runner, every
graph captured there.  The window replays the lap's rows cyclically from
the phase, one row a call, for `seconds` of the host's clock, the map
built with the configuration's key split.  Three blocks of rows are
sampled for the check: one drawn from the seed, one around an eviction,
and the three rows before an eviction, where the car is farthest from the
map's last centre; a run is correct only if the window dropped no point
for its voxel lying outside the map's key span.  The trajectory's error is
taken over the window's first `ate_laps` laps (all its rows if it holds
fewer): the filter drifts a few cm a lap, so an error over all the rows
would grow with the rows a run completes, with its speed.  With `trace` the runner
is built with a tracer (`utils.profiling.Tracer`): the window's rows split
by the stage stamps inside the captured step (`fold` inside the insert's
fold branch) and the device counter `map_folds`; after the window kernels A
and B are timed on the window's next row (`stages.kernel_ms`).
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from benchmark import check, check_coord, compare, stages, stats
from benchmark.drivers import common
from benchmark.drivers.replay import EVENTS_EVERY_ROWS
from benchmark.traffic import urban

# the step's counts a window row keeps
COUNTS = ("span_dropped_points", "capacity_dropped_points", "removed_voxels", "num_scan_points",
          "align_slice_overflow")


def generate(cell, dev: torch.device):
    """(the mix's stream, seconds it took)."""
    t0 = time.perf_counter()
    conf = cell.config["config"]
    stream = urban.generate(cell.config["sensor"], cell.mix, cell.mix["stream_seed"], dev,
                            lidar_quat_xyzw=conf["lidar_quat_xyzw"],
                            lidar_translation=conf["lidar_translation"])
    return stream, time.perf_counter() - t0


def stage_means(tracer, runner_rows: range) -> dict:
    """Over the given runner rows, each stage's mean ms (stamp to the next
    stamp) over the rows that hold it, and the rows that hold it."""
    rows = tracer.stage_rows()
    ms: dict[str, list[float]] = {}
    for k in runner_rows:
        if k >= len(rows):
            continue
        stages, _ = tracer.row_stages(rows[k])
        for name, a, b in stages:
            ms.setdefault(name, []).append((b - a) / 1e6)
    return {"stage_ms": {k: float(np.mean(v)) for k, v in ms.items()},
            "stage_rows": {k: len(v) for k, v in ms.items()}}


def run(cell, seed: int, seconds: float, trace: bool, device="cuda", t_start: float | None = None,
        fault=None, control: bool = False) -> dict:
    """One run of an urban replay cell; `fault(step)` may wrap the runner
    (tests); `control` also reads the control (`check_coord.control_readings`)."""
    from eskf_lio_torch.io.dataset import ImuRecord, LidarRecord, Sequence
    from eskf_lio_torch.map import voxel_map as vm
    from eskf_lio_torch.models import eskf
    from eskf_lio_torch.pipeline import odometry as odo
    from eskf_lio_torch.pipeline import replay
    from eskf_lio_torch.types import ImuChunk, Scan
    from eskf_lio_torch.utils.profiling import Tracer

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    mix = cell.mix
    config = common.program_config(cell.config["config"])  # a port without the split stops here
    key_bits = tuple(config.map_key_bits)
    ref_config = check_coord.reference_config(cell.config["config"])
    common.build_kernels(dev)
    stream, generate_s = generate(cell, dev)
    first = stream.ramp_sweeps + common.phase(mix, seed)  # the window's first sweep
    n_gen = stream.ramp_sweeps + stream.period_sweeps

    t_pack = time.perf_counter()
    i_end = stream.imu_after(float(stream.sweep_end[-1])) + 1
    t, g, a = stream.imu_block(0, i_end)
    seq = Sequence(
        imu=[ImuRecord(t=float(t[i]), gyro=g[i], accel=a[i]) for i in range(i_end)],
        scans=[LidarRecord(points=stream.sweep_points[i], t=stream.sweep_t[i],
                           start_time=float(stream.sweep_t[i][0]), end_time=float(stream.sweep_end[i]))
               for i in range(n_gen)],
    )
    raw_points = max(len(p) for p in stream.sweep_points)
    if raw_points > config.max_raw_points:
        raise RuntimeError(f"a sweep of {raw_points} points over max_raw_points")
    init_scan, chunks, scans, packed_evicts, updates, _ = replay.pack_sequence(config, seq, device=dev)
    del seq
    if chunks.dt.shape[0] != n_gen - 1 or not bool(updates.all()):
        raise RuntimeError("a chunk overflowed its capacity: the rows are not one per sweep")
    pack_s = time.perf_counter() - t_pack
    max_rows = int(seconds * 2000) + 64
    evicts = common.evict_flags(stream, first + max_rows, config.remove_period,
                                config.remove_distant_points)
    if evicts[1:n_gen] != [bool(x) for x in packed_evicts]:
        raise RuntimeError("the eviction schedule differs from pack_sequence's")

    tracer = Tracer() if trace and dev.type == "cuda" else None
    init_step = odo.make_init_step(config, dev)
    step = replay.make_replay_step(config, dev, tracer=tracer)
    if fault is not None:
        step = fault(step)
    voxmap = vm.VoxelMap.create(config.hash_capacity, config.map_delta_capacity, device=dev,
                                key_bits=key_bits)
    voxmap, _ = init_step(voxmap, init_scan)
    carry = (eskf.init_state(config, dev), voxmap, torch.eye(3, device=dev), torch.zeros(3, device=dev))
    flag = {True: torch.tensor([True]), False: torch.tensor([False])}

    def row(carry, k):
        """Stream sweep k through the runner: its generated sweep's packed row."""
        sl = slice(stream.sweep_index(k)[0] - 1, stream.sweep_index(k)[0])
        *carry, Rs, ts, diags = step(*carry, ImuChunk(*(x[sl] for x in chunks)),
                                     Scan(*(x[sl] for x in scans)), flag[evicts[k]], flag[True])
        return tuple(carry), Rs, ts, diags

    size = check.BLOCK_ROWS
    start = common.start_block(evicts, size)
    for k in range(1, first):  # warm-up: the ramp and the lap up to the phase
        carry, Rs, ts, diags = row(carry, k)
        if k in start.ks:
            start.poses.append((Rs[0], ts[0]))
            start.iterations.append(diags["icp_iterations"][0])
            if k == start.ks[-1]:
                start.after = check.clone_carry(carry)
    common.synchronize(dev)
    folds0 = tracer.device_counters().get("map_folds", 0) if tracer is not None else 0

    rng = np.random.default_rng(seed)
    want = {"any": rng.uniform(0.1, 0.8) * seconds, "evict": rng.uniform(0.1, 0.6) * seconds,
            "pre_evict": rng.uniform(0.1, 0.6) * seconds}
    blocks, active = [], None
    Rs_w, ts_w, it_w, fin_w, count_w, spans = [], [], [], [], [], []
    ahead = collections.deque()
    k = first
    pauses = common.GcPauses()
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    while True:
        if active is None:
            el = time.perf_counter() - t0
            kind = next((w for w, lag in want.items() if el >= lag and (
                w == "any" or (w == "evict" and evicts[k + 1])
                or (w == "pre_evict" and evicts[k + size]))), None)
            if kind is not None:
                del want[kind]
                active = check.Block(ks=list(range(k, k + size)), evicts=evicts[k: k + size],
                                     before=check.clone_carry(carry))
        if trace:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
        carry, Rs, ts, diags = row(carry, k)
        if trace:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            spans.append((e0, e1))
        Rs_w.append(Rs)
        ts_w.append(ts)
        it_w.append(diags["icp_iterations"])
        fin_w.append(diags["pose_finite"])
        count_w.append(torch.stack([diags[c] for c in COUNTS], -1))
        if active is not None:
            active.poses.append((Rs[0], ts[0]))
            active.iterations.append(diags["icp_iterations"][0])
            if k == active.ks[-1]:
                active.after = check.clone_carry(carry)
                blocks.append(active)
                active = None
        k += 1
        if (k - first) % EVENTS_EVERY_ROWS == 0:
            ev = torch.cuda.Event() if dev.type == "cuda" else None
            if ev is not None:
                ev.record()
                ahead.append(ev)
                if len(ahead) > 2:
                    oldest = ahead.popleft()
                    while not oldest.query():
                        time.sleep(2e-4)
        if active is None and time.perf_counter() - t0 >= seconds:
            break
    common.synchronize(dev)
    host_window_s = time.perf_counter() - t0
    pauses.stop()
    rows = k - first
    memory_peak = common.memory_peak(dev)

    window_ks = range(first, k)
    ate_rows = min(rows, int(mix["ate_laps"]) * stream.period_sweeps)
    est = torch.cat(ts_w).cpu().numpy().astype(np.float64)[:ate_rows]
    gt = np.stack([stream.gt_positions[stream.sweep_index(j)[0]] for j in window_ks[:ate_rows]])
    iters = torch.cat(it_w).cpu().numpy()
    finite = torch.cat(fin_w).cpu().numpy().astype(bool)
    counts = dict(zip(COUNTS, torch.cat(count_w).cpu().numpy().T))
    span_dropped = int(counts["span_dropped_points"].sum())
    capacity_dropped = int(counts["capacity_dropped_points"].sum())
    ev_rows = [j - first for j in window_ks if evicts[j]]
    record = {
        "setup_s": setup_s, "rows": rows, "host_window_s": host_window_s,
        "ate_m": stats.ate_rmse(est, gt) if finite.all() else float("inf"),
        "gn_iterations": int(iters.sum()), "update_rows": rows,
        "attempted": rows, "failed": int((~finite).sum()), "memory_peak_bytes": memory_peak,
    }
    half = len(est) // 2
    info = {"generate_s": generate_s, "pack_s": pack_s, "rows": rows, "first_sweep": first,
            "ate_rows": ate_rows, "gn_iterations_per_row": float(iters.sum()) / rows,
            "gc": pauses.summary(), "raw_points_max": raw_points,
            "ate_halves_cm": [stats.ate_rmse(est[:half], gt[:half]) * 100,
                              stats.ate_rmse(est[half:], gt[half:]) * 100] if finite.all() else None,
            "host_window_s": host_window_s, "evict_rows": len(ev_rows),
            "span_dropped_points": span_dropped, "capacity_dropped_points": capacity_dropped,
            "removed_voxels": [int(counts["removed_voxels"][i]) for i in ev_rows],
            "scan_points_max": int(counts["num_scan_points"].max()),
            "align_slice_overflow": int(counts["align_slice_overflow"].sum()),
            "live_voxels_end": int(carry[1].num_voxels())}

    if trace:
        ms = [a.elapsed_time(b) for a, b in spans]
        device_window_ms = spans[0][0].elapsed_time(spans[-1][1])
        record.update(row_spans_ms=ms, device_window_ms=device_window_ms,
                      busy_s=sum(ms) / 1e3, window_s=device_window_ms / 1e3)
        if tracer is not None:
            w0 = first - 1  # the warm-up's first row is the runner's row 0
            means = stage_means(tracer, range(w0, w0 + rows))
            folds = tracer.device_counters().get("map_folds", 0) - folds0
            record["urban"] = {**means, "map_folds": folds, "folds_per_row": folds / rows,
                               "evict_rows": len(ev_rows)}
            info["urban_trace"] = record["urban"]
            record["breakdown"] = {"device_ops": sorted(
                [[f"{name} (mean ms a row that holds it)", v / 1e3]
                 for name, v in means["stage_ms"].items()]
                + [["row (mean device span)", float(np.mean(ms)) / 1e3]], key=lambda x: -x[1])[:10]}
        b_next = stream.sweep_index(k)[0] - 1
        probe = {"state": stages.clone(carry[0]), "voxmap": stages.clone(carry[1]),
                 "R": carry[2].clone(), "t": carry[3].clone(),
                 "chunk": ImuChunk(*(x[b_next] for x in chunks)),
                 "scan": Scan(*(x[b_next] for x in scans))}
        record["kernels"] = stages.kernel_ms(config, probe, dev)
        del probe

    # the program's state is freed before the reference runs
    del step, carry, chunks, scans, init_scan, Rs_w, ts_w
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    for b in [start, *blocks]:
        b.iterations = [int(x) for x in b.iterations]
    gaps_read = check_coord.readings([start, *blocks], stream, ref_config, key_bits, dev)
    info["reference_s"] = time.perf_counter() - t_ref
    info["blocks"] = [b.ks[0] for b in blocks]
    info["live_voxels_blocks"] = [int(b.before[1].num_voxels()) for b in blocks]
    info["gn_iteration_gap"] = gaps_read.pop("gn_iteration_gap", None)
    info["gn_forced_rows"] = gaps_read.pop("gn_forced_rows", None)
    info["reference_removed"] = gaps_read.pop("reference_removed", None)
    info["readings"] = gaps_read
    if control:
        info["control_readings"] = check_coord.control_readings([start, *blocks], stream, ref_config,
                                                                key_bits, dev)
    ok, checks = compare.judge(gaps_read, cell.limits)
    checks["span_dropped_points"] = {"value": span_dropped, "limit": 0}
    record.update(correct=bool(ok and record["failed"] == 0 and span_dropped == 0),
                  checks=checks, info=info)
    return record
