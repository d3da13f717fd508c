"""The closed-loop replay: `pipeline.replay`'s runner over packed rows, back
to back, as an offline mapping user processes a log.

Set-up: the kernels' build (from the checkout's cache after the first
run), the stream (a ramp from rest and one period), packed once by the
port's `replay.pack_sequence`, the init scan (`odometry.make_init_step`),
then the ramp's rows and the period's up to the seed's phase through the
runner: every graph of the window is captured there (the step with and
without eviction).  The window replays the period's rows cyclically from
the phase, one row a call, for `seconds` of the host's clock; eviction
flags follow the stream's sensor time.  The device is
synchronised only at the window's two ends; the host stays at most two
groups of rows ahead of the device, polling an event (no synchronise), so
that the window ends on time.  With `trace`, CUDA events around every row
give the device's time a row and its idle gaps, and after the window the
stages and kernels are timed on a real row.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from benchmark import check, compare, stages, stats
from benchmark.drivers import common

EVENTS_EVERY_ROWS = 16  # the host runs at most two such groups of rows ahead of the device


def run(cell, seed: int, seconds: float, trace: bool, device="cuda", t_start: float | None = None,
        fault=None, control: bool = False) -> dict:
    """One run of a replay cell; `fault(step)` may wrap the runner (tests);
    `control` also reads the control (`benchmark/control.py`)."""
    from eskf_lio_torch.io.dataset import ImuRecord, LidarRecord, Sequence
    from eskf_lio_torch.map import voxel_map as vm
    from eskf_lio_torch.models import eskf
    from eskf_lio_torch.pipeline import odometry as odo
    from eskf_lio_torch.pipeline import replay
    from eskf_lio_torch.types import ImuChunk, Scan

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    mix = cell.mix
    config = common.program_config(cell.config["config"])
    ref_config = check.reference_config(cell.config["config"])
    common.build_kernels(dev)
    stream, generate_s = common.generate(cell, dev)
    first = stream.ramp_sweeps + common.phase(mix, seed)  # the window's first sweep
    n_gen = stream.ramp_sweeps + stream.period_sweeps

    # the program's inputs: the generated sweeps and the IMU through the
    # last sweep's first later sample, packed by the port
    t_pack = time.perf_counter()
    i_end = stream.imu_after(float(stream.sweep_end[-1])) + 1
    t, g, a = stream.imu_block(0, i_end)
    seq = Sequence(
        imu=[ImuRecord(t=float(t[i]), gyro=g[i], accel=a[i]) for i in range(i_end)],
        scans=[LidarRecord(points=stream.sweep_points[i], t=stream.sweep_t[i],
                           start_time=float(stream.sweep_t[i][0]), end_time=float(stream.sweep_end[i]))
               for i in range(n_gen)],
    )
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

    init_step = odo.make_init_step(config, dev)
    step = replay.make_replay_step(config, dev)
    if fault is not None:
        step = fault(step)
    voxmap = vm.VoxelMap.create(config.hash_capacity, config.map_delta_capacity, device=dev)
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
    for k in range(1, first):  # warm-up: the ramp and the period up to the phase
        carry, Rs, ts, diags = row(carry, k)
        if k in start.ks:
            start.poses.append((Rs[0], ts[0]))
            start.iterations.append(diags["icp_iterations"][0])
            if k == start.ks[-1]:
                start.after = check.clone_carry(carry)
    common.synchronize(dev)

    rng = np.random.default_rng(seed)
    f_any, f_evict = rng.uniform(0.1, 0.8), rng.uniform(0.1, 0.6)
    blocks, active, want = [], None, {"any": f_any * seconds, "evict": f_evict * seconds}
    Rs_w, ts_w, it_w, fin_w, spans = [], [], [], [], []
    ahead = collections.deque()
    k = first
    pauses = common.GcPauses()
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    while True:
        if active is None:
            el = time.perf_counter() - t0
            kind = ("any" if "any" in want and el >= want["any"] else
                    "evict" if "evict" in want and el >= want["evict"] and evicts[k + 1] else None)
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
    est = torch.cat(ts_w).cpu().numpy().astype(np.float64)
    gt = np.stack([stream.gt_positions[stream.sweep_index(j)[0]] for j in window_ks])
    iters = torch.cat(it_w).cpu().numpy()
    finite = torch.cat(fin_w).cpu().numpy().astype(bool)
    record = {
        "setup_s": setup_s, "rows": rows, "host_window_s": host_window_s,
        "ate_m": stats.ate_rmse(est, gt) if finite.all() else float("inf"),
        "gn_iterations": int(iters.sum()), "update_rows": rows,
        "attempted": rows, "failed": int((~finite).sum()), "memory_peak_bytes": memory_peak,
    }
    half = len(est) // 2
    info = {"generate_s": generate_s, "pack_s": pack_s, "rows": rows, "first_sweep": first,
            "gc": pauses.summary(),
            "ate_halves_cm": [stats.ate_rmse(est[:half], gt[:half]) * 100,
                              stats.ate_rmse(est[half:], gt[half:]) * 100] if finite.all() else None,
            "host_window_s": host_window_s, "evict_rows": int(sum(evicts[first:k]))}

    if trace:
        ms = [a.elapsed_time(b) for a, b in spans]
        gaps = [spans[i][1].elapsed_time(spans[i + 1][0]) for i in range(len(spans) - 1)]
        device_window_ms = spans[0][0].elapsed_time(spans[-1][1])
        record.update(row_spans_ms=ms, device_window_ms=device_window_ms,
                      busy_s=sum(ms) / 1e3, window_s=device_window_ms / 1e3)
        b_next = stream.sweep_index(k)[0] - 1
        probe = {"state": stages.clone(carry[0]), "voxmap": stages.clone(carry[1]),
                 "R": carry[2].clone(), "t": carry[3].clone(),
                 "chunk": ImuChunk(*(x[b_next] for x in chunks)),
                 "scan": Scan(*(x[b_next] for x in scans))}
        record["stage_ms"] = stages.stage_ms(config, probe, dev)
        record["kernels"] = stages.kernel_ms(config, probe, dev)
        order = np.argsort(gaps)[::-1][:10]
        record["breakdown"] = {
            "device_ops": sorted(
                [[f"{name} (ms a row, warm map)", v / 1e3] for name, v in record["stage_ms"].items()]
                + [["row (mean device span)", float(np.mean(ms)) / 1e3]],
                key=lambda x: -x[1])[:10],
            "idle_gaps": [[f"between rows {int(i)} and {int(i) + 1} (host: copy-in, replay call)",
                           gaps[i] / 1e3] for i in order],
        }
        del probe

    # the program's state is freed before the reference runs
    del step, carry, chunks, scans, init_scan, Rs_w, ts_w
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    for b in [start, *blocks]:
        b.iterations = [int(x) for x in b.iterations]
    gaps_read = check.readings([start, *blocks], stream, ref_config, dev, shifted=False)
    info["reference_s"] = time.perf_counter() - t_ref
    info["blocks"] = [b.ks[0] for b in blocks]
    info["gn_iteration_gap"] = gaps_read.pop("gn_iteration_gap", None)
    info["gn_forced_rows"] = gaps_read.pop("gn_forced_rows", None)
    info["readings"] = gaps_read
    if control:
        info["control_readings"] = check.control_readings([start, *blocks], stream, ref_config, dev,
                                                          shifted=False)
    ok, checks = compare.judge(gaps_read, cell.limits)
    record.update(correct=bool(ok and record["failed"] == 0), checks=checks, info=info)
    return record
