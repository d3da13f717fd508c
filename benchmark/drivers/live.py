"""The open-loop stream at the sensor's own rate: `pipeline.stream.
StreamingRunner.run` over a paced source, as a robot that needs each pose
back within its sweep.

The source yields the ramp and the period up to the seed's phase unpaced
(the warm-up: the init sweep, every graph's capture, those rows), waits
until the runner has posed the warm-up's last sweep, then yields each IMU record at its stamp and each sweep
at its end on the wall clock, for `seconds` of sweeps.  It never waits for
the runner, except where the runner's bounded scan queue blocks its ingest
thread, which is the shipped behaviour.  A sweep's latency runs from when
it was due to the `on_scan` callback, when its pose is on the host; a
sweep never posed is missing.  The generator's lateness (the yield after
the due time) is recorded beside it.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from benchmark import check, compare, stats
from benchmark.drivers import common

# the sensor streams on this long past the last sweep: the runner ends when
# its source does, and a source that ended right after the last sweep's
# covering sample could end it before that sweep is posed
TAIL_S = 0.2


class _ImuCursor:
    """The stream's IMU records in order, fetched a block at a time."""

    def __init__(self, stream, block: int = 4096):
        self.stream, self.block, self.i = stream, block, 0
        self.arrays = stream.imu_block(0, block)

    def t(self) -> float:
        return float(self.arrays[0][self.i % self.block])

    def pop(self):
        from eskf_lio_torch.io.dataset import ImuRecord

        j = self.i % self.block
        rec = ImuRecord(t=float(self.arrays[0][j]), gyro=self.arrays[1][j], accel=self.arrays[2][j])
        self.i += 1
        if self.i % self.block == 0:
            self.arrays = self.stream.imu_block(self.i, self.i + self.block)
        return rec


class _EventedStep:
    """The driver's scan step with CUDA events recorded around each call
    while `on` is set (traced runs)."""

    def __init__(self, step):
        self.step = step
        self.on = False
        self.spans = []

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, *args):
        if not self.on:
            return self.step(*args)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = self.step(*args)
        e1.record()
        self.spans.append((e0, e1))
        return out


def run(cell, seed: int, seconds: float, trace: bool, device="cuda", t_start: float | None = None,
        fault=None, control: bool = False) -> dict:
    """One run of a live cell; `fault(odometry)` may break the driver's
    step (tests); `control` also reads the control (`benchmark/control.py`)."""
    from eskf_lio_torch.io.dataset import LidarRecord
    from eskf_lio_torch.pipeline.stream import StreamingRunner

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    mix = cell.mix
    config = common.program_config(cell.config["config"])
    ref_config = check.reference_config(cell.config["config"])
    common.build_kernels(dev)
    runner = StreamingRunner(config, device=dev)
    odo = runner.odo
    if trace:
        odo.scan_step = _EventedStep(odo.scan_step)
    if fault is not None:
        fault(odo)
    stream, generate_s = common.generate(cell, dev)

    rate = cell.config["sensor"]["scan_rate_hz"]
    # stream sweeps 0 .. warm - 1 are the warm-up: the ramp and the period
    # up to the seed's phase
    warm = stream.ramp_sweeps + common.phase(mix, seed)
    n_window = int(round(seconds * rate))
    total = warm + n_window
    evicts = common.evict_flags(stream, total, config.remove_period, config.remove_distant_points)
    size = check.BLOCK_ROWS
    start = common.start_block(evicts, size)
    rng = np.random.default_rng(seed)
    blocks = [check.Block(ks=list(ks), evicts=[evicts[j] for j in ks])
              for ks in common.sample_blocks(rng, warm, total - 1, evicts, size)]
    before_at = {b.ks[0] - 1: b for b in blocks}
    after_at = {b.ks[-1]: b for b in blocks}
    in_block = {j: b for b in [start, *blocks] for j in b.ks}

    posed_at = {}  # stream sweep -> wall time of its on_scan
    warm_done = threading.Event()
    clock = {}  # t0 (wall) and tau0 (sensor) of the window; counters at its start
    lateness = []

    def on_scan(o):
        now = time.perf_counter()
        j = len(o.trajectory_t) - 1
        posed_at[j] = now
        if j in in_block and j > 0:
            b = in_block[j]
            b.poses.append((o.prev_R.clone(), o.prev_t.clone()))
            b.iterations.append(int(o.diags[-1]["icp_iterations"]))
        if j == start.ks[-1]:
            start.after = check.clone_carry((o.state, o.voxmap, o.prev_R, o.prev_t))
        if j in before_at:
            before_at[j].before = check.clone_carry((o.state, o.voxmap, o.prev_R, o.prev_t))
        if j in after_at:
            after_at[j].after = check.clone_carry((o.state, o.voxmap, o.prev_R, o.prev_t))
        if j == warm - 1:
            clock.update(timer=(o.timer.total, o.timer.count), h2d=o.h2d_bytes)
            if trace:
                o.scan_step.on = True
            clock["gc"] = common.GcPauses()
            warm_done.set()

    def source():
        """Records in sensor-time order: the warm-up unpaced, the window
        paced on the wall clock."""
        tau0 = stream.sweep_end_of(warm - 1)
        imu = _ImuCursor(stream)
        for k in range(total):
            end = stream.sweep_end_of(k)
            if k == warm:
                if not warm_done.wait(timeout=120):
                    return  # the runner stopped during the warm-up
                clock["t0"], clock["tau0"] = time.perf_counter(), tau0
            while imu.t() < end:
                if k >= warm:
                    _pace(imu.t())
                yield imu.pop()
            g, shift = stream.sweep_index(k)
            if k >= warm:
                _pace(end)
            rec_t = stream.sweep_t[g] + shift
            yield LidarRecord(points=stream.sweep_points[g], t=rec_t,
                              start_time=float(rec_t[0]), end_time=end)
            if k >= warm:
                lateness.append(time.perf_counter() - due(end))
            if k == warm - 1:
                yield imu.pop()  # the sample that covers the warm-up's last sweep
        tail_end = stream.sweep_end_of(total - 1) + TAIL_S
        while imu.t() <= tail_end:
            _pace(imu.t())
            yield imu.pop()

    def due(tau):
        return clock["t0"] + (tau - clock["tau0"])

    def _pace(tau):
        wait = due(tau) - time.perf_counter()
        if wait > 0:
            time.sleep(wait)

    runner.run(source(), on_scan=on_scan)
    common.synchronize(dev)
    t_end_wall = time.perf_counter()
    clock["gc"].stop()
    memory_peak = common.memory_peak(dev)

    window = range(warm, total)
    lat = [posed_at[k] - due(stream.sweep_end_of(k)) if k in posed_at else float("inf")
           for k in window]
    missing = sum(1 for k in window if k not in posed_at)
    positions = {j: p for j, p in enumerate(odo.trajectory_p)}
    posed = [k for k in window if k in positions]
    finite = all(np.isfinite(positions[k]).all() for k in posed)
    est = np.stack([positions[k] for k in posed]).astype(np.float64) if posed else np.zeros((0, 3))
    gt = np.stack([stream.gt_positions[stream.sweep_index(k)[0]] for k in posed]) if posed else est
    timer_w = (odo.timer.total - clock["timer"][0], odo.timer.count - clock["timer"][1])
    record = {
        "setup_s": clock["t0"] - t_start,
        "latencies_s": lat,
        "ate_m": stats.ate_rmse(est, gt) if posed and finite else float("inf"),
        "driver_step_ms": timer_w[0] / max(timer_w[1], 1) * 1e3,
        "h2d_bytes_per_scan": (odo.h2d_bytes - clock["h2d"]) / max(timer_w[1], 1),
        "attempted": n_window, "failed": missing + (0 if finite else 1),
        "memory_peak_bytes": memory_peak,
    }
    info = {
        "generate_s": generate_s, "ingest": runner.ingest, "sweeps": n_window,
        "first_sweep": warm, "gc": clock["gc"].summary(),
        "missing": missing, "latency_p50_ms": stats.percentile(lat, 50) * 1e3,
        "latency_samples": len(lat),
        "latency_top_ms": sorted(([round(x * 1e3, 3), k] for x, k in zip(lat, window)),
                                 reverse=True)[:20],
        "generator_late_ms_max": max(lateness) * 1e3 if lateness else None,
        "generator_late_ms_p95": stats.percentile(lateness, 95) * 1e3 if lateness else None,
        "host_window_s": t_end_wall - clock["t0"], "evict_sweeps": int(sum(evicts[warm:total])),
    }
    if trace:
        spans = odo.scan_step.spans
        ms = [a.elapsed_time(b) for a, b in spans]
        gaps = [spans[i][1].elapsed_time(spans[i + 1][0]) for i in range(len(spans) - 1)]
        record.update(step_spans_ms=ms, busy_s=sum(ms) / 1e3, window_s=t_end_wall - clock["t0"])
        order = np.argsort(gaps)[::-1][:10]
        record["breakdown"] = {
            "device_ops": [["scan step graph (mean device span a sweep)", float(np.mean(ms)) / 1e3],
                           ["scan step graph (longest device span)", float(np.max(ms)) / 1e3]],
            "idle_gaps": [[f"before window sweep {int(i) + 1} (host: waiting for the sweep, "
                           "then chunk, pack_scan and upload)", gaps[i] / 1e3] for i in order],
        }
    del runner, odo
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    done = [b for b in [start, *blocks] if b.after is not None and len(b.poses) == len(b.ks)]
    gaps_read = check.readings(done, stream, ref_config, dev, shifted=True)
    info["reference_s"] = time.perf_counter() - t_ref
    info["blocks"] = [b.ks[0] for b in blocks]
    info["gn_iteration_gap"] = gaps_read.pop("gn_iteration_gap", None)
    info["gn_forced_rows"] = gaps_read.pop("gn_forced_rows", None)
    info["readings"] = gaps_read
    if control:
        info["control_readings"] = check.control_readings(done, stream, ref_config, dev, shifted=True)
    ok, checks = compare.judge(gaps_read, cell.limits)
    record.update(correct=bool(ok and record["failed"] == 0 and len(done) == 1 + len(blocks)),
                  checks=checks, info=info)
    return record
