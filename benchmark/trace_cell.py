#!/usr/bin/env python3
"""One traced run of a cell with the program built with the port's tracer
(`eskf_lio_torch/utils/profiling.py::Tracer`), reduced to per-window
numbers: what the spans, counters and stamps inside the program say, which
no reader of `benchmark/metrics/` reads yet.

    python3 benchmark/trace_cell.py --workload mid360.live10hz --seed 1732050808 \\
        --seconds 51 --out build/trace/live.json

It runs the cell's driver (`benchmark/drivers/`) as `--trace 1` does, with
the runner that the driver builds (`StreamingRunner` live, the runner of
`make_replay_step` replayed) built with a `Tracer` instead, and writes one
JSON record to `--out` (a shorter line to the output):

* `metrics`: the per-layer metrics that PERF.md §7 (item 7) proposes, under
  their names, over the window's sweeps or rows;
* live: every window sweep tiled on the host clock from its due time (its
  end on the driver's paced clock) to the driver's `on_scan`: due -> put,
  `scan_queue`, `gate` (with the covering IMU sample's push lag),
  `process_scan`'s children, `on_scan`; the median and p95 sweeps' tiles and
  the window's means and medians;
* replayed: the window's rows split by the stage stamps inside the captured
  step, beside `benchmark/stages.py`'s probe row; the stamps' cover of the
  row's device span; the host's `row` and its children;
* `gaps_named`: the driver's ten longest idle gaps, in its values and order,
  each named by the program's host spans that overlap it
  (`Tracer.overlaps`), or "outside the program";
* `clock`: the mapping of the device's clocks onto the host's
  (`Tracer.clock`); `costs`: the tracer's own costs on this host and card.

`run` holds the run's own end-to-end numbers, which are not the
benchmark's: the tracer is on.  Only a `benchmark` change that builds the
program with a tracer inside the drivers' traced branches makes these
numbers metrics.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402

PROCESS_CHILDREN = ("chunk_build", "scan_pack", "upload", "step_launch", "read_back", "record")


def _mean(xs):
    xs = list(xs)
    return float(np.mean(xs)) if xs else None


def _nearest_rank(rows: list, q: float):
    return rows[max(0, math.ceil(q / 100 * len(rows)) - 1)]


def _by_sweep(tracer) -> dict:
    """sweep -> span name -> [(start, end)]."""
    out: dict = {}
    for name, a, b, _, sweep in tracer.spans():
        out.setdefault(sweep, {}).setdefault(name, []).append((a, b))
    return out


def _named(tracer, t0: float, t1: float) -> list:
    return [[name, round(ms, 4)] for name, ms in tracer.overlaps(int(t0), int(t1))]


@contextlib.contextmanager
def traced_program(tracer, seen: dict):
    """While open, the drivers build their runner with `tracer`: the live
    runner also hands its records and the driver's paced clock to `seen`
    (`order`: ("imu" | "sweep", sensor time) in the stream's order; `clock`:
    the live driver's dict with `t0` and `tau0`; `warm_counters`: the
    counters when the warm-up's last sweep was posed)."""
    from eskf_lio_torch.io.dataset import ImuRecord
    from eskf_lio_torch.pipeline import replay, stream

    runner_cls, make_step = stream.StreamingRunner, replay.make_replay_step

    class TracedRunner(runner_cls):
        def __init__(self, config, scan_queue_depth=4, device="cuda"):
            super().__init__(config, scan_queue_depth, device, tracer=tracer)

        def run(self, source, max_scans=None, on_scan=None):
            cells = dict(zip(on_scan.__code__.co_freevars, on_scan.__closure__ or ()))
            seen["clock"] = cells["clock"].cell_contents
            warm = None
            order = seen["order"] = []

            def records():
                for rec in source:
                    is_imu = isinstance(rec, ImuRecord)
                    order.append(("imu", rec.t) if is_imu else ("sweep", rec.end_time))
                    yield rec

            def posed(odo):
                nonlocal warm
                on_scan(odo)
                if warm is None and seen["clock"].get("gc") is not None:
                    warm = seen["warm_counters"] = dict(tracer.counters)

            return super().run(records(), max_scans, posed)

    def traced_make(config, device="cuda"):
        return make_step(config, device, tracer=tracer)

    stream.StreamingRunner, replay.make_replay_step = TracedRunner, traced_make
    try:
        yield
    finally:
        stream.StreamingRunner, replay.make_replay_step = runner_cls, make_step


def trace(cell, seed: int, seconds: float, device="cuda", t_start: float | None = None) -> dict:
    """One run of `cell` through its driver with the program traced, and
    its record (the module's docstring); on the CPU the driver runs
    untraced (no CUDA events) and the record holds the host's spans only."""
    from eskf_lio_torch.utils.profiling import Tracer

    dev = torch.device(device)
    tracer, seen = Tracer(), {}
    with traced_program(tracer, seen):
        run = harness.driver(cell).run(cell, seed, seconds, dev.type == "cuda", device=device,
                                       t_start=time.perf_counter() if t_start is None else t_start)
    live = cell.mix["driver"] == "live"
    captures = [b - a for name, a, b, _, _ in tracer.spans() if name == "graph_capture"]
    out = {"workload": cell.workload["name"], "seed": seed, "correct": run["correct"],
           "run": {k: run[k] for k in ("setup_s", "ate_m", "failed", "rows", "driver_step_ms")
                   if k in run},
           "graph_captures": len(captures), "graph_capture_s": sum(captures) / 1e9,
           "counters": dict(tracer.counters), "spans_recorded": tracer.n}
    out.update(_live(tracer, run, seen) if live else _replay(tracer, run))
    metrics = out.setdefault("metrics", {})
    metrics["graph_capture_s"] = out["graph_capture_s"]
    if dev.type == "cuda":
        out["clock"] = tracer.clock()
        out["costs"] = costs(dev)
    return out


def _replay(tracer, run) -> dict:
    """The window's rows: runner rows `first - 1` on (the warm-up's first
    driver row is the runner's row 0)."""
    w0, rows = run["info"]["first_sweep"] - 1, run["rows"]
    ids = range(w0, w0 + rows)
    sweeps = _by_sweep(tracer)
    res = {"host_ms": {name: _mean((b - a) / 1e6 for k in ids for a, b in sweeps.get(k, {}).get(name, []))
                       for name in ("row", "copy_in", "replay", "copy_out")}}
    nodes = tracer.counters.get("graph_nodes.scan_step")
    metrics = {"host_ms_per_row.replay": res["host_ms"]["row"],
               "graph_nodes.replay": None if nodes is None
               else nodes - tracer.counters.get("stamp_nodes.scan_step", 0)}
    res["metrics"] = metrics
    dmap = {sweep: (a, b) for _, sweep, a, b in tracer.device_spans("row")}
    if not dmap:
        return res
    res["row_device_ms"] = _mean((dmap[k][1] - dmap[k][0]) / 1e6 for k in ids if k in dmap)
    stage_rows = tracer.stage_rows()
    stages: dict = {}
    gn, first_to_last, start_lag, end_lag = [], [], [], []
    for k in ids:
        if k >= len(stage_rows) or k not in dmap:
            continue
        row = stage_rows[k]
        split, ticks = tracer.row_stages(row)
        for name, a, b in split:
            stages.setdefault(name, []).append((b - a) / 1e6)
        gn.append(ticks.get("gn", 0))
        first_to_last.append((row[-1][1] - row[0][1]) / 1e6)
        start_lag.append((row[0][1] - dmap[k][0]) / 1e3)
        end_lag.append((dmap[k][1] - row[-1][1]) / 1e3)
    res["stage_window_ms"] = {k: _mean(v) for k, v in stages.items()}
    res["stage_window_rows"] = {k: len(v) for k, v in stages.items()}
    res["stage_probe_ms"] = run.get("stage_ms")
    res["gn_stamps_per_row"] = _mean(gn)
    res["gn_iterations_per_row"] = run["gn_iterations"] / max(rows, 1)
    res["first_to_last_ms"] = _mean(first_to_last)
    res["stamps_cover"] = (res["first_to_last_ms"] / res["row_device_ms"]
                           if first_to_last and res["row_device_ms"] else None)
    res["first_stamp_after_row_start_us"] = [_mean(start_lag), min(start_lag), max(start_lag)] \
        if start_lag else None
    res["row_end_after_last_stamp_us"] = [_mean(end_lag), min(end_lag), max(end_lag)] \
        if end_lag else None
    window = res["stage_window_ms"]
    metrics.update({f"{name}_ms.window": window.get(stamp) for name, stamp in (
        ("predict", "predict"), ("preprocess", "preprocess"), ("align", "align"),
        ("insert", "map_insert"), ("evict", "evict"))})
    # the driver's gaps follow its own events around each window row i
    named = []
    for label, value in (run.get("breakdown") or {}).get("idle_gaps", []):
        i = int(re.search(r"between rows (\d+) and", label).group(1))
        a, b = dmap.get(w0 + i), dmap.get(w0 + i + 1)
        named.append([value, i, _named(tracer, a[1], b[0]) if a and b else None])
    res["gaps_named"] = named
    return res


def _live(tracer, run, seen: dict) -> dict:
    """The window's sweeps, stream ids `first_sweep` on, tiled."""
    warm, n = run["info"]["first_sweep"], run["info"]["sweeps"]
    lat = run["latencies_s"]
    clock = seen["clock"]
    ends, cover = [], {}
    for kind, t in seen["order"]:
        if kind == "sweep":
            ends.append(t)
        elif ends and len(ends) - 1 not in cover:
            cover[len(ends) - 1] = t  # the sample that covers the last sweep

    def due_ns(tau):
        return (clock["t0"] + tau - clock["tau0"]) * 1e9

    sweeps = _by_sweep(tracer)
    tiles = []
    for i in range(n):
        k = warm + i
        s = sweeps.get(k, {})
        if not math.isfinite(lat[i]) or not all(
                x in s for x in ("scan_put", "scan_queue", "gate", "process_scan", "on_scan")):
            continue
        due = due_ns(ends[k])
        (put, _), (q0, q1), (g0, g1) = s["scan_put"][0], s["scan_queue"][0], s["gate"][0]
        (p0, p1), (on, _) = s["process_scan"][0], s["on_scan"][0]
        row = {"sweep": k, "latency_ms": lat[i] * 1e3, "due_to_put": (put - due) / 1e6,
               "scan_queue": (q1 - q0) / 1e6, "gate": (g1 - g0) / 1e6,
               **{c: sum(b - a for a, b in s.get(c, [])) / 1e6 for c in PROCESS_CHILDREN},
               "on_scan_to_posed": (due + lat[i] * 1e9 - on) / 1e6,
               # the loop's own lines between the spans, not counted below
               "untraced": ((g0 - q1) + (p0 - g1) + (on - p1)) / 1e6}
        if k in cover and "imu_push" in s:
            row["covering_due_after_sweep_ms"] = (cover[k] - ends[k]) * 1e3
            row["imu_push_lag"] = (s["imu_push"][0][0] - due_ns(cover[k])) / 1e6
        counted = (row["due_to_put"] + row["scan_queue"] + row["gate"]
                   + sum(row[c] for c in PROCESS_CHILDREN) + row["on_scan_to_posed"])
        row["spans_sum_less_latency"] = counted - row["latency_ms"]
        tiles.append(row)
    res: dict = {"tiled_sweeps": len(tiles), "window_sweeps": n}
    if tiles:
        by_latency = sorted(tiles, key=lambda r: r["latency_ms"])
        res["tile_median"] = _nearest_rank(by_latency, 50)
        res["tile_p95"] = _nearest_rank(by_latency, 95)
        keys = [k for k in tiles[0] if k != "sweep"]
        res["tile_means"] = {k: _mean(r[k] for r in tiles if k in r) for k in keys}
        res["tile_medians"] = {k: float(np.median([r[k] for r in tiles if k in r])) for k in keys}
        res["spans_sum_less_latency_abs_max"] = max(abs(r["spans_sum_less_latency"]) for r in tiles)
    means = res.get("tile_means", {})
    counters, at_warm = tracer.counters, seen.get("warm_counters", {})
    polls = counters.get("gate_polls", 0) - at_warm.get("gate_polls", 0)
    res["window_counters"] = {k: counters.get(k, 0) - at_warm.get(k, 0)
                              for k in ("gate_polls", "puts_blocked", "upload_waits")}
    res["metrics"] = {
        "queue_wait_ms.live": means.get("scan_queue"),
        "gate_wait_ms.live": means.get("gate"),
        "gate_polls_per_scan.live": polls / n if n else None,
        "imu_push_lag_ms.live": means.get("imu_push_lag"),
        "host_prep_ms.live": (means["chunk_build"] + means["scan_pack"] + means["upload"])
        if means else None,
        "readback_wait_ms.live": means.get("read_back"),
    }
    steps = {sweep: (a, b) for _, sweep, a, b in tracer.device_spans("step")}
    res["step_device_ms"] = _mean((steps[k][1] - steps[k][0]) / 1e6
                                  for k in range(warm, warm + n) if k in steps)
    # the driver's gap i lies before window sweep i (between its step events)
    named = []
    for label, value in (run.get("breakdown") or {}).get("idle_gaps", []):
        i = int(re.search(r"before window sweep (\d+)", label).group(1))
        a, b = steps.get(warm + i - 1), steps.get(warm + i)
        named.append([value, i, _named(tracer, a[1], b[0]) if a and b else None])
    res["gaps_named"] = named
    return res


def costs(dev: torch.device) -> dict:
    """The tracer's costs here: host ns a span (begin and end), a `record`,
    a count and a device span's two events; device us a stamp node in a
    replayed graph (200 stamps against one small kernel); the steps of
    `%globaltimer` between back-to-back stamps."""
    from eskf_lio_torch.utils.graphs import prepare
    from eskf_lio_torch.utils.profiling import Tracer, now

    host, n = Tracer(), 100_000
    res = {}
    for name, fn in (("span_ns", lambda: (host.begin("x"), host.end())),
                     ("record_ns", lambda: host.record("x", 1, 2)),
                     ("count_ns", lambda: host.count("x"))):
        t0 = now()
        for _ in range(n):
            fn()
        res[name] = (now() - t0) / n
    t0 = now()
    for _ in range(2000):
        host.device_end(host.device_begin("d"))
    res["device_span_ns"] = (now() - t0) / 2000
    torch.cuda.synchronize()

    stamper = Tracer()
    stamper.attach(dev)
    stream = prepare(dev, 1024)
    stamps, plain = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    dummy = torch.zeros(1, device=dev)
    with torch.cuda.graph(stamps, stream=stream):
        for _ in range(200):
            stamper.stage("x", tick=True)
    with torch.cuda.graph(plain, stream=stream):
        dummy.add_(1)
    for _ in range(3):
        stamps.replay()
        plain.replay()
    e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    e0.record()
    for _ in range(20):
        stamps.replay()
    e1.record()
    for _ in range(20):
        plain.replay()
    e2.record()
    torch.cuda.synchronize()
    res["stamp_us"] = (e0.elapsed_time(e1) - e1.elapsed_time(e2)) * 1e3 / (20 * 199)
    ring = stamper.stamps()
    steps = np.diff(ring[ring[:, 0] > 0, 1])
    steps = steps[steps > 0]
    if len(steps):
        res["globaltimer_step_ns"] = [int(steps.min()), float(np.median(steps))]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True, help="the JSON record's path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_cell: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    out = trace(cell, args.seed, args.seconds, "cuda", t_start=T_START)
    out["card"] = harness.card_line()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=float)
    brief = {k: out[k] for k in ("workload", "seed", "correct", "metrics", "tile_median", "tile_p95",
                                 "stage_window_ms", "stamps_cover", "clock", "costs") if k in out}
    print(json.dumps(brief, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
