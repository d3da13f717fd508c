"""Profiling / tracing (port of `eskf_lio_tpu/utils/profiling.py`).

The reference hand-rolls `omp_get_wtime()` timers around three pipeline
stages and prints avg/max on exit (`Odometry.cpp:10-14,99-109`).  Here the
same avg/max stage summary exists (`pipeline.odometry.StageTimer`),
`torch.profiler` integration (`device_trace`, `annotate`), and `Tracer`,
the port's own tracer.

`Tracer` is off unless a program object is built with one (`Odometry`,
`StreamingRunner`, `make_replay_step`, `make_scan_step`, ...): without it a
boundary of the hot path costs one `is None` test.  With it:

* host spans, (name, start ns, end ns, parent span, sweep id), on the host
  clock `time.perf_counter_ns()`, kept in preallocated lists that double
  when full (no span is dropped); spans of one
  sweep (one replayed row) share its id, its index in the stream (the
  runner's row count in a replay);
* counters at the same boundaries;
* device spans from CUDA events that the program records around the step
  (live) or the row (replay), mapped onto the host clock by two anchors
  (`anchor`: an event recorded, then synchronised, with the host clock read
  around the wait) and a linear fit between them;
* stage stamps from inside a captured step: `stage(tracer, name)` at each
  stage boundary captures one node of `csrc/graph_cond.cu`'s stamp kernel,
  which writes (tag, `%globaltimer` ns) into a ring on the device at a cursor
  it advances itself, so that a replay reads nothing back; the ring is
  drained after the window and mapped onto the host clock by stamps
  launched at the anchors.  Eagerly (on the CPU) the same call records host
  spans.

`export(path)` writes everything as a Chrome-trace JSON file that Perfetto
and chrome://tracing open; `summary()` gives per-name means.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from eskf_lio_torch.ops._cuda import stream_handle
from eskf_lio_torch.utils.graphs import GRAPH_COND

now = time.perf_counter_ns  # the tracer's clock, the benchmark drivers' clock in ns

# stamp tags: 0 an anchor's stamp, -1 the kernel's first launch, 1.. the
# stage names in capture order
_ANCHOR_TAG, _WARM_TAG = 0, -1


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace of everything inside the block and
    write it as a Chrome trace into `logdir` (host activity, and the
    device's where a card is present)."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    )


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in profiler timelines."""
    with record_function(name):
        yield


def stage(tracer: Tracer | None, name: str, tick: bool = False) -> None:
    """A stage boundary inside the step: `name` starts where the previous
    stage ends ("end" closes the last).  While a CUDA stream captures a step
    built with a tracer, one stamp node; run eagerly, a host span (a `tick`,
    such as a GN iteration's head, an instant inside the open stage);
    without a tracer, nothing."""
    if tracer is not None:
        tracer.stage(name, tick)


class Tracer:
    """Spans, counters, device spans and stage stamps of one run (see the
    module's docstring).  Room for `SPANS` host spans is made at the start
    and doubled whenever it fills; the stamp ring keeps the last `STAMPS`
    stamps (~10 a row: 100 s of rows at 1,000 rows/s)."""

    SPANS = 1 << 16
    STAMPS = 1 << 20  # a power of two: the kernel wraps its cursor with a mask

    def __init__(self):
        self.t0 = now()
        self.names: list[str] = []
        self._ids: dict[str, int] = {}
        # span i: name id, start, end, parent span (-1: none), sweep (-1:
        # none), track (the recording thread's number; explicit spans their own)
        self._name = [0] * self.SPANS
        self._start = [0] * self.SPANS
        self._end = [0] * self.SPANS
        self._parent = [-1] * self.SPANS
        self._sweep = [-1] * self.SPANS
        self._track = [0] * self.SPANS
        self.n = 0
        self.counters: dict[str, int] = {}
        self.tracks: list[str] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        # device spans: [name id, sweep, start event, end event]
        self._device: list[list] = []
        self._streams: dict[tuple[int, int], torch.cuda.Stream] = {}
        # (event, host ns before its record, after its wait, and the same
        # pair for the anchor's stamp or None)
        self._anchors: list[tuple] = []
        self._finished = False
        # stamp ring on one device, and the stage names' tags
        self.ring: torch.Tensor | None = None
        self.cursor: torch.Tensor | None = None
        self._tags: dict[str, int] = {}
        self._ticks: set[str] = set()
        self.stamps_captured = 0

    # -- host spans ---------------------------------------------------------

    def _id(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            with self._lock:
                i = self._ids.setdefault(name, len(self.names))
                if i == len(self.names):
                    self.names.append(name)
        return i

    def _thread(self):
        loc = self._local
        if not hasattr(loc, "stack"):
            loc.stack, loc.mark = [], -1
            with self._lock:
                loc.track = len(self.tracks)
                self.tracks.append(threading.current_thread().name)
        return loc

    def _new(self, name: str, start: int, end: int, parent: int, sweep: int, track: int) -> int:
        name_id = self._id(name)
        with self._lock:
            i = self.n
            if i == len(self._name):
                for col in (self._name, self._start, self._end, self._parent, self._sweep,
                            self._track):
                    col.extend(col[:1] * i)  # the slots' contents are overwritten before read
            self.n = i + 1
            self._name[i], self._start[i], self._end[i] = name_id, start, end
            self._parent[i], self._sweep[i], self._track[i] = parent, sweep, track
        return i

    def begin(self, name: str, sweep: int | None = None, t: int | None = None) -> int:
        """Open a span on this thread, inside the innermost open one, whose
        sweep it takes unless given.  Returns its index."""
        loc = self._thread()
        parent = loc.stack[-1] if loc.stack else -1
        if sweep is None:
            sweep = self._sweep[parent] if parent >= 0 else -1
        i = self._new(name, now() if t is None else t, 0, parent, sweep, loc.track)
        loc.stack.append(i)
        return i

    def end(self, t: int | None = None) -> int:
        """Close this thread's innermost open span; returns the time."""
        t = now() if t is None else t
        self._end[self._local.stack.pop()] = t
        return t

    def switch(self, name: str) -> None:
        """Close the innermost open span and open `name` beside it at the
        same instant (same parent, same sweep): spans that tile."""
        sweep = self._sweep[self._local.stack[-1]]
        self.begin(name, sweep, self.end())

    def record(self, name: str, start: int, end: int, sweep: int = -1) -> int:
        """A closed span with its own times (one that starts on another
        thread), drawn on a track of its name."""
        loc = self._thread()
        parent = loc.stack[-1] if loc.stack else -1
        return self._new(name, start, end, parent, sweep, -1 - self._id(name))

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def stage(self, name: str, tick: bool = False) -> None:
        """`stage(tracer, name, tick)`: a stamp node under capture, else a
        host span (see the function)."""
        if self.ring is not None and torch.cuda.is_current_stream_capturing():
            self._stamp(self._tag(name))
            self.stamps_captured += 1
            if tick:
                self._ticks.add(name)
            return
        loc = self._thread()
        t = now()
        if tick:
            self.record(name, t, t, self._sweep[loc.stack[-1]] if loc.stack else -1)
            return
        if loc.mark >= 0 and loc.stack and loc.stack[-1] == loc.mark:
            self.end(t)
        loc.mark = self.begin(name, t=t) if name != "end" else -1

    def spans(self) -> list[tuple]:
        """(name, start, end, parent, sweep) of every closed span, in the
        order they were opened."""
        return [(self.names[self._name[i]], self._start[i], self._end[i], self._parent[i],
                 self._sweep[i]) for i in range(self.n) if self._end[i]]

    def overlaps(self, t0: int, t1: int) -> list[tuple[str, float]]:
        """What the host did between `t0` and `t1` ns: each span with no
        child that overlaps the interval, by name, with the milliseconds it
        covers of it, largest first, and last the milliseconds no such span
        covers as "outside the program"."""
        parents = {self._parent[i] for i in range(self.n)}
        by_name: dict[str, float] = {}
        cover = []
        for i in range(self.n):
            if i in parents or not self._end[i]:
                continue
            a, b = max(self._start[i], t0), min(self._end[i], t1)
            if b > a:
                nm = self.names[self._name[i]]
                by_name[nm] = by_name.get(nm, 0.0) + (b - a) / 1e6
                cover.append((a, b))
        covered, last = 0, t0
        for a, b in sorted(cover):
            a = max(a, last)
            if b > a:
                covered, last = covered + b - a, b
        out = sorted(by_name.items(), key=lambda x: -x[1])
        out.append(("outside the program", (t1 - t0 - covered) / 1e6))
        return out

    # -- device spans -------------------------------------------------------

    def anchor(self) -> None:
        """Tie the device's clocks to the host's, with the device idle: an
        event recorded and waited for, the host clock read before the record
        and after the wait (the narrowest of three tries); with a stamp ring,
        then a stamp launched and waited for in the same way."""
        torch.cuda.synchronize()
        best = None
        for _ in range(3):
            ev = torch.cuda.Event(enable_timing=True)
            h0 = now()
            ev.record()
            ev.synchronize()
            h1 = now()
            if best is None or h1 - h0 < best[2] - best[1]:
                best = (ev, h0, h1)
        stamp = None
        if self.ring is not None:
            h0 = now()
            self._stamp(_ANCHOR_TAG)
            torch.cuda.synchronize()
            stamp = (h0, now())
        self._anchors.append((*best, stamp))

    def finish(self) -> None:
        """Take the closing anchor, after the traced window (synchronises).
        A reader of device times takes it itself where it is missing."""
        self.anchor()
        self._finished = True

    def _stream(self) -> torch.cuda.Stream:
        """The current stream, its object kept by raw handle: building one
        (`torch.cuda.current_stream()`) costs more than the event's record."""
        dev = torch.device("cuda", torch.cuda.current_device())
        key = (dev.index, stream_handle(dev))
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = torch.cuda.current_stream(dev)
        return stream

    def device_begin(self, name: str, sweep: int = -1) -> list:
        """Record an event that opens a device span on the current stream
        (the first one takes the first anchor)."""
        if not self._anchors:
            self.anchor()
        self._finished = False
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record(self._stream())
        span = [self._id(name), sweep, e0, None]
        self._device.append(span)
        return span

    def device_end(self, span: list) -> None:
        span[3] = torch.cuda.Event(enable_timing=True)
        span[3].record(self._stream())

    def _fit(self):
        """(first anchor's event, its host ns, host ns per device ms)."""
        if not self._finished:
            self.finish()
        (e0, a0, b0, _), (e1, a1, b1, _) = self._anchors[0], self._anchors[-1]
        h0, h1 = (a0 + b0) / 2, (a1 + b1) / 2
        return e0, h0, (h1 - h0) / e0.elapsed_time(e1)

    def device_spans(self, name: str | None = None) -> list[tuple]:
        """(name, sweep, start ns, end ns) of each device span on the host
        clock, in the order they were recorded."""
        if not self._device:
            return []
        e0, h0, per_ms = self._fit()
        want = None if name is None else self._ids.get(name, -2)
        return [(self.names[n], sweep, h0 + e0.elapsed_time(a) * per_ms,
                 h0 + e0.elapsed_time(b) * per_ms)
                for n, sweep, a, b in self._device
                if b is not None and (want is None or n == want)]

    def clock(self) -> dict:
        """The mapping's error: each anchor's wait (us), and the drift of the
        device's clock against the host's between the first and last anchor
        (parts per million), for the events and for the stamps."""
        if not self._finished:
            self.finish()
        (e0, a0, b0, _), (e1, a1, b1, _) = self._anchors[0], self._anchors[-1]
        host_ms = ((a1 + b1) - (a0 + b0)) / 2e6
        out = {"anchors": len(self._anchors), "span_s": host_ms / 1e3,
               "wait_us": [(b - a) / 1e3 for _, a, b, _ in self._anchors],
               "stamp_wait_us": [(s[1] - s[0]) / 1e3 for *_, s in self._anchors if s],
               "event_drift_ppm": (e0.elapsed_time(e1) / host_ms - 1) * 1e6}
        fit = self._stamp_fit(self.stamps())
        if fit is not None:
            out["stamp_drift_ppm"] = (fit[2] - 1) * 1e6
        return out

    # -- stage stamps -------------------------------------------------------

    def attach(self, device: torch.device) -> None:
        """Make the stamp ring on `device` (outside any capture; once)."""
        if self.ring is not None:
            if self.ring.device != device:
                raise ValueError(f"the tracer's stamps live on {self.ring.device}, not {device}")
            return
        GRAPH_COND.lib()
        self.ring = torch.zeros((self.STAMPS, 2), dtype=torch.int64, device=device)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=device)
        # the stamp kernel's first launch loads it: not inside an anchor's wait
        self._stamp(_WARM_TAG)

    def _tag(self, name: str) -> int:
        if name not in self._tags:
            self._tags[name] = len(self._tags) + 1
        return self._tags[name]

    def _stamp(self, tag: int) -> None:
        GRAPH_COND.call("graph_cond_stamp", self.ring.data_ptr(), self.cursor.data_ptr(), tag,
                        self.STAMPS - 1, stream_handle(self.ring.device))

    def stamps(self) -> np.ndarray:
        """The ring's stamps in the order they were written, [n, 2] of (tag,
        `%globaltimer` ns): one read of the device, after the window."""
        if self.ring is None:
            return np.zeros((0, 2), np.int64)
        n = int(self.cursor.item())
        ring = self.ring.cpu().numpy()
        if n <= self.STAMPS:
            return ring[:n]
        return np.roll(ring, -(n % self.STAMPS), axis=0)

    def _stamp_fit(self, stamps: np.ndarray):
        """(first anchor stamp's timer ns, its host ns, host ns per timer
        ns) from the anchors' stamps (the last ones, where the ring wrapped),
        or None with fewer than two."""
        timer = stamps[stamps[:, 0] == _ANCHOR_TAG, 1]
        hosts = [(s[0] + s[1]) / 2 for *_, s in self._anchors if s][-len(timer):]
        if len(timer) < 2:
            return None
        return timer[0], hosts[0], (hosts[-1] - hosts[0]) / (timer[-1] - timer[0])

    def stage_rows(self) -> list[list[tuple[str, float]]]:
        """The stamps of each replay of a stamped step, (stage, host ns),
        cut at each `predict` stamp; the anchors' stamps map the device's
        timer onto the host clock by a linear fit."""
        if self.ring is None:
            return []
        if not self._finished:
            self.finish()
        stamps = self.stamps()
        fit = self._stamp_fit(stamps)
        if fit is None:
            return []
        g0, h0, per_ns = fit
        names = {t: n for n, t in self._tags.items()}
        rows, row = [], None
        for tag, g in stamps[stamps[:, 0] > _ANCHOR_TAG]:
            nm = names.get(int(tag), str(int(tag)))
            if nm == "predict":
                row = []
                rows.append(row)
            if row is not None:
                row.append((nm, h0 + float(g - g0) * per_ns))
        return rows

    # -- output -------------------------------------------------------------

    def row_stages(self, row: list[tuple[str, float]]):
        """One stamped row's stages, (name, start ns, end ns), each from its
        stamp to the next stage's (ticks skipped), and its ticks by name."""
        stages, ticks, open_ = [], {}, None
        for nm, t in row:
            if nm in self._ticks:
                ticks[nm] = ticks.get(nm, 0) + 1
                continue
            if open_ is not None:
                stages.append((open_[0], open_[1], t))
            open_ = (nm, t)
        return stages, ticks

    def summary(self) -> dict:
        """Per span name its count and mean and total ms; the counters; the
        device spans' count and mean ms; over the stamped rows each stage's
        mean ms, the ticks a row, and the first to last stamp's mean ms."""
        spans: dict[str, list[float]] = {}
        for nm, a, b, _, _ in self.spans():
            spans.setdefault(nm, []).append((b - a) / 1e6)
        out = {"spans": {k: {"count": len(v), "mean_ms": float(np.mean(v)),
                             "total_ms": float(np.sum(v))} for k, v in spans.items()},
               "counters": dict(self.counters)}
        dev: dict[str, list[float]] = {}
        for nm, _, a, b in self.device_spans():
            dev.setdefault(nm, []).append((b - a) / 1e6)
        out["device"] = {k: {"count": len(v), "mean_ms": float(np.mean(v))} for k, v in dev.items()}
        rows = self.stage_rows()
        if rows:
            ms: dict[str, list[float]] = {"first_to_last": []}
            ticks: dict[str, int] = {}
            for row in rows:
                stages, row_ticks = self.row_stages(row)
                for nm, a, b in stages:
                    ms.setdefault(nm, []).append((b - a) / 1e6)
                for nm, c in row_ticks.items():
                    ticks[nm] = ticks.get(nm, 0) + c
                ms["first_to_last"].append((row[-1][1] - row[0][1]) / 1e6)
            out["stages"] = {"rows": len(rows),
                             "ticks_per_row": {k: c / len(rows) for k, c in ticks.items()},
                             **{k: {"count": len(v), "mean_ms": float(np.mean(v))}
                                for k, v in ms.items()}}
        if self._anchors:
            out["clock"] = self.clock()
        return out

    def chrome_trace(self) -> dict:
        """Every span, counter, device span and stamped stage as Chrome-trace
        events (microseconds from the tracer's start): a track for each
        thread, one for each span recorded with its own times, one for the
        device spans and one for the stamped stages."""
        pid = os.getpid()

        def us(t):
            return (t - self.t0) / 1e3

        events, tracks = [], dict(enumerate(self.tracks))
        for i in range(self.n):
            if not self._end[i]:
                continue
            tid = self._track[i]
            if tid < 0:  # a span with its own times: a track of its name
                tid = 1000 - tid
                tracks[tid] = self.names[self._name[i]]
            events.append({"name": self.names[self._name[i]], "ph": "X", "pid": pid, "tid": tid,
                           "ts": us(self._start[i]), "dur": (self._end[i] - self._start[i]) / 1e3,
                           "args": {"sweep": self._sweep[i], "span": i, "parent": self._parent[i]}})
        if self._anchors:
            tracks[3000], tracks[3001] = "device", "device stages"
            for nm, sweep, a, b in self.device_spans():
                events.append({"name": nm, "ph": "X", "pid": pid, "tid": 3000, "ts": us(a),
                               "dur": (b - a) / 1e3, "args": {"sweep": sweep}})
            for row in self.stage_rows():
                for nm, a, b in self.row_stages(row)[0]:
                    events.append({"name": nm, "ph": "X", "pid": pid, "tid": 3001, "ts": us(a),
                                   "dur": (b - a) / 1e3})
                events += [{"name": nm, "ph": "i", "s": "t", "pid": pid, "tid": 3001, "ts": us(t)}
                           for nm, t in row if nm in self._ticks]
        events += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": t, "args": {"name": nm}}
                   for t, nm in tracks.items()]
        if self.counters:
            events.append({"name": "counters", "ph": "C", "pid": pid, "tid": 0,
                           "ts": us(now()), "args": dict(self.counters)})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        """Write `chrome_trace()` as JSON to `path`."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


class Stopwatch:
    """Blocking wall-clock timing of a device computation: a lap that hands
    back a result waits for the card (where there is one) before it reads
    the clock, so the asynchronous launch doesn't lie."""

    def __init__(self):
        self.laps: list[float] = []

    @contextlib.contextmanager
    def lap(self, result=None):
        t0 = time.perf_counter()
        out = {}
        try:
            yield out
        finally:
            if "result" in out and torch.cuda.is_available():
                torch.cuda.synchronize()
            self.laps.append(time.perf_counter() - t0)

    @property
    def avg(self) -> float:
        return sum(self.laps) / max(len(self.laps), 1)

    @property
    def max(self) -> float:
        return max(self.laps) if self.laps else 0.0

    def summary(self) -> str:
        return (
            f"n={len(self.laps)} avg={self.avg * 1e3:.2f} ms "
            f"max={self.max * 1e3:.2f} ms"
        )
