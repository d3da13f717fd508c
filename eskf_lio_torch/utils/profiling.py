"""Profiling / tracing (port of `eskf_lio_tpu/utils/profiling.py`).

The reference hand-rolls `omp_get_wtime()` timers around three pipeline
stages and prints avg/max on exit (`Odometry.cpp:10-14,99-109`).  Here the
same avg/max stage summary exists (`pipeline.odometry.StageTimer`), plus
`torch.profiler` integration for device-level traces viewable in
chrome://tracing or Perfetto.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


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
