"""What both drivers share: the program's config, the kernels' build, the
generated stream as the program's `Sequence`, and the sampled blocks."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import check
from benchmark.traffic import generator


def program_config(fields: dict):
    """The port's Config from a configuration file's `config`."""
    from eskf_lio_torch.config import Config, ImuConfig

    def tup(v):
        return tuple(v) if isinstance(v, list) else v

    fields = dict(fields)
    imu = ImuConfig(**{k: tup(v) for k, v in fields.pop("imu").items()})
    return Config(imu=imu, **{k: tup(v) for k, v in fields.items()})


def build_kernels(dev: torch.device) -> None:
    """nvcc for the port's CUDA sources into the checkout's `build/`
    (nothing when they are built already)."""
    if dev.type != "cuda":
        return
    from eskf_lio_torch.ops import _cuda, gn_normal_eq, segscan
    from eskf_lio_torch.utils.graphs import GRAPH_COND

    _cuda.build([gn_normal_eq.KERNEL, segscan.KERNEL, GRAPH_COND])


def generate(cell, dev: torch.device):
    """(the mix's stream, seconds it took)."""
    t0 = time.perf_counter()
    conf = cell.config["config"]
    stream = generator.generate(cell.config["sensor"], cell.mix, cell.mix["stream_seed"], dev,
                                lidar_quat_xyzw=conf["lidar_quat_xyzw"],
                                lidar_translation=conf["lidar_translation"])
    return stream, time.perf_counter() - t0


def phase(mix: dict, seed: int) -> int:
    """The sweep of the period at which a run's window starts, drawn from
    the run's seed among the mix's first `phases` (1: always the period's
    start, so that every run of a short window holds the same sweeps)."""
    return int(np.random.default_rng([seed, 1]).integers(0, int(mix["phases"])))


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def evict_flags(stream, n_sweeps: int, period: float, enabled: bool) -> list[bool]:
    """The eviction flag of stream sweeps 1 .. n_sweeps - 1 (index 0 is the
    init sweep, whose end starts the clock), by sensor time as the port's
    drivers set it."""
    flags = [False]
    last = stream.sweep_end_of(0)
    for k in range(1, n_sweeps):
        t = stream.sweep_end_of(k)
        ev = bool(enabled and t - last >= period)
        if ev:
            last = t
        flags.append(ev)
    return flags


def sample_blocks(rng: np.random.Generator, first: int, last: int, evicts: list[bool],
                  size: int) -> list[tuple[int, ...]]:
    """Up to two disjoint blocks of `size` consecutive stream sweeps in
    [first, last]: one around an eviction sweep drawn among those in the
    range, one drawn uniformly among the starts that do not overlap it."""
    blocks = []
    ev = [k for k in range(first + 1, last) if evicts[k] and k + size - 2 <= last]
    if ev:
        e = ev[int(rng.integers(0, len(ev)))]
        blocks.append(tuple(range(e - 1, e - 1 + size)))
    starts = [k for k in range(first, last - size + 2)
              if all(k + size <= b[0] or k >= b[-1] + 1 for b in blocks)]
    if starts:
        k = starts[int(rng.integers(0, len(starts)))]
        blocks.append(tuple(range(k, k + size)))
    return blocks


def start_block(evicts: list[bool], size: int) -> check.Block:
    return check.Block(ks=list(range(1, 1 + size)), evicts=[evicts[k] for k in range(1, 1 + size)])


class GcPauses:
    """The cyclic collector's pauses from construction to `stop()`."""

    def __init__(self):
        self.ms: list[float] = []
        self._t0 = None
        gc.callbacks.append(self._callback)

    def _callback(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms.append((time.perf_counter() - self._t0) * 1e3)

    def stop(self) -> None:
        if self._callback in gc.callbacks:
            gc.callbacks.remove(self._callback)

    def summary(self) -> dict:
        return {"pauses": len(self.ms), "max_ms": max(self.ms, default=0.0),
                "total_ms": sum(self.ms)}


def memory_peak(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
