"""Two-thread streaming pipeline: ingest thread + consumer loop.

Port of `eskf_lio_tpu/pipeline/stream.py`.  Re-creates the reference's
process architecture (`main.cpp:58-70`): a ROS `MultiThreadedExecutor` spins subscriber callbacks on
a side thread, pushing into `SynchronizedQueue`s, while `Odometry::run`
consumes on the main thread.  Here:

* the INGEST thread walks a merged time-ordered measurement source (a
  `Sequence`, a rosbag2 iterator, a live driver...) and pushes
  - IMU records into a lock-free C++ SPSC ring
    (`native/eskf_runtime.cpp`, the role of `SynchronizedQueue.hpp:9-57`;
    a deque+lock when the native lib is unavailable: `channel.native` says
    which), and
  - LiDAR sweeps into a small bounded queue (backpressure = the
    reference's unbounded queue minus the OOM risk);
* the CONSUMER (caller's thread) drains IMU, gates on coverage of each
  sweep (`Odometry.cpp:65-69`), and runs the per-scan step — so host
  ingestion and device compute overlap like the reference's
  callback/consumer split.  Only the consumer touches the device: the
  ingest thread handles numpy records and nothing else.

Built with a tracer (`utils.profiling.Tracer`), the runner records, by
sweep id (a sweep's index in the source, the init sweep 0):

* on the ingest thread, `scan_put` (the sweep's `put`, time blocked on the
  full queue included; the counter `puts_blocked` counts the puts that found
  the queue full) and `imu_push` for each IMU record, under the id of the
  sweep it follows: the first after a sweep is the sample that covers it
  (in a time-ordered source whose records never share a sweep's end time);
* on the consumer, `scan_queue` (from the start of the put to the return
  of the consumer's `get`), `gate` (from the first `process_scan` attempt
  on the sweep to the start of the attempt that finds coverage, the IMU
  drains between attempts included; the counter `gate_polls` counts the
  attempts that found none), `Odometry.process_scan`'s spans, and `on_scan`
  (the callback).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Iterable, Iterator

import numpy as np

from eskf_lio_torch.config import Config
from eskf_lio_torch.io import native_runtime
from eskf_lio_torch.io.dataset import ImuRecord, LidarRecord, Sequence
from eskf_lio_torch.pipeline.odometry import Odometry
from eskf_lio_torch.utils.profiling import now


class _ImuChannel:
    """IMU queue: native SPSC ring when available, locked deque otherwise."""

    def __init__(self, capacity_pow2: int = 8192):
        self._native = None
        try:
            self._native = native_runtime.NativeSpscQueue(
                native_runtime.IMU_DTYPE, capacity_pow2
            )
        except native_runtime.NativeRuntimeUnavailable:
            self._lock = threading.Lock()
            self._dq: deque = deque()

    @property
    def native(self) -> bool:
        """True when records go through the C++ ring."""
        return self._native is not None

    def push(self, rec: ImuRecord) -> None:
        if self._native is not None:
            row = np.zeros((), dtype=native_runtime.IMU_DTYPE)
            row["t"] = rec.t
            row["gyro"] = rec.gyro
            row["accel"] = rec.accel
            while not self._native.push(row):
                # ring full (rare): yield the core instead of busy-spinning —
                # on a small host a hot spin starves the very consumer this
                # push is waiting on
                time.sleep(100e-6)
        else:
            with self._lock:
                self._dq.append(rec)

    def pop_all(self) -> list[ImuRecord]:
        if self._native is not None:
            rows = self._native.pop_all()
            return [
                ImuRecord(
                    t=float(r["t"]),
                    gyro=np.asarray(r["gyro"], np.float64),
                    accel=np.asarray(r["accel"], np.float64),
                )
                for r in rows
            ]
        with self._lock:
            out = list(self._dq)
            self._dq.clear()
        return out


def merged_stream(seq: Sequence) -> Iterator[ImuRecord | LidarRecord]:
    """Time-ordered interleave of a Sequence's IMU and LiDAR records —
    what DDS delivery looks like to the reference's callbacks."""
    i = j = 0
    imu, scans = seq.imu, seq.scans
    while i < len(imu) or j < len(scans):
        if j >= len(scans) or (
            i < len(imu) and imu[i].t <= scans[j].end_time
        ):
            yield imu[i]
            i += 1
        else:
            yield scans[j]
            j += 1


class StreamingRunner:
    """Threaded streaming driver around `Odometry`.

    `run(source)` consumes any iterable of ImuRecord/LidarRecord (see
    `merged_stream` for Sequence replay) with ingestion on a side thread;
    with a tracer, traced as the module's docstring says.
    """

    def __init__(self, config: Config, scan_queue_depth: int = 4, device="cuda", tracer=None):
        self.config = config
        self.tracer = tracer
        self.odo = Odometry(config, device=device, tracer=tracer)
        # traced: the start of each sweep's put, for its `scan_queue` span
        self._put_t: deque | None = deque() if tracer is not None else None
        self._imu = _ImuChannel()
        self._scans: queue.Queue = queue.Queue(maxsize=scan_queue_depth)
        self._done = threading.Event()
        self._stop = threading.Event()  # the consumer is through: end ingest
        self._ingest_error: BaseException | None = None

    @property
    def ingest(self) -> str:
        """"native" when the IMU ring and `pack_scan` run in the C++ runtime,
        "python" when they take the deque and numpy paths."""
        return "native" if self._imu.native else "python"

    # -- ingest side --------------------------------------------------------

    def _ingest(self, source: Iterable) -> None:
        tr = self.tracer
        sweep = -1
        try:
            for rec in source:
                if self._stop.is_set():
                    break
                if isinstance(rec, ImuRecord):
                    if tr is not None:
                        tr.begin("imu_push", sweep)
                    self._imu.push(rec)
                    if tr is not None:
                        tr.end()
                    continue
                if tr is not None:
                    sweep += 1
                    t = now()
                    tr.begin("scan_put", sweep, t)
                    self._put_t.append(t)
                    if self._scans.full():
                        tr.count("puts_blocked")
                # blocks while the consumer lags, but not past its end (the
                # JAX runner leaves this thread blocked when `max_scans` cuts
                # the run short)
                while not self._stop.is_set():
                    try:
                        self._scans.put(rec, timeout=0.05)
                        break
                    except queue.Full:
                        pass
                if tr is not None:
                    tr.end()
        except BaseException as e:  # surface on the consumer side
            self._ingest_error = e
        finally:
            self._done.set()

    # -- consumer side ------------------------------------------------------

    def run(
        self,
        source: Iterable,
        max_scans: int | None = None,
        on_scan=None,
    ) -> dict:
        t = threading.Thread(
            target=self._ingest, args=(source,), name="ingest", daemon=True
        )
        t.start()
        tr = self.tracer
        # traced: the sweep's id, its first attempt, the attempts that failed
        sweep, gate_t, polls = -1, None, 0
        n_done = 0
        pending: LidarRecord | None = None
        while True:
            if max_scans is not None and n_done >= max_scans:
                break
            for rec in self._imu.pop_all():
                self.odo.feed_imu(rec)
            if pending is None:
                try:
                    pending = self._scans.get(timeout=0.01)
                except queue.Empty:
                    if self._done.is_set() and self._scans.empty():
                        break
                    continue
                if tr is not None:
                    sweep += 1
                    tr.record("scan_queue", self._put_t.popleft(), now(), sweep)
                    gate_t, polls = None, 0
            if tr is not None:
                attempt_t = now()
                gate_t = attempt_t if gate_t is None else gate_t
            out = self.odo.process_scan(pending)
            if out is None:
                # not yet covered by IMU (ref `Odometry.cpp:65-69`)
                if tr is not None:
                    polls += 1
                more = self._imu.pop_all()
                for rec in more:
                    self.odo.feed_imu(rec)
                if not more and self._done.is_set():
                    break  # stream ended without coverage
                continue
            pending = None
            n_done += 1
            if tr is not None:
                tr.record("gate", gate_t, attempt_t, sweep)
                tr.count("gate_polls", polls)
                tr.begin("on_scan", sweep)
            if on_scan is not None:
                on_scan(self.odo)
            if tr is not None:
                tr.end()
        if tr is not None and self.odo.device.type == "cuda":
            tr.finish()  # the traced window's closing anchor
        self._stop.set()
        t.join(timeout=5.0)
        if self._ingest_error is not None:
            raise self._ingest_error
        return self.odo.summary()
