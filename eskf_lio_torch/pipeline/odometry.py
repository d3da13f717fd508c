"""The per-scan odometry step and its host driver (port of
`eskf_lio_tpu/pipeline/odometry.py`).

`make_step_core` is the main path of one scan — IMU-prefix prediction,
deskew / downsample / covariances, VGICP alignment, the ESKF pose update,
map insert and the periodic eviction — over tensors on one device.  The
JAX package jits its step builders (`eskf_lio_tpu/pipeline/odometry.py:185,
208,232`); here, on a CUDA device, `make_scan_step` and `make_predict_only`
return steps captured into CUDA graphs over static buffers
(`GraphedScanStep`, `GraphedPredict`, on `utils/graphs.py`), whose GN loop
and insert fold branch on the device: a replay reads nothing back.  The
eviction flag is host-known, as in the JAX package, so the scan step holds
one graph with eviction and one without.  On the CPU the same functions run
eagerly, with one host read per device decision.

`Odometry` is the scan-at-a-time driver around it: the host does what the
reference's ROS threads and queues do — buffering, f64 timekeeping, chunk
building and gating on IMU coverage of the scan end (`Odometry.cpp:65-69`)
— uploads one packed scan and one IMU chunk per step, and reads the pose
and the diagnostics back in one transfer.

Built with a tracer (`utils.profiling.Tracer`), the step marks each stage
boundary (predict, preprocess, align, pose_update, map_insert, evict, end):
a captured step holds a stamp node at each, written on the device at every
replay, and an eager one records host spans; `Odometry.process_scan` records
its host spans and the step's device span.  Without one, nothing is marked.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import weakref
from typing import Callable

import numpy as np
import torch

from eskf_lio_torch import device as device_policy
from eskf_lio_torch.config import Config
from eskf_lio_torch.io import native_runtime
from eskf_lio_torch.io.dataset import LidarRecord, Sequence
from eskf_lio_torch.map import voxel_map as vm
from eskf_lio_torch.models import eskf, registration
from eskf_lio_torch.ops import lie, preprocess
from eskf_lio_torch.types import FilterState, ImuChunk, Pose, ProcessedScan, Scan
from eskf_lio_torch.utils.convert import from_numpy
from eskf_lio_torch.utils.graphs import StepGraph, assign
from eskf_lio_torch.utils.profiling import stage

# the step's diagnostics, in the order of a captured step's diagnostic
# vector; the flags among them are read back as bools
DIAG_KEYS = (
    "icp_iterations", "icp_converged", "num_correspondences", "inserted",
    "dropped_points", "removed_voxels", "num_scan_points",
    "align_slice_overflow", "pose_finite",
)
DIAG_FLAGS = ("icp_converged", "inserted", "pose_finite")


def diag_vector(diag: dict, keys=DIAG_KEYS) -> torch.Tensor:
    """The step's diagnostics as one int64 vector in `keys` order."""
    return torch.stack([diag[k].to(torch.int64) for k in keys])


def lidar_extrinsics(config: Config, device="cuda", dtype=torch.float32) -> Pose:
    """T_il from the config quaternion (xyzw) and translation."""
    dev = device_policy.resolve(device)
    qx, qy, qz, qw = config.lidar_quat_xyzw
    q = torch.tensor(np.asarray([qw, qx, qy, qz], np.float32), dtype=dtype, device=dev)
    t = torch.tensor(np.asarray(config.lidar_translation, np.float32), dtype=dtype, device=dev)
    return Pose(R=lie.quat_to_mat(lie.quat_normalize(q)), t=t)


def make_step_core(config: Config, device="cuda", tracer=None) -> Callable:
    """The per-scan step: core(carry, inputs) -> (carry, diag) with
    carry = (FilterState, VoxelMap, prev_R, prev_t) and
    inputs = (ImuChunk, Scan, do_evict: bool).  With a tracer, its stage
    boundaries are marked (`profiling.stage`)."""
    dev = device_policy.resolve(device)
    noise = eskf.make_noise_params(config, dev)
    T_il = lidar_extrinsics(config, dev)
    a_cap = config.align_capacity

    def core(carry, inputs):
        state, voxmap, prev_R, prev_t = carry
        chunk, scan, do_evict = inputs

        # 1+2. predict to the last sample before scan end (parallel prefix)
        stage(tracer, "predict")
        base, hist = eskf.predict_chunk_prefix(
            state, chunk, noise, base_mask=chunk.t_rel <= 0.0
        )
        # 3. preprocess
        stage(tracer, "preprocess")
        processed = preprocess.preprocess(scan, hist, T_il, config)

        # 4. VGICP over the align-budget prefix (live voxels are a contiguous
        # ascending-key prefix of the processed scan); insert uses the full
        # scan
        stage(tracer, "align")
        guess = eskf.pose_of(base)
        aligned_scan = ProcessedScan(*(x[:a_cap] for x in processed))
        res = registration.align(aligned_scan, voxmap, guess, config, tracer=tracer)

        # 5. measurement update
        stage(tracer, "pose_update")
        corrected = eskf.pose_update(base, res.pose, noise)
        T = eskf.pose_of(corrected)

        # 6. map update with the frame-to-frame motion gate
        stage(tracer, "map_insert")
        moved_R = prev_R.T @ T.R
        moved_t = prev_R.T @ (T.t - prev_t)
        cosine = 0.5 * (torch.trace(moved_R) - 1.0)
        should_insert = (cosine < config.map_update_cosine_threshold) | (
            torch.sum(moved_t * moved_t) > config.map_update_translation_sq_threshold
        )
        voxmap, dropped = vm.insert(
            voxmap,
            T.apply(processed.points),
            vm.pack_cov(T.R @ processed.covs @ T.R.T),
            processed.valid & should_insert,
            voxel_size=config.map_voxel_size,
            max_points_per_voxel=config.max_points_per_voxel,
        )

        # 7. periodic distant-voxel eviction (host-known schedule)
        removed = torch.zeros((), dtype=torch.int64, device=dev)
        if bool(do_evict) and config.remove_distant_points:
            stage(tracer, "evict")
            voxmap, removed = vm.evict_beyond(
                voxmap, T.t,
                voxel_size=config.map_voxel_size,
                distance_threshold=config.remove_distance_threshold,
                max_points_per_voxel=config.max_points_per_voxel,
            )

        n_points = processed.valid.sum()
        diag = {
            "icp_iterations": res.iterations,
            "icp_converged": res.converged,
            "num_correspondences": res.num_correspondences,
            "inserted": should_insert,
            "dropped_points": dropped,
            "removed_voxels": removed,
            "num_scan_points": n_points,
            "align_slice_overflow": torch.clamp(n_points - a_cap, min=0),
            # a non-finite pose means the filter diverged
            "pose_finite": torch.isfinite(T.t).all() & torch.isfinite(T.R).all(),
        }
        stage(tracer, "end")
        return (corrected, voxmap, T.R, T.t), diag

    return core


def _chunk_buffer(config: Config, dev) -> ImuChunk:
    """A zeroed static IMU chunk, the input buffer of a step on the card."""
    m = config.max_imu_per_scan
    return ImuChunk(
        dt=torch.zeros(m, device=dev), t_rel=torch.zeros(m, device=dev),
        gyro=torch.zeros((m, 3), device=dev), accel=torch.zeros((m, 3), device=dev),
        valid=torch.zeros(m, dtype=torch.bool, device=dev),
    )


def _scan_buffer(config: Config, dev) -> Scan:
    """A zeroed static packed scan, the input buffer of a step on the card."""
    n = config.max_raw_points
    return Scan(
        points=torch.zeros((n, 3), device=dev), t_rel=torch.zeros(n, device=dev),
        valid=torch.zeros(n, dtype=torch.bool, device=dev),
    )


class GraphedScanStep:
    """`make_scan_step`'s step on a CUDA device: `make_step_core` over
    static buffers (inputs, carry, diagnostics), captured into a CUDA graph
    on first use — one graph with the eviction and one without, sharing a
    memory pool — and replayed.  The GN loop and the insert fold run as
    conditional nodes: a replay reads nothing back.

    A call copies each argument that is not already its static buffer into
    it, replays, and returns the static buffers themselves: state, map and
    pose are overwritten by the next call, so a caller that keeps them
    clones them.  `diag` holds views of one int64 vector (`diag_vec`, in
    `diag_keys` order).

    A subclass captures another step of the same signature over other map
    buffers (`parallel/sharded_map.py::GraphedShardedScanStep`): it sets
    `diag_keys` and overrides `_make_core`, `_make_map`, `_run`,
    `_assign_map` and `_map`.

    With a tracer, both graphs hold the step's stage stamps and a call
    records the host spans `copy_in` (the assigns into the static buffers)
    and `replay` (the graph's launch)."""

    diag_keys = DIAG_KEYS

    def __init__(self, config: Config, device, tracer=None):
        dev = device_policy.resolve(device)
        self.config = config
        self.tracer = tracer
        if tracer is not None:
            tracer.attach(dev)
        self.core = self._make_core(config, dev)
        self._make_map(config, dev)
        self.chunk = _chunk_buffer(config, dev)
        self.scan = _scan_buffer(config, dev)
        self.state = eskf.init_state(config, dev)
        self.prev_R = torch.eye(3, device=dev)
        self.prev_t = torch.zeros(3, device=dev)
        self.diag_vec = torch.zeros(len(self.diag_keys), dtype=torch.int64, device=dev)
        self.diag = {k: self.diag_vec[i] for i, k in enumerate(self.diag_keys)}
        pool = torch.cuda.graph_pool_handle()
        # the graphs hold this step weakly: no reference cycle, so the graphs
        # are destroyed with the step, never by a later garbage collection
        # (which may run in the middle of another capture)
        me = weakref.proxy(self)
        self.graphs = {
            evict: StepGraph(functools.partial(GraphedScanStep._step, me, evict), dev,
                             config.max_raw_points, pool, tracer,
                             "scan_step.evict" if evict else "scan_step")
            for evict in (False, True)
        }

    def _make_core(self, config: Config, dev) -> Callable:
        """The step function that is captured."""
        return make_step_core(config, dev, self.tracer)

    def _make_map(self, config: Config, dev) -> None:
        """The static map buffers."""
        self.voxmap = vm.VoxelMap.create(
            config.hash_capacity, config.map_delta_capacity, device=dev
        )

    def _run(self, do_evict: bool):
        """The step over the static buffers: (state, voxmap, R, t, diag)."""
        (state, voxmap, R, t), diag = self.core(
            (self.state, self.voxmap, self.prev_R, self.prev_t),
            (self.chunk, self.scan, do_evict),
        )
        return state, voxmap, R, t, diag

    def _assign_map(self, voxmap) -> None:
        """Copy a map into the static map buffers (each field that is not
        already its buffer)."""
        assign(self.voxmap, voxmap)

    def _map(self):
        """The map a call returns: the static buffers."""
        return self.voxmap

    def _step(self, do_evict: bool) -> None:
        state, voxmap, R, t, diag = self._run(do_evict)
        assign(self.state, state)
        self._assign_map(voxmap)
        assign((self.prev_R, self.prev_t), (R, t))
        self.diag_vec.copy_(diag_vector(diag, self.diag_keys))

    def __call__(self, state, voxmap, prev_R, prev_t, chunk: ImuChunk, scan: Scan, do_evict):
        tr = self.tracer
        if tr is not None:
            tr.begin("copy_in")
        assign(self.state, state)
        self._assign_map(voxmap)
        assign((self.prev_R, self.prev_t, *self.chunk, *self.scan),
                (prev_R, prev_t, *chunk, *scan))
        if tr is not None:
            tr.switch("replay")
        self.graphs[bool(do_evict) and self.config.remove_distant_points]()
        if tr is not None:
            tr.end()
        return self.state, self._map(), self.prev_R, self.prev_t, self.diag


def make_scan_step(config: Config, device="cuda", tracer=None) -> Callable:
    """One scan: scan_step(state, voxmap, prev_R, prev_t, chunk, scan,
    do_evict) -> (state, voxmap, R, t, diag).  On a CUDA device a
    `GraphedScanStep`; on the CPU `make_step_core` run eagerly.  With a
    tracer, the step's stages are marked."""
    dev = device_policy.resolve(device)
    if dev.type == "cuda":
        return GraphedScanStep(config, dev, tracer)
    core = make_step_core(config, dev, tracer)

    def scan_step(state, voxmap, prev_R, prev_t, chunk: ImuChunk, scan: Scan, do_evict):
        (corrected, voxmap, R, t), diag = core(
            (state, voxmap, prev_R, prev_t), (chunk, scan, do_evict)
        )
        return corrected, voxmap, R, t, diag

    return scan_step


def make_init_step(config: Config, device="cuda") -> Callable:
    """First-scan path (ref `Odometry.cpp:55-63`): preprocess with no state
    history (no deskew) and insert at the identity pose."""
    T_il = lidar_extrinsics(config, device)

    def init_step(voxmap: vm.VoxelMap, scan: Scan):
        processed = preprocess.downsample_and_covariances(
            T_il.apply(scan.points), scan.valid, config
        )
        return vm.insert(
            voxmap,
            processed.points,
            vm.pack_cov(processed.covs),
            processed.valid,
            voxel_size=config.map_voxel_size,
            max_points_per_voxel=config.max_points_per_voxel,
        )

    return init_step


class GraphedPredict:
    """`make_predict_only`'s step on a CUDA device: the prediction through
    one chunk over a static state and chunk, captured once and replayed.
    A call returns the static state (overwritten by the next call).  With
    a tracer, the capture is traced."""

    def __init__(self, config: Config, device, tracer=None):
        dev = device_policy.resolve(device)
        self.noise = eskf.make_noise_params(config, dev)
        self.chunk = _chunk_buffer(config, dev)
        self.state = eskf.init_state(config, dev)
        self.graph = StepGraph(functools.partial(GraphedPredict._step, weakref.proxy(self)),
                               dev, config.max_raw_points, tracer=tracer, name="predict_only")

    def _step(self) -> None:
        assign(self.state, eskf.predict_chunk_prefix(self.state, self.chunk, self.noise)[0])

    def __call__(self, state: FilterState, chunk: ImuChunk) -> FilterState:
        assign((*self.state, *self.chunk), (*state, *chunk))
        self.graph()
        return self.state


def make_predict_only(config: Config, device="cuda", tracer=None) -> Callable:
    """Overflow path: advance the filter through a chunk without a scan.
    On a CUDA device a `GraphedPredict` (its capture traced with a tracer);
    on the CPU run eagerly."""
    dev = device_policy.resolve(device)
    if dev.type == "cuda":
        return GraphedPredict(config, dev, tracer)
    noise = eskf.make_noise_params(config, dev)

    def predict_only(state: FilterState, chunk: ImuChunk) -> FilterState:
        return eskf.predict_chunk_prefix(state, chunk, noise)[0]

    return predict_only


class _PinnedUploads:
    """Host-to-device copies of numpy arrays into fixed device buffers
    through page-locked staging buffers, without waiting for the device.
    Two sets of staging buffers are used in turn; a set is refilled only
    once the copies out of it have completed (an event recorded behind
    them), which the driver's read-back of the step in between has already
    ensured."""

    def __init__(self, dsts: list[torch.Tensor]):
        self.dsts = dsts
        self.slots = [
            [torch.empty(d.shape, dtype=d.dtype, pin_memory=True) for d in dsts]
            for _ in range(2)
        ]
        self.events: list[torch.cuda.Event | None] = [None, None]
        self.turn = 0

    def upload(self, arrays) -> bool:
        """Stage and enqueue the copies; True when the staging set was still
        being copied out of, and this waited for it."""
        slot, self.turn = self.turn, 1 - self.turn
        done = self.events[slot]
        waited = done is not None and not done.query()
        if waited:
            done.synchronize()
        for a, pinned, dst in zip(arrays, self.slots[slot], self.dsts):
            pinned.numpy()[...] = a  # the cast of `from_numpy` (f64 -> f32)
            dst.copy_(pinned, non_blocking=True)
        self.events[slot] = torch.cuda.Event()
        self.events[slot].record()
        return waited


# ---------------------------------------------------------------------------
# host orchestrator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StageTimer:
    """avg/max wall timing, mirroring the reference's report
    (`Odometry.cpp:10-14,99-109`)."""

    total: float = 0.0
    max: float = 0.0
    count: int = 0

    def add(self, dt: float) -> None:
        self.total += dt
        self.max = max(self.max, dt)
        self.count += 1

    @property
    def avg(self) -> float:
        return self.total / max(self.count, 1)


class Odometry:
    """Host-side driver: feeds measurement streams into the device step and
    records the trajectory.  Single-device.

    `h2d_bytes` and `device_reads` count what the driver itself moves: the
    bytes of the arrays it uploads and the transfers it reads back (each
    read waits for the device).  On a CUDA device the scan step is a
    `GraphedScanStep` (no host read inside it) and the uploads go from
    page-locked buffers into fixed device buffers (the graphed step's static
    inputs), without waiting; on the CPU the step's own host branches (one
    per GN iteration, one in `insert`) are not in `device_reads`.
    `graphed` and `step_reason` say which of the two the scan step is.

    With a tracer, `process_scan` records, for each sweep it poses (the
    sweep's id: its index in the stream, the init sweep 0), the span
    `process_scan` (from the gate's pass to the return: `timer` and then
    `record`) and its children in order and without gaps: `chunk_build`
    (the split of the pending IMU records, any overflow pre-advance and the
    chunk's arrays), `scan_pack` (`native_runtime.pack_scan`), `upload` (both
    staged uploads; the counter `upload_waits` counts those that waited for
    a staging set), `step_launch` (the step's call and the bookkeeping before
    the read-back), `read_back` (the host blocked until the pose is back)
    and `record`; on the card also the step's device span `step`."""

    def __init__(self, config: Config, init_state: FilterState | None = None,
                 device="cuda", tracer=None):
        self.config = config
        self.device = device_policy.resolve(device)
        self.tracer = tracer
        # device spans only where there are CUDA events
        self._device_tracer = tracer if self.device.type == "cuda" else None

        self.state = (
            init_state if init_state is not None else eskf.init_state(config, self.device)
        )
        self.voxmap = vm.VoxelMap.create(
            config.hash_capacity, config.map_delta_capacity, device=self.device
        )
        self.prev_R = torch.eye(3, device=self.device)
        self.prev_t = torch.zeros(3, device=self.device)
        self.scan_step, self.init_step, self.predict_only = self._make_steps()
        # on the card the uploads land in fixed input buffers: a graphed
        # step's own (single-device or sharded: both are `GraphedScanStep`s),
        # or buffers of the driver's (each step's reads of them are ordered
        # on the stream before the next upload's copies)
        self._staging = None
        if self.device.type == "cuda":
            own = isinstance(self.scan_step, GraphedScanStep)
            chunk = self.scan_step.chunk if own else _chunk_buffer(config, self.device)
            scan = self.scan_step.scan if own else _scan_buffer(config, self.device)
            self._staging = (_PinnedUploads(list(chunk)), _PinnedUploads(list(scan)))

        self.initialized = False
        self.t_last_update: float = 0.0  # f64 host clock of the filter state
        self.t_last_evict: float = -np.inf
        self.imu_pending: list = []  # records with t > t_last_update

        self.trajectory_t: list[float] = []
        self.trajectory_p: list[np.ndarray] = []
        self.trajectory_R: list[np.ndarray] = []
        self.diags: list[dict] = []
        self.timer = StageTimer()
        self.h2d_bytes = 0
        self.device_reads = 0

        # failure detection (the reference has none): flag divergence on a
        # non-finite pose or a sustained loss of map correspondences so
        # callers can stop/reset instead of silently corrupting the map
        self.diverged = False
        self.zero_corr_streak = 0
        self.zero_corr_limit = 10

    def _make_steps(self):
        """(scan step, init step, predict-only step) of this driver.  Sets
        `graphed` (whether the scan step is a captured graph) and
        `step_reason`, one line that says why."""
        self.graphed = self.device.type == "cuda"
        self.step_reason = (
            "graph: on a CUDA device the scan step is captured" if self.graphed
            else f"eager: the step runs on the {self.device.type}"
        )
        return (make_scan_step(self.config, self.device, self.tracer),
                make_init_step(self.config, self.device),
                make_predict_only(self.config, self.device, self.tracer))

    # -- chunk/scan packing ------------------------------------------------

    def _upload(self, arrays: list[np.ndarray], which: int) -> list[torch.Tensor]:
        """numpy arrays -> tensors on the device (f64 -> f32): on the card
        into the fixed input buffers (`which`: 0 the chunk, 1 the scan), on
        the CPU as new tensors."""
        self.h2d_bytes += sum(a.nbytes for a in arrays)
        if self._staging is None:
            return [from_numpy(a, self.device) for a in arrays]
        staging = self._staging[which]
        if staging.upload(arrays) and self.tracer is not None:
            self.tracer.count("upload_waits")
        return staging.dsts

    def _build_chunk(self, records, t_end: float) -> ImuChunk:
        return ImuChunk(*self._upload(self._chunk_arrays(records, t_end), 0))

    def _chunk_arrays(self, records, t_end: float) -> list[np.ndarray]:
        m = self.config.max_imu_per_scan
        n = len(records)
        assert n <= m, f"chunk overflow: {n} > {m}"
        dt = np.zeros(m, np.float32)
        t_rel = np.full(m, np.inf, np.float32)
        gyro = np.zeros((m, 3), np.float32)
        accel = np.zeros((m, 3), np.float32)
        valid = np.zeros(m, bool)
        prev_t = self.t_last_update
        for i, r in enumerate(records):
            dt[i] = r.t - prev_t
            t_rel[i] = r.t - t_end
            gyro[i] = r.gyro
            accel[i] = r.accel
            valid[i] = True
            prev_t = r.t
        return [dt, t_rel, gyro, accel, valid]

    def _pack_scan(self, rec: LidarRecord) -> tuple[list[np.ndarray], int]:
        # pad/truncate into the fixed device layout — the C++ fast path
        # when the native runtime is built, numpy otherwise.  Returns the
        # arrays AND the number of raw points dropped by the capacity cut
        # (the reference never drops, `Subscriber.hpp:89-97` — a static
        # budget must, so the loss is surfaced, not silent).
        xyz, t_rel, valid, n_packed = native_runtime.pack_scan(
            rec.points, rec.t, rec.end_time, self.config.max_raw_points
        )
        return [xyz, t_rel, valid], max(len(rec.points) - int(n_packed), 0)

    def _read_back(self, diag: dict) -> tuple[np.ndarray, np.ndarray, dict]:
        """The pose and the step's diagnostics on the host.  The values that
        live on the device come in ONE transfer (f32 values and counts are
        exact in f64); the GN loop's own host values are taken as they are."""
        on_device = [k for k, v in diag.items() if isinstance(v, torch.Tensor)]
        flat = torch.cat(
            [self.prev_R.reshape(-1).to(torch.float64), self.prev_t.to(torch.float64)]
            + [diag[k].reshape(1).to(torch.float64) for k in on_device]
        ).cpu().numpy()
        self.device_reads += 1
        pose_R = flat[:9].reshape(3, 3).astype(np.float32)
        pose_t = flat[9:12].astype(np.float32)
        values = {**diag, **dict(zip(on_device, flat[12:]))}
        diag_host = {
            k: np.asarray(v, bool if k in DIAG_FLAGS else np.int64)
            for k, v in values.items()
        }
        return pose_R, pose_t, diag_host

    # -- main entry --------------------------------------------------------

    def feed_imu(self, rec) -> None:
        self.imu_pending.append(rec)

    def process_scan(self, rec: LidarRecord) -> dict | None:
        """Process one LiDAR sweep; returns the diagnostics dict, or None if
        the scan is not yet covered by IMU (caller should feed more IMU and
        retry — the reference's gating loop, `Odometry.cpp:65-69`)."""
        t_end = rec.end_time

        if not self.initialized:
            # ref `Odometry.cpp:55-63`
            self.initialized = True
            self.t_last_update = t_end
            # eviction clock starts at the first scan (ref `LocalMap.cpp:60`
            # keys its period off construction time): the first eviction
            # fires `remove_period` after start, not on scan 1
            self.t_last_evict = t_end
            # drop IMU before the first scan end (ref `ErrorStateKF.cpp:66-69`)
            self.imu_pending = [r for r in self.imu_pending if r.t >= t_end]
            scan = Scan(*self._upload(self._pack_scan(rec)[0], 1))
            self.voxmap, _ = self.init_step(self.voxmap, scan)
            self._record(t_end, np.eye(3), np.zeros(3), None)
            self.prev_R = torch.eye(3, device=self.device)
            self.prev_t = torch.zeros(3, device=self.device)
            return {"initialized": True}

        # drop records predating the filter clock (ref drops IMU before
        # the first scan end, `ErrorStateKF.cpp:66-69`, and negative-dt
        # samples, `:80-82`).  The init-time drop only sees what has
        # ARRIVED; under a racing ingest thread, pre-init samples can land
        # after init and would otherwise bloat this chunk past its static
        # capacity (a spurious overflow pre-advance).
        if self.imu_pending and self.imu_pending[0].t <= self.t_last_update:
            self.imu_pending = [
                r for r in self.imu_pending if r.t > self.t_last_update
            ]

        # gating: need at least one IMU sample at/after scan end
        if not self.imu_pending or self.imu_pending[-1].t < t_end:
            return None

        t0 = time.perf_counter()
        tr = self.tracer
        if tr is not None:
            t0_ns = int(t0 * 1e9)  # the timer's start on the tracer's clock
            tr.begin("process_scan", len(self.trajectory_t), t0_ns)
            tr.begin("chunk_build", t=t0_ns)

        # split pending: chunk = all samples up to and incl. first > t_end
        idx_over = next(
            i for i, r in enumerate(self.imu_pending) if r.t > t_end
        ) if any(r.t > t_end for r in self.imu_pending) else len(self.imu_pending) - 1
        chunk_records = self.imu_pending[: idx_over + 1]
        m = self.config.max_imu_per_scan

        # overflow: pre-advance through all but the last window
        while len(chunk_records) > m:
            head, chunk_records = chunk_records[: m], chunk_records[m:]
            c = self._build_chunk(head, t_end)
            self.state = self.predict_only(self.state, c)
            self.t_last_update = head[-1].t

        chunk_arrays = self._chunk_arrays(chunk_records, t_end)
        if tr is not None:
            tr.switch("scan_pack")
        scan_arrays, dropped_raw = self._pack_scan(rec)
        if tr is not None:
            tr.switch("upload")
        chunk = ImuChunk(*self._upload(chunk_arrays, 0))
        scan = Scan(*self._upload(scan_arrays, 1))
        if tr is not None:
            tr.switch("step_launch")
        dtr = self._device_tracer
        if dtr is not None:
            dspan = dtr.device_begin("step", len(self.trajectory_t))

        do_evict = bool(
            self.config.remove_distant_points
            and t_end - self.t_last_evict >= self.config.remove_period
        )

        self.state, self.voxmap, self.prev_R, self.prev_t, diag = self.scan_step(
            self.state,
            self.voxmap,
            self.prev_R,
            self.prev_t,
            chunk,
            scan,
            do_evict,
        )
        if dtr is not None:
            dtr.device_end(dspan)

        # next chunk re-propagates overhang samples from the corrected state
        # (replaces the reference's rollback+replay, `ErrorStateKF.cpp:147-155`)
        self.t_last_update = t_end
        self.imu_pending = [r for r in self.imu_pending if r.t > t_end]
        if do_evict:
            self.t_last_evict = t_end

        # the read waits for the step's device work, so the timer below
        # covers it whole
        if tr is not None:
            tr.switch("read_back")
        pose_R, pose_t, diag_host = self._read_back(diag)
        self.timer.add(time.perf_counter() - t0)
        if tr is not None:
            tr.switch("record")
        # raw points that never reached the device (non-finite or beyond
        # `max_raw_points`) — a silent-data-loss channel made visible
        diag_host["dropped_raw_points"] = np.asarray(dropped_raw)
        if not bool(diag_host.get("pose_finite", True)):
            self.diverged = True
        if int(diag_host.get("num_correspondences", 1)) == 0:
            self.zero_corr_streak += 1
            if self.zero_corr_streak >= self.zero_corr_limit:
                self.diverged = True
        else:
            self.zero_corr_streak = 0
        self._record(t_end, pose_R, pose_t, diag_host)
        if tr is not None:
            tr.end(tr.end())
        return diag_host

    def run(
        self,
        seq: Sequence,
        max_scans: int | None = None,
        on_scan=None,
    ) -> dict:
        """Run a full sequence (merged time-ordered replay of both streams).
        `on_scan(self)` fires after each processed scan (live viz hook,
        the role of the reference's per-loop `visualizeLocalMap`,
        `LocalMap.cpp:120-130`).  Returns summary stats."""
        imu_iter = iter(seq.imu)
        next_imu = next(imu_iter, None)
        n_done = 0
        for scan in seq.scans:
            if max_scans is not None and n_done >= max_scans:
                break
            # feed IMU until the scan is covered
            while next_imu is not None and next_imu.t <= scan.end_time + 0.05:
                self.feed_imu(next_imu)
                next_imu = next(imu_iter, None)
            out = self.process_scan(scan)
            if out is None:
                # stream exhausted without coverage: stop
                break
            n_done += 1
            if on_scan is not None:
                on_scan(self)
        return self.summary()

    def _record(self, t, R, p, diag) -> None:
        self.trajectory_t.append(float(t))
        self.trajectory_R.append(np.asarray(R))
        self.trajectory_p.append(np.asarray(p))
        if diag is not None:
            self.diags.append(diag)

    def summary(self) -> dict:
        return {
            "diverged": self.diverged,
            "num_scans": len(self.trajectory_t),
            "avg_step_ms": self.timer.avg * 1e3,
            "max_step_ms": self.timer.max * 1e3,
            "scans_per_sec": 1.0 / self.timer.avg if self.timer.count else 0.0,
            "map_voxels": int(self.voxmap.num_voxels()),  # one device reduction
        }

    @property
    def positions(self) -> np.ndarray:
        return np.stack(self.trajectory_p) if self.trajectory_p else np.zeros((0, 3))
