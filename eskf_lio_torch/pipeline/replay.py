"""Replay: the offline / throughput execution mode (port of
`eskf_lio_tpu/pipeline/replay.py`).

A sequence is packed once into stacked tensors on the device, and the same
per-scan step (`make_step_core`) runs over its rows.  The JAX package runs
the rows under one `lax.scan` in one dispatch, with zero host round-trips in
between; here, on a CUDA device, each row copies its inputs into the static
inputs of the captured steps (`odometry.GraphedScanStep`,
`odometry.GraphedPredict`) and replays one of them — the choice is
host-known — and the row's pose and diagnostics are copied on the device
into [B]-stacked outputs: a batch reads nothing back until `collect`.  On
the CPU the rows run `make_step_core` eagerly.  Rows flagged
`updates=False` are predict-only overflow rows (more IMU samples in a scan
interval than one chunk holds): the filter advances through the chunk, the
map and pose carry pass through.  The control flags (`evicts`, `updates`)
stay on the host.

Built with a tracer (`utils.profiling.Tracer`), each row is a host span
`row` whose id is the runner's count of rows, with the children `copy_in`
(the assigns into the step's static inputs) and `replay` (the graph's
launch) of `GraphedScanStep`, and `copy_out` (the writes into the stacked
outputs); on the card the row's device span `row` from CUDA events, and the
captured step's stage stamps.
"""

from __future__ import annotations

import itertools
from typing import Callable

import numpy as np
import torch

from eskf_lio_torch import device as device_policy
from eskf_lio_torch.config import Config
from eskf_lio_torch.io.dataset import Sequence
from eskf_lio_torch.map import voxel_map as vm
from eskf_lio_torch.models import eskf
from eskf_lio_torch.pipeline import odometry as odo
from eskf_lio_torch.pipeline.odometry import DIAG_KEYS
from eskf_lio_torch.types import FilterState, ImuChunk, Scan


def _predict_row_diag(state: FilterState) -> dict:
    """A predict-only row's diagnostics: nothing aligned or inserted,
    converged, and whether the advanced state is finite."""
    finite = (torch.isfinite(state.p).all() & torch.isfinite(state.q).all()).to(torch.int64)
    diag = dict.fromkeys(DIAG_KEYS, torch.zeros_like(finite))
    diag.update(icp_converged=torch.ones_like(finite), pose_finite=finite)
    return diag


def make_replay_step(config: Config, device="cuda", tracer=None) -> Callable:
    """Runner over a stacked batch of rows:
    replay(state, voxmap, prev_R, prev_t, chunks, scans, evicts, updates)
    -> (state, voxmap, prev_R, prev_t, Rs [B,3,3], ts [B,3], diags) with
    chunks / scans stacked over B rows on the device, evicts / updates [B]
    host bools, and diags a dict of [B] tensors on the device.  On a CUDA
    device the steps are the captured ones and the returned carry is their
    static buffers, which the next call overwrites.  With a tracer, every
    row is traced (the module's docstring)."""
    dev = device_policy.resolve(device)
    scan_step = odo.make_scan_step(config, dev, tracer)
    predict = odo.make_predict_only(config, dev, tracer)
    row_ids = itertools.count() if tracer is not None else None
    device_tracer = tracer if dev.type == "cuda" else None

    def replay(state, voxmap, prev_R, prev_t, chunks: ImuChunk, scans: Scan,
               evicts, updates):
        n_rows = chunks.dt.shape[0]
        Rs = torch.empty((n_rows, 3, 3), device=dev)
        ts = torch.empty((n_rows, 3), device=dev)
        diag_rows = torch.empty((n_rows, len(DIAG_KEYS)), dtype=torch.int64, device=dev)
        carry = [state, voxmap, prev_R, prev_t]
        for b in range(n_rows):
            if tracer is not None:
                row = next(row_ids)
                tracer.begin("row", row)
            if device_tracer is not None:
                dspan = device_tracer.device_begin("row", row)
            chunk = ImuChunk(*(x[b] for x in chunks))
            if bool(updates[b]):
                scan = Scan(*(x[b] for x in scans))
                *carry, diag = scan_step(*carry, chunk, scan, bool(evicts[b]))
            else:
                carry[0] = predict(carry[0], chunk)
                diag = _predict_row_diag(carry[0])
            if tracer is not None:
                tracer.begin("copy_out")
            diag_rows[b] = odo.diag_vector(diag)
            Rs[b] = carry[2]
            ts[b] = carry[3]
            if device_tracer is not None:
                device_tracer.device_end(dspan)
            if tracer is not None:
                tracer.end(tracer.end())
        diags = {
            k: diag_rows[:, i].bool() if k in odo.DIAG_FLAGS else diag_rows[:, i]
            for i, k in enumerate(DIAG_KEYS)
        }
        return (*carry, Rs, ts, diags)

    replay.scan_step, replay.predict = scan_step, predict
    return replay


def pack_sequence(
    config: Config, seq: Sequence, max_scans: int | None = None, device="cuda"
):
    """Host-side packing of a Sequence into stacked replay inputs.

    Returns (init_scan, chunks [B,...], scans [B,...], evicts [B],
    updates [B], scan_end_times): the scans and chunks as f32 / bool
    tensors on the device, evicts / updates as host bool tensors.  The first
    scan is split out for the init path.  B ≥ number of scans − 1: overflow
    IMU windows become extra predict-only rows (updates=False)."""
    dev = device_policy.resolve(device)
    n_cap = config.max_raw_points
    m_cap = config.max_imu_per_scan

    def pack_scan_np(rec):
        pts = rec.points[:n_cap].astype(np.float32)
        t_rel = (rec.t[:n_cap] - rec.end_time).astype(np.float32)
        n = len(pts)
        pad = n_cap - n
        return (
            np.vstack([pts, np.zeros((pad, 3), np.float32)]),
            np.concatenate([t_rel, np.zeros(pad, np.float32)]),
            np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
        )

    def to_dev(a):
        # numpy f64 would stay f64 in torch.as_tensor: cast at the boundary
        a = np.asarray(a)
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        return torch.as_tensor(a, device=dev)

    scans = seq.scans if max_scans is None else seq.scans[:max_scans]
    init_scan = Scan(*(to_dev(a) for a in pack_scan_np(scans[0])))

    rows_dt, rows_trel, rows_gyro, rows_accel, rows_valid = [], [], [], [], []
    rows_scan, rows_evict, rows_update, end_times = [], [], [], []
    zero_scan = (
        np.zeros((n_cap, 3), np.float32),
        np.zeros(n_cap, np.float32),
        np.zeros(n_cap, bool),
    )

    def emit_row(records, t_end, prev_t, scan_np, evict):
        dt = np.zeros(m_cap, np.float32)
        trel = np.full(m_cap, np.inf, np.float32)
        gyro = np.zeros((m_cap, 3), np.float32)
        accel = np.zeros((m_cap, 3), np.float32)
        valid = np.zeros(m_cap, bool)
        for k, r in enumerate(records):
            dt[k] = r.t - prev_t
            trel[k] = r.t - t_end
            gyro[k] = r.gyro
            accel[k] = r.accel
            valid[k] = True
            prev_t = r.t
        rows_dt.append(dt)
        rows_trel.append(trel)
        rows_gyro.append(gyro)
        rows_accel.append(accel)
        rows_valid.append(valid)
        rows_scan.append(scan_np if scan_np is not None else zero_scan)
        rows_evict.append(evict)
        rows_update.append(scan_np is not None)
        return prev_t

    imu = seq.imu
    t_prev = scans[0].end_time
    imu_idx = 0
    # skip IMU at/before the init scan end (ref `ErrorStateKF.cpp:66-69`)
    while imu_idx < len(imu) and imu[imu_idx].t <= t_prev:
        imu_idx += 1
    # eviction clock starts at the init scan
    t_last_evict = scans[0].end_time

    for rec in scans[1:]:
        t_end = rec.end_time
        end_times.append(t_end)
        # all samples with t <= t_end, plus the first overhang sample
        records = []
        j = imu_idx
        while j < len(imu):
            records.append(imu[j])
            j += 1
            if records[-1].t > t_end:
                break
        # the next chunk re-propagates the overhang from the corrected state
        while imu_idx < len(imu) and imu[imu_idx].t <= t_end:
            imu_idx += 1
        # overflow: pre-advance through all but the last window
        while len(records) > m_cap:
            head, records = records[:m_cap], records[m_cap:]
            t_prev = emit_row(head, t_end, t_prev, None, False)
        evict = bool(
            config.remove_distant_points
            and t_end - t_last_evict >= config.remove_period
        )
        if evict:
            t_last_evict = t_end
        emit_row(records, t_end, t_prev, pack_scan_np(rec), evict)
        t_prev = t_end

    chunks = ImuChunk(
        *(to_dev(np.stack(r)) for r in (rows_dt, rows_trel, rows_gyro, rows_accel, rows_valid))
    )
    scans_stacked = Scan(*(to_dev(np.stack([s[i] for s in rows_scan])) for i in range(3)))
    return (
        init_scan,
        chunks,
        scans_stacked,
        torch.as_tensor(np.asarray(rows_evict, bool)),
        torch.as_tensor(np.asarray(rows_update, bool)),
        end_times,
    )


def collect(updates, Rs_all, ts_all, diags_all):
    """Join per-batch replay outputs into the scan-indexed trajectory:
    (positions [S,3], rotations [S,3,3], diags of [S] numpy arrays), the
    init scan at the identity first, predict-only rows dropped."""
    keep = np.concatenate([[True], np.asarray(updates, bool)])
    positions = np.concatenate(
        [np.zeros((1, 3))] + [t.cpu().numpy() for t in ts_all]
    )[keep]
    rotations = np.concatenate(
        [np.eye(3)[None]] + [r.cpu().numpy() for r in Rs_all]
    )[keep]
    diags = {
        k: np.concatenate([d[k].cpu().numpy() for d in diags_all])[keep[1:]]
        for k in DIAG_KEYS
    }
    return positions, rotations, diags


def run_replay(
    config: Config,
    seq: Sequence,
    init_state: FilterState | None = None,
    max_scans: int | None = None,
    batch: int | None = None,
    device="cuda",
    tracer=None,
):
    """Full offline run.  Returns (positions [S,3], rotations [S,3,3],
    diags dict of numpy arrays, final voxmap), indexed by scan; with a
    tracer, its rows traced."""
    dev = device_policy.resolve(device)
    init_scan, chunks, scans, evicts, updates, _ = pack_sequence(
        config, seq, max_scans, dev
    )
    init_step = odo.make_init_step(config, dev)
    replay = make_replay_step(config, dev, tracer)

    state = init_state if init_state is not None else eskf.init_state(config, dev)
    voxmap = vm.VoxelMap.create(
        config.hash_capacity, config.map_delta_capacity, device=dev,
        key_bits=config.map_key_bits,
    )
    voxmap, _ = init_step(voxmap, init_scan)

    prev_R = torch.eye(3, device=dev)
    prev_t = torch.zeros(3, device=dev)
    b_total = chunks.dt.shape[0]
    batch = batch or b_total
    Rs_all, ts_all, diags_all = [], [], []
    for s in range(0, b_total, batch):
        rows = slice(s, min(s + batch, b_total))
        state, voxmap, prev_R, prev_t, Rs, ts, diags = replay(
            state, voxmap, prev_R, prev_t,
            ImuChunk(*(x[rows] for x in chunks)),
            Scan(*(x[rows] for x in scans)),
            evicts[rows], updates[rows],
        )
        Rs_all.append(Rs)
        ts_all.append(ts)
        diags_all.append(diags)
    positions, rotations, diags = collect(updates, Rs_all, ts_all, diags_all)
    return positions, rotations, diags, voxmap
