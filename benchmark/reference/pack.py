"""The reference's own inputs for one update row: the IMU chunk and the
padded scan, worked out from the generated records as the port's host
drivers work them out (`pipeline/replay.py::pack_sequence`,
`pipeline/odometry.py::Odometry._build_chunk`, `native_runtime.pack_scan`):
the chunk holds every sample after the previous sweep's end up to and
including the first after this sweep's end; times are f64 differences cast
to f32."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.types import ImuChunk, Scan


def chunk_arrays(t, gyro, accel, prev_end: float, t_end: float, capacity: int):
    """(dt, t_rel, gyro, accel, valid) of one chunk, padded to `capacity`."""
    n = len(t)
    if n > capacity:
        raise ValueError(f"chunk of {n} samples over its capacity {capacity}")
    dt = np.zeros(capacity, np.float32)
    t_rel = np.full(capacity, np.inf, np.float32)
    g = np.zeros((capacity, 3), np.float32)
    a = np.zeros((capacity, 3), np.float32)
    valid = np.zeros(capacity, bool)
    prev = np.concatenate([[prev_end], t[:-1]])
    dt[:n] = t - prev
    t_rel[:n] = t - t_end
    g[:n], a[:n], valid[:n] = gyro, accel, True
    return dt, t_rel, g, a, valid


def scan_arrays(points, t, t_end: float, capacity: int):
    """(points, t_rel, valid) of one sweep, padded to `capacity`."""
    n = min(len(points), capacity)
    pts = np.zeros((capacity, 3), np.float32)
    t_rel = np.zeros(capacity, np.float32)
    valid = np.zeros(capacity, bool)
    pts[:n] = points[:n]
    t_rel[:n] = t[:n] - t_end
    valid[:n] = True
    return pts, t_rel, valid


def row(stream, k: int, config, device, shifted: bool):
    """(ImuChunk, Scan) of stream sweep k (k >= 1) on `device`.  `shifted`:
    the sweep as the live stream delivers it, its times moved by whole
    periods; otherwise the generated sweep whose packed row the replay
    cycles through."""
    i, shift = stream.sweep_index(k)
    if shifted:
        prev_end, t_end = stream.sweep_end_of(k - 1), stream.sweep_end_of(k)
    else:
        shift = 0.0
        prev_end, t_end = float(stream.sweep_end[i - 1]), float(stream.sweep_end[i])
    i0 = stream.imu_after(prev_end)
    i1 = stream.imu_after(t_end) + 1
    t, g, a = stream.imu_block(i0, i1)
    chunk = chunk_arrays(t, g, a, prev_end, t_end, config.max_imu_per_scan)
    scan = scan_arrays(stream.sweep_points[i], stream.sweep_t[i] + shift, t_end,
                       config.max_raw_points)
    dev = torch.device(device)
    return (ImuChunk(*(torch.as_tensor(x, device=dev) for x in chunk)),
            Scan(*(torch.as_tensor(x, device=dev) for x in scan)))


def init_scan(stream, config, device) -> Scan:
    """The first sweep, padded."""
    arrays = scan_arrays(stream.sweep_points[0], stream.sweep_t[0],
                         float(stream.sweep_end[0]), config.max_raw_points)
    return Scan(*(torch.as_tensor(x, device=torch.device(device)) for x in arrays))
