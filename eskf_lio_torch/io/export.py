"""Map + trajectory export (ref `LocalMap::save`, `LocalMap.cpp:156-167`).

The reference flattens every stored raw point into a PCD and writes the
trajectory as an Open3D PinholeCameraTrajectory JSON.  The device map stores
per-voxel statistics rather than raw members, so
the exported cloud is the voxel means (one point per voxel, count-weighted
quality); the trajectory export keeps the same JSON structure so the
reference's offline viewer workflow transfers.

Port of `eskf_lio_tpu/io/export.py`: the map is folded on its device, read
to the host once per field, and everything after that is numpy — the dense
cloud draws from `np.random.default_rng(seed)` on the host, so both
packages give the same cloud from the same map.  A sharded map is gathered
first (under a process group a collective: every process calls, and gets the
cloud), then folded as one map, as the JAX package does with its global
arrays.
"""

from __future__ import annotations

import json

import numpy as np

from eskf_lio_torch.map import voxel_map as _vm
from eskf_lio_torch.map.voxel_map import VoxelMap
from eskf_lio_torch.parallel.sharded_map import ShardedVoxelMap, whole_map
from eskf_lio_torch.utils.convert import to_numpy


def map_to_cloud(
    voxmap: VoxelMap | ShardedVoxelMap, max_points_per_voxel: int = 1000
) -> tuple[np.ndarray, np.ndarray]:
    """Extract (points [N,3], counts [N]) for occupied voxels (the LSM delta
    tier is folded in first)."""
    voxmap, _ = _vm.compact(whole_map(voxmap), max_points_per_voxel=max_points_per_voxel)
    occ = to_numpy(voxmap.live())
    means = to_numpy(voxmap.mean)[occ]
    counts = to_numpy(voxmap.count)[occ]
    return means, counts


def map_to_dense_cloud(
    voxmap: VoxelMap | ShardedVoxelMap,
    samples_per_voxel: int = 16,
    max_points_per_voxel: int = 1000,
    seed: int = 0,
) -> np.ndarray:
    """Export-parity option: the reference flattens
    up to 1000 stored raw member points per voxel into the PCD
    (`LocalMap.cpp:156-167`); this map stores running statistics instead of
    members (a deliberate design deviation), so a comparable
    dense artifact is synthesised by drawing min(count, K) samples per voxel
    from the voxel's Gaussian N(mean, cov).  Deterministic given `seed`.

    Returns points [M, 3]."""
    voxmap, _ = _vm.compact(whole_map(voxmap), max_points_per_voxel=max_points_per_voxel)
    occ = to_numpy(voxmap.live())
    means = to_numpy(voxmap.mean)[occ].astype(np.float64)
    # [M, 3, 3] from the packed [M, 6] payload
    covs = to_numpy(_vm.unpack_cov(voxmap.cov))[occ].astype(np.float64)
    counts = np.minimum(
        to_numpy(voxmap.count)[occ].astype(np.int64), samples_per_voxel
    )
    rng = np.random.default_rng(seed)
    # batched Cholesky with jitter; fall back to isotropic on failure
    jitter = 1e-9 * np.eye(3)
    out = [means]  # always include the mean itself
    k_max = int(counts.max()) if len(counts) else 0
    if k_max > 1:
        try:
            L = np.linalg.cholesky(covs + jitter)
        except np.linalg.LinAlgError:
            w = np.linalg.eigvalsh(covs)[:, :1]
            L = np.sqrt(np.maximum(w, 0.0))[..., None] * np.eye(3)
        z = rng.standard_normal((len(means), k_max - 1, 3))
        samples = means[:, None, :] + np.einsum("nij,nkj->nki", L, z)
        keep = np.arange(k_max - 1)[None, :] < (counts[:, None] - 1)
        out.append(samples[keep])
    return np.concatenate(out).astype(np.float32)


def write_pcd(path: str, points: np.ndarray) -> None:
    """Minimal ASCII PCD v0.7 writer (x y z)."""
    n = len(points)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        "DATA ascii\n"
    )
    with open(path, "w") as f:
        f.write(header)
        np.savetxt(f, np.asarray(points, np.float32), fmt="%.6f")


def read_pcd(path: str) -> np.ndarray:
    """Reader for the ASCII PCD written above."""
    with open(path) as f:
        lines = f.readlines()
    start = next(i for i, l in enumerate(lines) if l.startswith("DATA")) + 1
    return np.loadtxt(lines[start:], dtype=np.float32).reshape(-1, 3)


def write_trajectory_json(
    path: str,
    times: list[float],
    rotations: list[np.ndarray],
    positions: list[np.ndarray],
) -> None:
    """Trajectory as a PinholeCameraTrajectory-style JSON (the reference's
    output format via Open3D, `LocalMap.cpp:16-18,166`): one 4x4 extrinsic
    per processed scan, column-major like Open3D serialises."""
    params = []
    for t, R, p in zip(times, rotations, positions):
        ext = np.eye(4)
        ext[:3, :3] = R
        ext[:3, 3] = p
        params.append(
            {
                "class_name": "PinholeCameraParameters",
                "extrinsic": ext.flatten(order="F").tolist(),
                "timestamp": t,
                "version_major": 1,
                "version_minor": 0,
            }
        )
    doc = {
        "class_name": "PinholeCameraTrajectory",
        "parameters": params,
        "version_major": 1,
        "version_minor": 0,
    }
    with open(path, "w") as f:
        json.dump(doc, f)


def read_trajectory_json(path: str):
    """Returns (times, rotations, positions)."""
    with open(path) as f:
        doc = json.load(f)
    times, Rs, ps = [], [], []
    for prm in doc["parameters"]:
        ext = np.asarray(prm["extrinsic"]).reshape(4, 4, order="F")
        times.append(prm.get("timestamp", 0.0))
        Rs.append(ext[:3, :3])
        ps.append(ext[:3, 3])
    return times, Rs, ps


def save_run(odo, cloud_path: str, trajectory_path: str) -> None:
    """The framework's `LocalMap::save` equivalent, invoked at shutdown
    (ref `main.cpp:71`)."""
    pts, _ = map_to_cloud(odo.voxmap)
    write_pcd(cloud_path, pts)
    write_trajectory_json(
        trajectory_path, odo.trajectory_t, odo.trajectory_R, odo.trajectory_p
    )
