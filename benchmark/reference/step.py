"""The plain reference of one scan of the filter, and its first scan.

Frozen copy of `make_step_core`, `make_init_step` and `lidar_extrinsics`
of `eskf_lio_torch/pipeline/odometry.py` (without the profiler ranges), over
the plain modules of this folder: IMU-prefix prediction, deskew /
downsample / covariances, VGICP alignment, the ESKF pose update, the map
insert and the periodic eviction.  It runs eagerly on any device, with one
host read per device decision.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import eskf, lie, preprocess, registration
from benchmark.reference import voxel_map as vm
from benchmark.reference.config import Config
from benchmark.reference.types import Pose, ProcessedScan, Scan

DIAG_KEYS = (
    "icp_iterations", "icp_converged", "num_correspondences", "inserted",
    "dropped_points", "removed_voxels", "num_scan_points",
    "align_slice_overflow", "pose_finite",
)


def lidar_extrinsics(config: Config, device, dtype=torch.float32) -> Pose:
    """T_il from the config quaternion (xyzw) and translation."""
    qx, qy, qz, qw = config.lidar_quat_xyzw
    q = torch.tensor(np.asarray([qw, qx, qy, qz], np.float32), dtype=dtype, device=device)
    t = torch.tensor(np.asarray(config.lidar_translation, np.float32), dtype=dtype, device=device)
    return Pose(R=lie.quat_to_mat(lie.quat_normalize(q)), t=t)


def make_step(config: Config, device):
    """step(carry, (chunk, scan, do_evict)) -> (carry, diag), carry =
    (FilterState, VoxelMap, prev_R, prev_t)."""
    dev = torch.device(device)
    noise = eskf.make_noise_params(config, dev)
    T_il = lidar_extrinsics(config, dev)
    a_cap = config.align_capacity

    def step(carry, inputs):
        state, voxmap, prev_R, prev_t = carry
        chunk, scan, do_evict = inputs
        base, hist = eskf.predict_chunk_prefix(
            state, chunk, noise, base_mask=chunk.t_rel <= 0.0
        )
        processed = preprocess.preprocess(scan, hist, T_il, config)
        guess = eskf.pose_of(base)
        aligned_scan = ProcessedScan(*(x[:a_cap] for x in processed))
        res = registration.align(aligned_scan, voxmap, guess, config)
        corrected = eskf.pose_update(base, res.pose, noise)
        T = eskf.pose_of(corrected)

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
        removed = torch.zeros((), dtype=torch.int64, device=dev)
        if bool(do_evict) and config.remove_distant_points:
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
            "pose_finite": torch.isfinite(T.t).all() & torch.isfinite(T.R).all(),
        }
        return (corrected, voxmap, T.R, T.t), diag

    return step


def init_carry(config: Config, init_scan: Scan, device):
    """The first scan's path (preprocess without deskew, insert at the
    identity) from the initial state and an empty map: the carry before
    the first update row."""
    dev = torch.device(device)
    T_il = lidar_extrinsics(config, dev)
    voxmap = vm.VoxelMap.create(config.hash_capacity, config.map_delta_capacity, device=dev)
    processed = preprocess.downsample_and_covariances(
        T_il.apply(init_scan.points), init_scan.valid, config
    )
    voxmap, _ = vm.insert(
        voxmap, processed.points, vm.pack_cov(processed.covs), processed.valid,
        voxel_size=config.map_voxel_size, max_points_per_voxel=config.max_points_per_voxel,
    )
    return (eskf.init_state(config, dev), voxmap,
            torch.eye(3, device=dev), torch.zeros(3, device=dev))
