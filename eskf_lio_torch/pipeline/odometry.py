"""The per-scan odometry step (port of the step builders of
`eskf_lio_tpu/pipeline/odometry.py`).

`make_step_core` is the main path of one scan — IMU-prefix prediction,
deskew / downsample / covariances, VGICP alignment, the ESKF pose update,
map insert and the periodic eviction — over tensors on one device.  The
JAX package jits it; here it runs eagerly, with host branches where JAX has
`lax.cond` (eviction is host-known; the insert fold is one scalar read).
The streaming `Odometry` driver of the JAX module is not ported yet.

Each stage runs under a `torch.profiler.record_function` range (predict,
preprocess, align, pose_update, map_insert, evict), so a profiler trace
splits the step's host and device time by stage; without an active
profiler the ranges cost a few microseconds a step.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from eskf_lio_torch import device as device_policy
from eskf_lio_torch.config import Config
from eskf_lio_torch.map import voxel_map as vm
from eskf_lio_torch.models import eskf, registration
from eskf_lio_torch.ops import lie, preprocess
from eskf_lio_torch.types import FilterState, ImuChunk, Pose, ProcessedScan, Scan


def lidar_extrinsics(config: Config, device="cuda", dtype=torch.float32) -> Pose:
    """T_il from the config quaternion (xyzw) and translation."""
    dev = device_policy.resolve(device)
    qx, qy, qz, qw = config.lidar_quat_xyzw
    q = torch.tensor(np.asarray([qw, qx, qy, qz], np.float32), dtype=dtype, device=dev)
    t = torch.tensor(np.asarray(config.lidar_translation, np.float32), dtype=dtype, device=dev)
    return Pose(R=lie.quat_to_mat(lie.quat_normalize(q)), t=t)


def make_step_core(config: Config, device="cuda") -> Callable:
    """The per-scan step: core(carry, inputs) -> (carry, diag) with
    carry = (FilterState, VoxelMap, prev_R, prev_t) and
    inputs = (ImuChunk, Scan, do_evict: bool)."""
    dev = device_policy.resolve(device)
    noise = eskf.make_noise_params(config, dev)
    T_il = lidar_extrinsics(config, dev)
    a_cap = config.align_capacity

    def core(carry, inputs):
        state, voxmap, prev_R, prev_t = carry
        chunk, scan, do_evict = inputs

        # 1+2. predict to the last sample before scan end (parallel prefix)
        with record_function("predict"):
            base, hist = eskf.predict_chunk_prefix(
                state, chunk, noise, base_mask=chunk.t_rel <= 0.0
            )
        # 3. preprocess
        with record_function("preprocess"):
            processed = preprocess.preprocess(scan, hist, T_il, config)

        # 4. VGICP over the align-budget prefix (live voxels are a contiguous
        # ascending-key prefix of the processed scan); insert uses the full
        # scan
        with record_function("align"):
            guess = eskf.pose_of(base)
            aligned_scan = ProcessedScan(*(x[:a_cap] for x in processed))
            res = registration.align(aligned_scan, voxmap, guess, config)

        # 5. measurement update
        with record_function("pose_update"):
            corrected = eskf.pose_update(base, res.pose, noise)
            T = eskf.pose_of(corrected)

        # 6. map update with the frame-to-frame motion gate
        with record_function("map_insert"):
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
            with record_function("evict"):
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
        return (corrected, voxmap, T.R, T.t), diag

    return core


def make_scan_step(config: Config, device="cuda") -> Callable:
    """One scan: scan_step(state, voxmap, prev_R, prev_t, chunk, scan,
    do_evict) -> (state, voxmap, R, t, diag)."""
    core = make_step_core(config, device)

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


def make_predict_only(config: Config, device="cuda") -> Callable:
    """Overflow path: advance the filter through a chunk without a scan."""
    noise = eskf.make_noise_params(config, device)

    def predict_only(state: FilterState, chunk: ImuChunk) -> FilterState:
        return eskf.predict_chunk_prefix(state, chunk, noise)[0]

    return predict_only
