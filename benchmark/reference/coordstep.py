"""The plain reference of one scan of the filter over the coordinate map
(`coordmap.py`): `step.py`'s step, the same prediction, preprocessing,
alignment and pose update, with the map's lookup, insert and eviction
those of a dictionary of voxel coordinates, which has no span.
"""

from __future__ import annotations

import torch

from benchmark.reference import coordmap as cm
from benchmark.reference import eskf, preprocess, registration
from benchmark.reference import voxel_map as vm
from benchmark.reference.config import Config
from benchmark.reference.step import lidar_extrinsics
from benchmark.reference.types import ProcessedScan, Scan


def make_step(config: Config, device):
    """step(carry, (chunk, scan, do_evict)) -> (carry, diag), carry =
    (FilterState, CoordMap, prev_R, prev_t)."""
    dev = torch.device(device)
    noise = eskf.make_noise_params(config, dev)
    T_il = lidar_extrinsics(config, dev)
    a_cap = config.align_capacity
    vs = config.map_voxel_size

    def step(carry, inputs):
        state, cmap, prev_R, prev_t = carry
        chunk, scan, do_evict = inputs
        base, hist = eskf.predict_chunk_prefix(state, chunk, noise, base_mask=chunk.t_rel <= 0.0)
        processed = preprocess.preprocess(scan, hist, T_il, config)
        guess = eskf.pose_of(base)
        aligned_scan = ProcessedScan(*(x[:a_cap] for x in processed))
        res = registration.align(aligned_scan, None, guess, config,
                                 lookup_fn=lambda pts: cm.lookup(cmap, pts, voxel_size=vs))
        corrected = eskf.pose_update(base, res.pose, noise)
        T = eskf.pose_of(corrected)

        moved_R = prev_R.T @ T.R
        moved_t = prev_R.T @ (T.t - prev_t)
        cosine = 0.5 * (torch.trace(moved_R) - 1.0)
        should_insert = (cosine < config.map_update_cosine_threshold) | (
            torch.sum(moved_t * moved_t) > config.map_update_translation_sq_threshold
        )
        cmap = cm.insert(cmap, T.apply(processed.points), vm.pack_cov(T.R @ processed.covs @ T.R.T),
                         processed.valid & should_insert, voxel_size=vs,
                         max_points_per_voxel=config.max_points_per_voxel)
        removed = torch.zeros((), dtype=torch.int64, device=dev)
        if bool(do_evict) and config.remove_distant_points:
            cmap, removed = cm.evict_beyond(cmap, T.t, voxel_size=vs,
                                            distance_threshold=config.remove_distance_threshold)
        diag = {"icp_iterations": res.iterations, "removed_voxels": removed,
                "pose_finite": torch.isfinite(T.t).all() & torch.isfinite(T.R).all()}
        return (corrected, cmap, T.R, T.t), diag

    return step


def init_carry(config: Config, init_scan: Scan, device):
    """The first scan's path (preprocess without deskew, insert at the
    identity) from the initial state and an empty map."""
    dev = torch.device(device)
    T_il = lidar_extrinsics(config, dev)
    processed = preprocess.downsample_and_covariances(T_il.apply(init_scan.points), init_scan.valid,
                                                      config)
    cmap = cm.insert(cm.empty(dev), processed.points, vm.pack_cov(processed.covs), processed.valid,
                     voxel_size=config.map_voxel_size,
                     max_points_per_voxel=config.max_points_per_voxel)
    return (eskf.init_state(config, dev), cmap, torch.eye(3, device=dev), torch.zeros(3, device=dev))
