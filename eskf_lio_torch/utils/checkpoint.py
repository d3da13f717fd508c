"""Checkpoint / resume (port of `eskf_lio_tpu/utils/checkpoint.py`).

The reference has no mid-run checkpointing — only a terminal PCD+JSON dump
(`LocalMap.cpp:156-167`).  Here the entire odometry state is a set of
fixed-shape tensors, so a checkpoint is one npz save of (FilterState,
VoxelMap, pose carry) plus the trajectory and the host clocks, and resume
is exact: the restored runner continues bit-identically.

The on-disk layout is the JAX package's, so a checkpoint written by either
package loads into the other: `arrays.npz` holds `state_0..6` (p, v, q, ba,
bg, g, P), `voxmap_0..6` (origin, skey, payload, view, d_skey, d_payload,
d_view — the NamedTuple field order of both packages), `prev_R`, `prev_t`;
`meta.pkl` holds the flags, clocks and trajectory lists.

A sharded run (`parallel.sharded_map.ShardedOdometry`) keeps the same
layout: the `voxmap_i` leaves are the global arrays, every field but
`origin` the concatenation of the shards' blocks in shard order, so a
sharded checkpoint of either package loads into the other's driver with the
same shard count.  Under a process group saving and loading are
collectives: every process calls them; process 0 alone writes.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np

from eskf_lio_torch.map.voxel_map import VoxelMap
from eskf_lio_torch.parallel import distributed as dist
from eskf_lio_torch.parallel.sharded_map import ShardedVoxelMap
from eskf_lio_torch.types import FilterState
from eskf_lio_torch.utils.convert import (
    filter_state_from_numpy,
    from_numpy,
    to_numpy,
    voxel_map_from_numpy,
)


def save_checkpoint(path: str, odo) -> None:
    """Snapshot an `Odometry` (or `ShardedOdometry`) run to the directory
    `path`.

    Under a process group this is a collective — every process must call it
    (the shards' blocks are gathered to process 0); only process 0 touches
    the filesystem."""
    voxmap = odo.voxmap
    if isinstance(voxmap, ShardedVoxelMap):
        voxmap = voxmap.gather(root=0)
    if dist.process_index() != 0:
        return
    os.makedirs(path, exist_ok=True)
    flat = {}
    for i, leaf in enumerate(to_numpy(odo.state)):
        flat[f"state_{i}"] = leaf
    for i, leaf in enumerate(to_numpy(voxmap)):
        flat[f"voxmap_{i}"] = leaf
    flat["prev_R"] = to_numpy(odo.prev_R)
    flat["prev_t"] = to_numpy(odo.prev_t)
    meta = {
        "initialized": odo.initialized,
        "t_last_update": odo.t_last_update,
        "t_last_evict": odo.t_last_evict,
        "trajectory_t": odo.trajectory_t,
        "trajectory_p": odo.trajectory_p,
        "trajectory_R": odo.trajectory_R,
    }
    np.savez_compressed(os.path.join(path, "arrays.npz"), **flat)
    with open(os.path.join(path, "meta.pkl"), "wb") as f:
        pickle.dump(meta, f)


def load_checkpoint(path: str, odo) -> Any:
    """Restore a snapshot into an existing `Odometry` instance (same config),
    its tensors placed on the instance's device.  Returns the instance.

    Under a process group every process calls it with `path` readable
    locally (a shared filesystem or a copy); each reads the full arrays and
    a sharded driver keeps its own blocks of the map.

    `meta.pkl` is a pickle: load only checkpoints this program (or the JAX
    package) wrote."""
    with np.load(os.path.join(path, "arrays.npz")) as z:
        state = FilterState(*(z[f"state_{i}"] for i in range(len(FilterState._fields))))
        voxmap = VoxelMap(*(z[f"voxmap_{i}"] for i in range(len(VoxelMap._fields))))
        prev_R, prev_t = z["prev_R"], z["prev_t"]
    with open(os.path.join(path, "meta.pkl"), "rb") as f:
        meta = pickle.load(f)

    dev = odo.device
    odo.state = filter_state_from_numpy(state, dev)
    odo.voxmap = voxel_map_from_numpy(voxmap, dev)
    odo.prev_R = from_numpy(prev_R, dev)
    odo.prev_t = from_numpy(prev_t, dev)
    odo.initialized = meta["initialized"]
    odo.t_last_update = meta["t_last_update"]
    odo.t_last_evict = meta["t_last_evict"]
    odo.trajectory_t = list(meta["trajectory_t"])
    odo.trajectory_p = list(meta["trajectory_p"])
    odo.trajectory_R = list(meta["trajectory_R"])
    return odo
