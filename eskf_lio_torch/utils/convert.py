"""State carried across from the JAX package (the system has state, not
weights).

The JAX package's `FilterState`, `VoxelMap` and `NoiseParams` (and the
port's own) are NamedTuples of arrays with the same field names and
layouts.  Given one whose leaves are numpy arrays — for the JAX package,
`jax.tree.map(numpy.asarray, x)` — these functions build the port's
tensors on a device; `to_numpy` goes back.  Nothing here imports JAX: the
inputs are read by field name.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from eskf_lio_torch import device as device_policy
from eskf_lio_torch.map.voxel_map import VoxelMap
from eskf_lio_torch.models.eskf import NoiseParams
from eskf_lio_torch.types import FilterState


def from_numpy(a, device="cuda", dtype: torch.dtype | None = None) -> torch.Tensor:
    """One numpy array -> tensor on `device`.  Floats become float32 (as
    `jnp.asarray` does with 64-bit types disabled; `torch.as_tensor` would
    keep float64) unless `dtype` says otherwise."""
    a = np.require(a, requirements="W")  # torch wants a writable buffer
    if dtype is None and a.dtype.kind == "f":
        dtype = torch.float32
    t = torch.as_tensor(a, device=device_policy.resolve(device))
    return t if dtype is None else t.to(dtype)


def _convert(cls, src: Any, device, dtypes: dict) -> NamedTuple:
    return cls(
        **{
            f: from_numpy(getattr(src, f), device, dtypes.get(f))
            for f in cls._fields
        }
    )


def filter_state_from_numpy(src: Any, device="cuda") -> FilterState:
    """A FilterState (fields p, v, q, ba, bg, g, P as arrays) -> the port's."""
    return _convert(FilterState, src, device, {})


def voxel_map_from_numpy(src: Any, device="cuda") -> VoxelMap:
    """A VoxelMap (origin, skey, payload, view, d_skey, d_payload, d_view)
    -> the port's, integer words unchanged."""
    ints = dict.fromkeys(("origin", "skey", "view", "d_skey", "d_view"), torch.int32)
    return _convert(VoxelMap, src, device, ints)


def noise_from_numpy(src: Any, device="cuda") -> NoiseParams:
    """A NoiseParams (q_diag, v_diag) -> the port's."""
    return _convert(NoiseParams, src, device, {})


def to_numpy(x):
    """A tensor, or a NamedTuple / tuple / dict of them, as numpy arrays
    (the same container type)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    return x
