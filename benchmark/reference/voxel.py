"""Frozen copy of `eskf_lio_torch/ops/voxel.py` for the benchmark's plain reference.

Kernel calls and device control flow are replaced by the plain versions
in `benchmark/reference/plain.py`; the arithmetic is the port's at the
commit that added the benchmark.  The original docstring follows.

Voxel key primitives (port of `eskf_lio_tpu/ops/voxel.py`).

`voxel_key` is the reference's `floor(p / voxel_size)` (`LocalMap.cpp:114-118`).
`owner_hash` assigns keys to devices in the JAX package's sharded mode; it
relies on int32 multiply wrap-around, which is done here in int64 and
wrapped explicitly so the CPU and CUDA give the JAX package's bits.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding any integer -> int32 with two's-complement wrap-around
    of its low 32 bits."""
    return (((x + (1 << 31)) & _U32) - (1 << 31)).to(torch.int32)


def voxel_key(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """[..., 3] float points -> [..., 3] int32 voxel coordinates."""
    return torch.floor(points / voxel_size).to(torch.int32)


def owner_hash(keys: torch.Tensor, num_owners: int) -> torch.Tensor:
    """[..., 3] int32 voxel coords -> owner device index in [0, num_owners)."""
    k = keys.to(torch.int64)
    h = wrap_i32(k[..., 0] * 12582917 ^ k[..., 1] * 3145739 ^ k[..., 2] * 786433)
    h = h ^ (h >> 16)  # arithmetic shift of int32, as jnp's >>
    h = wrap_i32(h.to(torch.int64) * (2654435761 - (1 << 32)))
    h = h ^ (h >> 11)
    return (h & 0x7FFFFFFF) % num_owners
