"""Frozen copy of `eskf_lio_torch/ops/sortmerge.py` for the benchmark's plain reference.

Kernel calls and device control flow are replaced by the plain versions
in `benchmark/reference/plain.py`; the arithmetic is the port's at the
commit that added the benchmark.  The original docstring follows.

Sort-merge primitives for voxel-keyed joins (port of
`eskf_lio_tpu/ops/sortmerge.py`).

* `pack_keys` packs 3D voxel coords into ONE int32 relative to a local
  origin (10 bits per axis); neighbour offsets become constant adds.
* `mix32` / `skey_of` give the bijective hash order that keys the voxel map.
  torch has no uint32 right shift on the CPU, so the uint32 arithmetic runs
  in int64 masked to 32 bits (products split so no int64 overflows) and is
  wrapped back to int32: the bits equal the JAX package's on CPU and CUDA.
* `sort_perm` is a stable key sort with payload rows riding on a gather of
  the permutation; stability is the "first point per voxel" rule.
"""

from __future__ import annotations

import torch

from benchmark.reference.voxel import wrap_i32

INT32_MAX = 2147483647

# 10 bits per axis => grid extent 1024 voxels per axis around the origin
_BITS = 10
_SPAN = 1 << _BITS
_MASK = _SPAN - 1
_U32 = 0xFFFFFFFF
_SIGN = 0x80000000


def pack_keys(
    keys: torch.Tensor, origin: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., 3] int32 voxel coords -> (packed int32 relative to `origin`,
    in_range).  Out-of-span coords are flagged and packed as INT32_MAX."""
    rel = keys - origin
    in_range = torch.all((rel >= 0) & (rel < _SPAN), dim=-1)
    packed = (rel[..., 0] << (2 * _BITS)) | (rel[..., 1] << _BITS) | rel[..., 2]
    return torch.where(in_range, packed, INT32_MAX), in_range


def unpack_keys(packed: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_keys`; sentinel rows produce junk (callers mask)."""
    rel = torch.stack(
        [
            (packed >> (2 * _BITS)) & _MASK,
            (packed >> _BITS) & _MASK,
            packed & _MASK,
        ],
        dim=-1,
    )
    return rel + origin


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 holding their uint32 value."""
    return x.to(torch.int64) & _U32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64, with the product
    split in 16-bit halves so no intermediate leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """Bijective 32-bit mixer (lowbias32 finalizer) on uint32 values held in
    int64 (or int32 bits); returns int64 in [0, 2^32)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def unmix32(x: torch.Tensor) -> torch.Tensor:
    """Exact inverse of `mix32`; int64 in [0, 2^32) -> same."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x43021123)  # 0x846CA68B^-1 mod 2^32
    x = x ^ (x >> 15) ^ (x >> 30)
    x = _mul32(x, 0x1D69E2A5)  # 0x7FEB352D^-1 mod 2^32
    x = x ^ (x >> 16)
    return x


def skey_of(packed: torch.Tensor) -> torch.Tensor:
    """Hash sort key of a packed voxel key: int32 whose ascending order is
    the uint32 order of mix32(packed).  INT32_MAX passes through as the
    empty sentinel; a real key hashing to INT32_MAX becomes INT32_MAX-1."""
    s = wrap_i32(mix32(packed) ^ _SIGN)
    s = torch.where(s == INT32_MAX, INT32_MAX - 1, s)
    return torch.where(packed == INT32_MAX, INT32_MAX, s)


def packed_of_skey(skey: torch.Tensor) -> torch.Tensor:
    """Inverse of `skey_of` via `unmix32` (exact except the INT32_MAX-1
    remap)."""
    p = wrap_i32(unmix32(_u32(skey) ^ _SIGN))
    return torch.where(skey == INT32_MAX, INT32_MAX, p)


def sort_perm(skey: torch.Tensor, *rows: torch.Tensor, take: int | None = None):
    """Stable ascending sort by `skey`; every extra array rides on one row
    gather of the permutation.  `take=k` keeps only the first k sorted rows
    before the gathers.  Returns (skey_sorted, perm, *rows_sorted)."""
    n = skey.shape[0]
    skey_s, perm = torch.sort(skey, stable=True)
    if take is not None and take < n:
        skey_s, perm = skey_s[:take], perm[:take]
    return (skey_s, perm) + tuple(r[perm] for r in rows)


def bucket_of(skey: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Top log2(n_buckets) bits of the uint32 order of an skey."""
    if n_buckets <= 1:
        return torch.zeros(skey.shape, dtype=torch.int32, device=skey.device)
    bits = n_buckets.bit_length() - 1
    return ((_u32(skey) ^ _SIGN) >> (32 - bits)).to(torch.int32)


def unique_segments(sorted_keys: torch.Tensor, valid_sorted: torch.Tensor):
    """Heads + segment ids over a sorted key array.  Returns (head [N] bool,
    seg_id [N] int64); invalid rows land in the last bin."""
    n = sorted_keys.shape[0]
    same = torch.zeros(n, dtype=torch.bool, device=sorted_keys.device)
    same[1:] = sorted_keys[1:] == sorted_keys[:-1]
    head = valid_sorted & ~same
    seg_id = torch.cumsum(head.to(torch.int64), 0) - 1
    seg_id = torch.where(valid_sorted, seg_id.clamp(min=0), n - 1)
    return head, seg_id
