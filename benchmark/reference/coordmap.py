"""A plain voxel map keyed by integer voxel coordinates, for the reference
of a cell whose sensor travels far: the C++ reference's `LocalMap`
semantics (`LocalMap.cpp`) over a dictionary that never drops a key.

The dictionary is two tensors: the sorted int64 codes of the voxel
coordinates (21 bits an axis around zero, +-1,048,575 voxels: +-314 km at
0.3 m; a coordinate beyond raises) and a [L, 10] row a voxel of its
point count, mean and mean point covariance (packed xx, xy, xz, yy, yz,
zz), float32 as in the port.  A lookup is a binary search of the codes.
An insert adds a batch's points in their order, each to its voxel while
the voxel holds fewer than the cap (`Voxel::addPoint`); an eviction drops
every voxel whose centre lies farther than the threshold from the centre
given (`needsPointRemoval`).  There is no packing origin, no span, no
capacity and no hash order: nothing of the port's layout.

`from_packed` reads a map of the port's layout (the fields of
`reference/voxel_map.py::VoxelMap`) into this one, given its key split,
so that a block of rows can start from the program's map; `tiers` gives
a map the field names `compare.map_gaps` reads, so that two maps compare
voxel by voxel, by coordinate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import sortmerge as sm

_BITS = 21
_OFF = 1 << (_BITS - 1)
_MASK = (1 << _BITS) - 1
INT32_MAX = 2**31 - 1


class CoordMap(NamedTuple):
    codes: torch.Tensor  # [L] int64, ascending, unique
    stats: torch.Tensor  # [L, 10] float32: count, mean (3), covariance (6)


class Tiers(NamedTuple):
    """A map as `compare.map_gaps` reads it: the main tier's keys and rows,
    and an empty delta tier."""

    skey: torch.Tensor
    payload: torch.Tensor
    d_skey: torch.Tensor
    d_payload: torch.Tensor


def empty(device) -> CoordMap:
    dev = torch.device(device)
    return CoordMap(torch.zeros(0, dtype=torch.int64, device=dev),
                    torch.zeros((0, 10), dtype=torch.float32, device=dev))


def encode(keys: torch.Tensor) -> torch.Tensor:
    """[..., 3] integer voxel coordinates -> [...] int64 codes."""
    k = keys.to(torch.int64)
    if bool(((k < -_OFF + 1) | (k > _OFF - 1)).any()):
        raise ValueError("a voxel coordinate beyond +-2^20")
    k = k + _OFF
    return (k[..., 0] << (2 * _BITS)) | (k[..., 1] << _BITS) | k[..., 2]


def decode(codes: torch.Tensor) -> torch.Tensor:
    """[...] int64 codes -> [..., 3] int64 voxel coordinates."""
    return torch.stack([(codes >> (2 * _BITS)) & _MASK, (codes >> _BITS) & _MASK,
                        codes & _MASK], -1) - _OFF


def voxel_of(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """floor(p / voxel_size), as `LocalMap::getVoxelKey`."""
    return torch.floor(points / voxel_size).to(torch.int64)


def _find(cmap: CoordMap, codes: torch.Tensor):
    """(row of each code in the map, whether it is there)."""
    if cmap.codes.numel() == 0:
        z = torch.zeros(codes.shape, dtype=torch.int64, device=codes.device)
        return z, torch.zeros(codes.shape, dtype=torch.bool, device=codes.device)
    row = torch.searchsorted(cmap.codes, codes).clamp(max=cmap.codes.numel() - 1)
    return row, cmap.codes[row] == codes


def lookup(cmap: CoordMap, points: torch.Tensor, *, voxel_size: float):
    """Each point's own voxel: (mean [N, 3], packed covariance [N, 6], hit [N])."""
    row, hit = _find(cmap, encode(voxel_of(points, voxel_size)))
    stats = torch.where(hit[:, None], cmap.stats[row], 0.0) if cmap.codes.numel() else \
        torch.zeros((points.shape[0], 10), dtype=torch.float32, device=points.device)
    return stats[:, 1:4], stats[:, 4:10], hit


def insert(cmap: CoordMap, points: torch.Tensor, covs_packed: torch.Tensor, valid: torch.Tensor,
           *, voxel_size: float, max_points_per_voxel: int) -> CoordMap:
    """Add the valid points in their order, each to its voxel while the voxel
    holds fewer than `max_points_per_voxel`: count, mean and covariance as
    running means."""
    dev = points.device
    idx = torch.nonzero(valid).flatten()
    if idx.numel() == 0:
        return cmap
    codes = encode(voxel_of(points[idx], voxel_size))
    order = torch.sort(codes, stable=True).indices  # batch order within a voxel
    codes, idx = codes[order], idx[order]
    uniq, inverse, counts = torch.unique_consecutive(codes, return_inverse=True, return_counts=True)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(codes.numel(), device=dev) - first[inverse]
    row, found = _find(cmap, uniq)
    n0 = torch.where(found, cmap.stats[row, 0], 0.0) if cmap.codes.numel() else \
        torch.zeros(uniq.shape, dtype=torch.float32, device=dev)
    take = rank < (max_points_per_voxel - n0)[inverse]
    k = torch.zeros(uniq.shape, dtype=torch.float32, device=dev).index_add_(
        0, inverse[take], torch.ones(int(take.sum()), device=dev))
    sums = torch.zeros((uniq.numel(), 9), dtype=torch.float32, device=dev).index_add_(
        0, inverse[take], torch.cat([points[idx[take]], covs_packed[idx[take]]], 1))
    old = torch.where(found[:, None], cmap.stats[row], 0.0) if cmap.codes.numel() else \
        torch.zeros((uniq.numel(), 10), dtype=torch.float32, device=dev)
    n = n0 + k
    denom = torch.clamp(n, min=1.0)[:, None]
    mean = (n0[:, None] * old[:, 1:4] + sums[:, :3]) / denom
    cov = (n0[:, None] * old[:, 4:10] + sums[:, 3:]) / denom
    new = torch.cat([n[:, None], mean, cov], 1)
    stats = cmap.stats.clone()
    stats[row[found]] = new[found]
    codes_all = torch.cat([cmap.codes, uniq[~found]])
    stats_all = torch.cat([stats, new[~found]])
    order = torch.argsort(codes_all)
    return CoordMap(codes_all[order], stats_all[order])


def evict_beyond(cmap: CoordMap, center: torch.Tensor, *, voxel_size: float,
                 distance_threshold: float) -> tuple[CoordMap, torch.Tensor]:
    """Drop the voxels whose centre lies farther than `distance_threshold`
    from `center`: (map, voxels removed)."""
    centres = (decode(cmap.codes).to(center.dtype) + 0.5) * voxel_size
    keep = torch.linalg.norm(centres - center, dim=-1) <= distance_threshold
    return CoordMap(cmap.codes[keep], cmap.stats[keep]), (~keep).sum()


def _unpack(packed: torch.Tensor, origin: torch.Tensor, bits) -> torch.Tensor:
    """A packed key of the port's layout -> int64 voxel coordinates: x in the
    high bits, z in the low, around `origin`."""
    bx, by, bz = bits
    p = packed.to(torch.int64)
    rel = torch.stack([(p >> (by + bz)) & ((1 << bx) - 1), (p >> bz) & ((1 << by) - 1),
                       p & ((1 << bz) - 1)], -1)
    return rel + origin.to(torch.int64)


def from_packed(vmap, key_bits, max_points_per_voxel: int) -> CoordMap:
    """The voxels of a map of the port's layout (`origin`, main tier `skey`
    / `payload` of count, mean, covariance; delta tier `d_skey` /
    `d_payload` of count and sums), its tiers combined as the port's lookup
    combines them: the delta's sums under what the cap leaves room for."""
    cap = float(max_points_per_voxel)
    live_m = vmap.skey != INT32_MAX
    live_d = vmap.d_skey != INT32_MAX
    c_m = encode(_unpack(sm.packed_of_skey(vmap.skey[live_m]), vmap.origin, key_bits))
    c_d = encode(_unpack(sm.packed_of_skey(vmap.d_skey[live_d]), vmap.origin, key_bits))
    main = CoordMap(*(x for x in _sorted(c_m, vmap.payload[live_m])))
    raw = vmap.d_payload[live_d]
    row, found = _find(main, c_d)
    base = torch.where(found[:, None], main.stats[row], 0.0) if main.codes.numel() else \
        torch.zeros_like(raw)
    c0, c_add = base[:, 0], raw[:, 0]
    add = torch.minimum(torch.clamp(cap - c0, min=0.0), c_add)
    scale = torch.where(c_add > 0, add / torch.clamp(c_add, min=1.0), 0.0)
    denom = torch.clamp(c0 + add, min=1.0)[:, None]
    mean = (c0[:, None] * base[:, 1:4] + scale[:, None] * raw[:, 1:4]) / denom
    cov = (c0[:, None] * base[:, 4:10] + scale[:, None] * raw[:, 4:10]) / denom
    comb = torch.cat([(c0 + add)[:, None], mean, cov], 1)
    stats = main.stats.clone()
    stats[row[found]] = comb[found]
    return CoordMap(*_sorted(torch.cat([main.codes, c_d[~found]]), torch.cat([stats, comb[~found]])))


def _sorted(codes: torch.Tensor, stats: torch.Tensor):
    order = torch.argsort(codes)
    return codes[order], stats[order]


def tiers(cmap: CoordMap) -> Tiers:
    """`cmap` with the field names `compare.map_gaps` reads (its codes never
    equal the empty key INT32_MAX: every code is above 2^41)."""
    dev = cmap.codes.device
    return Tiers(cmap.codes, cmap.stats, torch.zeros(0, dtype=torch.int64, device=dev),
                 torch.zeros((0, 10), dtype=torch.float32, device=dev))
