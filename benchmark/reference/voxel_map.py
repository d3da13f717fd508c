"""Frozen copy of `eskf_lio_torch/map/voxel_map.py` for the benchmark's plain reference.

Kernel calls and device control flow are replaced by the plain versions
in `benchmark/reference/plain.py`; the arithmetic is the port's at the
commit that added the benchmark.  The original docstring follows.

Device-resident voxel map: a two-tier hash-ordered LSM dictionary.

Port of `eskf_lio_tpu/map/voxel_map.py` (the reference `LocalMap`), with
the JAX layout kept exactly so the two compare word for word:

* entries are ordered by `skey`, the bijective 32-bit hash order of the
  packed voxel key (`ops.sortmerge.skey_of`); no packed column is stored;
* MAIN tier: capacity C of finalised stats rows (count, mean, cov),
  ascending by skey, plus its `view`, rebuilt only on fold/eviction;
  DELTA tier: capacity D of raw-sum rows in append order plus its `d_view`;
* each view is set-associative: 8 slots of 16 int32 words — [skey, row,
  payload (10 f32 bitcast), 4 pad] — in one 512-byte bucket row, 4x slot
  headroom (the main view is 128 MiB at C = 2^19);
* lookup = one bucket-row gather per tier; insert = one stable sort, a
  segment sum, one d_view probe, capped merge / append; a batch whose new
  voxels would overflow the delta folds delta + batch into MAIN.

Translation notes: JAX's out-of-range scatter indices are dropped
(`mode="drop"`); here such rows go to one extra dump row that is sliced
off.  Every gather index is in range by construction (bucket ids are below
the bucket count; searchsorted results are clamped).  The fold/append
`lax.cond` (`eskf_lio_tpu/map/voxel_map.py:615`) is `utils.graphs.device_if`:
inside a captured step two IF nodes that write the map's own buffers in
place (the fold the main tier too, the append the delta tier only), eagerly
one host read.  `jax.ops.segment_sum` over the
key-sorted batch is `ops.segscan.segsum_sorted` (kernel B on the card, no
float atomics), so the same batch gives the same map bit for bit, run after
run; payloads agree with the JAX package to f32 rounding, integer words
exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import plain as device_policy
from benchmark.reference import plain
from benchmark.reference import sortmerge as sm
from benchmark.reference import voxel as vx
from benchmark.reference.plain import device_if

INT32_MAX = sm.INT32_MAX

VIEW_ASSOC = 8
VIEW_HEADROOM = 4  # total view slots = VIEW_HEADROOM * capacity
VIEW_SLOT = 16  # int32 words per slot (64-byte aligned)
_SLOT_PAY = 12  # payload words per slot: skey, row, payload x10


def pack_cov(cov: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric -> [..., 6] (xx, xy, xz, yy, yz, zz)."""
    return torch.stack(
        [
            cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
            cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2],
        ],
        dim=-1,
    )


def unpack_cov(packed: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 3] symmetric."""
    xx, xy, xz, yy, yz, zz = packed.unbind(-1)
    return torch.stack(
        [
            torch.stack([xx, xy, xz], dim=-1),
            torch.stack([xy, yy, yz], dim=-1),
            torch.stack([xz, yz, zz], dim=-1),
        ],
        dim=-2,
    )


def _n_view_buckets(capacity: int) -> int:
    return max(capacity * VIEW_HEADROOM // VIEW_ASSOC, 1)


class VoxelMap(NamedTuple):
    """Two-tier hash-ordered LSM voxel dictionary."""

    origin: torch.Tensor  # [3] int32 packing origin (voxel coords)
    skey: torch.Tensor  # [C] int32, ascending, INT32_MAX tail
    payload: torch.Tensor  # [C, 10] f32: count, mean(3), cov(6)
    view: torch.Tensor  # [C/2, 128] int32 — stats-inlined, fold-rebuilt
    d_skey: torch.Tensor  # [D] int32, append order
    d_payload: torch.Tensor  # [D, 10] f32: count, Σp(3), Σcov(6)
    d_view: torch.Tensor  # [D/2, 128] int32 — raw-sum-inlined, per-scan

    @property
    def capacity(self) -> int:
        return self.skey.shape[0]

    @property
    def delta_capacity(self) -> int:
        return self.d_skey.shape[0]

    def d_fill(self) -> torch.Tensor:
        """Live delta rows, derived from liveness (appends are contiguous)."""
        return (self.d_skey != INT32_MAX).sum()

    @property
    def count(self) -> torch.Tensor:
        return self.payload[:, 0]

    @property
    def mean(self) -> torch.Tensor:
        return self.payload[:, 1:4]

    @property
    def cov(self) -> torch.Tensor:
        return self.payload[:, 4:10]

    @property
    def packed(self) -> torch.Tensor:
        """[C] packed voxel keys, derived from skey by the inverse mixer."""
        return sm.packed_of_skey(self.skey)

    @property
    def keys(self) -> torch.Tensor:
        """[C, 3] voxel integer coords (valid where live())."""
        return sm.unpack_keys(self.packed, self.origin)

    @staticmethod
    def create(
        capacity: int,
        delta_capacity: int | None = None,
        dtype=torch.float32,
        device="cuda",
    ) -> "VoxelMap":
        dev = device_policy.resolve(device)
        d = delta_capacity if delta_capacity is not None else max(
            capacity // 16, 2048
        )
        return VoxelMap(
            origin=torch.full((3,), -512, dtype=torch.int32, device=dev),
            skey=torch.full((capacity,), INT32_MAX, dtype=torch.int32, device=dev),
            payload=torch.zeros((capacity, 10), dtype=dtype, device=dev),
            view=_empty_view(capacity, dev),
            d_skey=torch.full((d,), INT32_MAX, dtype=torch.int32, device=dev),
            d_payload=torch.zeros((d, 10), dtype=dtype, device=dev),
            d_view=_empty_view(d, dev),
        )

    def live(self) -> torch.Tensor:
        """Main-tier liveness mask (delta excluded)."""
        return self.skey != INT32_MAX

    def num_voxels(self) -> torch.Tensor:
        """Distinct voxels across both tiers (skey ascending per tier)."""
        n_main = self.live().sum()
        d_live = self.d_skey != INT32_MAX
        idx = torch.searchsorted(self.skey, self.d_skey)
        idx = torch.clamp(idx, max=self.capacity - 1)
        in_main = self.skey[idx] == self.d_skey
        return n_main + (d_live & ~in_main).sum()


def _empty_view(capacity: int, device) -> torch.Tensor:
    """All-empty view: every slot's skey word is INT32_MAX, the rest 0."""
    nb = _n_view_buckets(capacity)
    view = torch.zeros((nb, VIEW_ASSOC * VIEW_SLOT), dtype=torch.int32, device=device)
    view[:, 0::VIEW_SLOT] = INT32_MAX
    return view


def _slot_values(skey, row, payload) -> torch.Tensor:
    """[E, 16] int32 slot image: skey, row, payload (f32 bitcast), pad."""
    e = skey.shape[0]
    return torch.cat(
        [
            skey[:, None].to(torch.int32),
            row[:, None].to(torch.int32),
            payload.contiguous().view(torch.int32),
            torch.zeros((e, VIEW_SLOT - _SLOT_PAY), dtype=torch.int32, device=skey.device),
        ],
        dim=1,
    )


def _scatter_rows(table: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor, ok):
    """table with rows `idx` set to `vals` where `ok`; other rows, and rows
    whose index is out of range, are routed to a dump row past the end and
    dropped (JAX `mode="drop"`).  A branch that is computed but not taken
    (`utils.graphs.select_branches`) may hold such indices."""
    n = table.shape[0]
    ext = torch.cat([table, table[:1]])
    idx = idx.to(torch.int64)
    ext[torch.where(ok & (idx >= 0) & (idx < n), idx, n)] = vals
    return ext[:n]


def _scatter_slots(view, b, slot, vals, ok):
    """Write [E, 16] slot images at (bucket b, slot) as one flat row
    scatter; rows with ok=False are dropped."""
    nb = view.shape[0]
    flat = b.to(torch.int64) * VIEW_ASSOC + slot
    out = _scatter_rows(view.reshape(nb * VIEW_ASSOC, VIEW_SLOT), flat, vals, ok)
    return out.reshape(nb, VIEW_ASSOC * VIEW_SLOT)


def _segment_start(head: torch.Tensor) -> torch.Tensor:
    """Row index of the first row of each row's segment (a running max)."""
    pos = torch.arange(head.shape[0], dtype=torch.int64, device=head.device)
    return torch.cummax(torch.where(head, pos, 0), 0).values


def _build_view(skey_sorted: torch.Tensor, payload_sorted: torch.Tensor):
    """Payload-inlined set-associative view of an ascending skey array.
    Entries past VIEW_ASSOC per bucket are dropped from the view only —
    returns (view, n_dropped)."""
    c = skey_sorted.shape[0]
    dev = skey_sorted.device
    nb = _n_view_buckets(c)
    bo = sm.bucket_of(skey_sorted, nb)
    live = skey_sorted != INT32_MAX
    pos = torch.arange(c, dtype=torch.int64, device=dev)
    head = torch.ones(c, dtype=torch.bool, device=dev)
    head[1:] = bo[1:] != bo[:-1]
    rank = pos - _segment_start(head)
    ok = live & (rank < VIEW_ASSOC)
    dropped = (live & ~ok).sum()
    view = _scatter_slots(
        _empty_view(c, dev), bo, rank,
        _slot_values(skey_sorted, pos, payload_sorted), ok,
    )
    return view, dropped


def _probe_rows(view: torch.Tensor, q_skey: torch.Tensor):
    """Gather each query's bucket row; returns (slots [N, 8, 16], bucket)."""
    nb = view.shape[0]
    b = sm.bucket_of(q_skey, nb)
    rows = view[b.to(torch.int64)]  # [N, 128] — one 512-byte row gather
    return rows.view(q_skey.shape[0], VIEW_ASSOC, VIEW_SLOT), b


def _hit_slot(slots: torch.Tensor, q_skey: torch.Tensor):
    """(eq [N, 8], lane [N], hit slot image [N, 16]) of each query."""
    eq = slots[:, :, 0] == q_skey[:, None]
    lane = torch.argmax(eq.to(torch.int32), dim=1)  # first match, else 0
    idx = lane[:, None, None].expand(-1, 1, VIEW_SLOT)
    return eq, lane, torch.gather(slots, 1, idx)[:, 0, :]


def _view_probe(view: torch.Tensor, q_skey: torch.Tensor):
    """ONE row-gather lookup: returns (payload [N,10] f32, row_idx [N],
    lane [N], found [N]) per query skey."""
    slots, _ = _probe_rows(view, q_skey)
    eq, lane, hitslot = _hit_slot(slots, q_skey)
    found = eq.any(dim=1) & (q_skey != INT32_MAX)
    payload = hitslot[:, 2:_SLOT_PAY].contiguous().view(torch.float32)
    return payload, hitslot[:, 1], lane, found


def _view_find(view: torch.Tensor, q_skey: torch.Tensor):
    """Compatibility probe: returns (row_idx, found) per query skey."""
    _, idx, _, found = _view_probe(view, q_skey)
    return idx, found


def _combine(c_main, mean_main, cov_main, c_add, psum, csum, cap):
    """Running-mean update of (count, mean, cov) with `c_add` raw-sum points,
    capped at `cap` (ref `Voxel::addPoint`, `LocalMap.hpp:79-87`)."""
    cap_add = torch.minimum(torch.clamp(cap - c_main, min=0.0), c_add)
    scale = torch.where(c_add > 0, cap_add / torch.clamp(c_add, min=1.0), 0.0)
    denom = torch.clamp(c_main + cap_add, min=1.0)
    mean = (c_main[..., None] * mean_main + scale[..., None] * psum) / denom[..., None]
    cov = (c_main[..., None] * cov_main + scale[..., None] * csum) / denom[..., None]
    return c_main + cap_add, mean, cov


def _combine_rows(stats, add_raw, cap):
    """`_combine` over [*, 10] rows: stats (count, mean, cov) + raw sums."""
    cnt, mean, cov = _combine(
        stats[..., 0], stats[..., 1:4], stats[..., 4:10],
        add_raw[..., 0], add_raw[..., 1:4], add_raw[..., 4:10], cap,
    )
    return torch.cat([cnt[..., None], mean, cov], dim=-1)


# ---------------------------------------------------------------------------
# lookup
# ---------------------------------------------------------------------------


def lookup(vmap: VoxelMap, points: torch.Tensor, *, voxel_size: float,
           max_points_per_voxel: int = 1000):
    """Per-point single-voxel correspondence lookup (ref
    `correspondenceMatching`, `LocalMap.cpp:78-109`).  Returns (mean [N,3],
    cov_packed [N,6], hit [N] bool), combining the main entry with any
    pending delta sums for the same voxel."""
    keys = vx.voxel_key(points, voxel_size)
    packed, in_range = sm.pack_keys(keys, vmap.origin)
    return lookup_packed(
        vmap, packed, in_range, max_points_per_voxel=max_points_per_voxel
    )


def lookup_packed(vmap: VoxelMap, packed: torch.Tensor, in_range: torch.Tensor,
                  *, max_points_per_voxel: int = 1000):
    """lookup() given precomputed packed keys: two gathers, one per tier."""
    skey = sm.skey_of(packed)
    pay_m_raw, _, _, m_hit = _view_probe(vmap.view, skey)
    m_hit = m_hit & in_range
    pay_d_raw, _, _, d_hit = _view_probe(vmap.d_view, skey)
    d_hit = d_hit & in_range
    pay_m = torch.where(m_hit[:, None], pay_m_raw, 0.0)
    pay_d = torch.where(d_hit[:, None], pay_d_raw, 0.0)
    _, mean, cov = _combine(
        pay_m[:, 0], pay_m[:, 1:4], pay_m[:, 4:10],
        pay_d[:, 0], pay_d[:, 1:4], pay_d[:, 4:10], float(max_points_per_voxel),
    )
    return mean, cov, m_hit | d_hit


# ---------------------------------------------------------------------------
# fold (LSM flush: delta [+ batch] -> main)
# ---------------------------------------------------------------------------


def _fold_into_main(vmap: VoxelMap, ex_skey, ex_payload, cap, with_view=True):
    """Merge the main tier with extra raw-sum rows [L] (unique keys).  One
    combined sort; equal-key pairs are adjacent and combine under the point
    cap; a second sort compacts survivors to an ascending [C] prefix.
    Returns (skey [C], payload [C,10], view | None, overflow)."""
    c_cap = vmap.capacity
    dev = vmap.skey.device
    p, perm, pay = sm.sort_perm(
        torch.cat([vmap.skey, ex_skey]),
        torch.cat([vmap.payload, ex_payload]),
    )
    old = perm < c_cap
    n = p.shape[0]

    prev_same = torch.zeros(n, dtype=torch.bool, device=dev)
    prev_same[1:] = p[1:] == p[:-1]
    prev_old = torch.zeros(n, dtype=torch.bool, device=dev)
    prev_old[1:] = old[:-1]
    pay_prev = torch.cat([torch.zeros_like(pay[:1]), pay[:-1]])

    is_new = ~old & (p != INT32_MAX)
    merged = is_new & prev_same & prev_old

    stats_prev = torch.where(merged[:, None], pay_prev, 0.0)
    combined = _combine_rows(stats_prev, pay, cap)

    next_absorbs = torch.zeros(n, dtype=torch.bool, device=dev)
    next_absorbs[:-1] = merged[1:]
    dead = old & next_absorbs
    keep_row = (p != INT32_MAX) & ~dead
    row_skey = torch.where(keep_row, p, INT32_MAX)
    row_payload = torch.where(is_new[:, None], combined, pay)

    f_skey, _, f_payload = sm.sort_perm(row_skey, row_payload)
    f_skey, f_payload = f_skey[:c_cap], f_payload[:c_cap]
    kept = f_skey != INT32_MAX
    n_live = (row_skey != INT32_MAX).sum()
    overflow = torch.clamp(n_live - kept.sum(), min=0)
    f_view = _build_view(f_skey, f_payload)[0] if with_view else None
    return f_skey, f_payload, f_view, overflow


def _empty_delta(vmap: VoxelMap):
    d_cap = vmap.delta_capacity
    dev = vmap.skey.device
    return (
        torch.full((d_cap,), INT32_MAX, dtype=torch.int32, device=dev),
        torch.zeros((d_cap, 10), dtype=vmap.payload.dtype, device=dev),
        _empty_view(d_cap, dev),
    )


# ---------------------------------------------------------------------------
# insert
# ---------------------------------------------------------------------------


def insert(vmap: VoxelMap, points: torch.Tensor, covs_packed: torch.Tensor,
           valid: torch.Tensor, *, voxel_size: float, max_points_per_voxel: int):
    """Insert a batch of world-frame points + packed covariances (replaces
    the reference's per-point loop, `LocalMap.cpp:47-58`).

    1. One stable sort groups the batch; per-voxel raw sums by segment sum,
       compacted to unique ascending entries.
    2. One d_view probe resolves every unique voxel against the delta tier:
       hits merge capped raw sums into their rows, misses append.
    3. If the appends would overflow the delta, delta + the batch's new
       voxels fold into MAIN (`device_if` on one device bool).

    Returns (new_map, num_dropped).  Eagerly the result is new tensors (the
    main tier shared with `vmap` when nothing folds); inside a graph capture
    the result is `vmap`'s own buffers, written in place."""
    dtype = points.dtype
    dev = points.device
    n = points.shape[0]
    d_cap = vmap.delta_capacity
    cap = float(max_points_per_voxel)

    keys = vx.voxel_key(points, voxel_size)
    packed, in_range = sm.pack_keys(keys, vmap.origin)
    ok = valid & in_range
    dropped_range = (valid & ~in_range).sum()
    skey = sm.skey_of(torch.where(ok, packed, INT32_MAX))

    okf = ok.to(dtype)[:, None]
    raw = torch.cat([okf, points * okf, covs_packed * okf], dim=1)  # [N, 10]

    # 1. group by voxel
    skey_s, _, raw_s = sm.sort_perm(skey, raw)
    ok_s = skey_s != INT32_MAX
    head, seg_id = sm.unique_segments(skey_s, ok_s)
    # segment totals arrive on head rows only (other rows are unspecified):
    # compact exactly those to the unique rows, as the keys below
    u_pay = _scatter_rows(
        torch.zeros_like(raw_s), seg_id, plain.segsum_sorted(skey_s, raw_s), head
    )  # [N, 10]
    u_skey = _scatter_rows(
        torch.full((n,), INT32_MAX, dtype=torch.int32, device=dev),
        seg_id, skey_s, head,
    )
    u_live = u_skey != INT32_MAX

    # 2. ONE probe of the delta view resolves every unique voxel
    slots, b = _probe_rows(vmap.d_view, u_skey)
    eq, lane, hitslot = _hit_slot(slots, u_skey)
    found = eq.any(dim=1) & u_live
    drow = hitslot[:, 1].to(torch.int64)
    old_sum = hitslot[:, 2:_SLOT_PAY].contiguous().view(torch.float32)
    first_free = (slots[:, :, 0] != INT32_MAX).sum(dim=1)

    # capped raw-sum merge (first-come across batches within the delta epoch)
    old_cnt = torch.where(found, old_sum[:, 0], 0.0)
    u_cnt = u_pay[:, 0]
    cap_add = torch.minimum(torch.clamp(cap - old_cnt, min=0.0), u_cnt)
    scale = torch.where(u_cnt > 0, cap_add / torch.clamp(u_cnt, min=1.0), 0.0)
    u_capped = u_pay * scale[:, None]
    new_sum = torch.where(found[:, None], old_sum + u_capped, u_capped)

    d_payload = _scatter_rows(vmap.d_payload, drow, new_sum, found)

    miss = u_live & ~found
    n_miss = miss.sum()
    d_fill = vmap.d_fill()
    would_overflow = d_fill + n_miss > d_cap

    def fold():
        ex_skey = torch.where(miss, u_skey, INT32_MAX)
        ex_pay = torch.where(miss[:, None], u_capped, 0.0)
        m_skey, m_payload, m_view, overflow = _fold_into_main(
            vmap,
            torch.cat([vmap.d_skey, ex_skey]),
            torch.cat([d_payload, ex_pay]),
            cap,
        )
        return (m_skey, m_payload, m_view, *_empty_delta(vmap), overflow)

    def append():
        # segmented rank of slot-claiming misses within their (contiguous)
        # bucket runs
        bhead = torch.ones(n, dtype=torch.bool, device=dev)
        bhead[1:] = b[1:] != b[:-1]
        miss_i = miss.to(torch.int64)
        incl = torch.cumsum(miss_i, 0)
        base = (incl - miss_i)[_segment_start(bhead)]
        rank = incl - 1 - base  # rank among misses of the same bucket
        slot = first_free + rank
        acc = miss & (slot < VIEW_ASSOC)
        new_drow = d_fill + torch.cumsum(acc.to(torch.int64), 0) - 1
        overflow = (miss & ~acc).sum()

        o_dskey = _scatter_rows(vmap.d_skey, new_drow, u_skey, acc)
        o_dpay = _scatter_rows(d_payload, new_drow, u_capped, acc)
        # ONE slot scatter into the SMALL d_view: refresh hit sums and
        # claim miss slots
        o_dview = _scatter_slots(
            vmap.d_view,
            b,
            torch.where(found, lane, slot),
            _slot_values(u_skey, torch.where(found, drow, new_drow), new_sum),
            found | acc,
        )
        # the main tier passes through: under capture it is not copied
        return (vmap.skey, vmap.payload, vmap.view, o_dskey, o_dpay, o_dview, overflow)

    # under capture both branches write the map's own buffers
    outs = (*vmap[1:], torch.zeros((), dtype=torch.int64, device=dev))
    m_skey, m_payload, m_view, o_dskey, o_dpay, o_dview, overflow = device_if(
        would_overflow, fold, outs, otherwise=append
    )
    new_map = VoxelMap(
        origin=vmap.origin,
        skey=m_skey, payload=m_payload, view=m_view,
        d_skey=o_dskey, d_payload=o_dpay, d_view=o_dview,
    )
    return new_map, dropped_range + overflow


# ---------------------------------------------------------------------------
# compaction / eviction
# ---------------------------------------------------------------------------


def compact(vmap: VoxelMap, *, max_points_per_voxel: int):
    """Force the LSM flush (delta -> main)."""
    m_skey, m_payload, m_view, overflow = _fold_into_main(
        vmap, vmap.d_skey, vmap.d_payload, float(max_points_per_voxel)
    )
    d_skey, d_payload, d_view = _empty_delta(vmap)
    return (
        VoxelMap(
            origin=vmap.origin,
            skey=m_skey, payload=m_payload, view=m_view,
            d_skey=d_skey, d_payload=d_payload, d_view=d_view,
        ),
        overflow,
    )


def evict_beyond(vmap: VoxelMap, center: torch.Tensor, *, voxel_size: float,
                 distance_threshold: float, max_points_per_voxel: int = 1000):
    """Drop voxels farther than `distance_threshold` from `center` (ref
    `needsPointRemoval`, `LocalMap.cpp:149-154`), folding the delta in and
    re-centring the packing origin on `center` — all in ONE fold.  Returns
    (new_map, num_removed) with removed rows counted across both tiers."""
    dtype = vmap.payload.dtype
    new_origin = vx.voxel_key(center, voxel_size) - 512

    def rekey(skey: torch.Tensor):
        live = skey != INT32_MAX
        keys = sm.unpack_keys(sm.packed_of_skey(skey), vmap.origin)
        centers = (keys.to(dtype) + 0.5) * voxel_size
        dist = torch.linalg.norm(centers - center, dim=-1)
        survive = live & (dist <= distance_threshold)
        # INT32_MAX-1 is the skey_of sentinel-collision remap: exempt it from
        # the geometric test (its recovered coordinates are wrong)
        survive = survive | (skey == INT32_MAX - 1)
        repacked, in_range = sm.pack_keys(keys, new_origin)
        keep = survive & in_range
        n_removed = (live & ~keep).sum()
        return sm.skey_of(torch.where(keep, repacked, INT32_MAX)), n_removed

    m_skey2, m_removed = rekey(vmap.skey)
    d_skey2, d_removed = rekey(vmap.d_skey)
    f_skey, f_payload, f_view, _ = _fold_into_main(
        vmap._replace(skey=m_skey2), d_skey2, vmap.d_payload,
        float(max_points_per_voxel),
    )
    d_skey, d_payload, d_view = _empty_delta(vmap)
    return (
        VoxelMap(
            origin=new_origin,
            skey=f_skey, payload=f_payload, view=f_view,
            d_skey=d_skey, d_payload=d_payload, d_view=d_view,
        ),
        m_removed + d_removed,
    )
