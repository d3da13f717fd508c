"""The numbers that decide `correct`: gaps between what the program
produced and what the plain reference works out from the same inputs.

Each gap compares one part of the filter after a block of rows:

* `pose_gap_m`, `rot_gap_rad`: the largest distance between the program's
  and the reference's pose over the block's rows (`models.registration`
  and the pose update of `models.eskf`);
* `vel_gap_mps`: the velocity after the block (`models.eskf` predict);
* `cov_gap`: the 18x18 error covariance after the block, as the Frobenius
  norm of the difference over the reference's norm (`models.eskf`);
* `map_count_gap`: the voxels that only one side holds or whose point
  count differs, over the reference's live voxels, both tiers of the map
  (`map.voxel_map` insert and evict: a point that lands in another voxel);
* `map_mean_gap_m`: over the voxels both hold with equal counts, the RMS
  distance between their mean points (`ops.preprocess`'s downsampled
  points, inserted at the pose);
* `map_cov_gap`: over the same voxels, the covariances (or their sums)
  as the Frobenius norm of the difference over the reference's norm
  (`ops.preprocess`'s regularised covariances);
* `map_cov_gap_median`: the median over the same voxels of each voxel's
  covariance gap (the norm of its difference over the norm of the
  reference's).  A sparse sweep leaves a few voxels of a few points whose
  covariance is nearly isotropic; their eigenvectors, and so their
  regularised covariance, turn on the last bits of the sums, and they
  alone set `map_cov_gap` there (`map_cov_voxels_over_1pct` counts them,
  deciding nothing).

`gn_iteration_gap` (the largest difference in GN iterations a row, as each
side ran on its own) is printed beside them and decides nothing: a row
whose last increment lies at the convergence threshold takes one iteration
more on one side, and the reference runs such a row again to the judged
side's count (`check.run_reference`), so that the gaps compare two poses
after the same iterations.
"""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    d = torch.linalg.norm((a - b).double())
    n = torch.linalg.norm(b.double())
    return float(d / n) if float(n) > 0 else float(d)


def _tier(keys_p, pay_p, keys_r, pay_r, sums: bool) -> dict:
    """Sums over one map tier: voxels changed (held by one side only or
    with another count), the reference's live voxels, and over the common
    voxels of equal count the squared mean distances and the squared
    norms of the covariance difference and of the reference's covariance.
    A payload row is count, mean (main) or point sum (delta), covariance
    or its sum."""
    live_p, live_r = keys_p != INT32_MAX, keys_r != INT32_MAX
    kp, op = torch.sort(keys_p[live_p])
    kr, orr = torch.sort(keys_r[live_r])
    pp, pr = pay_p[live_p][op].double(), pay_r[live_r][orr].double()
    in_r, in_p = torch.isin(kp, kr), torch.isin(kr, kp)
    a, b = pp[in_r], pr[in_p]  # the common voxels, in the same key order
    same = a[:, 0] == b[:, 0]
    a, b = a[same], b[same]
    mean_a, mean_b = a[:, 1:4], b[:, 1:4]
    if sums:
        count = b[:, :1].clamp(min=1.0)
        mean_a, mean_b = mean_a / count, mean_b / count
    return {
        "changed": int((~in_r).sum()) + int((~in_p).sum()) + int((~same).sum()),
        "live": int(live_r.sum()),
        "common": int(same.sum()),
        "mean_sq": float(((mean_a - mean_b) ** 2).sum()),
        "cov_diff_sq": float(((a[:, 4:] - b[:, 4:]) ** 2).sum()),
        "cov_ref_sq": float((b[:, 4:] ** 2).sum()),
        "cov_rel": torch.linalg.norm(a[:, 4:] - b[:, 4:], dim=1)
        / torch.linalg.norm(b[:, 4:], dim=1).clamp(min=1e-30),
    }


def map_gaps(prog_map, ref_map) -> dict:
    """`map_count_gap`, `map_mean_gap_m` and `map_cov_gap` of two maps with
    the port's layout (`skey`, `payload` of the main tier; `d_skey`,
    `d_payload` of the delta tier)."""
    t = [_tier(prog_map.skey, prog_map.payload, ref_map.skey, ref_map.payload, sums=False),
         _tier(prog_map.d_skey, prog_map.d_payload, ref_map.d_skey, ref_map.d_payload, sums=True)]
    total = {k: sum(x[k] for x in t) for k in t[0] if k != "cov_rel"}
    cov_rel = torch.cat([x["cov_rel"] for x in t])
    return {
        "map_count_gap": total["changed"] / max(total["live"], 1),
        "map_mean_gap_m": (total["mean_sq"] / max(total["common"], 1)) ** 0.5,
        "map_cov_gap": (total["cov_diff_sq"] / total["cov_ref_sq"]) ** 0.5
        if total["cov_ref_sq"] > 0 else total["cov_diff_sq"] ** 0.5,
        "map_cov_gap_median": float(cov_rel.median()) if len(cov_rel) else 0.0,
        "map_cov_voxels_over_1pct": int((cov_rel > 1e-2).sum()),
    }


def gaps(prog: dict, ref: dict) -> dict:
    """The gaps of one block.  Each side is a dict with `poses` (a list of
    (R [3,3], t [3]) per row), `state` (a FilterState), `map` (a VoxelMap)
    and `iterations` (GN iterations per row)."""
    pose = max(float(torch.linalg.norm((tp.double() - tr.double())))
               for (_, tp), (_, tr) in zip(prog["poses"], ref["poses"]))
    # |Rp - Rr|_F / sqrt(2): the angle between them where it is small, and
    # free of arccos's loss of precision near 1
    rot = max(float(torch.linalg.norm(Rp.double() - Rr.double())) / 2**0.5
              for (Rp, _), (Rr, _) in zip(prog["poses"], ref["poses"]))
    out = {
        "pose_gap_m": pose,
        "rot_gap_rad": rot,
        "vel_gap_mps": float(torch.linalg.norm(prog["state"].v.double() - ref["state"].v.double())),
        "cov_gap": _rel(prog["state"].P, ref["state"].P),
        **map_gaps(prog["map"], ref["map"]),
        "gn_iteration_gap": max((abs(int(a) - int(b)) for a, b in
                                 zip(prog["iterations"], ref["iterations"])), default=0),
    }
    if not all(torch.isfinite(t).all() for t in (*prog["state"], *(p for pr in prog["poses"] for p in pr))):
        out = {k: float("inf") for k in out}
    return out


def worst(blocks: list[dict]) -> dict:
    """The largest of each gap over the blocks."""
    return {k: max(b[k] for b in blocks) for k in blocks[0]} if blocks else {}


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the gaps that have a
    limit; a gap that is not finite fails."""
    checks = {k: {"value": readings[k], "limit": lim} for k, lim in limits.items()}
    ok = all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
