"""`check.py` for a cell whose reference map is the coordinate map
(`reference/coordmap.py`, `reference/coordstep.py`): runs the plain
reference over the blocks of rows that a run sampled and holds the
program's outputs against it (`compare.py`), its map read voxel by voxel
by coordinate.

A block that starts inside the window starts the reference from the
program's state and map, the map read by coordinate from its packed keys
under the configuration's key split; the start block starts it from the
initial state and an empty map.  After the block the program's map is
read the same way and the two compare by coordinate: a point the program
dropped because its voxel lay outside its key span is a voxel, or a count,
that only the reference holds.
"""

from __future__ import annotations

import torch

from benchmark import check, compare
from benchmark.reference import config as ref_config
from benchmark.reference import coordmap as cm
from benchmark.reference import coordstep, pack


# the port's own map setting, which the coordinate map has no use for: it
# has no key span
MAP_LAYOUT = ("map_key_bits",)


def reference_config(fields: dict) -> ref_config.Config:
    """The reference's Config from a configuration file's `config`, less
    the port's own map layout (`MAP_LAYOUT`)."""
    return check.reference_config({k: v for k, v in fields.items() if k not in MAP_LAYOUT})


def _copy(carry) -> tuple:
    state, cmap, R, t = carry
    return (type(state)(*(f.clone() for f in state)), cm.CoordMap(*(f.clone() for f in cmap)),
            R.clone(), t.clone())


def run_reference(block: check.Block, stream, config, key_bits, device, tf32: bool = False,
                  follow: list[int] | None = None) -> dict:
    """`check.run_reference` over the coordinate map (its docstring)."""
    with check.matmul_precision(tf32), torch.no_grad():
        if block.before is None:
            carry = coordstep.init_carry(config, pack.init_scan(stream, config, device), device)
        else:
            state, vmap, R, t = block.before
            carry = _copy((state, cm.from_packed(vmap, key_bits, config.max_points_per_voxel), R, t))
        ref_step = coordstep.make_step(config, device)
        poses, iters, forced_rows, removed = [], [], 0, []
        for j, (k, evict) in enumerate(zip(block.ks, block.evicts)):
            chunk, scan = pack.row(stream, k, config, device, shifted=False)
            before = _copy(carry) if follow is not None else None
            out, diag = ref_step(carry, (chunk, scan, evict))
            iters.append(int(diag["icp_iterations"]))
            if follow is not None and abs(int(follow[j]) - iters[-1]) == 1:
                out, diag = coordstep.make_step(check.forced(config, int(follow[j])), device)(
                    before, (chunk, scan, evict))
                forced_rows += 1
            carry = out
            removed.append(int(diag["removed_voxels"]))
            poses.append((carry[2], carry[3]))
    return {"poses": poses, "state": carry[0], "map": cm.tiers(carry[1]), "iterations": iters,
            "forced_rows": forced_rows, "removed": removed}


def program_side(block: check.Block, key_bits, max_points_per_voxel: int) -> dict:
    side = check.program_side(block)
    side["map"] = cm.tiers(cm.from_packed(side["map"], key_bits, max_points_per_voxel))
    return side


def readings(blocks: list[check.Block], stream, config, key_bits, device) -> dict:
    """The largest gap of each kind between program and reference over the
    blocks, `gn_forced_rows`, and `reference_removed`, the voxels each of
    the reference's evicting rows removed."""
    refs = [run_reference(b, stream, config, key_bits, device, follow=b.iterations) for b in blocks]
    out = compare.worst([compare.gaps(program_side(b, key_bits, config.max_points_per_voxel), r)
                         for b, r in zip(blocks, refs)])
    out["gn_forced_rows"] = sum(r["forced_rows"] for r in refs)
    out["reference_removed"] = [n for b, r in zip(blocks, refs)
                                for n, e in zip(r["removed"], b.evicts) if e]
    return out


def control_readings(blocks: list[check.Block], stream, config, key_bits, device) -> dict:
    """The same gaps with the reference in TF32 put in the program's place,
    judged as the program is (the control, which the limits must fail)."""
    out, forced_rows = [], 0
    for b in blocks:
        low = run_reference(b, stream, config, key_bits, device, tf32=True)
        exact = run_reference(b, stream, config, key_bits, device, follow=low["iterations"])
        out.append(compare.gaps(low, exact))
        forced_rows += exact["forced_rows"]
    out = compare.worst(out)
    out["gn_forced_rows"] = forced_rows
    return out

