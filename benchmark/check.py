"""Runs the plain reference over the blocks of rows that a run sampled and
holds the program's outputs against it (`compare.py`).

A block is a few consecutive update rows.  The start block runs the
reference from the initial state and an empty map through the first sweep
and the rows after it; every other block starts from the program's own
state and map, cloned before the block's first row inside the window, and
ends where the program's clone after its last row was taken: the
reference cannot follow a window of thousands of rows eagerly, so it
follows the program row by row from sampled points of it.  The reference
takes from the program only that state; its inputs it packs itself from
the generated records (`reference/pack.py`).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from benchmark import compare
from benchmark.reference import config as ref_config
from benchmark.reference import pack, step
from benchmark.reference import types as ref_types
from benchmark.reference import voxel_map as ref_vm

BLOCK_ROWS = 3  # consecutive update rows in a checked block


@dataclasses.dataclass
class Block:
    """Rows `ks` (stream sweep indices) and what the program made of them:
    `before` the carry (state, map, R, t) before the first row (None: the
    start block), `after` the carry after the last, the poses and GN
    iterations of each row, and the eviction flag of each row."""

    ks: list[int]
    evicts: list[bool]
    before: tuple | None = None
    after: tuple | None = None
    poses: list = dataclasses.field(default_factory=list)
    iterations: list = dataclasses.field(default_factory=list)


def reference_config(fields: dict) -> ref_config.Config:
    """The reference's Config from a configuration file's `config`."""
    fields = dict(fields)
    imu = ref_config.ImuConfig(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in fields.pop("imu").items()})
    return ref_config.Config(imu=imu, **{k: tuple(v) if isinstance(v, list) else v
                                         for k, v in fields.items()})


def clone_carry(carry) -> tuple:
    """A copy of a program carry (state, map, R, t) as the reference's
    types (the same fields, in the same order)."""
    state, voxmap, R, t = carry
    return (ref_types.FilterState(*(x.clone() for x in state)),
            ref_vm.VoxelMap(*(x.clone() for x in voxmap)), R.clone(), t.clone())


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 matrix products in full precision, or in TF32 (the control)."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def forced(config, iterations: int):
    """The reference's config that runs exactly `iterations` GN iterations:
    its cosine test can never pass."""
    return dataclasses.replace(config, icp_max_iterations=iterations, icp_cosine_threshold=2.0)


def _copy(carry) -> tuple:
    return tuple(type(x)(*(f.clone() for f in x)) if isinstance(x, tuple) else x.clone()
                 for x in carry)


def run_reference(block: Block, stream, config, device, shifted: bool, tf32: bool = False,
                  follow: list[int] | None = None) -> dict:
    """The reference over a block: poses, state, map, its own GN iterations
    a row and the rows it ran to another count.  With `follow` (the GN
    iterations a row of the side judged), a row whose count differs from
    the judged side's by one is run again from the same carry to that count:
    a last increment at the convergence threshold passes the test on one
    side and not on the other, and the pose then differs by that increment.
    A row that differs by more is left as it ran."""
    with matmul_precision(tf32), torch.no_grad():
        if block.before is None:
            carry = step.init_carry(config, pack.init_scan(stream, config, device), device)
        else:
            carry = _copy(block.before)
        ref_step = step.make_step(config, device)
        poses, iters, forced_rows = [], [], 0
        for j, (k, evict) in enumerate(zip(block.ks, block.evicts)):
            chunk, scan = pack.row(stream, k, config, device, shifted)
            before = _copy(carry) if follow is not None else None
            out, diag = ref_step(carry, (chunk, scan, evict))
            iters.append(int(diag["icp_iterations"]))
            if follow is not None and abs(int(follow[j]) - iters[-1]) == 1:
                out, _ = step.make_step(forced(config, int(follow[j])), device)(
                    before, (chunk, scan, evict))
                forced_rows += 1
            carry = out
            poses.append((carry[2], carry[3]))
    return {"poses": poses, "state": carry[0], "map": carry[1], "iterations": iters,
            "forced_rows": forced_rows}


def program_side(block: Block) -> dict:
    return {"poses": block.poses, "state": block.after[0], "map": block.after[1],
            "iterations": block.iterations}


def readings(blocks: list[Block], stream, config, device, shifted: bool) -> dict:
    """The largest gap of each kind between program and reference over the
    blocks, and `gn_forced_rows`, the rows the reference ran to the
    program's GN count."""
    refs = [run_reference(b, stream, config, device, shifted, follow=b.iterations) for b in blocks]
    out = compare.worst([compare.gaps(program_side(b), r) for b, r in zip(blocks, refs)])
    out["gn_forced_rows"] = sum(r["forced_rows"] for r in refs)
    return out


def control_readings(blocks: list[Block], stream, config, device, shifted: bool) -> dict:
    """The same gaps with the reference in TF32 put in the program's place
    (the control, which the limits must fail), judged as the program is."""
    out, forced_rows = [], 0
    for b in blocks:
        low = run_reference(b, stream, config, device, shifted, tf32=True)
        exact = run_reference(b, stream, config, device, shifted, follow=low["iterations"])
        out.append(compare.gaps(low, exact))
        forced_rows += exact["forced_rows"]
    out = compare.worst(out)
    out["gn_forced_rows"] = forced_rows
    return out
