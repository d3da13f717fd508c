#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

1. Device: prints the card's name and power limit (nvidia-smi) and builds
   the CUDA sources of `eskf_lio_torch/csrc/`, one nvcc per source, all
   started together.
2. Kernels: runs each kernel and its plain PyTorch version on the card at
   the main path's shapes (kernel A, the GN normal equations, at N = 16,384
   align points; kernel B, the segmented head-row sums, at N = 131,072 raw
   points x W = 10 moments of a real scan) and on edge cases (ragged and
   grid-stride N for A; one segment, all-unique keys, runs that straddle
   many tiles, W = 1 / 10 / 16 and a ragged last tile for B), checks the
   agreement against a stated tolerance and that the same bits come out
   twice, and times the kernel (device time by kernel name from
   torch.profiler, which must show ONE launch per call), its wrapper call,
   its plain version and, for B, the one PyTorch call computing the same
   function.  Beside kernel A's time it prints the duration of an empty
   <<<1,32>>> kernel, the least any launch takes; and it times kernel B
   against `index_add_` at the shape of `voxel_map.insert`'s per-voxel sums.
   `light_shapes`: both kernels at the bench's LIGHT shapes against their
   plain versions (B over a real LIGHT scan's moments at [24,576, 10] and its
   insert rows at [12,288, 10], also against `index_add_`; A at N = 12,288),
   with device times and bounds.
   `tool_shapes`: both kernels at the shapes only the tools give them (A at
   `probe_align_parts`'s N = 32,768; B over a real scan's insert rows under
   `ate_matrix`'s `budget48k` budget at [49,152, 10], also against
   `index_add_`, and over `profile_preprocess`'s input at [131,072, 10],
   nearly every key its own segment, also against `torch.segment_reduce`),
   with device times, call times and bounds.
   `preprocess_shapes`: the preprocessor's six kernels (`csrc/preprocess.cu`)
   against the plain version (`preprocess_ref`) at every shape a later
   phase gives them: mid360's and LIGHT's (24,576 raw points into 12,288)
   and HEAVY's (131,072 into 32,768), timed, `ate_matrix`'s budget48k
   (131,072 into 49,152), and the init step's path (no deskew) over a real
   HEAVY scan: the same mask and points bit for bit, covariances within 4
   ulps of 1, six launches counted a call; at the timed shapes each kernel
   once a call, its device time, its bytes' bound and its share, the sorts'
   and kernel B's time, the whole call's device and call time against the
   plain version's.
   `gn_pass_shapes`: the GN pass's lookup and increment kernels
   (`csrc/gn_pass.cu`) at mid360's (12,288 align rows, key split (10, 10,
   10)) and urban's (24,576, (11, 11, 9)) shapes over a 2^19-row map holding
   a room in both tiers: the lookup against `voxel_map.lookup` and the
   increment against its plain version, bit for bit, one launch a call;
   each timed in a captured graph beside an empty kernel there, with its
   bytes' bound, its wrapper call and its plain version; the lookup also
   with L2 emptied before each call, the time its bound (the distinct
   sectors it reads, at the HBM rate) is held against.  Every path below
   counts their launches (one `gn_pass.KERNEL`): L + 1 a GN pass (a lookup
   per local shard and one increment; twice unsharded), kernel A L times.
   `predict_shapes`: the IMU prefix's kernel (`csrc/imu_prefix.cu`) at
   mid360's M = 64 and urban's M = 32 on chunks recorded from both cells
   (`tests/data/imu_prefix_chunks.npz`) against `eskf.imu_prefix_ref`, bit
   for bit, one launch a call; timed in a captured graph (L2-warm) beside
   the plain chain there and an empty kernel.  Every path below counts its
   launches: one a `predict_chunk_prefix` call (a row of the replay, an
   update scan or an overflow pre-advance of the live and sharded drivers,
   a timed row of the bench's series).
   `kernel_bounds`: `python -m eskf_lio_torch.utils.kernel_bounds` in a
   process of its own, kernel B's values, kernel A's rows and mask and
   every input of the preprocessor's and the GN pass's kernels in host
   memory registered for
   the card up to their last byte, where a load past the end is an illegal
   address (kernel B's was, at N a multiple of the tile rows, before the
   halo fix).
3. The captured step.  `control_flow`: the conditional graph nodes
   (`csrc/graph_cond.cu` through `utils/graphs.py`: an if/else around a
   sort, a WHILE loop holding an IF) against Python control flow on the same
   inputs, replay after replay; exact equality.
   End to end: drives the port's replay (`pack_sequence`, `make_init_step`,
   `make_replay_step`, on the card the captured step) at the HEAVY size of
   `bench.py` (131,072 raw points, 32,768 scan points, 16,384 align points, a
   2^19-row voxel map) on the bench's synthetic sequence cut to 40 scans,
   with the launch counters set to 0 just before and read just after (the
   launches inside a graph are counted on the device); checks finite poses,
   convergence, ATE against ground truth, that the kernels were launched
   exactly as often as the path needs (kernel A once a GN iteration, kernel
   B twice and the preprocessor's kernels six times a scan), and that the warm half's rows waited
   for the device 0 times (torch's sync debug mode, by calling line).
   `profile`: the eager step (`make_step_core`) over the same rows, its last
   five under torch.profiler (busy time, launches).  `graph`: the eager
   step and a second graph run beside the first: scans/s of both, device
   time a scan of the graph path between CUDA events, capture seconds,
   node count and peak memory; then a third graph run built with the port's
   tracer (`utils/profiling.py::Tracer`): its graphs hold exactly their
   stamp nodes more than the second run's, and its stamps time the step's
   stages on every row (`traced`: each stage's mean, the GN stamps a row,
   the first to last stamp against the row's device span); all four runs
   equal bit for bit.
4. Live path: at the same size and on the same 40 scans, with
   `remove_period` cut to 2.0 s and `remove_distance_threshold` to 15 m so
   that an eviction fires inside the step (the synthetic room is 20 m wide:
   nothing lies beyond the default 100 m),
   `stream`: the scan-at-a-time `Odometry.run` and the threaded
   `StreamingRunner.run(merged_stream(seq))` (both on the captured step),
   launch counters zeroed before and read after each; both must track ground
   truth, must have fed the step bitwise-equal inputs, and the synchronous
   driver run twice, and once with `make_step_core` run eagerly in place of
   the captured step, must give the same bits (trajectory and every word of
   the map; these runs stop after 24 scans, past the eviction).  Prints
   scans/s, host-to-device bytes and device syncs per scan (at most 2 on the
   captured step), and which ingest path ran.
   `resume`: 20 scans, `save_checkpoint`, `load_checkpoint` into a fresh
   driver, 19 more: equal bit for bit to the straight run.
   `cli`: `eskf_lio_torch.cli.main` in process on a HEAVY YAML, 2 s of the
   synthetic simulator in --stream mode, with the PCD, trajectory JSON and
   checkpoint it writes checked.
5. Sharded map and multi-process runtime (`eskf_lio_torch/parallel/`), at the
   live path's size and on its sequence:
   `sharded`: `ShardedOdometry(n_devices=4)` in this process, all four shards
   (2^17 slots each) on the card, beside the single-device run of phase 4:
   twice on its captured step (`GraphedShardedScanStep`, the default without
   a process group; the driver's `step_reason` is printed) and once with the
   eager sharded step in its place: ATE, positions within 2 cm of the
   single-device run's, no slice overflow, every live key in its owner's
   block, distinct voxels and point mass within 2 % of the single-device map,
   kernel A launched 4 x Σ GN iterations and kernel B (1 + 4) x scans in each
   run (counted on the device inside the graphs), the two graph runs and the
   eager run equal bit for bit, device syncs per scan by calling line (at
   most 2 on the captured step), scans/s of both, the graph path's device
   time a scan between CUDA events, its capture seconds, nodes and peak
   memory, and the eager step's last scan under torch.profiler
   (`sharded_profile`: launches, busy time).  (Phase 2 holds both
   kernels against their plain versions and times them at a shard's slice
   shapes, A at N = 8,192 and B at N = 16,384, W = 10: `slice_shapes`.)
   `dist`: two processes of `python -m eskf_lio_torch.cli --devices 4
   --coordinator 127.0.0.1:PORT --num-processes 2 --process-id I` (two shards
   each, both on the one card, hence `gloo`) on a HEAVY YAML and the first 20
   scans of the sequence, written to an npz file: both exit 0 under a
   timeout, process 0's trajectory is within 1e-3 m of a one-process
   `ShardedOdometry` run on the same file (and within 2 cm of the `sharded`
   run's: a file's scans end at their last point, not at the sweep's nominal
   end, which moves the pose's time stamp), the PCD has one point
   per distinct voxel of the checkpointed map, process 1 wrote nothing; the
   same run cut at scan 10, checkpointed and resumed by two fresh processes
   gives the straight run's trajectory; prints the all-reduce's time per call;
   both processes must report their scan step as eager under `gloo`.
   `staged`: the sharded driver under a `gloo` group of one process, its
   all-reduces staged through the host as in `dist`, with the device syncs
   counted: what the group adds to a scan; it must run eager, and equal the
   graphed run of `sharded` bit for bit.
   `nccl`: one process group of one process on the card (two cards are not
   available to this script), which takes `nccl`: one all-reduce of the
   43-float buffer through the sharded step's `reduce_fn`; a WHILE loop
   whose body holds an NCCL collective (`nccl_in_body`: none, the in-place
   all-reduce, an all-gather), its body's nodes by type and its values;
   then the sharded driver of `sharded` under the group, twice on its
   captured step, whose graphs now hold the step's all-reduces (the 43
   floats of every GN pass after the first inside the GN loop's WHILE
   node, the four counters at the top level), and once on the eager step: all three equal bit for bit to each
   other and to the `sharded` phase's graph run without a group, kernel A
   launched 4 x Σ GN iterations and kernel B 5 x scans (counted on the
   device), at most 2 device syncs a scan on the graph; scans/s, device ms
   a scan, capture seconds, nodes, and the nodes the collective added to
   the WHILE body (the body here less the body captured without a group).
6. `graph_stress`: `python -m eskf_lio_torch.utils.graph_stress` twice, each
   run the small config's rounds and then HEAVY's in one process.  Its
   default set (20 rounds, then 5): fresh graphed steps, single-device and
   sharded, against the eager steps bit for bit, with the graphs replayed
   out of capture order, destroyed and recaptured, collected inside another
   capture, and captured on either side of a growth of the capture scratch,
   all on one thread.  `--eager` (40 rounds, then 6): the same loop with no
   graph, two eager steps a pair, the reproducer of kernel B's read past
   the end of its values (ROADMAP.md, queue 3).
7. `bench`: `python -m eskf_lio_torch.bench` in a process of its own, as a
   user runs it, with a budget that lets its four phases finish (the LIGHT
   and HEAVY replay series on the full 13 s sequence, 64 timed scans each;
   the stage breakdown on the warm HEAVY map; the C++ reference filter):
   four JSON lines, each a superset of the one before, the last holding the
   JAX bench's keys and this card's nvidia-smi line, convergence >= 0.9,
   ATE <= 1.0 cm (LIGHT) and <= 2.5 cm (HEAVY), all seven stages timed, and
   the timed halves' launches counted on the device: kernel A once per GN
   iteration, kernel B twice per update row.
8. `tools`: each of the ten modules of `eskf_lio_torch/tools/` (the JAX
   package's `tools/*.py`) as a user runs it, `python -m
   eskf_lio_torch.tools.<name>`, in a process of its own under a timeout, at
   the JAX script's sizes (`ate_matrix` with `exact budget48k`: `base` is
   the bench's HEAVY series): exit 0, every line in its schema, every time
   finite and above 0 (a time less an empty graph's replays: 0 or more,
   its raw time above 0), the card's nvidia-smi line last; ATE <= 1.0 cm
   (`light_stages`, `ate_check --tn 1e-3 --rn 3e-4`, the bench's update
   noises) and <= 2.5 cm (`ate_matrix`), convergence >= 0.9 where a series
   reports it; `ate_check` at its own noises, where the filter loses the
   track in both packages, within 2 % of the JAX package's raw ATE on the
   same run; and for the tools that replay
   (`light_stages`, `probe_adaptive`'s warm-up, `ate_matrix`,
   `bench_scaling_mesh`) the launches counted on the device: kernel A
   D x Σ GN iterations, the GN pass's kernels (D + 1) x Σ GN iterations,
   kernel B (D + 1) x update scans (D = 1 unsharded),
   the preprocessor's kernels 6 x update scans.
9. Prints the kernels' JSON line, the nvidia-smi line, and last
   {"ok": true, "device": {...}} — only when every phase passed.

`--kernels-only` stops after phase 2 and prints no result line (a short run
while working on a kernel).

Exits non-zero with no result line when there is no GPU, when the package
is not beside this script, or when any check fails.  Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet), used for the bound column
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# kernel A's arithmetic per live correspondence (gn_normal_eq.cu: 45 + 30
# for R Σ Rᵀ, 6 + 30 for A and W, 3 + 15 for r and W·r, 27 + 18 + 9 for
# the block products, 28 sums)
GN_FLOP_PER_POINT = 211

# tolerances, each relative to the sum of absolute values of the terms
# summed (an f32 sum of n terms is exact to ~n·eps of that sum; both
# versions group their sums differently, and nvcc contracts a*b+c into
# one FMA where torch rounds twice)
GN_TOL = 1e-4
SEG_TOL = 1e-4

# end-to-end gates
MIN_CONVERGENCE = 0.9
MAX_ATE_CM = 15.0
N_SCANS = 40


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def event_ms(fn, iters: int = 50, warmup: int = 5, batches: int = 5) -> float:
    """Per-call time between CUDA events around `iters` back-to-back calls
    (includes any gap while the host prepares the next call): the median of
    `batches` such measurements, since the host's clock is shared."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(batches):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


def device_profile(fn, iters: int = 50, warmup: int = 5) -> tuple[float, dict]:
    """Per-call device time of `fn` (torch.profiler): the sum of the device
    kernels' own durations, without the host's gaps between launches, and the
    same by kernel name as {name: {"per_call": launches, "ms": time}}.  The
    tracer sometimes comes back short of a record or two (49 of 50 launches,
    on a busy host and, in some calls, every time after an earlier trace in
    the process): a kernel's time per call is its mean duration over the
    records that came, times its launches per call, which must be within
    0.05 of a whole number.  A trace without device records, or short of
    more than that, is taken again, up to eight traces in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for attempt in range(8):
        torch.cuda.synchronize()
        time.sleep(0.1 * attempt)  # let the tracer's earlier buffers drain
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name, seen = {}, []
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                us = float(
                    getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0.0)
                )
                seen.append(e.count / iters)
                per_call = round(e.count / iters)
                by_name[e.key] = {"per_call": per_call, "ms": us / 1e3 / e.count * per_call}
        total = sum(v["ms"] for v in by_name.values())
        whole = all(abs(x - round(x)) <= 0.05 and round(x) >= 1 for x in seen)
        if total > 0.0 and whole:
            return total, by_name
        print(f"  torch.profiler's trace is incomplete ({len(by_name)} device kernels, "
              f"{sorted(seen)} per call); tracing again")
    raise SmokeFailure("torch.profiler gave no complete device trace in eight tries")


def device_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    return device_profile(fn, iters, warmup)[0]


def print_by_name(label: str, by_name: dict) -> None:
    for name, v in sorted(by_name.items(), key=lambda kv: -kv[1]["ms"]):
        print(f"  {label} device kernel {name[:60]}: {v['per_call']:g} per call, "
              f"{v['ms']:.5f} ms per call")


def bound(n_bytes: int, n_flop: int) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the f32 operations over the f32 peak."""
    t_bytes, t_flop = n_bytes / PEAK_BYTES_PER_S, n_flop / PEAK_F32_FLOP_PER_S
    return {
        "bound_ms": max(t_bytes, t_flop) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_flop else "operations",
    }


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def gn_inputs(n: int, seed: int, dev, hit_rate: float = 0.7):
    """Correspondences like the align loop's: points at LiDAR range, SPD
    body covariances, map means near the points, a hit mask."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def spd(scale):
        A = rng.normal(size=(n, 3, 3)) * scale
        C = A @ A.transpose(0, 2, 1) + 0.05 * np.eye(3)
        # row-major, as the align loop holds its packed covariances
        return np.ascontiguousarray(C[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]])

    pts = rng.normal(size=(n, 3)) * 8.0
    mu = pts + rng.normal(size=(n, 3)) * 0.1
    ang = rng.normal(size=3) * 0.3
    t = [torch.as_tensor(a.astype(np.float32), device=dev)
         for a in (pts, spd(0.3), mu, spd(0.3), ang)]
    from eskf_lio_torch.ops import lie

    R = lie.so3_exp(t[4])
    mask = torch.as_tensor(rng.random(n) < hit_rate, device=dev)
    return t[0], t[1], R, t[2], t[3], mask


def gn_rel_err(args, out_k, out_p) -> tuple[float, float]:
    """(max abs error, max error relative to the sum of |terms|) between
    two (JTJ, JTr) results."""
    import torch

    from eskf_lio_torch.ops import gn_normal_eq as gn

    sum_abs = gn._closed_form_terms(*args).abs().sum(0)  # [28]
    full = torch.tensor(gn._FULL, device=sum_abs.device)
    scale = torch.cat([sum_abs[full], sum_abs[21:27]])
    diff = torch.cat([(out_k[0] - out_p[0]).reshape(-1), out_k[1] - out_p[1]]).abs()
    check(bool(torch.isfinite(diff).all()), "kernel A produced non-finite sums")
    rel = (diff / torch.clamp(scale, min=1e-30)).max().item()
    return diff.max().item(), rel


def kernel_a_phase(dev, n_main: int) -> dict:
    import torch

    from eskf_lio_torch.models import registration as reg
    from eskf_lio_torch.map import voxel_map as vm
    from eskf_lio_torch.ops import gn_normal_eq as gn

    res = {}
    cases = (("main", n_main, 1), ("n=1000", 1000, 2), ("n=1", 1, 3),
             ("n=129: one full chunk and a ragged one", 129, 6),
             ("n=100000: grid-stride", 100000, 7))
    for label, n, seed in cases:
        args = gn_inputs(n, seed, dev)
        out_k = gn.normal_equations_rotated(*args)
        out_p = gn.normal_equations_rotated_ref(*args)
        abs_err, rel = gn_rel_err(args, out_k, out_p)
        # cross-check against the einsum path of registration too
        pts, covs, R, mu, covm, mask = args
        covs_w = R @ vm.unpack_cov(covs) @ R.T
        out_e = reg.normal_equations(pts, covs_w, mu, vm.unpack_cov(covm), mask)
        _, rel_e = gn_rel_err(args, out_k, out_e)
        print(f"kernel A [{label}] N={n}: max_abs_err={abs_err:.3e} "
              f"rel_err(plain)={rel:.3e} rel_err(einsum)={rel_e:.3e} tol={GN_TOL:g} "
              f"count={int(out_k[2])}")
        check(rel <= GN_TOL, f"kernel A disagrees with its plain version [{label}]")
        check(rel_e <= GN_TOL, f"kernel A disagrees with the einsum path [{label}]")
        check(int(out_k[2]) == int(mask.sum()) == int(out_p[2]),
              f"kernel A's count is not the number of masked-in rows [{label}]")
        if label == "main":
            res["max_abs_err"] = abs_err
            res["args"] = args
    # every row masked: exactly zero, even with garbage behind the mask
    pts, covs, R, mu, covm, mask = gn_inputs(n_main, 4, dev)
    out = gn.normal_equations_rotated(
        pts, torch.zeros_like(covs), R, mu, torch.full_like(covm, float("nan")),
        torch.zeros_like(mask),
    )
    check(bool((out[0] == 0).all() and (out[1] == 0).all() and out[2] == 0),
          "kernel A: all-masked rows did not sum to exactly 0")
    print("kernel A [all rows masked, NaN map covariances]: exactly 0")
    # deterministic: the same bits twice (both results held at once: each
    # call writes a tensor of its own)
    args = res.pop("args")
    first, again = gn.normal_equations_rotated(*args), gn.normal_equations_rotated(*args)
    check(all(torch.equal(x, y) for x, y in zip(first, again)),
          "kernel A is not deterministic")
    # inputs read once (f32 rows of 3 + 6 + 3 + 6, a mask byte, R), the
    # 43-float output written once; arithmetic only on live rows
    n_live = int(args[5].sum())
    bytes_moved = n_main * ((3 + 6 + 3 + 6) * 4 + 1) + 9 * 4 + 43 * 4
    # the wrapper's call time first: a profiler run leaves host threads busy
    call_ms = event_ms(lambda: gn.normal_equations_rotated(*args))
    ms, by_name = device_profile(lambda: gn.normal_equations_rotated(*args))
    print_by_name("kernel A", by_name)
    check(len(by_name) == 1 and all(v["per_call"] == 1 for v in by_name.values()),
          f"kernel A is not one launch per call: {by_name}")
    empty_ms, _ = device_profile(lambda: gn.launch_empty_kernel(dev))
    print(f"empty <<<1,32>>> kernel: {empty_ms:.5f} ms (device), the least any launch takes")
    res.update(
        ms=ms, empty_launch_ms=empty_ms, call_ms=call_ms,
        plain_ms=device_ms(lambda: gn.normal_equations_rotated_ref(*args)),
        library_ms=None,  # no single PyTorch call computes JᵀWJ/JᵀWr
        **bound(bytes_moved, GN_FLOP_PER_POINT * n_live),
    )
    print(f"kernel A timing N={n_main}: kernel {res['ms']:.5f} ms (device), "
          f"{res['call_ms']:.4f} ms per wrapper call, plain {res['plain_ms']:.4f} ms, "
          f"bound {res['bound_ms']:.5f} ms ({res['bound_by']}), which no launch reaches "
          f"at this N (empty launch {empty_ms:.5f} ms); library: none")
    return res


def scan_moments(points, n_rows: int, dev):
    """Kernel B's main-path inputs from a real scan padded to `n_rows` raw
    points, as the downsampler builds them: key-sorted packed voxel keys
    (padding rows sort last as INT32_MAX) and [N, 10] moment rows."""
    import torch

    from eskf_lio_torch.ops import sortmerge as sm
    from eskf_lio_torch.ops import voxel as vx

    n = points.shape[0]
    points = torch.cat([points, points.new_zeros((n_rows - n, 3))])
    valid = torch.arange(n_rows, device=dev) < n
    keys = vx.voxel_key(points, 0.3)
    origin = torch.full((3,), -512, dtype=torch.int32, device=dev)
    packed, in_range = sm.pack_keys(keys, origin)
    ok = valid & in_range
    q = torch.where(ok[:, None], points - (keys.to(points.dtype) + 0.5) * 0.3, 0.0)
    packed_s, _, q_s = sm.sort_perm(torch.where(ok, packed, sm.INT32_MAX), q)
    w = (packed_s != sm.INT32_MAX).to(points.dtype)[:, None]
    x, y, z = q_s.unbind(-1)
    second = torch.stack([x * x, x * y, x * z, y * y, y * z, z * z], -1)
    return packed_s.contiguous(), torch.cat([w, q_s * w, second * w], 1).contiguous()


def seg_compare(keys, vals, label) -> float:
    """Kernel B vs its plain version on head rows; returns max abs error."""
    import torch

    from eskf_lio_torch.ops import segscan

    out_k = segscan.segsum_sorted(keys, vals)
    out_p = segscan.segsum_sorted_ref(keys, vals)
    scale = segscan.segsum_sorted_ref(keys, vals.abs())
    n = keys.shape[0]
    head = torch.ones(n, dtype=torch.bool, device=keys.device)
    head[1:] = keys[1:] != keys[:-1]
    diff = (out_k[head] - out_p[head]).abs()
    check(bool(torch.isfinite(out_k[head]).all()), f"kernel B non-finite [{label}]")
    rel = (diff / torch.clamp(scale[head], min=1e-30)).max().item()
    print(f"kernel B [{label}] N={n} W={vals.shape[1]} segments={int(head.sum())}: "
          f"max_abs_err={diff.max().item():.3e} rel_err={rel:.3e} tol={SEG_TOL:g}")
    check(rel <= SEG_TOL, f"kernel B disagrees with its plain version [{label}]")
    again = segscan.segsum_sorted(keys, vals)
    check(bool(torch.equal(again, out_k)), f"kernel B is not deterministic [{label}]")
    return diff.max().item()


def run_keys(run_lengths, n: int, dev):
    """[n] sorted int32 keys made of runs of the given lengths, repeated
    until n rows are covered."""
    import numpy as np
    import torch

    lengths = np.resize(np.asarray(run_lengths), 2 * n // min(run_lengths) + 1)
    keys = np.repeat(np.arange(len(lengths)), lengths)[:n].astype(np.int32)
    return torch.as_tensor(keys, device=dev)


def insert_rows(dev, config, scan_points, n_shards: int = 1):
    """Kernel B's inputs at the shape of `voxel_map.insert`'s per-voxel sums:
    a real scan downsampled to `max_scan_points` rows, moved to a pose off
    the voxel grid as an update scan is, keyed by its map voxels and sorted
    as `insert` sorts it; with `n_shards` > 1, the rows that shard 0 of a
    sharded map owns, compacted to its insert slice first, as the sharded
    step does.  Returns (skey_s, raw_s, head, seg_id)."""
    import torch

    from eskf_lio_torch.map import voxel_map as vm
    from eskf_lio_torch.ops import lie, preprocess
    from eskf_lio_torch.ops import sortmerge as sm
    from eskf_lio_torch.ops import voxel as vx

    n_rows = config.max_raw_points
    n = scan_points.shape[0]
    points = torch.cat([scan_points, scan_points.new_zeros((n_rows - n, 3))])
    processed = preprocess.downsample_and_covariances(
        points, torch.arange(n_rows, device=dev) < n, config
    )
    origin = vm.VoxelMap.create(config.hash_capacity, config.map_delta_capacity, device=dev).origin
    R = lie.so3_exp(torch.tensor([0.02, -0.01, 0.1], device=dev))
    world = processed.points @ R.T + torch.tensor([0.4, -0.2, 0.05], device=dev)
    covs = vm.pack_cov(R @ processed.covs @ R.T)
    valid = processed.valid
    if n_shards > 1:
        from eskf_lio_torch.parallel import sharded_map

        owner = vx.owner_hash(vx.voxel_key(world, config.map_voxel_size), n_shards)
        (world, covs), valid, _ = sharded_map._compact_slice(
            valid & (owner == 0), (world, covs),
            sharded_map.slice_capacity(config.max_scan_points, n_shards, config.shard_slack),
        )
    keys = vx.voxel_key(world, config.map_voxel_size)
    packed, in_range = sm.pack_keys(keys, origin)
    ok = valid & in_range
    skey = sm.skey_of(torch.where(ok, packed, sm.INT32_MAX))
    okf = ok.to(world.dtype)[:, None]
    raw = torch.cat([okf, world * okf, covs * okf], dim=1)
    skey_s, _, raw_s = sm.sort_perm(skey, raw)
    head, seg_id = sm.unique_segments(skey_s, skey_s != sm.INT32_MAX)
    return skey_s.contiguous(), raw_s.contiguous(), head, seg_id


def kernel_b_phase(dev, config, scan_points) -> dict:
    import numpy as np
    import torch

    from eskf_lio_torch.ops import segscan

    keys, vals = scan_moments(scan_points, config.max_raw_points, dev)
    n, w = vals.shape
    res = {"max_abs_err": seg_compare(keys, vals, "main: real scan")}
    rng = np.random.default_rng(5)
    rnd = torch.as_tensor(rng.normal(size=(n, 16)).astype(np.float32), device=dev)
    rnd10 = rnd[:, :10].contiguous()
    seg_compare(torch.zeros(n, dtype=torch.int32, device=dev), rnd10, "one segment")
    seg_compare(torch.arange(n, dtype=torch.int32, device=dev), rnd10, "all unique")
    k1000 = torch.as_tensor(np.sort(rng.integers(0, 90, 1000)).astype(np.int32), device=dev)
    seg_compare(k1000, rnd10[:1000].contiguous(), "n=1000")
    seg_compare(k1000[:1].contiguous(), rnd10[:1].contiguous(), "n=1")
    # runs that straddle many 256-row tiles, with a real scan's padding tail
    # (its last 11,072 rows share one key), at the narrowest, the main
    # path's and the widest row
    straddle = run_keys((300, 700, 5000), n, dev)
    straddle[n - 11072:] = 2**31 - 1
    for width in (1, 10, 16):
        seg_compare(straddle, rnd[:, :width].contiguous(), f"runs of 300/700/5000 + tail, W={width}")
    seg_compare(straddle[: n - 37].contiguous(), rnd[: n - 37, :7].contiguous(),
                "ragged last tile, W=7")

    # the one PyTorch call computing the same function (segment totals,
    # compacted), timed only as a yardstick
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = keys[1:] != keys[:-1]
    starts = torch.nonzero(head)[:, 0]
    lengths = torch.diff(torch.cat([starts, torch.tensor([n], device=dev)]))
    lib = torch.segment_reduce(vals, "sum", lengths=lengths)
    out_k = segscan.segsum_sorted(keys, vals)
    lib_err = (lib - out_k[starts]).abs().max().item()
    print(f"kernel B vs torch.segment_reduce: max_abs_err={lib_err:.3e}")
    # keys and values read once, [N, W] written once; one add per value
    call_ms = event_ms(lambda: segscan.segsum_sorted(keys, vals))
    ms, by_name = device_profile(lambda: segscan.segsum_sorted(keys, vals))
    print_by_name("kernel B", by_name)
    check(len(by_name) == 1 and all(v["per_call"] == 1 for v in by_name.values()),
          f"kernel B is not one launch per call: {by_name}")
    res.update(
        ms=ms, call_ms=call_ms,
        plain_ms=device_ms(lambda: segscan.segsum_sorted_ref(keys, vals)),
        library_ms=device_ms(lambda: torch.segment_reduce(vals, "sum", lengths=lengths)),
        **bound(n * 4 + 2 * n * w * 4, n * w),
    )
    print(f"kernel B timing N={n} W={w}: kernel {res['ms']:.5f} ms (device), "
          f"{res['call_ms']:.4f} ms per wrapper call, plain {res['plain_ms']:.4f} ms, "
          f"torch.segment_reduce {res['library_ms']:.4f} ms, "
          f"bound {res['bound_ms']:.5f} ms (bytes)")
    for label, k in (("one segment", torch.zeros(n, dtype=torch.int32, device=dev)),
                     ("runs of 300/700/5000 + tail", straddle)):
        print(f"kernel B timing [{label}] N={n} W={w}: "
              f"{device_ms(lambda: segscan.segsum_sorted(k, rnd10)):.5f} ms (device)")

    # kernel B at its second call site, `voxel_map.insert`'s per-voxel sums,
    # against the zeros_like + index_add_ it replaced there
    skey_s, raw_s, head_i, seg_id = insert_rows(dev, config, scan_points)
    out_b = segscan.segsum_sorted(skey_s, raw_s)
    out_i = torch.zeros_like(raw_s).index_add_(0, seg_id, raw_s)
    scale = torch.zeros_like(raw_s).index_add_(0, seg_id, raw_s.abs())
    rows = seg_id[head_i]
    rel = ((out_b[head_i] - out_i[rows]).abs() / scale[rows].clamp(min=1e-30)).max().item()
    check(rel <= SEG_TOL, "kernel B disagrees with index_add_ at insert's shape")
    b_call_ms = event_ms(lambda: segscan.segsum_sorted(skey_s, raw_s))
    b_ms = device_ms(lambda: segscan.segsum_sorted(skey_s, raw_s))
    i_ms = device_ms(lambda: torch.zeros_like(raw_s).index_add_(0, seg_id, raw_s))
    n_i, w_i = raw_s.shape
    b_bound = bound(n_i * 4 + 2 * n_i * w_i * 4, n_i * w_i)["bound_ms"]
    print(f"insert's shape N={n_i} W={w_i} voxels={int(head_i.sum())}: "
          f"kernel B {b_ms:.5f} ms (bound {b_bound:.5f} ms, bytes; "
          f"{b_call_ms:.4f} ms per wrapper call), "
          f"zeros_like + index_add_ {i_ms:.5f} ms (device), rel_err={rel:.3e}")
    res.update(insert_shape_ms=b_ms, insert_shape_index_add_ms=i_ms,
               insert_shape_bound_ms=b_bound, insert_shape_call_ms=b_call_ms)
    return res


# ---------------------------------------------------------------------------
# phase 3: the captured step's control flow, and the main path end to end
# ---------------------------------------------------------------------------


def kernel_bounds_phase() -> dict:
    """`python -m eskf_lio_torch.utils.kernel_bounds` in a process of its
    own: each kernel over inputs in host memory registered for the card up
    to their last byte (a load past the end is an illegal address there):
    kernel B's values at N a multiple of the tile rows, head rows against
    the plain version; kernel A's four row arrays and mask at N = 16,384,
    12,288, 8,192 and two ragged N, its sums against the plain version;
    every input of the preprocessor's kernels and of the GN pass's lookup
    and increment kernels, outputs bit-equal to a call on device-resident
    inputs."""
    proc = subprocess.run([sys.executable, "-m", "eskf_lio_torch.utils.kernel_bounds"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    line = [l for l in proc.stdout.splitlines() if l.startswith("kernel_bounds ")]
    check(proc.returncode == 0 and bool(line),
          f"kernel_bounds exited {proc.returncode}: "
          f"{(proc.stderr.strip().splitlines() or ['no output'])[-1][:300]}")
    res = json.loads(line[-1].split(" ", 1)[1])
    for s in res["shapes"]:
        # relative to the sum of absolute values: at most the longest run's
        # length (values in [0, 1), a key run over 40 % of the rows)
        check(s["max_abs_err"] <= SEG_TOL * 0.4 * s["n"],
              f"kernel_bounds B N={s['n']} W={s['w']}: error {s['max_abs_err']}")
    for s in res["gn_shapes"]:
        check(s["rel_err"] <= GN_TOL, f"kernel_bounds A N={s['n']}: rel_err {s['rel_err']}")
    for s in res["pre_shapes"]:
        check(s["equal"], f"kernel_bounds P N={s['n']} K={s['k']} {s['path']}: outputs differ")
    for s in res["gn_pass_shapes"]:
        check(s["equal"], f"kernel_bounds G N={s['n']} {s['key_bits']}: outputs differ")
    out = {"segscan": res["shapes"], "gn_normal_eq": res["gn_shapes"],
           "preprocess": res["pre_shapes"], "gn_pass": res["gn_pass_shapes"]}
    print("kernel_bounds " + json.dumps(out))
    return out


def control_flow_phase(dev) -> dict:
    """The conditional nodes (`csrc/graph_cond.cu`, through
    `utils/graphs.py`) against Python control flow on the same inputs: an
    if/else (IF nodes on a predicate and on its negation) around a sort,
    then a WHILE loop holding an IF, for both values of the predicate and
    several trip counts, replay after replay of one capture; exact
    equality.  Times a replay with the loop at 0 and at 10 passes."""
    import torch

    from eskf_lio_torch.utils import graphs

    n = 1 << 16
    x = torch.zeros(n, device=dev)
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    stop = torch.zeros((), dtype=torch.int64, device=dev)
    out = (torch.zeros(n, device=dev), torch.zeros((), dtype=torch.int64, device=dev))

    def body(c):
        _, k, z = c
        z = graphs.device_if(k % 3 == 0, lambda: (z * 0.5,), (z,))[0]
        return k + 1 < stop, k + 1, z * 1.01 + 1

    def step():
        y, m = graphs.device_if(flag, lambda: (torch.sort(x, descending=True)[0], stop * 2),
                                out, otherwise=lambda: (x + 1, stop))
        carry = (stop > 0, torch.zeros((), dtype=torch.int64, device=dev), y)
        _, k, z = graphs.device_while(body, carry, 100)
        out[0].copy_(z)
        out[1].copy_(k + m)

    def plain(f, s):
        y = torch.sort(x, descending=True)[0] if f else x + 1
        m = 2 * s if f else s
        for k in range(s):
            if k % 3 == 0:
                y = y * 0.5
            y = y * 1.01 + 1
        return y, s + m

    graph = graphs.StepGraph(step, dev, segscan_rows=0)
    cases = ((True, 3), (False, 0), (True, 17), (False, 5), (True, 0), (False, 1))
    for f, s in cases:
        x.copy_(torch.randn(n, device=dev))
        flag.fill_(f)
        stop.fill_(s)
        want = plain(f, s)
        graph()
        torch.cuda.synchronize()
        check(torch.equal(out[0], want[0]) and int(out[1]) == want[1],
              f"captured control flow differs from Python's (flag {f}, {s} passes)")
    times = {}
    for s in (0, 10):
        stop.fill_(s)
        times[f"replay_ms_{s}_passes"] = event_ms(graph, iters=20, warmup=2, batches=3)
    res = dict(cases=len(cases), capture_s=graph.capture_s, nodes=graph.nodes,
               cuda_runtime=graphs.GRAPH_COND.lib().graph_cond_runtime_version(),
               # why the nodes are made through the CUDA runtime
               torch_has_if_node_call=hasattr(torch.cuda.CUDAGraph, "begin_capture_to_if_node"),
               **times)
    print("control_flow " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# the main path end to end
# ---------------------------------------------------------------------------


def sync_sites(caught, n: int) -> dict:
    """torch's sync debug mode warns at each call that waits for the device
    (a blocking upload included): the warnings by calling line, per scan."""
    sites: dict = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{Path(w.filename).name}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return {k: v / n for k, v in sorted(sites.items(), key=lambda kv: -kv[1])}


def graph_info(step) -> dict:
    """Capture seconds and node counts of a graphed replay's steps (the
    update graphs that were captured, and the predict-only graph if any)."""
    graphs_ = {f"update{'_evict' if e else ''}": g for e, g in step.scan_step.graphs.items()}
    graphs_["predict_only"] = step.predict.graph
    return {name: {"capture_s": g.capture_s, "nodes": g.nodes}
            for name, g in graphs_.items() if g.graph is not None}


def e2e_phase(dev, config, seq, packed, kernels) -> dict:
    """The replay on the graph path (the default on the card): each row
    replays the captured step, with the launch counters zeroed before the
    run and read after it (kernel launches inside the graphs are counted
    on the device), and the device syncs of the rows counted by line (of
    the warm half: the first half holds the capture)."""
    import numpy as np
    import torch

    from eskf_lio_torch.bench import run_rows, start_replay
    from eskf_lio_torch.map import voxel_map as vm
    from eskf_lio_torch.pipeline import replay
    from eskf_lio_torch.utils.metrics import ate_rmse

    init_scan, chunks, _, _, updates, _ = packed
    b_total = chunks.dt.shape[0]
    half = b_total // 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    for k in kernels:
        k.reset_launches()
    t0 = time.perf_counter()
    step, carry = start_replay(dev, config, init_scan)
    outs, caught = [], {}
    for part, rows in (("first", slice(0, half)), ("warm", slice(half, b_total))):
        with warnings.catch_warnings(record=True) as caught[part], sync_debug("warn"):
            warnings.simplefilter("always")
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            carry, Rs, ts, diags = run_rows(step, carry, packed, rows)
            torch.cuda.synchronize()
            outs.append((Rs, ts, diags, time.perf_counter() - t_start))
    wall = time.perf_counter() - t0
    launches = {k.name: k.launch_count() for k in kernels}

    positions, _, diags = replay.collect(
        updates, [o[0] for o in outs], [o[1] for o in outs], [o[2] for o in outs]
    )
    n_upd = int(np.asarray(updates).sum())
    warm_updates = int(np.asarray(updates[half:]).sum())
    scans_per_s = warm_updates / outs[1][3]
    ate_cm = 100.0 * ate_rmse(positions, seq.gt_positions[: len(positions)])
    conv = float(np.mean(diags["icp_converged"]))
    iters = diags["icp_iterations"]
    res = dict(
        path="graph", scans=len(positions), update_rows=n_upd, scans_per_s=scans_per_s,
        warm_rows=b_total - half, ate_cm=ate_cm, convergence=conv,
        mean_icp_iterations=float(np.mean(iters)), gn_iterations=int(np.sum(iters)),
        wall_s=wall, peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
        map_voxels=int(carry[1].num_voxels()), launches=launches,
        max_align_slice_overflow=int(np.max(diags["align_slice_overflow"])),
        dropped_points=int(np.sum(diags["dropped_points"])),
        graphs=graph_info(step),
        # the GN loop's WHILE body of the update graph, by node type
        gn_while_body=next({"nodes": b["nodes"], "by_type": b["by_type"]}
                           for b in step.scan_step.graphs[False].bodies
                           if b["kind"] == "while" and b["depth"] == 0),
        # the warm half's rows; the first half's hold the capture's own
        # synchronisations (before and after it), once a run
        device_syncs_in_rows_per_scan=sum(sync_sites(caught["warm"], warm_updates).values()),
        sync_sites_in_rows_per_scan=sync_sites(caught["warm"], warm_updates),
        sync_sites_first_half=sync_sites(caught["first"], 1),
    )
    print("e2e " + json.dumps(res))
    check(bool(np.isfinite(positions).all()) and bool(diags["pose_finite"].all()),
          "non-finite pose in the replay")
    check(conv > MIN_CONVERGENCE, f"convergence rate {conv:.3f} <= {MIN_CONVERGENCE}")
    check(ate_cm <= MAX_ATE_CM, f"ATE {ate_cm:.2f} cm > {MAX_ATE_CM} cm")
    for name, per in GN_PASS_LAUNCHES.items():
        check(launches[name] == per * int(np.sum(iters)),
              f"{name} launches {launches[name]} != {per} x GN iterations {int(np.sum(iters))}")
    # the downsampler and `insert`, on every update scan and on the init scan
    check(launches["segscan"] == 2 * n_upd + 2,
          f"kernel B launches {launches['segscan']} != 2 x update scans + 2 = {2 * n_upd + 2}")
    check(launches["preprocess"] == PRE_LAUNCHES * (n_upd + 1),
          f"preprocess launches {launches['preprocess']} != {PRE_LAUNCHES} x {n_upd + 1} scans")
    # the IMU prefix once a row, update or predict-only
    check(launches["imu_prefix"] == b_total,
          f"imu_prefix launches {launches['imu_prefix']} != {b_total} rows")
    check(res["device_syncs_in_rows_per_scan"] == 0,
          f"the replay's rows waited for the device: {res['sync_sites_in_rows_per_scan']}")
    res["_trajectory"] = (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))
    res["_map"] = vm.VoxelMap(*(x.clone() for x in carry[1]))

    # eviction at full size on the final map (the 4 s run ends before the
    # first 10 s eviction period): fold, then drop voxels beyond 5 m
    voxmap, _ = vm.compact(carry[1], max_points_per_voxel=config.max_points_per_voxel)
    before = int(voxmap.num_voxels())
    evicted, removed = vm.evict_beyond(
        voxmap, carry[3], voxel_size=config.map_voxel_size, distance_threshold=5.0,
        max_points_per_voxel=config.max_points_per_voxel,
    )
    after = int(evicted.num_voxels())
    print(f"evict: {before} voxels -> {after} (removed {int(removed)})")
    check(0 < int(removed) < before and after == before - int(removed),
          "eviction at full size did not remove a consistent voxel count")
    return res


def eager_rows(core, carry, packed, rows: slice):
    """Rows of the packed sequence through `make_step_core` run eagerly on
    the card (the bench sequence has update rows only); (carry, Rs, ts)."""
    from eskf_lio_torch.types import ImuChunk, Scan

    _, chunks, scans, evicts, updates, _ = packed
    Rs, ts = [], []
    for b in range(rows.start, rows.stop):
        check(bool(updates[b]), f"row {b} of the bench sequence is predict-only")
        carry, _ = core(carry, (ImuChunk(*(x[b] for x in chunks)),
                                Scan(*(x[b] for x in scans)), bool(evicts[b])))
        Rs.append(carry[2])
        ts.append(carry[3])
    return carry, Rs, ts


def eager_start(dev, config, init_scan):
    """The eager step and the carry after the init scan."""
    from eskf_lio_torch.bench import start_replay
    from eskf_lio_torch.pipeline import odometry as odo

    _, carry = start_replay(dev, config, init_scan, graphed=False)
    return odo.make_step_core(config, dev), carry


def trace_scans(run_scans, n: int, scan_ms: float) -> dict:
    """`run_scans()` (n scans; it must leave no state behind, since a trace
    without device records is taken again, see device_profile) under
    torch.profiler: the device's busy time per scan (the sum of kernel
    durations), its idle share against the unprofiled wall time per scan
    `scan_ms`, launches per scan and the kernels that take the most device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e, own):
        name = "self_device_time_total" if own else "device_time_total"
        legacy = "self_cuda_time_total" if own else "cuda_time_total"
        return float(getattr(e, name, None) or getattr(e, legacy, 0.0))

    def on_device(e):
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    for attempt in range(8):
        torch.cuda.synchronize()
        time.sleep(0.1 * attempt)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_scans()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        kernels = [e for e in events if on_device(e)]
        if kernels:
            break
        print("  torch.profiler recorded no device kernel; tracing again")
    busy_ms = sum(dev_us(e, True) for e in kernels) / 1e3 / n
    top = sorted(kernels, key=lambda e: -dev_us(e, True))[:10]
    check(busy_ms > 0.0, "the profiled scans ran nothing on the device")
    return dict(
        scans=n, busy_ms_per_scan=busy_ms, wall_ms_per_scan_unprofiled=scan_ms,
        wall_ms_per_scan_profiled=wall_ms / n,
        idle_share=1.0 - busy_ms / scan_ms,
        launches_per_scan=sum(e.count for e in kernels) / n,
        top_kernels=[
            {"name": e.key[:80], "per_scan": e.count / n, "ms_per_scan": dev_us(e, True) / 1e3 / n}
            for e in top
        ],
    )


def profile_phase(dev, config, packed, n_prof: int = 5) -> dict:
    """Where the eager step's time goes: `make_step_core` run eagerly over
    the sequence, its last `n_prof` rows under torch.profiler (the device
    records of a graph's conditional bodies come back incomplete, so the
    graph path is timed with CUDA events instead: `graph_phase`)."""
    import numpy as np
    import torch

    b_total = packed[1].dt.shape[0]
    core, carry = eager_start(dev, config, packed[0])
    carry, *_ = eager_rows(core, carry, packed, slice(0, b_total - n_prof))
    torch.cuda.synchronize()
    n = int(np.asarray(packed[4][b_total - n_prof:]).sum())
    t0 = time.perf_counter()
    eager_rows(core, carry, packed, slice(b_total - n_prof, b_total))
    torch.cuda.synchronize()
    scan_ms = (time.perf_counter() - t0) * 1e3 / n
    res = trace_scans(
        lambda: eager_rows(core, carry, packed, slice(b_total - n_prof, b_total)), n, scan_ms
    )
    res["path"] = "eager"
    print("profile " + json.dumps(res))
    return res


def graph_phase(dev, config, packed, e2e: dict, eager_busy_ms: float) -> dict:
    """The eager step and the graph step side by side on the same rows:
    `make_step_core` eagerly over the whole sequence (scans/s of its warm
    half), then a second graph run row by row, each row between CUDA events
    (device time a scan: the events' span, which holds the row's few input
    and output copies besides the graph), and a third graph run built with
    the tracer, its rows in one call (`traced`); all must give the first
    graph run's trajectory and map bit for bit."""
    import numpy as np
    import torch

    from eskf_lio_torch.bench import run_rows, start_replay
    from eskf_lio_torch.pipeline import replay
    from eskf_lio_torch.utils.profiling import Tracer

    b_total = packed[1].dt.shape[0]
    half = b_total // 2
    ref_Rs, ref_ts = e2e["_trajectory"]
    ref_map = e2e["_map"]

    core, carry = eager_start(dev, config, packed[0])
    carry, Rs_a, ts_a = eager_rows(core, carry, packed, slice(0, half))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, Rs_b, ts_b = eager_rows(core, carry, packed, slice(half, b_total))
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager_equal = (
        torch.equal(torch.stack(Rs_a + Rs_b), ref_Rs) and torch.equal(torch.stack(ts_a + ts_b), ref_ts)
        and maps_bit_equal(carry[1], ref_map)
    )
    apart_m = float((torch.stack(ts_a + ts_b) - ref_ts).norm(dim=1).max())
    del carry

    step, carry = start_replay(dev, config, packed[0])
    spans, walls, Rs, ts = [], [], [], []
    for b in range(b_total):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t_row = time.perf_counter()
        start.record()
        carry, R, t, _ = run_rows(step, carry, packed, slice(b, b + 1))
        end.record()
        end.synchronize()
        walls.append(time.perf_counter() - t_row)
        spans.append(start.elapsed_time(end))
        Rs.append(R)
        ts.append(t)
    again_equal = (torch.equal(torch.cat(Rs), ref_Rs) and torch.equal(torch.cat(ts), ref_ts)
                   and maps_bit_equal(carry[1], ref_map))
    warm = slice(half, b_total)
    graph_ms = float(np.mean(spans[warm]))

    tracer = Tracer()
    _, carry = start_replay(dev, config, packed[0], graphed=False)
    stamped = replay.make_replay_step(config, dev, tracer)
    carry, Rs_s, ts_s, _ = run_rows(stamped, carry, packed, slice(0, b_total))
    stamped_equal = (torch.equal(Rs_s, ref_Rs) and torch.equal(ts_s, ref_ts)
                     and maps_bit_equal(carry[1], ref_map))
    del carry
    nodes = {}
    for evict, g in step.scan_step.graphs.items():
        g_s = stamped.scan_step.graphs[evict]
        if g.graph is not None and g_s.graph is not None:
            nodes[f"update{'_evict' if evict else ''}"] = {
                "nodes": g.nodes, "stamped_nodes": g_s.nodes, "stamps": g_s.stamp_nodes,
                "unstamped_stamps": g.stamp_nodes}
    summary = tracer.summary()
    stages = summary.get("stages", {})
    # the warm half's rows: a first row's device span holds its capture
    stamped_rows, row_spans = tracer.stage_rows()[warm], tracer.device_spans("row")[warm]
    row_ms = float(np.mean([b - a for _, _, a, b in row_spans])) / 1e6
    first_to_last_ms = float(np.mean([r[-1][1] - r[0][1] for r in stamped_rows])) / 1e6 \
        if stamped_rows else 0.0
    traced = dict(
        rows=stages.get("rows", 0), warm_row_device_ms=row_ms,
        stage_ms={k: v["mean_ms"] for k, v in stages.items() if isinstance(v, dict) and "mean_ms" in v},
        gn_stamps_per_row=stages.get("ticks_per_row", {}).get("gn", 0.0),
        first_to_last_share=first_to_last_ms / row_ms,
        nodes=nodes, clock=summary["clock"], bit_equal=stamped_equal,
    )
    res = dict(
        rows=b_total, warm_rows=b_total - half,
        eager_scans_per_s=(b_total - half) / eager_s,
        graph_scans_per_s=e2e["scans_per_s"],
        graph_device_ms_per_scan=graph_ms,
        graph_wall_ms_per_scan_row_by_row=1e3 * float(np.mean(walls[warm])),
        graph_idle_share_row_by_row=1.0 - graph_ms / (1e3 * float(np.mean(walls[warm]))),
        # the e2e phase's warm half enqueues its rows back to back: its wall
        # time a scan bounds the device time from above
        graph_wall_ms_per_scan_back_to_back=1e3 / e2e["scans_per_s"],
        eager_busy_ms_per_scan=eager_busy_ms,
        graphs=graph_info(step), peak_mem_gib=e2e["peak_mem_gib"],
        eager_equals_graph_bitwise=eager_equal, eager_vs_graph_max_m=apart_m,
        second_graph_run_bit_equal=again_equal,
        device_syncs_in_rows_per_scan=e2e["device_syncs_in_rows_per_scan"],
        launches=e2e["launches"], gn_iterations=e2e["gn_iterations"],
        update_rows=e2e["update_rows"], traced=traced,
    )
    print("graph " + json.dumps(res))
    check(again_equal, "two graph runs of the replay differ in their bits")
    check(eager_equal, f"the eager step and the graph step differ (max {apart_m:.3e} m)")
    check(stamped_equal, "the graph run built with a tracer differs in its bits")
    check(bool(nodes) and all(n["unstamped_stamps"] == 0 and n["stamps"] > 0
                              and n["stamped_nodes"] == n["nodes"] + n["stamps"]
                              for n in nodes.values()),
          f"the tracer's graphs hold more or other nodes than their stamps: {nodes}")
    check(traced["rows"] == b_total, f"{traced['rows']} stamped rows, not {b_total}")
    check(round(traced["gn_stamps_per_row"] * b_total) == e2e["gn_iterations"],
          f"GN stamps {traced['gn_stamps_per_row'] * b_total} != GN iterations {e2e['gn_iterations']}")
    check(0.5 < traced["first_to_last_share"] <= 1.0,
          f"the stamps cover {traced['first_to_last_share']:.3f} of a row's device span")
    return res


# ---------------------------------------------------------------------------
# phase 4: the live path (streaming drivers, checkpoint, CLI)
# ---------------------------------------------------------------------------

STREAM_REMOVE_PERIOD_S = 2.0
STREAM_REMOVE_DISTANCE_M = 15.0
# the digested reruns of the stream phase stop here: past the eviction of
# update scan 20, short of the whole sequence
RERUN_SCANS = 24
# the graphed driver's waits for the device: its read-back of the pose, and
# the init scan's fold flag and the summary's voxel count once a run
MAX_STREAM_SYNCS_PER_SCAN = 2.0


def eager_scan_step(config, dev):
    """`make_step_core` run eagerly, with the scan step's signature."""
    from eskf_lio_torch.pipeline import odometry as odo

    core = odo.make_step_core(config, dev)

    def scan_step(state, voxmap, prev_R, prev_t, chunk, scan, do_evict):
        (state, voxmap, R, t), diag = core((state, voxmap, prev_R, prev_t),
                                           (chunk, scan, do_evict))
        return state, voxmap, R, t, diag

    return scan_step


def stream_config():
    """HEAVY with the eviction schedule pulled inside a 4 s run."""
    from eskf_lio_torch.bench import heavy_config

    return dataclasses.replace(
        heavy_config(), remove_period=STREAM_REMOVE_PERIOD_S,
        remove_distance_threshold=STREAM_REMOVE_DISTANCE_M,
    )


@contextlib.contextmanager
def sync_debug(mode: str):
    import torch

    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def record_step_inputs(odo, log: list) -> None:
    """Wrap the driver's scan step to log a digest of its stream-derived
    inputs (IMU chunk, scan, evict flag), not of the carried state.  Chunk
    rows are masked to `valid & t_rel <= 0`: whether the first IMU sample
    beyond scan end is already in the chunk depends on arrival timing, and
    nothing reads it.  The digest's own reads are kept out of the count of
    device syncs."""
    import numpy as np

    inner = odo.scan_step

    def host(x):
        return np.ascontiguousarray(x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x))

    def wrapped(state, voxmap, prev_R, prev_t, chunk, scan, do_evict):
        with sync_debug("default"):
            h = hashlib.sha1()
            m = host(chunk.valid) & (host(chunk.t_rel) <= 0.0)
            for arr in (chunk.dt, chunk.t_rel, chunk.gyro, chunk.accel):
                a = host(arr)
                mm = m.reshape(m.shape + (1,) * (a.ndim - m.ndim))
                h.update(np.ascontiguousarray(np.where(mm, a, 0)).tobytes())
            h.update(m.tobytes())
            for arr in (*scan, do_evict):
                h.update(host(arr).tobytes())
            log.append(h.hexdigest())
        return inner(state, voxmap, prev_R, prev_t, chunk, scan, do_evict)

    odo.scan_step = wrapped


def maps_bit_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def drive(run, odo, kernels, seq, digests=None, count_syncs=False, keep_map_at=(),
          n_shards=None):
    """One driver run with the launch counters zeroed before and read after.
    `run(on_scan)` starts it; returns its readings and the maps it held after
    the scan counts in `keep_map_at`, and checks its health.  `n_shards`:
    the run is a sharded driver's, which launches kernel A once per shard per
    GN iteration and kernel B once in the downsampler and once per shard in
    `insert`, and reports slice overflows."""
    import numpy as np
    import torch

    from eskf_lio_torch.utils.metrics import ate_rmse

    if digests is not None:
        record_step_inputs(odo, digests)
    stamps, kept = [], {}
    # the overflow pre-advances, each one predict call beside the scans'
    pre_advances, predict_only = [0], odo.predict_only

    def counted_predict_only(*args):
        pre_advances[0] += 1
        return predict_only(*args)

    odo.predict_only = counted_predict_only

    def on_scan(o):
        stamps.append(time.perf_counter())
        if len(o.trajectory_t) in keep_map_at:
            # a graphed step writes its map in place: keep a copy
            kept[len(o.trajectory_t)] = type(o.voxmap)(*(x.clone() for x in o.voxmap))

    for k in kernels:
        k.reset_launches()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught, \
            sync_debug("warn" if count_syncs else "default"):
        warnings.simplefilter("always")
        summary = run(on_scan)
        torch.cuda.synchronize()
    launches = {k.name: k.launch_count() for k in kernels}

    diags = odo.diags
    n_upd = len(diags)
    iters = int(sum(int(d["icp_iterations"]) for d in diags))
    conv = float(np.mean([bool(d["icp_converged"]) for d in diags]))
    positions = odo.positions
    ate_cm = 100.0 * ate_rmse(positions, seq.gt_positions[: len(positions)])
    half = len(stamps) // 2
    res = dict(
        scans=summary["num_scans"], scans_per_s=summary["scans_per_sec"],
        warm_half_scans_per_s=(len(stamps) - 1 - half) / (stamps[-1] - stamps[half]),
        avg_step_ms=summary["avg_step_ms"], max_step_ms=summary["max_step_ms"],
        ate_cm=ate_cm, convergence=conv, gn_iterations=iters, launches=launches,
        h2d_bytes_per_scan=odo.h2d_bytes / summary["num_scans"],
        driver_reads_per_update_scan=odo.device_reads / n_upd,
        map_voxels=summary["map_voxels"],
        evictions=[(i + 1, int(d["removed_voxels"])) for i, d in enumerate(diags)
                   if int(d["removed_voxels"]) > 0],
        dropped_points=int(sum(int(d["dropped_points"]) for d in diags)),
        dropped_raw_points=int(sum(int(d["dropped_raw_points"]) for d in diags)),
    )
    for key in (("gn_slice_overflow", "insert_slice_overflow") if n_shards
                else ("align_slice_overflow",)):
        res[f"max_{key}"] = int(max(int(d[key]) for d in diags))
    if count_syncs:
        res["sync_sites_per_scan"] = sync_sites(caught, summary["num_scans"])
        res["device_syncs_per_scan"] = sum(res["sync_sites_per_scan"].values())
    check(bool(np.isfinite(positions).all()) and all(bool(d["pose_finite"]) for d in diags),
          "non-finite pose in a streaming run")
    check(not summary["diverged"], "a streaming run diverged")
    check(conv > MIN_CONVERGENCE, f"streaming convergence {conv:.3f} <= {MIN_CONVERGENCE}")
    check(ate_cm <= MAX_ATE_CM, f"streaming ATE {ate_cm:.2f} cm > {MAX_ATE_CM} cm")
    per_iter, per_scan = (n_shards or 1), 1 + (n_shards or 1)
    check(launches["gn_normal_eq"] == per_iter * iters,
          f"kernel A launches {launches['gn_normal_eq']} != {per_iter} x GN iterations {iters}")
    # a lookup per local shard and one increment a GN pass
    want = (per_iter + 1) * iters
    check(launches["gn_pass"] == want, f"gn_pass launches {launches['gn_pass']} != {want}")
    # the downsampler and `insert`, on every update scan and on the init scan
    check(launches["segscan"] == per_scan * (n_upd + 1),
          f"kernel B launches {launches['segscan']} != {per_scan} x {n_upd + 1} scans")
    # the preprocessor once a scan, whatever the shards
    check(launches["preprocess"] == PRE_LAUNCHES * (n_upd + 1),
          f"preprocess launches {launches['preprocess']} != {PRE_LAUNCHES} x {n_upd + 1} scans")
    # the IMU prefix once an update scan and once an overflow pre-advance
    res["pre_advances"] = pre_advances[0]
    check(launches["imu_prefix"] == n_upd + pre_advances[0],
          f"imu_prefix launches {launches['imu_prefix']} != {n_upd} update scans + "
          f"{pre_advances[0]} pre-advances")
    return res, kept


def stream_phase(seq, kernels, replay_scans_per_s: float):
    import numpy as np

    from eskf_lio_torch.pipeline.odometry import Odometry
    from eskf_lio_torch.pipeline.stream import StreamingRunner, merged_stream

    config = stream_config()
    n, m = len(seq.scans), RERUN_SCANS

    # each driver twice, in turns: timed over the whole sequence; then over
    # its first `m` scans with the step's inputs digested (and, for the
    # synchronous one, the device syncs counted)
    sync = Odometry(config)  # the default device is the card
    check(sync.device.type == "cuda", "Odometry did not default to the card")
    res_a, maps = drive(lambda cb: sync.run(seq, on_scan=cb), sync, kernels, seq,
                        keep_map_at=(m, n - 1))
    runner = StreamingRunner(config)
    res_b, _ = drive(lambda cb: runner.run(merged_stream(seq), on_scan=cb), runner.odo,
                     kernels, seq)
    again, digests_a = Odometry(config), []
    res_a2, _ = drive(lambda cb: again.run(seq, max_scans=m, on_scan=cb), again, kernels, seq,
                      digests=digests_a, count_syncs=True)
    runner2, digests_b = StreamingRunner(config), []
    res_b2, _ = drive(lambda cb: runner2.run(merged_stream(seq), max_scans=m, on_scan=cb),
                      runner2.odo, kernels, seq, digests=digests_b)
    # the same driver with `make_step_core` run eagerly in place of the
    # captured step: the graph path's bits, and the device syncs the eager
    # step makes (its GN loop and insert read their decisions)
    eager = Odometry(config)
    eager.scan_step = eager_scan_step(config, eager.device)
    res_e, _ = drive(lambda cb: eager.run(seq, max_scans=m, on_scan=cb), eager, kernels, seq,
                     count_syncs=True)

    def same_run(other):
        return (
            np.array_equal(np.stack(sync.trajectory_p[:m]), np.stack(other.trajectory_p))
            and np.array_equal(np.stack(sync.trajectory_R[:m]), np.stack(other.trajectory_R))
            and maps_bit_equal(maps[m], other.voxmap)
        )

    same_bits, eager_bits = same_run(again), same_run(eager)

    res = dict(
        config=f"HEAVY with remove_period {STREAM_REMOVE_PERIOD_S} s and "
               f"remove_distance_threshold {STREAM_REMOVE_DISTANCE_M} m, so that an "
               "eviction fires inside the step (the replay phase ends before the "
               "default 10 s period, and the 20 m room has nothing beyond 100 m)",
        scans=n, digested_scans=m, ingest=runner.ingest,
        replay_warm_half_scans_per_s=replay_scans_per_s,
        synchronous=res_a, threaded=res_b,
        # the second pair of runs, slowed alike by the digest's reads
        digested_scans_per_s={"synchronous": res_a2["scans_per_s"],
                              "threaded": res_b2["scans_per_s"]},
        device_syncs_per_scan=res_a2["device_syncs_per_scan"],
        sync_sites_per_scan=res_a2["sync_sites_per_scan"],
        eager_step=dict(scans_per_s=res_e["scans_per_s"], avg_step_ms=res_e["avg_step_ms"],
                        device_syncs_per_scan=res_e["device_syncs_per_scan"],
                        sync_sites_per_scan=res_e["sync_sites_per_scan"],
                        launches=res_e["launches"], bit_equal_to_graph=eager_bits),
        synchronous_twice_bit_equal=same_bits,
        step_inputs_bit_equal=digests_a == digests_b,
    )
    print("stream " + json.dumps(res))
    check(res_a["scans"] == res_b["scans"] == n,
          f"drivers processed {res_a['scans']} and {res_b['scans']} of {n} scans")
    check(len(digests_a) == m - 1 and digests_a == digests_b,
          "the threaded and the synchronous driver fed the step different inputs")
    check(all(bool(r["evictions"]) for r in (res_a, res_b, res_a2, res_b2)),
          "no eviction removed a voxel inside the step")
    check(same_bits, "two runs of the synchronous driver differ in their bits")
    check(eager_bits, "the eager step and the graph step of the driver differ in their bits")
    check(res_a2["device_syncs_per_scan"] <= MAX_STREAM_SYNCS_PER_SCAN,
          f"the graphed driver waited for the device {res_a2['device_syncs_per_scan']:.2f} "
          f"times a scan (at most {MAX_STREAM_SYNCS_PER_SCAN})")
    launches = {"stream_synchronous": res_a["launches"], "stream_threaded": res_b["launches"]}
    return sync, maps[n - 1], launches


def continue_run(odo, seq, start: int, stop: int) -> None:
    """Feed scans [start, stop) and the IMU after the filter clock to a
    restored driver, as `Odometry.run` would have."""
    imu = iter([r for r in seq.imu if r.t > odo.t_last_update])
    nxt = next(imu, None)
    for scan in seq.scans[start:stop]:
        while nxt is not None and nxt.t <= scan.end_time + 0.05:
            odo.feed_imu(nxt)
            nxt = next(imu, None)
        check(odo.process_scan(scan) is not None, "a resumed scan was not covered by IMU")


def resume_phase(seq, straight, straight_map) -> None:
    """20 scans, checkpoint, a fresh driver, 19 more: equal to the straight
    run of the stream phase (its first 39 poses and its map after scan 39)."""
    import numpy as np

    from eskf_lio_torch.pipeline.odometry import Odometry
    from eskf_lio_torch.utils import checkpoint

    config = stream_config()
    n_first, n_all = 20, len(seq.scans) - 1
    first = Odometry(config)
    first.run(seq, max_scans=n_first)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(path, first)
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        resumed = Odometry(config)
        t0 = time.perf_counter()
        checkpoint.load_checkpoint(path, resumed)
        load_s = time.perf_counter() - t0
    check(all(x.device.type == "cuda" for x in (*resumed.voxmap, *resumed.state)),
          "a restored tensor is not on the card")
    continue_run(resumed, seq, n_first, n_all)
    same_traj = (
        np.array_equal(np.stack(resumed.trajectory_p), np.stack(straight.trajectory_p[:n_all]))
        and np.array_equal(np.stack(resumed.trajectory_R), np.stack(straight.trajectory_R[:n_all]))
    )
    same_map = maps_bit_equal(resumed.voxmap, straight_map)
    print("resume " + json.dumps(dict(
        scans_before=n_first, scans_after=n_all - n_first, checkpoint_bytes=size,
        save_s=save_s, load_s=load_s, trajectory_bit_equal=same_traj, map_bit_equal=same_map,
    )))
    check(same_traj, "the resumed trajectory differs from the straight run's")
    check(same_map, "the resumed map differs from the straight run's")


HEAVY_YAML = """\
sensors:
  imu:
    intrinsics:
      parameters:
        gravity: [0.0, 0.0, -9.81]
kalman_filter:
  update:
    translation_noise: 1.0e-3
    rotation_noise: 3.0e-4
tpu:
  max_raw_points: 131072
  max_scan_points: 32768
  max_imu_per_scan: 64
  hash_capacity_log2: 19
"""


def cli_phase(kernels) -> dict:
    """The command line in process: --stream on 2 s of the synthetic
    simulator at HEAVY capacities, with every artifact it can write, the
    IMU prefix's launches held to the predict calls it made."""
    from eskf_lio_torch.pipeline import odometry

    # the overflow pre-advances, each one predict call beside the update scans'
    pre_advances, make_predict_only = [0], odometry.make_predict_only

    def counting_make_predict_only(*args, **kwargs):
        predict_only = make_predict_only(*args, **kwargs)

        def counted(*a):
            pre_advances[0] += 1
            return predict_only(*a)

        return counted

    odometry.make_predict_only = counting_make_predict_only
    try:
        return _cli_run(kernels, pre_advances)
    finally:
        odometry.make_predict_only = make_predict_only


def _cli_run(kernels, pre_advances) -> dict:
    from eskf_lio_torch import cli
    from eskf_lio_torch.bench import heavy_config
    from eskf_lio_torch.config import load_config
    from eskf_lio_torch.io import export

    with tempfile.TemporaryDirectory() as tmp:
        cfg, pcd, traj, ckpt = (os.path.join(tmp, n) for n in
                                ("heavy.yaml", "map.pcd", "traj.json", "ckpt"))
        with open(cfg, "w") as f:
            f.write(HEAVY_YAML)
        check(load_config(cfg) == heavy_config(), "the CLI phase's YAML is not HEAVY")
        for k in kernels:
            k.reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--config", cfg, "--synthetic", "2.0", "--points-per-scan", "120000",
                           "--stream", "--cloud-out", pcd, "--traj-out", traj,
                           "--checkpoint-out", ckpt])
        wall = time.perf_counter() - t0
        report = out.getvalue()
        for line in report.splitlines():
            print(f"  cli: {line}")
        check(rc == 0, f"the CLI returned {rc}")
        for want in ("step average elapsed time = ", "scans/s (streaming, threaded ingest)",
                     "map voxels = ", f"saved {pcd}", f"saved {traj}"):
            check(want in report, f"the CLI's report lacks {want!r}")
        voxels = int(report.split("map voxels = ")[1].split()[0])
        with open(pcd) as f:
            points = next(int(l.split()[1]) for l in f if l.startswith("POINTS"))
        poses = len(export.read_trajectory_json(traj)[0])
        res = dict(
            wall_s=wall, map_voxels=voxels, pcd_points=points, poses=poses,
            checkpoint_files=sorted(os.listdir(ckpt)),
            launches={k.name: k.launch_count() for k in kernels},
            pre_advances=pre_advances[0],
        )
        print("cli " + json.dumps(res))
        check(points == voxels > 1000, f"PCD POINTS {points} != map voxels {voxels}")
        check(poses == 19, f"{poses} poses for the 19 scans of 2 s")
        check(res["checkpoint_files"] == ["arrays.npz", "meta.pkl"], "no checkpoint written")
        check(res["launches"]["segscan"] == 2 * poses and res["launches"]["gn_normal_eq"] > 0
              and all(res["launches"][k] == per * res["launches"]["gn_normal_eq"]
                      for k, per in GN_PASS_LAUNCHES.items())
              and res["launches"]["preprocess"] == PRE_LAUNCHES * poses
              and res["launches"]["imu_prefix"] == poses - 1 + pre_advances[0],
              f"the CLI's run did not go through the kernels: {res['launches']} (the IMU "
              f"prefix once a scan after the first and once a pre-advance: {poses - 1} + "
              f"{pre_advances[0]})")
        return res["launches"]


# ---------------------------------------------------------------------------
# phase 5: the sharded map and the multi-process runtime
# ---------------------------------------------------------------------------

N_SHARDS = 4
MAX_SHARDED_VS_SINGLE_M = 0.02
MAX_DIST_VS_SHARDED_M = 1e-3
DIST_SCANS = 20
DIST_CHECKPOINT_AT = 10
DIST_TIMEOUT_S = 300


def slice_kernel_phase(dev, config, scan_points) -> dict:
    """Both kernels at the shapes a shard of a D = 4 map gives them, against
    their plain versions with the tolerances of the kernel phases."""
    import torch

    from eskf_lio_torch.ops import gn_normal_eq as gn
    from eskf_lio_torch.ops import segscan
    from eskf_lio_torch.parallel.sharded_map import slice_capacity

    n_a = slice_capacity(config.align_capacity, N_SHARDS, config.shard_slack)
    args = gn_inputs(n_a, 31, dev)
    out_k, out_p = gn.normal_equations_rotated(*args), gn.normal_equations_rotated_ref(*args)
    abs_a, rel_a = gn_rel_err(args, out_k, out_p)
    check(rel_a <= GN_TOL, "kernel A disagrees with its plain version at a shard's GN slice")
    check(int(out_k[2]) == int(args[5].sum()), "kernel A's count is wrong at a shard's GN slice")
    a = dict(
        n=n_a, max_abs_err=abs_a, rel_err=rel_a,
        call_ms=event_ms(lambda: gn.normal_equations_rotated(*args)),
        ms=device_ms(lambda: gn.normal_equations_rotated(*args)),
        plain_ms=device_ms(lambda: gn.normal_equations_rotated_ref(*args)),
        **bound(n_a * ((3 + 6 + 3 + 6) * 4 + 1) + 9 * 4 + 43 * 4,
                GN_FLOP_PER_POINT * int(args[5].sum())),
    )

    skey_s, raw_s, head, seg_id = insert_rows(dev, config, scan_points, N_SHARDS)
    n_b, w = raw_s.shape
    check(n_b == slice_capacity(config.max_scan_points, N_SHARDS, config.shard_slack),
          f"a shard's insert slice has {n_b} rows")
    out_b = segscan.segsum_sorted(skey_s, raw_s)
    out_r = segscan.segsum_sorted_ref(skey_s, raw_s)
    scale = segscan.segsum_sorted_ref(skey_s, raw_s.abs())
    diff = (out_b[head] - out_r[head]).abs()
    rel_b = (diff / scale[head].clamp(min=1e-30)).max().item()
    check(rel_b <= SEG_TOL, "kernel B disagrees with its plain version at a shard's insert slice")
    b = dict(
        n=n_b, w=w, voxels=int(head.sum()), max_abs_err=diff.max().item(), rel_err=rel_b,
        call_ms=event_ms(lambda: segscan.segsum_sorted(skey_s, raw_s)),
        ms=device_ms(lambda: segscan.segsum_sorted(skey_s, raw_s)),
        plain_ms=device_ms(lambda: segscan.segsum_sorted_ref(skey_s, raw_s)),
        library_ms=device_ms(lambda: torch.zeros_like(raw_s).index_add_(0, seg_id, raw_s)),
        **bound(n_b * 4 + 2 * n_b * w * 4, n_b * w),
    )
    res = {"gn_normal_eq": a, "segscan": b, "tolerance": {"gn": GN_TOL, "seg": SEG_TOL}}
    print("slice_shapes " + json.dumps(res))
    return res


def a_times(args) -> dict:
    """Kernel A's device time (torch.profiler), its wrapper's call time
    between CUDA events, its plain version's time and its bound, on `args`."""
    from eskf_lio_torch.ops import gn_normal_eq as gn

    n = args[0].shape[0]
    return dict(
        # the wrapper's call time first: a profiler run leaves host threads busy
        call_ms=event_ms(lambda: gn.normal_equations_rotated(*args)),
        ms=device_ms(lambda: gn.normal_equations_rotated(*args)),
        plain_ms=device_ms(lambda: gn.normal_equations_rotated_ref(*args)),
        library_ms=None,  # no single PyTorch call computes JᵀWJ/JᵀWr
        **bound(n * ((3 + 6 + 3 + 6) * 4 + 1) + 9 * 4 + 43 * 4,
                GN_FLOP_PER_POINT * int(args[5].sum())),
    )


def b_times(keys, vals, library) -> dict:
    """Kernel B's device time, call time, plain version's time and bound on
    (keys, vals), and the time of `library`, the one PyTorch call that
    computes the same sums (timed only as a yardstick)."""
    from eskf_lio_torch.ops import segscan

    n, w = vals.shape
    return dict(
        call_ms=event_ms(lambda: segscan.segsum_sorted(keys, vals)),
        ms=device_ms(lambda: segscan.segsum_sorted(keys, vals)),
        plain_ms=device_ms(lambda: segscan.segsum_sorted_ref(keys, vals)),
        library_ms=device_ms(library),
        # keys and values read once, [N, W] written once; one add per value
        **bound(n * 4 + 2 * n * w * 4, n * w),
    )


def segment_reduce_call(keys, vals):
    """`torch.segment_reduce` (sum by lengths) over the segments of sorted
    `keys`: kernel B's sums, compacted to one row a segment, checked
    against the kernel's head rows."""
    import torch

    from eskf_lio_torch.ops import segscan

    n = keys.shape[0]
    head = torch.ones(n, dtype=torch.bool, device=keys.device)
    head[1:] = keys[1:] != keys[:-1]
    starts = torch.nonzero(head)[:, 0]
    lengths = torch.diff(torch.cat([starts, torch.tensor([n], device=keys.device)]))
    lib = torch.segment_reduce(vals, "sum", lengths=lengths)
    scale = torch.segment_reduce(vals.abs(), "sum", lengths=lengths).clamp(min=1e-30)
    rel = ((lib - segscan.segsum_sorted(keys, vals)[starts]).abs() / scale).max().item()
    check(rel <= SEG_TOL, f"kernel B disagrees with torch.segment_reduce: {rel:.3e}")
    return lambda: torch.segment_reduce(vals, "sum", lengths=lengths)


def light_kernel_phase(dev) -> dict:
    """Both kernels at the shapes the bench's LIGHT series gives them,
    against their plain versions with the tolerances of the kernel phases:
    kernel B over a real LIGHT scan's moments at [24,576, 10] (the
    downsampler) and over its insert rows at [12,288, 10] (also against
    `index_add_`), kernel A at LIGHT's N = 12,288 align points.  Both of
    B's N are multiples of the tile rows, the case of kernel B's read past
    the end of its values."""
    import torch

    from eskf_lio_torch.bench import LIGHT, bench_sequence, make_config
    from eskf_lio_torch.config import Config
    from eskf_lio_torch.ops import gn_normal_eq as gn
    from eskf_lio_torch.ops import segscan

    config = make_config(LIGHT["max_raw_points"], LIGHT["max_scan_points"],
                         gn_backend=Config.gn_backend)
    seq = bench_sequence(2, LIGHT["points_per_scan"])
    scan = torch.as_tensor(seq.scans[1].points[: config.max_raw_points], device=dev)

    n_a = config.align_capacity
    args = gn_inputs(n_a, 41, dev)
    out_k, out_p = gn.normal_equations_rotated(*args), gn.normal_equations_rotated_ref(*args)
    abs_a, rel_a = gn_rel_err(args, out_k, out_p)
    print(f"kernel A [LIGHT] N={n_a}: max_abs_err={abs_a:.3e} rel_err={rel_a:.3e} tol={GN_TOL:g}")
    check(rel_a <= GN_TOL, "kernel A disagrees with its plain version at LIGHT's align budget")
    check(int(out_k[2]) == int(args[5].sum()) == int(out_p[2]),
          "kernel A's count is wrong at LIGHT's align budget")
    a = dict(n=n_a, max_abs_err=abs_a, rel_err=rel_a, **a_times(args))

    keys, vals = scan_moments(scan, config.max_raw_points, dev)
    n_d, w = vals.shape
    check((n_d, w) == (LIGHT["max_raw_points"], 10), f"LIGHT's moments are [{n_d}, {w}]")
    down = dict(n=n_d, w=w, max_abs_err=seg_compare(keys, vals, "LIGHT: real scan"),
                **b_times(keys, vals, segment_reduce_call(keys, vals)))

    skey_s, raw_s, head, seg_id = insert_rows(dev, config, scan)
    n_i = raw_s.shape[0]
    check(raw_s.shape == (LIGHT["max_scan_points"], 10), f"LIGHT's insert rows are {raw_s.shape}")
    abs_i = seg_compare(skey_s, raw_s, "LIGHT: insert rows")
    out_b = segscan.segsum_sorted(skey_s, raw_s)
    out_x = torch.zeros_like(raw_s).index_add_(0, seg_id, raw_s)
    scale = torch.zeros_like(raw_s).index_add_(0, seg_id, raw_s.abs())
    rows = seg_id[head]
    rel_x = ((out_b[head] - out_x[rows]).abs() / scale[rows].clamp(min=1e-30)).max().item()
    check(rel_x <= SEG_TOL, "kernel B disagrees with index_add_ at LIGHT's insert shape")
    ins = dict(n=n_i, w=w, voxels=int(head.sum()), max_abs_err=abs_i, rel_err_index_add=rel_x,
               **b_times(skey_s, raw_s,
                         lambda: torch.zeros_like(raw_s).index_add_(0, seg_id, raw_s)))
    res = {"gn_normal_eq": a, "segscan_downsample": down, "segscan_insert": ins,
           "tolerance": {"gn": GN_TOL, "seg": SEG_TOL}}
    print("light_shapes " + json.dumps(res))
    return res


PRE_LAUNCHES = 6  # the preprocessor's kernels' launches a scan (`preprocess.LAUNCHES`)
# the preprocessor's kernels: bytes each reads and writes once at N raw
# rows, K budget rows and M1 history rows (inputs through a permutation
# counted once, as the bound counts them)
PRE_KERNELS = ("key_deskew_kernel", "moments_kernel", "compact_kernel", "pass_z_kernel",
               "pass_y_kernel", "pass_x_kernel")


def preprocess_kernel_bytes(n: int, k: int, m1: int) -> dict:
    return {
        # points, times, mask; history, extrinsics -> key, offset
        "key_deskew_kernel": n * (12 + 4 + 1) + m1 * (4 + 12 + 16 + 1) + 48 + n * (4 + 12),
        # sorted key, permutation, offset -> moments, compaction key
        "moments_kernel": n * (4 + 8 + 12) + n * (40 + 4),
        # compaction key and permutation, packed key -> packed key
        "compact_kernel": k * (4 + 8 + 4) + k * 4,
        # key, two permutations, head sums -> moments, y key
        "pass_z_kernel": k * (4 + 8 + 8 + 40) + k * (40 + 4),
        # key, permutation, moments, packed key -> moments, x key
        "pass_y_kernel": k * (4 + 8 + 40 + 4) + k * (40 + 4),
        # key, four permutations, moments, packed key, offset -> points, covs, mask
        "pass_x_kernel": k * (4 + 8 + 40 + 8 + 4 + 8 + 8 + 8 + 12) + k * (12 + 36 + 1),
    }


def preprocess_shape(dev, cfg, seed: int, timed: bool = True) -> dict:
    """The preprocessor's kernels on a room sweep of `cfg.max_raw_points`
    raw points into `cfg.max_scan_points` rows with a 65-row state history,
    against the plain version on the card: the same mask and points bit for
    bit, covariances within 4 ulps of 1.  `timed`: also each kernel once a
    call, its device time, its bytes' bound and its share, the other
    kernels' (sorts', kernel B's) time, and the whole call's device and call
    time against the plain version's."""
    import torch

    from eskf_lio_torch.ops import preprocess as pre
    from eskf_lio_torch.utils import kernel_bounds

    n, k = cfg.max_raw_points, cfg.max_scan_points
    scan, hist, T_il = kernel_bounds.room_scan(n, seed, dev)
    run = lambda: pre.preprocess(scan, hist, T_il, cfg)
    plain = lambda: pre.preprocess_ref(scan, hist, T_il, cfg)
    launches = pre.KERNEL.launch_count()
    got = run()
    check(pre.KERNEL.launch_count() - launches == pre.LAUNCHES,
          f"preprocess N={n} K={k}: {pre.KERNEL.launch_count() - launches} launches counted, "
          f"not {pre.LAUNCHES}")
    want = plain()
    check(torch.equal(got.valid, want.valid) and torch.equal(got.points, want.points),
          f"the preprocessor's kernels disagree with the plain version's mask or points at "
          f"N={n} K={k}")
    cov_err = float((got.covs - want.covs).abs().max())
    print(f"preprocess kernels N={n} K={k}: {int(got.valid.sum())} points, "
          f"cov max_abs_err={cov_err:.3e}")
    check(cov_err <= 4 * 2.0**-23, f"the preprocessor's covariances are more than 4 ulps off "
          f"at N={n} K={k}")
    res = dict(n=n, k=k, points=int(got.valid.sum()), cov_max_abs_err=cov_err)
    if not timed:
        return res
    ms, by_name = device_profile(run)
    print_by_name(f"preprocess N={n}", by_name)
    kern = {}
    for name, n_bytes in preprocess_kernel_bytes(n, k, hist.t_rel.shape[0]).items():
        hits = [v for key, v in by_name.items() if name in key]
        check(len(hits) == 1 and hits[0]["per_call"] == 1,
              f"kernel {name}: {hits} launches a call, not one")
        b = bound(n_bytes, 0)
        kern[name] = dict(ms=hits[0]["ms"], bytes=n_bytes, **b,
                          share=b["bound_ms"] / hits[0]["ms"])
    others = {key: v["ms"] for key, v in by_name.items()
              if not any(name in key for name in PRE_KERNELS)}
    res.update(device_ms=ms, kernels=kern, kernels_ms=sum(v["ms"] for v in kern.values()),
               kernels_bound_ms=sum(v["bound_ms"] for v in kern.values()),
               other_device_ms=sum(others.values()), other_kernels=len(others),
               call_ms=event_ms(run), plain_device_ms=device_ms(plain),
               plain_call_ms=event_ms(plain))
    return res


def pre_row(shapes: dict) -> dict:
    """The preprocessor's row of the kernels line: the six kernels' device
    time, their bytes' bound, the whole call's time and the plain version's
    at HEAVY's shapes; the largest covariance error over every shape."""
    heavy = shapes["heavy"]
    return dict(max_abs_err=max(r["cov_max_abs_err"] for r in shapes.values()),
                ms=heavy["kernels_ms"], call_ms=heavy["call_ms"],
                plain_ms=heavy["plain_device_ms"], bound_ms=heavy["kernels_bound_ms"],
                bound_by="bytes",
                library_ms=None)  # no PyTorch call does the preprocessor's work


def preprocess_kernel_phase(dev, config, scan_points) -> dict:
    """The preprocessor's kernels against the plain version on the card at
    every shape a path of this script gives them: mid360's and LIGHT's
    (24,576 raw points into 12,288), HEAVY's (131,072 into 32,768: the
    replay, the streaming and sharded drivers, the CLI and the bench's HEAVY
    series), timed; `ate_matrix`'s budget48k (131,072 into 49,152); and the
    init step's path (no deskew) over a real HEAVY scan."""
    import torch

    from eskf_lio_torch.config import Config
    from eskf_lio_torch.ops import preprocess as pre
    from eskf_lio_torch.tools import ate_matrix

    res = {"mid360": preprocess_shape(dev, Config(max_raw_points=24576, max_scan_points=12288), 7),
           "heavy": preprocess_shape(dev, config, 11)}
    budget = dataclasses.replace(config, max_scan_points=ate_matrix.BUDGET_48K)
    res["budget48k"] = preprocess_shape(dev, budget, 13, timed=False)
    # padded to the raw budget with an invalid tail, as the replay packs it
    n = config.max_raw_points
    points = torch.zeros((n, 3), device=dev)
    points[: scan_points.shape[0]] = scan_points
    valid = torch.arange(n, device=dev) < scan_points.shape[0]
    launches = pre.KERNEL.launch_count()
    got = pre.downsample_and_covariances(points, valid, config)
    check(pre.KERNEL.launch_count() - launches == pre.LAUNCHES,
          "the init path's kernels were not launched six times")
    want = pre.downsample_and_covariances_ref(points, valid, config)
    check(torch.equal(got.valid, want.valid) and torch.equal(got.points, want.points),
          "the init path's kernels disagree with the plain version's mask or points at HEAVY")
    cov_err = float((got.covs - want.covs).abs().max())
    check(cov_err <= 4 * 2.0**-23, "the init path's covariances are more than 4 ulps off")
    res["init_heavy"] = dict(n=n, k=config.max_scan_points,
                             points=int(got.valid.sum()), cov_max_abs_err=cov_err)
    print("preprocess_shapes " + json.dumps(res))
    return res


# launches a GN pass on every unsharded path: kernel A, and the GN pass's
# lookup and increment kernels around it (one `gn_pass.KERNEL`, two launches)
GN_PASS_LAUNCHES = {"gn_normal_eq": 1, "gn_pass": 2}
# rows of the kernels line whose launches are counted with another kernel's
COUNTED_AS = {"gn_lookup": "gn_pass", "gn_increment": "gn_pass"}
# the replay configurations' align rows and map key splits
GN_PASS_SHAPES = {"mid360": (12288, (10, 10, 10)), "urban": (24576, (11, 11, 9))}


def gn_pass_map(dev, n: int, bits, seed: int):
    """A 2^19-row map (its main view 128 MiB, as the replay cells') holding
    a room's surfaces in both tiers, and `n` query rows on them with a
    0.9-valid mask: the lookup's inputs at a replay cell's shape."""
    import torch

    from eskf_lio_torch.map import voxel_map as vm
    from eskf_lio_torch.utils import kernel_bounds

    m = vm.VoxelMap.create(1 << 19, device=dev, key_bits=bits)
    scan, _, _ = kernel_bounds.room_scan(4 * n, seed, dev)
    pts = scan.points[scan.valid]
    half = pts.shape[0] // 2
    covs = torch.tensor([0.01, 0.0, 0.0, 0.01, 0.0, 0.01], device=dev).expand(pts.shape[0], 6)
    kw = dict(voxel_size=0.3, max_points_per_voxel=1000, key_bits=bits)
    ones = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
    m, _ = vm.insert(m, pts, covs.contiguous(), ones, **kw)
    m, _ = vm.compact(m, max_points_per_voxel=1000)
    m, _ = vm.insert(m, pts[:half] + 0.05, covs[:half].contiguous(), ones[:half], **kw)
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, pts.shape[0], (n,), device=dev, generator=g)
    q = (pts[idx] + (torch.rand((n, 3), device=dev, generator=g) - 0.5) * 0.04).contiguous()
    valid = torch.rand(n, device=dev, generator=g) < 0.9
    return m, q, valid


def graph_launch_ms(fn, launches: int = 20, replays: int = 20, flush=None) -> float:
    """Device ms a call of `fn` when `launches` calls are captured into one
    CUDA graph and the graph is replayed `replays` times between two CUDA
    events, as the main path's graph runs them (each call's node launch
    included).  torch.profiler drops some records of these kernels (46 of
    50 in every trace of one card run), so they are timed this way.  With
    `flush`, a call of it is captured before each call of `fn` and timed
    with it (`cold_graph_launch_ms` takes it out again)."""
    import torch

    if flush is not None:
        body = fn

        def fn():
            flush()
            body()

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # warm: no first use inside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / (replays * launches))
    return best


def cold_graph_launch_ms(fn, dev) -> float:
    """`graph_launch_ms` of `fn` with the L2 cache emptied of its data
    before each call: a read of 128 MiB (2.5 times the H100's 50 MB L2)
    captured before each call, its time alone taken out.  So each call
    reads its inputs from HBM, as a row's first GN pass does."""
    import torch

    junk = torch.ones(1 << 25, device=dev)  # 128 MiB
    flush = lambda: junk.sum()  # noqa: E731
    return (graph_launch_ms(fn, flush=flush) - graph_launch_ms(lambda: None, flush=flush))


def view_sectors(view, skey) -> int:
    """The 32-byte sectors of `view` that the lookup kernel reads for these
    skeys, each counted once: a probed bucket's eight skey words (one
    sector each) and a hit slot's second sector (payload words 8-11; words
    2-7 share the skey word's sector)."""
    import torch

    from eskf_lio_torch.map import voxel_map as vm

    slots, b = vm._probe_rows(view, skey)
    eq, lane, _ = vm._hit_slot(slots, skey)
    found = eq.any(dim=1) & (skey != vm.INT32_MAX)
    hit_slots = (b.to(torch.int64) * 8 + lane)[found]
    return 8 * torch.unique(b).numel() + torch.unique(hit_slots).numel()


def gn_pass_shape(dev, n: int, bits, seed: int) -> dict:
    """The lookup kernel against `voxel_map.lookup` (bit for bit on its own
    pts_w) and the increment kernel against its plain version, one launch a
    call each, timed beside their bound and their plain versions."""
    import torch

    from eskf_lio_torch.map import voxel_map as vm
    from eskf_lio_torch.ops import gn_normal_eq, gn_pass, lie

    m, q, valid = gn_pass_map(dev, n, bits, seed)
    R = lie.so3_exp(torch.tensor([0.01, -0.02, 0.015], device=dev))
    t = torch.tensor([0.05, -0.03, 0.02], device=dev)
    kw = dict(voxel_size=0.3, max_points_per_voxel=1000, key_bits=bits)
    before = gn_pass.KERNEL.launch_count()
    pts_w, mu, cov, mask = gn_pass.lookup(q, valid, R, t, m, **kw)
    check(gn_pass.KERNEL.launch_count() - before == 1, "the lookup is not one launch a call")
    want = vm.lookup(m, pts_w, **kw)
    same = (torch.equal(pts_w, lie.transform_points(R, t, q))
            and torch.equal(mu.view(torch.int32), want[0].contiguous().view(torch.int32))
            and torch.equal(cov.view(torch.int32), want[1].contiguous().view(torch.int32))
            and torch.equal(mask, valid & want[2]))
    check(same, f"the lookup kernel disagrees with voxel_map.lookup at N={n} {bits}")
    hits = int(want[2].sum())
    # the bytes a call must bring from HBM: per row the point and mask read,
    # pts_w, mu, covariance and mask written; each sector of both views that
    # some row reads, once (rows of one scan share buckets)
    skey = vm.sm.skey_of(vm.sm.pack_keys(vm.vx.voxel_key(pts_w, 0.3), m.origin, bits)[0])
    sectors = view_sectors(m.view, skey) + view_sectors(m.d_view, skey)
    lookup_bytes = n * (12 + 1 + 12 + 12 + 24 + 1) + 32 * sectors
    run = lambda: gn_pass.lookup(q, valid, R, t, m, **kw)  # noqa: E731
    plain = lambda: gn_pass.lookup_ref(q, valid, R, t, m, **kw)  # noqa: E731
    call_ms = event_ms(run)
    # warm: the graph's calls read the same rows, so the views' sectors stay
    # in L2 after the first, as in a row's later GN passes; cold: L2 emptied
    # before each call, as in a row's first pass.  The bound (HBM rate) is
    # held against the cold time.
    ms = graph_launch_ms(run)
    cold_ms = cold_graph_launch_ms(run, dev)
    b = bound(lookup_bytes, 0)
    lookup = dict(n=n, key_bits=list(bits), hits=hits, max_abs_err=0.0, ms=ms, cold_ms=cold_ms,
                  call_ms=call_ms, plain_ms=device_ms(plain), bytes=lookup_bytes,
                  view_sectors=sectors, **b, share=b["bound_ms"] / cold_ms, library_ms=None)
    # the increment on kernel A's system of these rows
    covs = torch.tensor([0.01, 0.0, 0.0, 0.01, 0.0, 0.01], device=dev).expand(n, 6).contiguous()
    JTJ, JTr, num = gn_normal_eq.normal_equations_rotated(pts_w, covs, R, mu, cov, mask)
    thr = dict(max_iterations=30, cosine_threshold=0.9999, translation_sq_threshold=1e-6)
    it = torch.tensor(2, device=dev)
    got = gn_pass.increment(JTJ, JTr, num, R, t, it, deltas=True, **thr)
    ref = gn_pass.increment_ref(JTJ, JTr, num, R, t, it, deltas=True, **thr)
    err = max(float((a.float() - b_.float()).abs().max()) for a, b_ in zip(got, ref))
    size = float((ref[6] - torch.eye(3, device=dev)).abs().max() + ref[7].abs().max())
    print(f"gn_increment N={n}: max_abs_err={err:.3e} against the plain version "
          f"(increment size {size:.3e}), iterations {int(got[1])} / {int(ref[1])}")
    check(err == 0.0 and int(got[1]) == int(ref[1]) and bool(got[2]) == bool(ref[2]),
          f"the increment kernel is not its plain version's bits at N={n}")
    run = lambda: gn_pass.increment(JTJ, JTr, num, R, t, it, **thr)  # noqa: E731
    plain = lambda: gn_pass.increment_ref(JTJ, JTr, num, R, t, it, **thr)  # noqa: E731
    call_ms = event_ms(run)
    ms = graph_launch_ms(run)
    # JTJ, JTr, count, R, t, it read; the carry and the deltas written
    inc_bytes = 4 * (36 + 6 + 1 + 9 + 3) + 8 + (1 + 8 + 1 + 4 * (9 + 3 + 1))
    b = bound(inc_bytes, 0)
    increment = dict(max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=device_ms(plain),
                     bytes=inc_bytes, **b, share=b["bound_ms"] / ms, library_ms=None)
    print(f"gn_pass N={n} {bits}: lookup {lookup['ms']:.5f} ms warm, {lookup['cold_ms']:.5f} "
          f"cold (plain {lookup['plain_ms']:.4f}, bound {lookup['bound_ms']:.5f}, "
          f"{lookup['share']:.1%} of cold), increment "
          f"{increment['ms']:.5f} ms (plain {increment['plain_ms']:.4f})")
    return {"lookup": lookup, "increment": increment}


def gn_pass_kernel_phase(dev) -> dict:
    """The GN pass's lookup and increment kernels at the replay cells'
    shapes: mid360's 12,288 align rows under the (10, 10, 10) key split
    and urban's 24,576 under (11, 11, 9), over a 2^19-row map; each
    kernel's time in a captured graph beside an empty kernel's there."""
    from eskf_lio_torch.ops import gn_normal_eq, gn_pass

    gn_pass.reserve_capture(dev)
    empty = graph_launch_ms(lambda: gn_normal_eq.launch_empty_kernel(dev))
    print(f"empty <<<1,32>>> kernel in a captured graph: {empty:.5f} ms a launch")
    res = {"empty_launch_in_graph_ms": empty}
    res |= {name: gn_pass_shape(dev, n, bits, 17 + i)
           for i, (name, (n, bits)) in enumerate(GN_PASS_SHAPES.items())}
    print("gn_pass_shapes " + json.dumps(res))
    return res


PREDICT_SHAPES = {"mid360": 64, "urban": 32}  # M of each cell's chunks


def predict_kernel_phase(dev) -> dict:
    """The IMU prefix's kernel at the replay cells' chunk lengths, on rows
    recorded from their generators: bit for bit against the plain chain,
    one launch a call, and each timed in a captured graph beside the chain
    captured the same way and an empty kernel there."""
    import numpy as np
    import torch

    from eskf_lio_torch.models import eskf
    from eskf_lio_torch.ops import gn_normal_eq, imu_prefix
    from eskf_lio_torch.types import FilterState, ImuChunk

    imu_prefix.reserve_capture(dev)
    data = np.load(ROOT / "tests" / "data" / "imu_prefix_chunks.npz")
    empty = graph_launch_ms(lambda: gn_normal_eq.launch_empty_kernel(dev))
    res = {"empty_launch_in_graph_ms": empty}
    for name, m in PREDICT_SHAPES.items():
        state = FilterState(*(torch.as_tensor(data[f"{name}.0.state.{f}"], device=dev)
                              for f in FilterState._fields))
        chunk = ImuChunk(*(torch.as_tensor(data[f"{name}.0.chunk.{f}"], device=dev)
                           for f in ImuChunk._fields))
        check(chunk.dt.shape[0] == m, f"{name}: a recorded chunk of {chunk.dt.shape[0]} samples")
        q_diag = torch.as_tensor(data[f"{name}.q_diag"], device=dev)
        base_mask = chunk.t_rel <= 0.0
        before = imu_prefix.KERNEL.launch_count()
        got = imu_prefix.imu_prefix(state, chunk, q_diag, base_mask)
        torch.cuda.synchronize()
        launches = imu_prefix.KERNEL.launch_count() - before
        want = eskf.imu_prefix_ref(state, chunk, q_diag, base_mask)
        pairs = [(got[0].P, want[0].P), (got[0].p, want[0].p), (got[0].v, want[0].v),
                 (got[0].q, want[0].q), (got[1].p, want[1].p), (got[1].q, want[1].q),
                 (got[1].t_rel, want[1].t_rel), (got[1].valid, want[1].valid)]
        equal = all(torch.equal(x, y) if x.dtype == torch.bool else
                    torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in pairs)
        err = max(float((x - y).abs().max()) for x, y in pairs if x.dtype != torch.bool)
        run = lambda: imu_prefix.imu_prefix(state, chunk, q_diag, base_mask)  # noqa: E731
        plain = lambda: eskf.imu_prefix_ref(state, chunk, q_diag, base_mask)  # noqa: E731
        ms = graph_launch_ms(run)
        res[name] = dict(
            m=m, bit_equal=equal, launches_a_call=launches, ms=ms, plain_ms=graph_launch_ms(plain),
            call_ms=event_ms(run),
            # latency: ~0.2 M fmas at M = 64 (the transitions' pattern) on one SM in
            # dependent rounds, bytes ~10 KB
            bound_ms=None, bound_by="latency", max_abs_err=err, library_ms=None, cold_ms=None)
        print(f"imu_prefix M={m} ({name}): {ms:.5f} ms a launch in a captured graph (plain "
              f"chain {res[name]['plain_ms']:.4f}, empty kernel {empty:.5f}), bit-equal {equal}, "
              f"{launches} launch a call")
        check(equal, f"imu_prefix at M={m}: the kernel's bits differ from the plain chain's")
        check(launches == imu_prefix.LAUNCHES, f"imu_prefix at M={m}: {launches} launches a call")
    print("predict_shapes " + json.dumps(res))
    return res


def tool_kernel_phase(dev, config, scan_points) -> dict:
    """Both kernels at the shapes the tools (`eskf_lio_torch/tools/`) give
    them and no other path does, against their plain versions with the
    tolerances of the kernel phases: kernel A at `probe_align_parts`'s
    N = 32,768; kernel B over a real scan's insert rows under `ate_matrix`'s
    `budget48k` budget ([49,152, 10], a multiple of the tile rows; also
    against `index_add_`), and over `profile_preprocess`'s input at
    [131,072, 10], its keys nearly all distinct (also against
    `torch.segment_reduce`)."""
    import torch

    from eskf_lio_torch.ops import gn_normal_eq as gn
    from eskf_lio_torch.ops import segscan
    from eskf_lio_torch.tools import ate_matrix, probe_align_parts, profile_preprocess as pp

    args = gn_inputs(probe_align_parts.N, 51, dev)
    out_k, out_p = gn.normal_equations_rotated(*args), gn.normal_equations_rotated_ref(*args)
    abs_a, rel_a = gn_rel_err(args, out_k, out_p)
    print(f"kernel A [probe_align_parts] N={probe_align_parts.N}: max_abs_err={abs_a:.3e} "
          f"rel_err={rel_a:.3e} tol={GN_TOL:g}")
    check(rel_a <= GN_TOL, "kernel A disagrees with its plain version at N = 32,768")
    check(int(out_k[2]) == int(args[5].sum()) == int(out_p[2]),
          "kernel A's count is wrong at N = 32,768")
    a = dict(n=probe_align_parts.N, max_abs_err=abs_a, rel_err=rel_a, **a_times(args))

    budget = dataclasses.replace(config, max_scan_points=ate_matrix.BUDGET_48K)
    skey_s, raw_s, head, seg_id = insert_rows(dev, budget, scan_points)
    check(raw_s.shape == (ate_matrix.BUDGET_48K, 10), f"budget48k's insert rows are {raw_s.shape}")
    abs_i = seg_compare(skey_s, raw_s, "budget48k: insert rows")
    out_b = segscan.segsum_sorted(skey_s, raw_s)
    out_x = torch.zeros_like(raw_s).index_add_(0, seg_id, raw_s)
    scale = torch.zeros_like(raw_s).index_add_(0, seg_id, raw_s.abs())
    rows = seg_id[head]
    rel_x = ((out_b[head] - out_x[rows]).abs() / scale[rows].clamp(min=1e-30)).max().item()
    check(rel_x <= SEG_TOL, "kernel B disagrees with index_add_ at budget48k's insert shape")
    ins = dict(n=raw_s.shape[0], w=10, voxels=int(head.sum()), max_abs_err=abs_i,
               rel_err_index_add=rel_x,
               **b_times(skey_s, raw_s,
                         lambda: torch.zeros_like(raw_s).index_add_(0, seg_id, raw_s)))

    inp = pp.make_inputs(pp.N_RAW, pp.KCAP, pp.C_LOG2, dev)
    keys, vals = inp["skey_sorted"], inp["vals10"]
    del inp
    rnd = dict(n=keys.shape[0], w=vals.shape[1],
               segments=int((keys[1:] != keys[:-1]).sum()) + 1,
               max_abs_err=seg_compare(keys, vals, "profile_preprocess: random keys"),
               **b_times(keys, vals, segment_reduce_call(keys, vals)))
    res = {"gn_normal_eq_32k": a, "segscan_insert_48k": ins, "segscan_random_keys_131k": rnd,
           "tolerance": {"gn": GN_TOL, "seg": SEG_TOL}}
    print("tool_shapes " + json.dumps(res))
    return res


def distinct_voxels(voxmap) -> int:
    """Distinct live keys over both tiers (`num_voxels()` assumes one
    globally sorted main tier, which concatenated blocks are not)."""
    import torch

    from eskf_lio_torch.ops import sortmerge as sm

    keys = torch.cat([voxmap.skey, voxmap.d_skey])
    return int(torch.unique(keys[keys != sm.INT32_MAX]).numel())


def point_mass(voxmap) -> float:
    return float(voxmap.payload[:, 0].sum() + voxmap.d_payload[:, 0].sum())


def graphs_captured(step) -> dict:
    """A captured sharded step's graphs (with and without the eviction):
    capture seconds, nodes, and the nodes of the GN loop's WHILE body by
    type (`csrc/graph_cond.cu` reads them through the graph API)."""
    return {
        f"update{'_evict' if e else ''}": {
            "capture_s": g.capture_s, "nodes": g.nodes,
            "while_body": next({"nodes": b["nodes"], "by_type": b["by_type"]}
                               for b in g.bodies if b["kind"] == "while" and b["depth"] == 0),
        }
        for e, g in step.graphs.items() if g.graph is not None
    }


def time_steps(odo, spans: list) -> None:
    """Put the driver's scan step between two CUDA events a call; `spans`
    gets the pairs, read after the run (no wait inside it)."""
    import torch

    inner = odo.scan_step

    def timed(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args)
        end.record()
        spans.append((start, end))
        return out

    odo.scan_step = timed


def sharded_phase(seq, kernels, single, slices):
    """`ShardedOdometry(n_devices=4)` in this process beside the
    single-device run of the stream phase (`single`, the same config and
    sequence): twice on its captured step (the default without a process
    group) and once on the eager sharded step; `slices` is what
    `slice_kernel_phase` measured."""
    import numpy as np
    import torch

    from eskf_lio_torch.map import voxel_map as vm
    from eskf_lio_torch.ops import sortmerge as sm
    from eskf_lio_torch.ops import voxel as vx
    from eskf_lio_torch.parallel.sharded_map import (
        GraphedShardedScanStep, ShardedOdometry, make_sharded_scan_step,
    )

    config = stream_config()
    first = ShardedOdometry(config, n_devices=N_SHARDS)  # the default device is the card
    check(first.device.type == "cuda", "ShardedOdometry did not default to the card")
    check(first.graphed and isinstance(first.scan_step, GraphedShardedScanStep),
          f"the sharded driver without a process group is not graphed: {first.step_reason}")
    check(len(first.voxmap.blocks) == N_SHARDS
          and first.voxmap.blocks[0].capacity == config.hash_capacity // N_SHARDS,
          "the map was not cut into four blocks of 2^19 / 4 slots")
    step, spans = first.scan_step, []
    time_steps(first, spans)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res_1, _ = drive(lambda cb: first.run(seq, on_scan=cb), first, kernels, seq,
                     n_shards=N_SHARDS)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # the median: the span of a call that captures a graph (the eviction's,
    # inside the warm half) holds the capture's host time, the stream idle
    warm = spans[len(spans) // 2:]
    device_ms = float(np.median([s.elapsed_time(e) for s, e in warm]))
    captured = graphs_captured(step)
    # the step writes its blocks in place: keep a copy of this run's map
    first_map = [vm.VoxelMap(*(x.clone() for x in b)) for b in first.voxmap.blocks]

    again = ShardedOdometry(config, n_devices=N_SHARDS)
    res_2, _ = drive(lambda cb: again.run(seq, on_scan=cb), again, kernels, seq,
                     n_shards=N_SHARDS, count_syncs=True)
    # the same driver on the eager sharded step
    eager = ShardedOdometry(config, n_devices=N_SHARDS)
    eager_step, last_call = make_sharded_scan_step(config, eager.mesh), {}

    def keep_last_call(*args):
        last_call["args"] = args
        return eager_step(*args)

    eager.scan_step = keep_last_call
    res_e, _ = drive(lambda cb: eager.run(seq, on_scan=cb), eager, kernels, seq,
                     n_shards=N_SHARDS, count_syncs=True)
    # where the eager step's time goes: its last scan five more times (the
    # eager step is a function of its arguments; it builds new tensors)
    n_prof = 5
    profiled = trace_scans(lambda: [eager_step(*last_call["args"]) for _ in range(n_prof)],
                           n_prof, res_e["avg_step_ms"])
    print("sharded_profile " + json.dumps(profiled))

    def same_run(other):
        return (
            np.array_equal(np.stack(first.trajectory_p), np.stack(other.trajectory_p))
            and np.array_equal(np.stack(first.trajectory_R), np.stack(other.trajectory_R))
            and all(maps_bit_equal(x, y) for x, y in zip(first_map, other.voxmap.blocks))
        )

    twice_bits, eager_bits = same_run(again), same_run(eager)

    # the same driver with the IMU prefix as the plain chain, as before its
    # kernel: the kernel gives the chain's bits, so the same trajectory
    from eskf_lio_torch.models import eskf

    kernel_predict = eskf.predict_chunk_prefix
    eskf.predict_chunk_prefix = lambda state, chunk, noise, base_mask=None: (
        eskf.imu_prefix_ref(state, chunk, noise.q_diag, base_mask))
    try:
        chain = ShardedOdometry(config, n_devices=N_SHARDS)
        chain.run(seq)
        torch.cuda.synchronize()
    finally:
        eskf.predict_chunk_prefix = kernel_predict
    chain_bits = same_run(chain)

    # every live key of block d, in both tiers, is owned by shard d
    foreign = 0
    for d, block in enumerate(first_map):
        for skey in (block.skey, block.d_skey):
            live = skey[skey != sm.INT32_MAX]
            keys = sm.unpack_keys(sm.packed_of_skey(live), block.origin, config.map_key_bits)
            foreign += int((vx.owner_hash(keys, N_SHARDS) != d).sum())
    whole = vm.VoxelMap(*(torch.cat(fields) for fields in zip(*first_map)))
    whole = whole._replace(origin=first_map[0].origin)
    voxels = (distinct_voxels(whole), distinct_voxels(single.voxmap))
    mass = (point_mass(whole), point_mass(single.voxmap))
    apart_m = float(np.linalg.norm(first.positions - single.positions, axis=1).max())

    res = dict(
        shards=N_SHARDS, shard_slots=first_map[0].capacity,
        gn_slice_rows=slices["gn_normal_eq"]["n"], insert_slice_rows=slices["segscan"]["n"],
        step=first.step_reason, first=res_1,
        graph=dict(scans_per_s=res_1["scans_per_s"], second_scans_per_s=res_2["scans_per_s"],
                   warm_half_scans_per_s=res_1["warm_half_scans_per_s"],
                   device_ms_per_scan_median=device_ms, graphs=captured, peak_mem_gib=peak_gib,
                   device_syncs_per_scan=res_2["device_syncs_per_scan"],
                   sync_sites_per_scan=res_2["sync_sites_per_scan"],
                   launches=res_1["launches"]),
        eager=dict(scans_per_s=res_e["scans_per_s"],
                   warm_half_scans_per_s=res_e["warm_half_scans_per_s"],
                   device_syncs_per_scan=res_e["device_syncs_per_scan"],
                   sync_sites_per_scan=res_e["sync_sites_per_scan"],
                   launches=res_e["launches"],
                   launches_per_scan=profiled["launches_per_scan"],
                   busy_ms_per_scan=profiled["busy_ms_per_scan"],
                   idle_share=profiled["idle_share"]),
        single_device_scans_per_s=single.summary()["scans_per_sec"],
        max_distance_from_single_device_m=apart_m,
        distinct_voxels={"sharded": voxels[0], "single": voxels[1]},
        point_mass={"sharded": mass[0], "single": mass[1]},
        foreign_keys=foreign, graph_twice_bit_equal=twice_bits,
        graph_equals_eager_bitwise=eager_bits, graph_equals_plain_chain_bitwise=chain_bits,
    )
    print("sharded " + json.dumps(res))
    check(res_1["scans"] == len(seq.scans), f"the sharded driver processed {res_1['scans']} scans")
    check(apart_m <= MAX_SHARDED_VS_SINGLE_M,
          f"sharded positions {apart_m:.4f} m from the single-device run's")
    check(res_1["max_gn_slice_overflow"] == 0 and res_1["max_insert_slice_overflow"] == 0,
          "an owner slice overflowed")
    check(bool(res_1["evictions"]), "no eviction removed a voxel inside the sharded step")
    check(foreign == 0, f"{foreign} live keys lie in a block that does not own them")
    check(abs(voxels[0] - voxels[1]) <= 0.02 * voxels[1], f"distinct voxels diverged: {voxels}")
    check(abs(mass[0] - mass[1]) <= 0.02 * mass[1], f"point mass diverged: {mass}")
    check(twice_bits, "two runs of the graphed sharded driver differ in their bits")
    check(eager_bits, "the graphed and the eager sharded step differ in their bits")
    check(chain_bits, "the sharded step with the IMU prefix's kernel and with the plain chain "
                      "differ in their bits")
    check(res_2["device_syncs_per_scan"] <= MAX_STREAM_SYNCS_PER_SCAN,
          f"the graphed sharded driver waited for the device {res_2['device_syncs_per_scan']:.2f} "
          f"times a scan (at most {MAX_STREAM_SYNCS_PER_SCAN})")
    return first, {"sharded": res_1["launches"], "sharded_eager": res_e["launches"]}, res


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_cli_processes(jobs: dict) -> dict:
    """Start every (name -> argv of `python -m eskf_lio_torch.cli`) together,
    wait for each under a timeout, kill what is left.  Returns name ->
    stdout; a process that fails or hangs fails the smoke."""
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = {
        name: subprocess.Popen(
            [sys.executable, "-m", "eskf_lio_torch.cli", *argv], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for name, argv in jobs.items()
    }
    out, deadline = {}, time.perf_counter() + DIST_TIMEOUT_S
    try:
        for name, p in procs.items():
            try:
                stdout, stderr = p.communicate(timeout=max(deadline - time.perf_counter(), 1.0))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"process {name} did not end within {DIST_TIMEOUT_S} s")
            check(p.returncode == 0, f"process {name} exited {p.returncode}:\n{stderr[-3000:]}")
            out[name] = stdout
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def all_reduce_report(stdout: str) -> dict:
    """The command line's own count of its all-reduces (a multi-process run
    prints it): calls, and host ms per call in all and inside the backend."""
    found = re.search(r"all-reduce: (\d+) calls, ([\d.]+) ms per call on the host "
                      r"\(([\d.]+) ms in the backend\)", stdout)
    check(found is not None, "a process did not report its all-reduces")
    return dict(calls=int(found[1]), ms_per_call=float(found[2]),
                backend_ms_per_call=float(found[3]))


def dist_phase(seq, sharded) -> dict:
    """Two processes of the command line, two shards each, both on the one
    card (`gloo`), against the one-process run of the sharded phase."""
    import numpy as np

    from eskf_lio_torch.bench import heavy_config
    from eskf_lio_torch.config import load_config
    from eskf_lio_torch.io import dataset, export
    from eskf_lio_torch.parallel.sharded_map import ShardedOdometry

    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)

        with open(path("heavy.yaml"), "w") as f:
            f.write(HEAVY_YAML)
        check(load_config(path("heavy.yaml")) == heavy_config(), "the dist phase's YAML is not HEAVY")
        # the sequence's first scans as files: all of them, and those after
        # the checkpoint for the resumed run (a driver drops the IMU samples
        # before its filter clock)
        t0 = time.perf_counter()
        cut = dataclasses.replace(seq, scans=seq.scans[:DIST_SCANS])
        dataset.save_npz(path("all.npz"), cut)
        dataset.save_npz(path("rest.npz"),
                         dataclasses.replace(seq, scans=seq.scans[DIST_CHECKPOINT_AT:DIST_SCANS]))
        write_s = time.perf_counter() - t0

        def argv(tag, i, port, *more):
            return ["--config", path("heavy.yaml"), "--devices", str(N_SHARDS),
                    "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                    "--process-id", str(i), "--traj-out", path(f"{tag}{i}.json"),
                    "--cloud-out", path(f"{tag}{i}.pcd"),
                    "--checkpoint-out", path(f"{tag}{i}.ckpt"), *more]

        # the straight run and the run that stops at the checkpoint, together
        ports = free_port(), free_port()
        t0 = time.perf_counter()
        outs = run_cli_processes({
            **{f"straight{i}": argv("straight", i, ports[0], "--input", path("all.npz"))
               for i in range(2)},
            **{f"head{i}": argv("head", i, ports[1], "--input", path("all.npz"),
                                "--max-scans", str(DIST_CHECKPOINT_AT)) for i in range(2)},
        })
        first_s = time.perf_counter() - t0
        port = free_port()
        t0 = time.perf_counter()
        outs.update(run_cli_processes({
            f"resumed{i}": argv("resumed", i, port, "--input", path("rest.npz"),
                                "--resume-from", path("head0.ckpt")) for i in range(2)
        }))
        resumed_s = time.perf_counter() - t0
        for line in outs["straight0"].splitlines():
            print(f"  dist process 0: {line}")

        for i in range(2):
            check(f"distributed: process {i}/2" in outs[f"straight{i}"],
                  f"process {i} did not join a group of two")
            check("scan step: eager: a gloo process group" in outs[f"straight{i}"],
                  f"process {i} did not report its scan step as eager under gloo")
        wrote_1 = [n for n in os.listdir(tmp) if n.split(".")[0] in ("straight1", "head1", "resumed1")]
        check(not wrote_1, f"process 1 wrote {wrote_1}")

        _, Rs, ps = export.read_trajectory_json(path("straight0.json"))
        positions = np.asarray(ps, np.float32)
        check(len(positions) == DIST_SCANS, f"{len(positions)} poses for {DIST_SCANS} scans")
        # the same four shards in one process, on the same file and config
        one = ShardedOdometry(heavy_config(), n_devices=N_SHARDS)  # graphed: no group
        one.run(dataset.load_npz(path("all.npz")))
        apart_m = float(np.linalg.norm(positions - one.positions, axis=1).max())
        from_memory_m = float(np.linalg.norm(
            positions - sharded.positions[:DIST_SCANS], axis=1).max())
        _, Rs_r, ps_r = export.read_trajectory_json(path("resumed0.json"))
        resumed_equal = (np.array_equal(np.asarray(ps_r), np.asarray(ps))
                         and np.array_equal(np.asarray(Rs_r), np.asarray(Rs)))
        with np.load(path("straight0.ckpt/arrays.npz")) as z:
            keys = np.concatenate([z["voxmap_1"], z["voxmap_4"]])
            voxels = len(np.unique(keys[keys != np.iinfo(np.int32).max]))
        with open(path("straight0.pcd")) as f:
            points = next(int(l.split()[1]) for l in f if l.startswith("POINTS"))
        res = dict(
            processes=2, shards=N_SHARDS, backend="gloo", scans=DIST_SCANS,
            step=next(l for l in outs["straight0"].splitlines() if l.startswith("scan step:")),
            one_process_step=one.step_reason, max_distance_from_one_process_m=apart_m,
            max_distance_from_the_sharded_phase_m=from_memory_m,
            resumed_equals_straight=resumed_equal,
            distinct_voxels=voxels, pcd_points=points,
            # per GN iteration and once per scan; the straight run shared the
            # host with the run that stopped at the checkpoint (four
            # processes), the resumed run had it to itself (two)
            all_reduce={"four_processes_at_once": all_reduce_report(outs["straight0"]),
                        "two_processes": all_reduce_report(outs["resumed0"])},
            reported_scans_per_s=float(outs["straight0"].split("throughput = ")[1].split()[0]),
            sequence_files_s=write_s, four_processes_wall_s=first_s,
            two_processes_resumed_wall_s=resumed_s,
        )
        print("dist " + json.dumps(res))
        check(apart_m <= MAX_DIST_VS_SHARDED_M,
              f"two processes are {apart_m:.5f} m from the one-process sharded run")
        check(from_memory_m <= MAX_SHARDED_VS_SINGLE_M,
              f"two processes on the file are {from_memory_m:.4f} m from the sharded phase's run")
        check(points == voxels > 1000, f"PCD POINTS {points} != distinct voxels {voxels}")
        check(resumed_equal, "the resumed two-process run differs from the straight one")
        check(res["all_reduce"]["four_processes_at_once"]["calls"] > DIST_SCANS,
              "the run made no all-reduce per GN iteration")
        return res


def staged_phase(seq, kernels, sharded) -> dict:
    """What the process group adds to a scan, counted in this process: the
    sharded driver under a `gloo` group of one process that is told it shares
    its card (so its all-reduces are staged through the host, as the dist
    phase's are), with the device syncs counted by calling line."""
    import numpy as np
    import torch

    from eskf_lio_torch.parallel import distributed as dist
    from eskf_lio_torch.parallel.sharded_map import ShardedOdometry

    check(dist.initialize(f"127.0.0.1:{free_port()}", 1, 0, processes_per_host=2,
                          timeout_s=60.0) == (1, 0), "a group of one process did not form")
    try:
        backend = torch.distributed.get_backend()
        check(backend == "gloo", f"a process that shares its card took {backend}")
        odo = ShardedOdometry(stream_config(), n_devices=N_SHARDS)
        check(not odo.graphed and "gloo" in odo.step_reason,
              f"the sharded driver under a gloo group is not eager: {odo.step_reason}")
        dist.ALL_REDUCE.reset()
        run, _ = drive(lambda cb: odo.run(seq, max_scans=RERUN_SCANS, on_scan=cb), odo, kernels,
                       seq, n_shards=N_SHARDS, count_syncs=True)
        stats = dataclasses.asdict(dist.ALL_REDUCE)
    finally:
        dist.shutdown(wait=False)
    same_bits = np.array_equal(odo.positions, sharded.positions[:RERUN_SCANS])
    res = dict(
        backend=backend, world_size=1, step=odo.step_reason, scans=RERUN_SCANS,
        gn_iterations=run["gn_iterations"],
        all_reduce_calls=stats["calls"],
        all_reduce_ms_per_call=1e3 * stats["seconds"] / max(stats["calls"], 1),
        all_reduce_backend_ms_per_call=1e3 * stats["backend_seconds"] / max(stats["calls"], 1),
        device_syncs_per_scan=run["device_syncs_per_scan"],
        sync_sites_per_scan=run["sync_sites_per_scan"], scans_per_s=run["scans_per_s"],
        equals_the_run_without_a_group=same_bits,
    )
    print("staged " + json.dumps(res))
    # one all-reduce per GN iteration, one per update scan, one for the init scan
    check(stats["calls"] == run["gn_iterations"] + RERUN_SCANS,
          f"{stats['calls']} all-reduces for {run['gn_iterations']} GN iterations "
          f"and {RERUN_SCANS} scans")
    check(same_bits, "a group of one process (eager) differs from the graphed run without one")
    return res


def nccl_in_body(dev) -> dict:
    """What NCCL's own work becomes inside a WHILE body on this card: a loop
    of three passes whose body adds one to a 43-float buffer and then runs
    nothing more (`none`), the in-place all-reduce of the buffer
    (`all_reduce`, as the sharded step's `reduce_fn` does), or an all-gather
    of it into another buffer (`all_gather`, which NCCL serves with a copy of
    its own for one rank).  Each case's body nodes by type, and whether a
    replay gave the loop's values."""
    import torch

    from eskf_lio_torch.utils import graphs

    res = {}
    for op in ("none", "all_reduce", "all_gather"):
        x = torch.zeros(43, device=dev)
        got = torch.zeros(43, device=dev)
        k = torch.zeros((), dtype=torch.int32, device=dev)

        def fn():
            def body(c):
                _, n, y, g = c
                y = y + 1.0
                if op == "all_reduce":
                    torch.distributed.all_reduce(y)
                g = g.clone()
                if op == "all_gather":
                    torch.distributed.all_gather_into_tensor(g, y)
                return n + 1 < 3, n + 1, y, g

            out = graphs.device_while(
                body, (torch.ones((), dtype=torch.bool, device=dev), k, x, got), 10)
            graphs.assign((k, x, got), out[1:])

        g = graphs.StepGraph(fn, dev, 1024)
        g()
        torch.cuda.synchronize()
        want_got = 3.0 if op == "all_gather" else 0.0
        body = next(b for b in g.bodies if b["kind"] == "while")
        res[op] = {"nodes": body["nodes"], "by_type": body["by_type"],
                   "values_ok": int(k) == 3 and bool((x == 3.0).all())
                   and bool((got == want_got).all())}
        del g
    return res


def nccl_phase(dev, seq, kernels, sharded, sharded_res) -> dict:
    """Under a process group of one process on the card, which takes
    `nccl`: one all-reduce of the 43 floats through the sharded step's
    `reduce_fn` (`reduce_fn_ms`); NCCL inside a WHILE body
    (`nccl_in_body`); then `ShardedOdometry(n_devices=4)` on the sharded
    phase's config and sequence, twice on its captured step, whose graphs
    hold the step's all-reduces (the 43 floats of every GN pass after the
    first inside the GN loop's WHILE node, the four counters at the top
    level), and once on the eager sharded
    step.  All three runs and the sharded phase's graph run without a group
    (`sharded`) must be equal bit for bit, with launches as the sharded
    phase's and at most 2 device syncs a scan on the graph."""
    import gc

    import numpy as np
    import torch

    from eskf_lio_torch.map import voxel_map as vm
    from eskf_lio_torch.ops import gn_normal_eq as gn
    from eskf_lio_torch.parallel import distributed as dist
    from eskf_lio_torch.parallel import sharded_map

    check(dist.initialize(f"127.0.0.1:{free_port()}", 1, 0, timeout_s=60.0) == (1, 0),
          "a group of one process did not form")
    try:
        backend = torch.distributed.get_backend()
        check(backend == "nccl", f"one process with a card of its own took {backend}")
        JTJ, JTr, n = gn.normal_equations_rotated(*gn_inputs(8192, 32, dev))
        reduce_fn = sharded_map._shard_sum_fn(1)
        dist.ALL_REDUCE.reset()
        out = reduce_fn(JTJ[None], JTr[None], n[None])
        torch.cuda.synchronize()
        check(dist.ALL_REDUCE.calls == 1, "reduce_fn did not call the all-reduce once")
        check(torch.equal(out[0], JTJ) and torch.equal(out[1], JTr) and torch.equal(out[2], n),
              "a one-process all-reduce changed the normal equations")
        reduce_ms = event_ms(lambda: reduce_fn(JTJ[None], JTr[None], n[None]))
        in_body = nccl_in_body(dev)
        check(all(r["values_ok"] for r in in_body.values()),
              f"a WHILE loop holding an NCCL collective gave wrong values: {in_body}")

        config = stream_config()
        first = sharded_map.ShardedOdometry(config, n_devices=N_SHARDS)
        check(first.graphed and isinstance(first.scan_step, sharded_map.GraphedShardedScanStep)
              and "nccl" in first.step_reason,
              f"the sharded driver under an nccl group is not graphed: {first.step_reason}")
        step, spans = first.scan_step, []
        time_steps(first, spans)
        dist.ALL_REDUCE.reset()
        res_1, _ = drive(lambda cb: first.run(seq, on_scan=cb), first, kernels, seq,
                         n_shards=N_SHARDS)
        calls_1 = dist.ALL_REDUCE.calls
        warm = spans[len(spans) // 2:]
        device_ms = float(np.median([a.elapsed_time(b) for a, b in warm]))
        captured = graphs_captured(step)
        first_map = [vm.VoxelMap(*(x.clone() for x in b)) for b in first.voxmap.blocks]
        again = sharded_map.ShardedOdometry(config, n_devices=N_SHARDS)
        res_2, _ = drive(lambda cb: again.run(seq, on_scan=cb), again, kernels, seq,
                         n_shards=N_SHARDS, count_syncs=True)
        eager = sharded_map.ShardedOdometry(config, n_devices=N_SHARDS)
        eager.scan_step = sharded_map.make_sharded_scan_step(config, eager.mesh)
        dist.ALL_REDUCE.reset()
        res_e, _ = drive(lambda cb: eager.run(seq, on_scan=cb), eager, kernels, seq,
                         n_shards=N_SHARDS, count_syncs=True)
        calls_e = dist.ALL_REDUCE.calls

        def same_run(other, other_blocks):
            return (np.array_equal(np.stack(first.trajectory_p), np.stack(other.trajectory_p))
                    and np.array_equal(np.stack(first.trajectory_R),
                                       np.stack(other.trajectory_R))
                    and all(maps_bit_equal(x, y) for x, y in zip(first_map, other_blocks)))

        bits = dict(graph_twice=same_run(again, again.voxmap.blocks),
                    graph_equals_eager=same_run(eager, eager.voxmap.blocks),
                    graph_equals_no_group=same_run(sharded, sharded.voxmap.blocks))
        # the nodes the collective added to the GN loop's WHILE body: the
        # body here less the body of the same graph captured without a group
        added = {}
        for name, g in captured.items():
            alone = sharded_res["graph"]["graphs"][name]["while_body"]
            mine = g["while_body"]
            added[name] = {
                "nodes": mine["nodes"] - alone["nodes"],
                "by_type": {t: mine["by_type"].get(t, 0) - alone["by_type"].get(t, 0)
                            for t in {*mine["by_type"], *alone["by_type"]}
                            if mine["by_type"].get(t, 0) != alone["by_type"].get(t, 0)},
            }
        res = dict(
            backend=backend, world_size=1, floats=43, reduce_fn_ms=reduce_ms,
            nccl_version=".".join(map(str, torch.cuda.nccl.version())),
            step=first.step_reason, nccl_in_body=in_body,
            graph=dict(scans_per_s=res_1["scans_per_s"], second_scans_per_s=res_2["scans_per_s"],
                       warm_half_scans_per_s=res_1["warm_half_scans_per_s"],
                       device_ms_per_scan_median=device_ms, graphs=captured,
                       while_body_nodes_added_by_the_collective=added,
                       device_syncs_per_scan=res_2["device_syncs_per_scan"],
                       sync_sites_per_scan=res_2["sync_sites_per_scan"],
                       launches=res_1["launches"], gn_iterations=res_1["gn_iterations"],
                       all_reduce_calls_seen_by_the_host=calls_1),
            eager=dict(scans_per_s=res_e["scans_per_s"],
                       warm_half_scans_per_s=res_e["warm_half_scans_per_s"],
                       device_syncs_per_scan=res_e["device_syncs_per_scan"],
                       launches=res_e["launches"], all_reduce_calls=calls_e),
            no_group_graph_device_ms_per_scan=sharded_res["graph"]["device_ms_per_scan_median"],
            bit_equal=bits,
        )
        del first, again, eager, step
        gc.collect()
        torch.cuda.synchronize()
    finally:
        dist.shutdown(wait=False)
    print("nccl " + json.dumps(res))
    check(bits["graph_twice"], "two runs of the graphed sharded driver under nccl differ")
    check(bits["graph_equals_eager"],
          "the graphed and the eager sharded step under nccl differ in their bits")
    check(bits["graph_equals_no_group"],
          "the graphed sharded step under a one-process nccl group differs from the graph "
          "without a group")
    check(res_2["device_syncs_per_scan"] <= MAX_STREAM_SYNCS_PER_SCAN,
          f"the graphed sharded driver under nccl waited for the device "
          f"{res_2['device_syncs_per_scan']:.2f} times a scan (at most {MAX_STREAM_SYNCS_PER_SCAN})")
    # the eager step all-reduces once per GN iteration and once per update
    # scan, and once for the init scan; the graphed driver's host sees only
    # the captures' calls and the eager init scan's
    check(calls_e == res_e["gn_iterations"] + res_e["scans"],
          f"{calls_e} all-reduces in the eager run for {res_e['gn_iterations']} GN iterations "
          f"and {res_e['scans']} scans")
    return res


# ---------------------------------------------------------------------------
# phase 6: the graph stress test
# ---------------------------------------------------------------------------

# the stress test's two runs, each with both configs in one process: the
# graph path's default set, and the eager loop (no graph) that met the
# illegal address of kernel B's halo load (ROADMAP.md, queue 3)
STRESS_RUNS = (("graph", ()), ("eager", ("--eager",)))
STRESS_TIMEOUT_S = 300


def graph_stress_phase() -> dict:
    """`python -m eskf_lio_torch.utils.graph_stress` twice, each run the
    small config's rounds and then HEAVY's in one process.  The default
    set: fresh graphed steps, single-device and sharded, against the eager
    steps bit for bit, with the graphs replayed out of capture order,
    destroyed and recaptured, collected inside another capture, and
    captured on either side of a growth of the capture scratch, all on one
    thread.  `--eager`: the same loop with both steps of a pair eager, 40
    small rounds then 6 at HEAVY."""
    res = {}
    for name, extra in STRESS_RUNS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "eskf_lio_torch.utils.graph_stress", *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=STRESS_TIMEOUT_S,
        )
        line = [l for l in proc.stdout.splitlines() if l.startswith("graph_stress ")]
        check(proc.returncode == 0 and bool(line),
              f"graph_stress {' '.join(extra)} exited {proc.returncode}: "
              f"{(proc.stderr.strip().splitlines() or ['no output'])[-1][:300]}")
        res[name] = {r["config"]: r for r in json.loads(line[-1].split(" ", 1)[1])["results"]}
        res[name]["process_s"] = time.perf_counter() - t0
    print("graph_stress " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# phase 7: the bench, as a user runs it
# ---------------------------------------------------------------------------

# a budget that lets all four phases finish (the bench skips what is left
# once it runs out), and the keys the JAX bench's last line holds
BENCH_BUDGET_S = 600
BENCH_TIMEOUT_S = 600
BENCH_LAST_LINE_KEYS = (
    "metric", "value", "unit", "vs_baseline", "vs_realtime", "series", "light", "heavy",
    "workload", "stages_ms", "heavy_ref", "light_ref", "baseline_source", "gn_backend",
    "elapsed_s",
)
BENCH_STAGES = ("predict", "preprocess", "align", "align_iters", "insert", "evict", "full_step")
BENCH_TIMED_SCANS = 64
BENCH_MAX_ATE_CM = {"light": 1.0, "heavy": 2.5}  # the JAX bench: 0.45 and 1.81


def bench_phase(smi: str) -> dict:
    """`python -m eskf_lio_torch.bench` in a process of its own: four lines
    (light, heavy, stages, reference), each a superset of the one before,
    the last with the JAX bench's keys and the card's nvidia-smi line; 64
    timed scans a series, convergence, ATE, every stage timed, and the
    launches of the timed halves counted on the device: kernel A once per
    GN iteration, kernel B twice per update row."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("ESKF_BENCH_ONLY", "ESKF_BENCH_BUDGET_S", "ESKF_GN_BACKEND")}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "eskf_lio_torch.bench", "--budget-s", str(BENCH_BUDGET_S)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S,
    )
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"the bench exited {proc.returncode}: "
          f"{(proc.stderr.strip().splitlines() or ['no output'])[-1][:300]}")
    lines = [json.loads(l) for l in proc.stdout.splitlines() if l.startswith("{")]
    for line in lines:
        print("bench " + json.dumps(line))
    print(f"bench: {len(lines)} lines in {seconds:.1f} s")
    check([l.get("series") for l in lines] == ["light", "heavy", "heavy", "heavy"],
          f"the bench printed {len(lines)} lines, not light, heavy, stages, reference")
    check(all(set(a) <= set(b) for a, b in zip(lines, lines[1:])),
          "a bench line lacks a key of the line before it")
    last = lines[-1]
    missing = set(BENCH_LAST_LINE_KEYS) - set(last)
    check(not missing and "note" not in last, f"the bench's last line lacks {sorted(missing)}")
    check(last["device"] == smi, f"the bench names its device {last['device']!r}, not {smi!r}")
    for name, max_ate in BENCH_MAX_ATE_CM.items():
        s = last[name]
        check(s["timed_scans"] == BENCH_TIMED_SCANS,
              f"{name}: {s['timed_scans']} timed scans, not {BENCH_TIMED_SCANS}")
        check(s["icp_convergence_rate"] >= MIN_CONVERGENCE,
              f"{name}: convergence {s['icp_convergence_rate']} < {MIN_CONVERGENCE}")
        check(s["ate_rmse_cm"] <= max_ate, f"{name}: ATE {s['ate_rmse_cm']} cm > {max_ate} cm")
        for k, per in GN_PASS_LAUNCHES.items():
            check(s["launches"][k] == per * s["gn_iterations"],
                  f"{name}: {k} launches {s['launches'][k]} != {per} x GN iterations "
                  f"{s['gn_iterations']}")
        check(s["launches"]["segscan"] == 2 * s["update_rows"],
              f"{name}: kernel B launches {s['launches']['segscan']} != 2 x update rows "
              f"{2 * s['update_rows']}")
        check(s["launches"]["preprocess"] == PRE_LAUNCHES * s["update_rows"],
              f"{name}: preprocess launches {s['launches']['preprocess']} != {PRE_LAUNCHES} x "
              f"update rows {s['update_rows']}")
        check(s["launches"]["imu_prefix"] == s["timed_scans"],
              f"{name}: imu_prefix launches {s['launches']['imu_prefix']} != timed rows "
              f"{s['timed_scans']}")
    stages = last["stages_ms"]
    check(set(stages) == set(BENCH_STAGES) and all(stages[k] > 0 for k in BENCH_STAGES),
          f"the stage breakdown is incomplete: {stages}")
    return {"last_line": last, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 8: the JAX system's diagnostic tools, as a user runs them
# ---------------------------------------------------------------------------

# (label, module under eskf_lio_torch.tools, arguments, timeout s).
# ate_matrix runs two variants: `base` is the bench's HEAVY series.
# ate_check runs twice: with its own update noises (1e-4 m, 3e-5 rad) the
# filter loses the track on its noiseless sequence in both packages (GN
# iterations up to 50 a scan), so that run is held to the JAX package's own
# run of `tools/ate_check.py`; with the bench's noises it is held to 1 cm
TOOLS = (
    ("light_stages", "light_stages", (), 300),
    ("profile_preprocess", "profile_preprocess", (), 300),
    ("probe_align_parts", "probe_align_parts", (), 300),
    ("probe_adaptive", "probe_adaptive", (), 300),
    ("ate_check", "ate_check", (), 300),
    ("ate_check_bench_noise", "ate_check", ("--tn", "1e-3", "--rn", "3e-4"), 300),
    ("ate_matrix", "ate_matrix", ("exact", "budget48k"), 400),
    ("bench_scaling_mesh", "bench_scaling_mesh", (), 300),
    ("bench_shard", "bench_shard", (), 300),
    ("bench_compile", "bench_compile", (), 300),
    ("compile_bisect", "compile_bisect", (), 300),
)
TOOL_MAX_ATE_CM = {"light_stages": 1.0, "ate_matrix": 2.5, "ate_check_bench_noise": 1.0}
# `python tools/ate_check.py` (its default arguments), JAX on the CPU: the
# raw rmse of its first line, in cm (one run; the port's must be within 2 %)
ATE_CHECK_JAX_RAW_CM = 777.11
ATE_CHECK_JAX_RAW_TOL = 0.02
SERIES_KEYS = ("scans_per_sec", "timed_scans", "icp_convergence_rate", "ate_rmse_cm",
               "compile_s", "launches", "gn_iterations", "update_rows")
PROFILE_PIECES = (
    "sort2 @131k", "gather q[perm] [131k,3]", "gather [131k,14]", "gather [131k->32k,14]",
    "segment_sum [131k,10]", "segscan kernel [131k,10]", "one-hot deskew matmul",
    "deskew row gather [131k]", "sort2 @32k", "gather [32k,10]", "plane_regularize [32k]",
    "axis_pass z [32k,10]", "axis_pass y [32k,10]", "axis_pass x [32k,10]",
    "view probe [32k] @C=2^19", "preprocess FULL", "downsample+cov FULL",
    "preprocess FULL plain", "downsample+cov FULL plain",
)
ALIGN_PARTS = ("linalg_solve6", "chol6_unrolled", "se3_exp", "transform_points_32k",
               "lookup_two_tier_32k", "gn_pallas_32k")
COMPILE_CASES = 16
BISECT_PIECES = ("scatter_slots[D]", "build_view[C]", "sort_perm[C+D]", "fold_into_main",
                 "insert")


def positive(x, what: str) -> float:
    check(isinstance(x, (int, float)) and not isinstance(x, bool) and math.isfinite(x) and x > 0,
          f"{what}: {x!r} is not a finite time above 0")
    return x


def net_time(x, what: str) -> float:
    """A time less an empty graph's replays: finite, and 0 only where the
    piece's replays took no longer than the empty graph's (its raw time is
    held above 0 beside it)."""
    check(isinstance(x, (int, float)) and math.isfinite(x) and x >= 0,
          f"{what}: {x!r} is not a finite time of 0 or more")
    return x


def launches_follow_the_rule(line: dict, what: str, shards: int = 1,
                             rows_key: str = "update_rows") -> None:
    """The launches counted on the device: kernel A and the lookup kernel
    once per GN iteration of each shard and the increment kernel once per
    GN iteration, kernel B once for the downsampler and once per shard's
    insert a scan, the preprocessor's kernels `PRE_LAUNCHES` times a scan,
    the IMU prefix once a predict call (a series' timed rows, else the
    line's `predict_calls`: a scan's, an overflow row's or pre-advance's)."""
    got = line["launches"]
    check(got["gn_normal_eq"] == shards * line["gn_iterations"] > 0,
          f"{what}: kernel A launched {got['gn_normal_eq']} times, not {shards} x "
          f"{line['gn_iterations']} GN iterations")
    # (L + 1) a GN pass: twice unsharded
    want = (shards + 1) * line["gn_iterations"]
    check(got["gn_pass"] == want, f"{what}: gn_pass launched {got['gn_pass']} times, not {want}")
    check(got["segscan"] == (shards + 1) * line[rows_key] > 0,
          f"{what}: kernel B launched {got['segscan']} times, not {shards + 1} x "
          f"{line[rows_key]} scans")
    check(got["preprocess"] == PRE_LAUNCHES * line[rows_key],
          f"{what}: the preprocessor's kernels launched {got['preprocess']} times, not "
          f"{PRE_LAUNCHES} x {line[rows_key]} scans")
    calls = line["timed_scans"] if "timed_scans" in line else line["predict_calls"]
    check(got["imu_prefix"] == calls,
          f"{what}: imu_prefix launched {got['imu_prefix']} times, not once a predict call "
          f"({calls})")


def series_ok(line: dict, what: str, max_ate_cm: float) -> None:
    missing = set(SERIES_KEYS) - set(line)
    check(not missing, f"{what}: the series line lacks {sorted(missing)}")
    positive(line["scans_per_sec"], f"{what} scans/s")
    check(line["icp_convergence_rate"] >= MIN_CONVERGENCE,
          f"{what}: convergence {line['icp_convergence_rate']} < {MIN_CONVERGENCE}")
    check(line["ate_rmse_cm"] <= max_ate_cm, f"{what}: ATE {line['ate_rmse_cm']} cm > {max_ate_cm}")
    launches_follow_the_rule(line, what)


def check_tool(label: str, name: str, lines: list[str]) -> dict:
    """Parse the lines of the tool `name` (run as `label`) in its schema and
    hold them to their bounds; return what PERF.md records of it."""
    js = [json.loads(l) for l in lines if l.startswith("{")]
    if name == "light_stages":
        series, stages = js
        series_ok(series, name, TOOL_MAX_ATE_CM[name])
        st = stages["light_stages_ms"]
        check(set(st) == set(BENCH_STAGES), f"light_stages: stages {sorted(st)}")
        for k in BENCH_STAGES:
            positive(st[k], f"light_stages {k}")
        return {"series": series, "stages_ms": st}
    if name == "profile_preprocess":
        pieces = {}
        for l in lines:
            m = re.match(r"^(.{28}) +(\S+) ms  \(raw (\S+) ms\)(  port: .*)?$", l)
            check(m is not None, f"profile_preprocess: a line out of its schema: {l!r}")
            pieces[m.group(1).rstrip()] = {
                "ms": net_time(float(m.group(2)), f"profile_preprocess {l}"),
                "raw_ms": positive(float(m.group(3)), f"profile_preprocess {l}")}
        check(tuple(pieces) == PROFILE_PIECES, f"profile_preprocess printed {list(pieces)}")
        return pieces
    if name == "probe_align_parts":
        check(tuple(l["op"] for l in js) == ALIGN_PARTS, f"probe_align_parts printed {js}")
        for l in js:
            net_time(l["ms"], f"{l['op']} ms")
            positive(l["raw_ms"], f"{l['op']} raw_ms")
        return {l["op"]: {k: l[k] for k in ("ms", "raw_ms", "k")} for l in js}
    if name == "probe_adaptive":
        m = re.match(r"^warm map voxels: (\d+)$", lines[0])
        check(m is not None and int(m.group(1)) > 0, f"probe_adaptive: {lines[0]!r}")
        warm = js[0]["warm_up"]
        launches_follow_the_rule(warm, "probe_adaptive's warm-up")
        variants = js[1:]
        check([v["variant"] for v in variants] == ["exact", "adaptive", "freeze", "every2"],
              f"probe_adaptive printed {variants}")
        for v in variants:
            positive(v["align_ms"], f"probe_adaptive {v['variant']}")
            check(isinstance(v["iterations"], int) and v["iterations"] >= 1,
                  f"probe_adaptive {v['variant']}: {v['iterations']} iterations")
        return {"warm_map_voxels": int(m.group(1)), "warm_up": warm, "variants": variants}
    if name == "ate_check":
        m = re.match(r"^ATE rmse: (\S+) cm  max: (\S+) cm  port: .* rmse (\S+) cm$", lines[0])
        check(m is not None, f"ate_check: {lines[0]!r}")
        rmse, worst, raw = (positive(float(m.group(i)), f"{label} ATE") for i in (1, 2, 3))
        if label in TOOL_MAX_ATE_CM:
            check(rmse <= TOOL_MAX_ATE_CM[label],
                  f"{label}: ATE {rmse} cm > {TOOL_MAX_ATE_CM[label]}")
        else:
            check(abs(raw - ATE_CHECK_JAX_RAW_CM) <= ATE_CHECK_JAX_RAW_TOL * ATE_CHECK_JAX_RAW_CM,
                  f"{label}: raw ATE {raw} cm, the JAX package's {ATE_CHECK_JAX_RAW_CM}")
        # numpy wraps a long array onto lines of its own
        rest = "\n".join(lines[1:])
        check(re.fullmatch(r"per-scan \|error\| cm, scans 95\.\.115: \[[^]]*\]\n"
                           r"iters 95\.\.115: \[[^]]*\]\n"
                           r"gt speed at scans 20/60/100: \[[^]]*\]", rest) is not None,
              f"ate_check printed {lines}")
        return {"ate_rmse_cm": rmse, "ate_max_cm": worst, "raw_ate_rmse_cm": raw,
                "lines": lines[1:]}
    if name == "ate_matrix":
        check([l["variant"] for l in js] == ["exact", "budget48k"], f"ate_matrix printed {js}")
        for l in js:
            series_ok(l, f"ate_matrix {l['variant']}", TOOL_MAX_ATE_CM[name])
        return {l["variant"]: l for l in js}
    if name == "bench_scaling_mesh":
        from eskf_lio_torch.parallel.sharded_map import slice_capacity
        from eskf_lio_torch.tools import bench_scaling_mesh as bsm

        cfg = bsm.make_config()
        check([l["devices"] for l in js] == list(bsm.DEVICES), f"bench_scaling_mesh printed {js}")
        for l in js:
            d = l["devices"]
            positive(l["ms_per_scan"], f"bench_scaling_mesh D={d}")
            positive(l["capture_s"], f"bench_scaling_mesh D={d} capture")
            check(l["per_device_slice"] == slice_capacity(cfg.max_scan_points, d, cfg.shard_slack)
                  and l["per_device_map_rows"] == cfg.hash_capacity // d
                  and l["shards_on_one_device"] is True, f"bench_scaling_mesh D={d}: {l}")
            launches_follow_the_rule(l, f"bench_scaling_mesh D={d}", shards=d, rows_key="scans")
        return {str(l["devices"]): l for l in js}
    if name == "bench_shard":
        check([l["stage"] for l in js] == ["plain_step", "sharded_step_mesh1", "sharding_overhead"],
              f"bench_shard printed {js}")
        positive(js[0]["ms_per_scan"], "bench_shard plain_step")
        positive(js[1]["ms_per_scan"], "bench_shard sharded_step_mesh1")
        check(math.isfinite(js[2]["overhead_pct"]), f"bench_shard: {js[2]}")
        return {l["stage"]: l.get("ms_per_scan", l.get("overhead_pct")) for l in js}
    if name == "bench_compile":
        check(lines[0].startswith("backend: cuda"), f"bench_compile: {lines[0]!r}")
        cases = []
        for l in lines[1:]:
            m = re.match(r"^(\S+) +N= *(\d+)  compile +(\S+)s   warm +(\S+) us/iter(  port: .*)?$", l)
            check(m is not None, f"bench_compile: a line out of its schema: {l!r}")
            cases.append({"case": m.group(1), "n": int(m.group(2)),
                          "compile_s": positive(float(m.group(3)), f"bench_compile {l}"),
                          "warm_us": net_time(float(m.group(4)), f"bench_compile {l}")})
        check(len(cases) == COMPILE_CASES, f"bench_compile printed {len(cases)} cases")
        return {"cases": cases}
    if name == "compile_bisect":
        check(lines[0] == "backend: cuda" and lines[1] == "C = 2^12 = 4096  (delta 1024)",
              f"compile_bisect: {lines[:2]}")
        pieces = {}
        for l in lines[2:]:
            m = re.match(r"^  (\S+) +first +(\S+)s  capture +(\S+)s  warm +(\S+) ms$", l)
            check(m is not None, f"compile_bisect: a line out of its schema: {l!r}")
            pieces[m.group(1)] = {
                "first_s": positive(float(m.group(2)), f"compile_bisect {l}"),
                "capture_s": positive(float(m.group(3)), f"compile_bisect {l}"),
                "warm_ms": net_time(float(m.group(4)), f"compile_bisect {l}")}
        check(tuple(pieces) == BISECT_PIECES, f"compile_bisect printed {list(pieces)}")
        return pieces
    raise SmokeFailure(f"no schema for the tool {name}")


def tools_phase(smi: str) -> dict:
    """Each of `eskf_lio_torch/tools/` as a user runs it, `python -m
    eskf_lio_torch.tools.<name>` in a process of its own at the JAX
    script's sizes: exit 0; every line in its schema, every time finite and
    above 0, the last line this card's nvidia-smi line; ATE and convergence
    within bounds where a tool reports them; and for the tools that replay
    (light_stages, probe_adaptive's warm-up, ate_matrix, bench_scaling_mesh)
    the launches counted on the device by the rule of the main path."""
    res = {}
    for label, name, args, timeout in TOOLS:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"eskf_lio_torch.tools.{name}", *args],
                              cwd=ROOT, capture_output=True, text=True, timeout=timeout)
        seconds = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            print(f"tool {label}: {line}")
        check(proc.returncode == 0,
              f"the tool {label} exited {proc.returncode}: "
              f"{(proc.stderr.strip().splitlines() or ['no output'])[-1][:300]}")
        lines = proc.stdout.splitlines()
        check(bool(lines) and lines[-1] == json.dumps({"device": smi}),
              f"the tool {label} names its device {lines[-1:]!r}, not {smi!r}")
        res[label] = {"result": check_tool(label, name, lines[:-1]), "seconds": seconds}
        print(f"tool {label}: checked, {seconds:.1f} s")
    print("tools " + json.dumps({k: v["seconds"] for k, v in res.items()}))
    return res


# ---------------------------------------------------------------------------


def main() -> int:
    t_script = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "eskf_lio_torch" / "csrc").is_dir():
        print(f"chip_smoke: no eskf_lio_torch/ beside {Path(__file__).name}; "
              "run it from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    from eskf_lio_torch.bench import bench_sequence, heavy_config, nvidia_smi_line
    from eskf_lio_torch.ops import _cuda, gn_normal_eq, gn_pass, imu_prefix, preprocess, segscan
    from eskf_lio_torch.utils import graphs

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    # the ported kernels, whose launches the paths count, and the
    # conditional nodes of the captured step
    kernels = [gn_normal_eq.KERNEL, gn_pass.KERNEL, segscan.KERNEL,
               preprocess.KERNEL, imu_prefix.KERNEL]
    t0 = time.perf_counter()
    built = kernels + [graphs.GRAPH_COND]
    secs = _cuda.build(built)
    print(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
          f"(parallel wall {time.perf_counter() - t0:.2f} s)")
    for k in built:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {k.name}: {line.strip()}")

    try:
        config = heavy_config()
        t0 = time.perf_counter()
        seq = bench_sequence(N_SCANS)
        print(f"sequence: {len(seq.scans)} scans x 120000 points, "
              f"generated in {time.perf_counter() - t0:.1f} s")
        scan0 = torch.as_tensor(seq.scans[1].points[: config.max_raw_points], device=dev)
        res_a = kernel_a_phase(dev, config.align_capacity)
        res_b = kernel_b_phase(dev, config, scan0)
        # with the other kernel timings: torch.profiler's traces of single
        # kernels came back short after the replay's long trace
        slices = slice_kernel_phase(dev, config, scan0)
        light_shapes = light_kernel_phase(dev)
        tool_shapes = tool_kernel_phase(dev, config, scan0)
        preprocess_shapes = preprocess_kernel_phase(dev, config, scan0)
        gn_pass_shapes = gn_pass_kernel_phase(dev)
        predict_shapes = predict_kernel_phase(dev)
        res_b["bounds"] = kernel_bounds_phase()
        from eskf_lio_torch.pipeline import replay

        if "--kernels-only" in sys.argv[1:]:
            print("chip_smoke: --kernels-only, stopping before the replay (no result line)")
            return 0
        control = control_flow_phase(dev)
        packed = replay.pack_sequence(config, seq, device=dev)
        e2e = e2e_phase(dev, config, seq, packed, kernels)
        prof = profile_phase(dev, config, packed)
        graph = graph_phase(dev, config, packed, e2e, prof["busy_ms_per_scan"])
        del packed
        by_path = {"replay": e2e["launches"]}
        straight, straight_map, launches = stream_phase(seq, kernels, e2e["scans_per_s"])
        by_path.update(launches)
        resume_phase(seq, straight, straight_map)
        by_path["cli"] = cli_phase(kernels)
        sharded, launches, sharded_res = sharded_phase(seq, kernels, straight, slices)
        by_path.update(launches)
        dist_phase(seq, sharded)
        staged_phase(seq, kernels, sharded)
        nccl = nccl_phase(dev, seq, kernels, sharded, sharded_res)
        by_path["sharded_nccl"] = nccl["graph"]["launches"]
        stress = graph_stress_phase()
        bench = bench_phase(smi)
        by_path["bench_light"] = bench["last_line"]["light"]["launches"]
        by_path["bench_heavy"] = bench["last_line"]["heavy"]["launches"]
        tools = tools_phase(smi)
        by_path["tool_light_stages"] = tools["light_stages"]["result"]["series"]["launches"]
        by_path["tool_probe_adaptive_warm_up"] = (
            tools["probe_adaptive"]["result"]["warm_up"]["launches"])
        for variant, line in tools["ate_matrix"]["result"].items():
            by_path[f"tool_ate_matrix_{variant}"] = line["launches"]
        for d, line in tools["bench_scaling_mesh"]["result"].items():
            by_path[f"tool_bench_scaling_mesh_d{d}"] = line["launches"]
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        return 1

    rows = [
        ("gn_normal_eq", res_a, "eskf_lio_torch/csrc/gn_normal_eq.cu",
         "eskf_lio_tpu/ops/gn_pallas.py:49"),
        ("segscan", res_b, "eskf_lio_torch/csrc/segscan.cu",
         "eskf_lio_tpu/ops/segscan.py:37"),
        # the six kernels together at HEAVY's shapes; no Pallas kernel: they
        # replace the chain of XLA ops of the JAX package's preprocessor
        ("preprocess", pre_row(preprocess_shapes), "eskf_lio_torch/csrc/preprocess.cu",
         "eskf_lio_tpu/ops/preprocess.py:186"),
        # the GN pass's kernels before and after kernel A at urban's shapes; no
        # Pallas kernel: they replace XLA's fusion of the lookup and se3_exp
        ("gn_lookup", gn_pass_shapes["urban"]["lookup"], "eskf_lio_torch/csrc/gn_pass.cu",
         "eskf_lio_tpu/map/voxel_map.py:lookup_packed"),
        ("gn_increment", gn_pass_shapes["urban"]["increment"], "eskf_lio_torch/csrc/gn_pass.cu",
         "eskf_lio_tpu/models/registration.py:solve_increment"),
        # the IMU prefix at mid360's M = 64; no Pallas kernel: it replaces
        # XLA's fusion of the JAX package's associative scans and cumsums
        ("imu_prefix", predict_shapes["mid360"], "eskf_lio_torch/csrc/imu_prefix.cu",
         "eskf_lio_tpu/models/eskf.py:predict_chunk_prefix"),
    ]
    line = {
        "kernels": [
            {
                "name": name, "route": "cuda", "source": src, "replaces": rep,
                # of the replay; each path was driven with the counts set to 0
                # just before it and read just after
                "launches": e2e["launches"][COUNTED_AS.get(name, name)],
                "launches_by_path": {path: n[COUNTED_AS.get(name, name)]
                                     for path, n in by_path.items()},
                "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                # the lookup's time with L2 emptied before each call, which
                # its bound (HBM rate) is held against
                "cold_ms": r.get("cold_ms"),
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "status": "ok",
            }
            for name, r, src, rep in rows
        ],
        # yardsticks measured in this run: an empty <<<1,32>>> launch, and
        # kernel B at its second call site (insert's [32,768, 10] rows) with
        # its bound and the zeros_like + index_add_ it replaced there
        "empty_launch_ms": res_a["empty_launch_ms"],
        # both kernels at the shapes a shard of the four-way map gives them
        "slice_shapes": slices,
        # both kernels at the shapes of the bench's LIGHT series
        "light_shapes": light_shapes,
        # both kernels at the shapes only the tools give them
        "tool_shapes": tool_shapes,
        "preprocess_shapes": preprocess_shapes,
        # the lookup and increment kernels at mid360's and urban's shapes
        "gn_pass_shapes": gn_pass_shapes,
        # the IMU prefix at mid360's and urban's chunk lengths
        "predict_shapes": predict_shapes,
        "insert_shape": {"segscan_ms": res_b["insert_shape_ms"],
                         "call_ms": res_b["insert_shape_call_ms"],
                         "bound_ms": res_b["insert_shape_bound_ms"],
                         "index_add_ms": res_b["insert_shape_index_add_ms"]},
        # the captured step (not a ported kernel: the conditional nodes of
        # csrc/graph_cond.cu against Python control flow, and the replay's
        # graph path beside the eager step)
        "control_flow": control,
        "graph_step": {k: graph[k] for k in (
            "graph_scans_per_s", "eager_scans_per_s", "graph_device_ms_per_scan",
            "graph_wall_ms_per_scan_back_to_back", "eager_busy_ms_per_scan",
            "graph_idle_share_row_by_row", "graphs", "peak_mem_gib",
            "device_syncs_in_rows_per_scan")},
        # the sharded driver's captured step (D = 4, one process) beside its
        # eager step, and the graph stress test's rounds
        "sharded_graph_step": {
            "graph": {k: sharded_res["graph"][k] for k in (
                "scans_per_s", "warm_half_scans_per_s", "device_ms_per_scan_median", "graphs",
                "peak_mem_gib", "device_syncs_per_scan")},
            "eager": {k: sharded_res["eager"][k] for k in (
                "scans_per_s", "device_syncs_per_scan", "busy_ms_per_scan", "idle_share")},
            "bit_equal": sharded_res["graph_equals_eager_bitwise"],
        },
        # the same captured step under a one-process nccl group: its
        # all-reduces inside the graph (the 43 floats inside the WHILE node
        # for every GN pass after the first)
        "sharded_graph_nccl": {
            "graph": {k: nccl["graph"][k] for k in (
                "scans_per_s", "warm_half_scans_per_s", "device_ms_per_scan_median",
                "device_syncs_per_scan", "while_body_nodes_added_by_the_collective")},
            "eager": {k: nccl["eager"][k] for k in ("scans_per_s", "device_syncs_per_scan")},
            "bit_equal": nccl["bit_equal"], "nccl_in_body": nccl["nccl_in_body"],
            "reduce_fn_ms": nccl["reduce_fn_ms"],
        },
        "graph_stress": stress,
        # `python -m eskf_lio_torch.bench`: its last line, less the series'
        # launches (in launches_by_path) and the reference's stage times
        "bench": {k: bench["last_line"][k] for k in (
            "value", "vs_baseline", "vs_realtime", "baseline_source", "stages_ms")}
        | {s: {k: v for k, v in bench["last_line"][s].items() if k != "launches"}
           for s in ("light", "heavy")}
        | {"seconds": bench["seconds"]},
        # both kernels over inputs that end a registered host range (phase 2)
        "kernel_bounds": res_b["bounds"],
        # `python -m eskf_lio_torch.tools.<name>`: each tool's checked result
        # and its process's seconds
        "tools": tools,
        # the whole script's seconds, the kernels' build included
        "script_s": time.perf_counter() - t_script,
    }
    print(json.dumps(line))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
