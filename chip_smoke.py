#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

1. Device: prints the card's name and power limit (nvidia-smi) and builds
   both CUDA kernels from `eskf_lio_torch/csrc/`, one nvcc per source, all
   started together.
2. Kernels: runs each kernel and its plain PyTorch version on the card at
   the main path's shapes (kernel A, the GN normal equations, at N = 16,384
   align points; kernel B, the segmented head-row sums, at N = 131,072 raw
   points x W = 10 moments of a real scan) and on edge cases, checks the
   agreement against a stated tolerance, and times the kernel, its plain
   version and, for B, the one PyTorch call computing the same function.
3. End to end: drives the port's replay (`pack_sequence`, `make_init_step`,
   `make_replay_step`) at the HEAVY size of `bench.py` (131,072 raw points,
   32,768 scan points, 16,384 align points, a 2^19-row voxel map) on the
   bench's synthetic sequence cut to 40 scans, with the launch counters set
   to 0 just before and read just after; checks finite poses, convergence,
   ATE against ground truth, and that the kernels were launched exactly as
   often as the path needs.
4. Prints the kernels' JSON line, the nvidia-smi line, and last
   {"ok": true, "device": {...}} — only when every phase passed.

Exits non-zero with no result line when there is no GPU, when the package
is not beside this script, or when any check fails.  Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def event_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Per-call time between CUDA events around `iters` back-to-back calls
    (includes any gap while the host issues the next call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Per-call sum of the device kernels' own durations (torch.profiler),
    without the host's issue gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            total_us += float(
                getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0.0)
            )
    check(total_us > 0.0, "torch.profiler recorded no device time")
    return total_us / 1e3 / iters


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
        return C[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]

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
    for label, n, seed in (("main", n_main, 1), ("n=1000", 1000, 2), ("n=1", 1, 3)):
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
              f"rel_err(plain)={rel:.3e} rel_err(einsum)={rel_e:.3e} tol={GN_TOL:g}")
        check(rel <= GN_TOL, f"kernel A disagrees with its plain version [{label}]")
        check(rel_e <= GN_TOL, f"kernel A disagrees with the einsum path [{label}]")
        if label == "main":
            res["max_abs_err"] = abs_err
            res["args"] = args
    # every row masked: exactly zero, even with garbage behind the mask
    pts, covs, R, mu, covm, mask = gn_inputs(n_main, 4, dev)
    out = gn.normal_equations_rotated(
        pts, torch.zeros_like(covs), R, mu, torch.full_like(covm, float("nan")),
        torch.zeros_like(mask),
    )
    check(bool((out[0] == 0).all() and (out[1] == 0).all()),
          "kernel A: all-masked rows did not sum to exactly 0")
    print("kernel A [all rows masked, NaN map covariances]: exactly 0")
    # deterministic: the same bits twice
    args = res.pop("args")
    first, again = gn.normal_equations_rotated(*args), gn.normal_equations_rotated(*args)
    check(torch.equal(first[0], again[0]) and torch.equal(first[1], again[1]),
          "kernel A is not deterministic")
    # inputs read once (f32 rows of 3 + 6 + 3 + 6, a mask byte, R), the
    # 43-float output written once; arithmetic only on live rows
    n_live = int(args[5].sum())
    bytes_moved = n_main * ((3 + 6 + 3 + 6) * 4 + 1) + 9 * 4 + 43 * 4
    res.update(
        ms=device_ms(lambda: gn.normal_equations_rotated(*args)),
        call_ms=event_ms(lambda: gn.normal_equations_rotated(*args)),
        plain_ms=device_ms(lambda: gn.normal_equations_rotated_ref(*args)),
        library_ms=None,  # no single PyTorch call computes JᵀWJ/JᵀWr
        **bound(bytes_moved, GN_FLOP_PER_POINT * n_live),
    )
    print(f"kernel A timing N={n_main}: kernel {res['ms']:.4f} ms (device), "
          f"{res['call_ms']:.4f} ms per wrapper call, plain {res['plain_ms']:.4f} ms, "
          f"bound {res['bound_ms']:.5f} ms ({res['bound_by']}); library: none")
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


def kernel_b_phase(dev, scan_points, n_rows: int) -> dict:
    import numpy as np
    import torch

    from eskf_lio_torch.ops import segscan

    keys, vals = scan_moments(scan_points, n_rows, dev)
    n, w = vals.shape
    res = {"max_abs_err": seg_compare(keys, vals, "main: real scan")}
    rng = np.random.default_rng(5)
    rnd = torch.as_tensor(rng.normal(size=(n, w)).astype(np.float32), device=dev)
    seg_compare(torch.zeros(n, dtype=torch.int32, device=dev), rnd, "one segment")
    seg_compare(torch.arange(n, dtype=torch.int32, device=dev), rnd, "all unique")
    k1000 = torch.as_tensor(np.sort(rng.integers(0, 90, 1000)).astype(np.int32), device=dev)
    seg_compare(k1000, rnd[:1000].contiguous(), "n=1000")
    seg_compare(k1000[:1].contiguous(), rnd[:1].contiguous(), "n=1")

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
    res.update(
        ms=device_ms(lambda: segscan.segsum_sorted(keys, vals)),
        call_ms=event_ms(lambda: segscan.segsum_sorted(keys, vals)),
        plain_ms=device_ms(lambda: segscan.segsum_sorted_ref(keys, vals)),
        library_ms=device_ms(lambda: torch.segment_reduce(vals, "sum", lengths=lengths)),
        **bound(n * 4 + 2 * n * w * 4, n * w),
    )
    print(f"kernel B timing N={n} W={w}: kernel {res['ms']:.4f} ms (device), "
          f"{res['call_ms']:.4f} ms per wrapper call, plain {res['plain_ms']:.4f} ms, "
          f"torch.segment_reduce {res['library_ms']:.4f} ms, "
          f"bound {res['bound_ms']:.5f} ms (bytes)")
    return res


# ---------------------------------------------------------------------------
# phase 3: the main path end to end
# ---------------------------------------------------------------------------


def heavy_config():
    from eskf_lio_torch.config import Config, ImuConfig

    # bench.py:102-112, HEAVY (bench.py:79-82)
    return Config(
        imu=ImuConfig(gravity=(0.0, 0.0, -9.81)),
        translation_noise=1e-3,
        rotation_noise=3e-4,
        max_raw_points=131072,
        max_scan_points=32768,
        max_imu_per_scan=64,
        hash_capacity_log2=19,
    )


def bench_sequence(n_scans: int):
    import numpy as np

    from eskf_lio_torch.io import dataset

    # bench.py:115-123, cut in duration only: n_scans = duration * 10 - 1
    return dataset.make_synthetic_sequence(
        duration=(n_scans + 1) / 10.0 + 1e-6, points_per_scan=120000, seed=11,
        imu_noise_gyro=4.9e-3, imu_noise_accel=0.0206,
        gyro_bias=np.array([0.002, -0.001, 0.0015]),
        accel_bias=np.array([0.02, -0.03, 0.01]),
    )


def start_replay(dev, config, init_scan):
    """The user's entry points: the filter state, the map with the first
    scan inserted, and the replay runner."""
    import torch

    from eskf_lio_torch.map import voxel_map as vm
    from eskf_lio_torch.models import eskf
    from eskf_lio_torch.pipeline import odometry as odo
    from eskf_lio_torch.pipeline import replay

    init_step = odo.make_init_step(config, dev)
    step = replay.make_replay_step(config, dev)
    state = eskf.init_state(config, dev)
    voxmap = vm.VoxelMap.create(config.hash_capacity, config.map_delta_capacity, device=dev)
    voxmap, _ = init_step(voxmap, init_scan)
    return step, (state, voxmap, torch.eye(3, device=dev), torch.zeros(3, device=dev))


def run_rows(step, carry, packed, rows: slice):
    """Replay rows `rows` of the packed sequence; (carry, Rs, ts, diags)."""
    _, chunks, scans, evicts, updates, _ = packed
    *carry, Rs, ts, diags = step(
        *carry,
        type(chunks)(*(x[rows] for x in chunks)),
        type(scans)(*(x[rows] for x in scans)),
        evicts[rows], updates[rows],
    )
    return carry, Rs, ts, diags


def e2e_phase(dev, config, seq, packed, kernels) -> dict:
    import numpy as np
    import torch

    from eskf_lio_torch.map import voxel_map as vm
    from eskf_lio_torch.pipeline import replay
    from eskf_lio_torch.utils.metrics import ate_rmse

    init_scan, chunks, _, _, updates, _ = packed
    b_total = chunks.dt.shape[0]
    half = b_total // 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    step, carry = start_replay(dev, config, init_scan)
    outs = []
    for rows in (slice(0, half), slice(half, b_total)):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        carry, Rs, ts, diags = run_rows(step, carry, packed, rows)
        torch.cuda.synchronize()
        outs.append((Rs, ts, diags, time.perf_counter() - t_start))
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}

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
        scans=len(positions), update_rows=n_upd, scans_per_s=scans_per_s,
        warm_rows=b_total - half, ate_cm=ate_cm, convergence=conv,
        mean_icp_iterations=float(np.mean(iters)), wall_s=wall,
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
        map_voxels=int(carry[1].num_voxels()), launches=launches,
        max_align_slice_overflow=int(np.max(diags["align_slice_overflow"])),
        dropped_points=int(np.sum(diags["dropped_points"])),
    )
    print("e2e " + json.dumps(res))
    check(bool(np.isfinite(positions).all()) and bool(diags["pose_finite"].all()),
          "non-finite pose in the replay")
    check(conv > MIN_CONVERGENCE, f"convergence rate {conv:.3f} <= {MIN_CONVERGENCE}")
    check(ate_cm <= MAX_ATE_CM, f"ATE {ate_cm:.2f} cm > {MAX_ATE_CM} cm")
    check(launches["gn_normal_eq"] == int(np.sum(iters)),
          f"kernel A launches {launches['gn_normal_eq']} != GN iterations {int(np.sum(iters))}")
    check(launches["segscan"] == n_upd + 1,
          f"kernel B launches {launches['segscan']} != update scans + 1 = {n_upd + 1}")

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


STAGES = ("predict", "preprocess", "align", "pose_update", "map_insert", "evict")


def profile_phase(dev, config, packed, scan_ms: float, n_prof: int = 5) -> dict:
    """Where the time goes: a fresh replay of the same sequence with the
    last `n_prof` rows under torch.profiler.  Reports the device's busy
    time per scan (the sum of kernel durations), its idle share against the
    unprofiled warm wall time per scan, each stage's host and device time,
    and the kernels that take the most device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    b_total = packed[1].dt.shape[0]
    step, carry = start_replay(dev, config, packed[0])
    carry, *_ = run_rows(step, carry, packed, slice(0, b_total - n_prof))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_rows(step, carry, packed, slice(b_total - n_prof, b_total))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = int(np.asarray(packed[4][b_total - n_prof:]).sum())

    def dev_us(e, own):
        name = "self_device_time_total" if own else "device_time_total"
        legacy = "self_cuda_time_total" if own else "cuda_time_total"
        return float(getattr(e, name, None) or getattr(e, legacy, 0.0))

    def on_device(e):
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    # the stage ranges appear twice: on the host, and mirrored on the
    # device timeline as annotations spanning their kernels
    events = prof.key_averages()
    kernels = [e for e in events if on_device(e) and e.key not in STAGES]
    busy_ms = sum(dev_us(e, True) for e in kernels) / 1e3 / n
    stages = {}
    for e in events:
        if e.key in STAGES:
            row = stages.setdefault(e.key, {})
            if on_device(e):
                row["device_span_ms"] = dev_us(e, True) / 1e3 / n
            else:
                row["host_ms"] = e.cpu_time_total / 1e3 / n
                row["kernel_ms"] = dev_us(e, False) / 1e3 / n
    top = sorted(kernels, key=lambda e: -dev_us(e, True))[:10]
    res = dict(
        scans=n, busy_ms_per_scan=busy_ms, wall_ms_per_scan_unprofiled=scan_ms,
        wall_ms_per_scan_profiled=wall_ms / n,
        idle_share=1.0 - busy_ms / scan_ms,
        launches_per_scan=sum(e.count for e in kernels) / n,
        stages=stages,
        top_kernels=[
            {"name": e.key[:80], "per_scan": e.count / n, "ms_per_scan": dev_us(e, True) / 1e3 / n}
            for e in top
        ],
    )
    print("profile " + json.dumps(res))
    check(busy_ms > 0.0, "the profiled replay ran nothing on the device")
    return res


# ---------------------------------------------------------------------------


def main() -> int:
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

    from eskf_lio_torch.ops import _cuda, gn_normal_eq, segscan

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    kernels = [gn_normal_eq.KERNEL, segscan.KERNEL]
    t0 = time.perf_counter()
    secs = _cuda.build(kernels)
    print(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
          f"(parallel wall {time.perf_counter() - t0:.2f} s)")
    for k in kernels:
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
        res_b = kernel_b_phase(dev, scan0, config.max_raw_points)
        from eskf_lio_torch.pipeline import replay

        packed = replay.pack_sequence(config, seq, device=dev)
        e2e = e2e_phase(dev, config, seq, packed, kernels)
        profile_phase(dev, config, packed, 1e3 / e2e["scans_per_s"])
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        return 1

    rows = [
        ("gn_normal_eq", res_a, "eskf_lio_torch/csrc/gn_normal_eq.cu",
         "eskf_lio_tpu/ops/gn_pallas.py:49"),
        ("segscan", res_b, "eskf_lio_torch/csrc/segscan.cu",
         "eskf_lio_tpu/ops/segscan.py:37"),
    ]
    line = {
        "kernels": [
            {
                "name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": e2e["launches"][name], "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "status": "ok",
            }
            for name, r, src, rep in rows
        ]
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
