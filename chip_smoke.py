#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

1. Device: prints the card's name and power limit (nvidia-smi) and builds
   both CUDA kernels from `eskf_lio_torch/csrc/`, one nvcc per source, all
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
3. End to end: drives the port's replay (`pack_sequence`, `make_init_step`,
   `make_replay_step`) at the HEAVY size of `bench.py` (131,072 raw points,
   32,768 scan points, 16,384 align points, a 2^19-row voxel map) on the
   bench's synthetic sequence cut to 40 scans, with the launch counters set
   to 0 just before and read just after; checks finite poses, convergence,
   ATE against ground truth, and that the kernels were launched exactly as
   often as the path needs.
4. Prints the kernels' JSON line, the nvidia-smi line, and last
   {"ok": true, "device": {...}} — only when every phase passed.

`--kernels-only` stops after phase 2 and prints no result line (a short run
while working on a kernel).

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
    same by kernel name as {name: {"per_call": launches, "ms": time}}.  A
    trace that comes back without device records, or with fewer of a kernel
    than a whole number per call (an empty one was seen once in a dozen
    runs, after an earlier trace in the same process, and both kinds several
    times on a busy host), is taken again, up to eight traces in all."""
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
        by_name = {}
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                us = float(
                    getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0.0)
                )
                by_name[e.key] = {"per_call": e.count / iters, "ms": us / 1e3 / iters}
        total = sum(v["ms"] for v in by_name.values())
        whole = all(float(v["per_call"]).is_integer() for v in by_name.values())
        if total > 0.0 and whole:
            return total, by_name
        print(f"  torch.profiler's trace is incomplete ({len(by_name)} device kernels, "
              f"{total:.5f} ms per call); tracing again")
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


def insert_rows(dev, config, scan_points):
    """Kernel B's inputs at the shape of `voxel_map.insert`'s per-voxel sums:
    a real scan downsampled to `max_scan_points` rows, moved to a pose off
    the voxel grid as an update scan is, keyed by its map voxels and sorted
    as `insert` sorts it.  Returns (skey_s, raw_s, head, seg_id)."""
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
    keys = vx.voxel_key(world, config.map_voxel_size)
    packed, in_range = sm.pack_keys(keys, origin)
    ok = processed.valid & in_range
    skey = sm.skey_of(torch.where(ok, packed, sm.INT32_MAX))
    okf = ok.to(points.dtype)[:, None]
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

    # kernel B against index_add_ at the shape of `voxel_map.insert`'s
    # per-voxel sums (which still use index_add_): a measurement only
    skey_s, raw_s, head_i, seg_id = insert_rows(dev, config, scan_points)
    out_b = segscan.segsum_sorted(skey_s, raw_s)
    out_i = torch.zeros_like(raw_s).index_add_(0, seg_id, raw_s)
    scale = torch.zeros_like(raw_s).index_add_(0, seg_id, raw_s.abs())
    rows = seg_id[head_i]
    rel = ((out_b[head_i] - out_i[rows]).abs() / scale[rows].clamp(min=1e-30)).max().item()
    check(rel <= SEG_TOL, "kernel B disagrees with index_add_ at insert's shape")
    b_ms = device_ms(lambda: segscan.segsum_sorted(skey_s, raw_s))
    i_ms = device_ms(lambda: torch.zeros_like(raw_s).index_add_(0, seg_id, raw_s))
    print(f"insert's shape N={raw_s.shape[0]} W={raw_s.shape[1]} voxels={int(head_i.sum())}: "
          f"kernel B {b_ms:.5f} ms, zeros_like + index_add_ {i_ms:.5f} ms (device), "
          f"rel_err={rel:.3e}")
    res.update(insert_shape_ms=b_ms, insert_shape_index_add_ms=i_ms)
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
    n = int(np.asarray(packed[4][b_total - n_prof:]).sum())

    def dev_us(e, own):
        name = "self_device_time_total" if own else "device_time_total"
        legacy = "self_cuda_time_total" if own else "cuda_time_total"
        return float(getattr(e, name, None) or getattr(e, legacy, 0.0))

    def on_device(e):
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    # a trace without device records is taken again (see device_profile)
    for attempt in range(8):
        time.sleep(0.1 * attempt)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_rows(step, carry, packed, slice(b_total - n_prof, b_total))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # the stage ranges appear twice: on the host, and mirrored on the
        # device timeline as annotations spanning their kernels
        events = prof.key_averages()
        kernels = [e for e in events if on_device(e) and e.key not in STAGES]
        if kernels:
            break
        print("  torch.profiler recorded no device kernel in the replay; tracing again")
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
        res_b = kernel_b_phase(dev, config, scan0)
        from eskf_lio_torch.pipeline import replay

        if "--kernels-only" in sys.argv[1:]:
            print("chip_smoke: --kernels-only, stopping before the replay (no result line)")
            return 0
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
                "ms": r["ms"], "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "status": "ok",
            }
            for name, r, src, rep in rows
        ],
        # yardsticks measured in this run: an empty <<<1,32>>> launch, and
        # kernel B against zeros_like + index_add_ at insert's shape
        "empty_launch_ms": res_a["empty_launch_ms"],
        "insert_shape": {"segscan_ms": res_b["insert_shape_ms"],
                         "index_add_ms": res_b["insert_shape_index_add_ms"]},
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
