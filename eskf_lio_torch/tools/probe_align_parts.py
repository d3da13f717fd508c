"""The parts of one GN iteration, timed one by one (port of
`tools/probe_align_parts.py`): the 6x6 solve two ways, `se3_exp`,
`transform_points` at 32k points, the two-tier map lookup at 32k points on a
map built by `insert` + `compact`, and kernel A at N = 32,768.

    python -m eskf_lio_torch.tools.probe_align_parts [--device cpu]

Prints one JSON line per part, `{"op", "ms", "raw_ms", "k"}` with the JAX
script's k: `raw_ms` is the time per iteration of k replays of the part's
captured graph, `ms` the same less k replays of a one-kernel graph
(`bench.StageTimer`).  A part the port computes another way says so
(`"port"`).  Then the device line.
"""

from __future__ import annotations

import sys
from typing import Callable

import numpy as np
import torch

from eskf_lio_torch import bench, tools
from eskf_lio_torch import device as device_policy
from eskf_lio_torch.map import voxel_map as vm
from eskf_lio_torch.ops import gn_normal_eq, lie

N = 32768
# iterations per timing, the JAX script's
K_SOLVE = 2000
K_TRANSFORM = 500
K_MAP = 300
MAP_RAW, MAP_SCAN = 131072, 32768  # the map's config: bench.make_config(131072, 32768)
VOXEL = 0.3
MAX_POINTS_PER_VOXEL = 1000


def linalg_solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The solve `models/registration.py::solve_increment` makes:
    `torch.linalg.solve_ex`, whose error code stays on the device
    (`torch.linalg.solve` reads it on the host, which a capture refuses)."""
    return torch.linalg.solve_ex(A, b)[0]


def chol6_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled 6x6 Cholesky solve (A SPD), the JAX script's `chol6_solve`
    written for torch: no LAPACK call, only elementwise work."""
    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        d = A[j, j] - sum(L[j][m] ** 2 for m in range(j))
        dj = torch.sqrt(torch.clamp(d, min=1e-30))
        L[j][j] = dj
        for i in range(j + 1, 6):
            v = A[i, j] - sum(L[i][m] * L[j][m] for m in range(j))
            L[i][j] = v / dj
    y = [None] * 6
    for i in range(6):
        y[i] = (b[i] - sum(L[i][m] * y[m] for m in range(i))) / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        x[i] = (y[i] - sum(L[m][i] * x[m] for m in range(i + 1, 6))) / L[i][i]
    return torch.stack(x)


def make_inputs(n: int, dev: torch.device, map_raw: int = MAP_RAW,
                map_scan: int = MAP_SCAN) -> dict:
    """The JAX script's inputs from `default_rng(0)`, and its map: `n`
    points x3 inserted into an empty map of `bench.make_config(map_raw,
    map_scan)`'s capacities, then compacted."""
    rng = np.random.default_rng(0)
    M = rng.standard_normal((6, 6)).astype(np.float32)
    A0 = torch.as_tensor(M @ M.T + 6 * np.eye(6, dtype=np.float32), device=dev)
    b0 = torch.as_tensor(rng.standard_normal(6).astype(np.float32), device=dev)
    pts = torch.as_tensor(rng.standard_normal((n, 3)).astype(np.float32), device=dev)
    cfg = bench.make_config(map_raw, map_scan)
    covs = (torch.eye(3, device=dev) * 0.01).expand(n, 3, 3)
    cp = vm.pack_cov(covs).contiguous()
    voxmap = vm.VoxelMap.create(cfg.hash_capacity, cfg.map_delta_capacity, device=dev)
    voxmap, _ = vm.insert(voxmap, pts * 3.0, cp, torch.ones(n, dtype=torch.bool, device=dev),
                          voxel_size=VOXEL, max_points_per_voxel=MAX_POINTS_PER_VOXEL)
    voxmap, _ = vm.compact(voxmap, max_points_per_voxel=MAX_POINTS_PER_VOXEL)
    return dict(A0=A0, b0=b0, pts=pts, pts3=pts * 3.0, R0=torch.eye(3, device=dev),
                t0=torch.zeros(3, device=dev), cp=cp, voxmap=voxmap,
                mask=torch.ones(n, dtype=torch.bool, device=dev))


def parts(inp: dict, k_solve: int = K_SOLVE, k_transform: int = K_TRANSFORM,
          k_map: int = K_MAP) -> list[tuple[str, Callable, int, str | None]]:
    """(op, fn returning the part's outputs, k, how the port differs)."""
    n = inp["pts"].shape[0]
    nk = f"{n // 1000}k"
    return [
        ("linalg_solve6", lambda: linalg_solve6(inp["A0"], inp["b0"]), k_solve,
         "torch.linalg.solve_ex, its error code not read"),
        ("chol6_unrolled", lambda: chol6_solve(inp["A0"], inp["b0"]), k_solve, None),
        ("se3_exp", lambda: lie.se3_exp(inp["b0"] * 1e-6), k_solve, None),
        (f"transform_points_{nk}", lambda: lie.transform_points(inp["R0"], inp["t0"], inp["pts"]),
         k_transform, None),
        (f"lookup_two_tier_{nk}",
         lambda: vm.lookup(inp["voxmap"], inp["pts3"], voxel_size=VOXEL,
                           max_points_per_voxel=MAX_POINTS_PER_VOXEL), k_map, None),
        (f"gn_pallas_{nk}",
         lambda: gn_normal_eq.normal_equations_rotated(inp["pts3"], inp["cp"], inp["R0"],
                                                       inp["pts3"], inp["cp"], inp["mask"]),
         k_map, "kernel A, csrc/gn_normal_eq.cu"),
    ]


def main(argv: list[str] | None = None, n: int = N, k_solve: int = K_SOLVE,
         k_transform: int = K_TRANSFORM, k_map: int = K_MAP, map_raw: int = MAP_RAW,
         map_scan: int = MAP_SCAN) -> int:
    args = tools.parser("The parts of one GN iteration, timed one by one.").parse_args(argv)
    dev = device_policy.resolve(args.device)
    inp = make_inputs(n, dev, map_raw, map_scan)
    timer = bench.StageTimer(dev, map_scan)
    for op, fn, k, note in parts(inp, k_solve, k_transform, k_map):
        ms, raw_ms, _ = timer.measure(fn, lambda: None, k)
        line = {"op": op, "ms": round(ms, 4), "raw_ms": round(raw_ms, 4), "k": k}
        if note:
            line["port"] = note
        tools.emit(line)
    tools.report_device(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
