"""What each piece of the map's compaction path costs once and warm (port of
`tools/compile_bisect.py`), at a main capacity of C = 2^C_log2 rows and a
delta of D = max(C / 8, 1024) rows:

  scatter_slots[D]   `map/voxel_map.py::_scatter_slots`
  build_view[C]      `_build_view`
  sort_perm[C+D]     `ops/sortmerge.py::sort_perm` with a [C+D, 10] payload
  fold_into_main     `_fold_into_main`
  insert             `insert` of 2,048 points (its fold two IF nodes)

The JAX script times XLA's trace and compile of each piece; the port has no
compile, so each line gives the first eager call, the capture of its graph,
and the warm time of 50 replays less 50 replays of a one-kernel graph
(`bench.StageTimer`).

    python -m eskf_lio_torch.tools.compile_bisect [--device cpu] [C_log2 ...]   # default 12

Prints `backend: <device>`, then per capacity `C = 2^c = n  (delta d)` and
one line per piece, then the device line.
"""

from __future__ import annotations

import sys
import time
from typing import Callable

import torch

from eskf_lio_torch import bench, tools
from eskf_lio_torch import device as device_policy
from eskf_lio_torch.map import voxel_map as vm
from eskf_lio_torch.ops import sortmerge as sm

K = 50
INSERT_POINTS = 2048
CAP = 1000.0  # max points per voxel


def pieces(c: int, dev: torch.device) -> list[tuple[str, Callable]]:
    d = max(c // 8, 1024)
    m = vm.VoxelMap.create(c, device=dev)
    zeros_i = torch.zeros(d, dtype=torch.int32, device=dev)
    vals = torch.zeros((d, vm.VIEW_SLOT), dtype=torch.int32, device=dev)
    ok = torch.ones(d, dtype=torch.bool, device=dev)
    payload = torch.zeros((d, 10), device=dev)
    big_key = torch.zeros(c + d, dtype=torch.int32, device=dev)
    big_pay = torch.zeros((c + d, 10), device=dev)
    pts = torch.zeros((INSERT_POINTS, 3), device=dev)
    covs = torch.zeros((INSERT_POINTS, 6), device=dev)
    valid = torch.ones(INSERT_POINTS, dtype=torch.bool, device=dev)
    return [
        ("scatter_slots[D]", lambda: vm._scatter_slots(m.d_view, zeros_i, zeros_i, vals, ok)),
        ("build_view[C]", lambda: vm._build_view(m.skey, m.payload)),
        ("sort_perm[C+D]", lambda: sm.sort_perm(big_key, big_pay)),
        ("fold_into_main", lambda: vm._fold_into_main(m, zeros_i, payload, CAP)),
        ("insert", lambda: vm.insert(m, pts, covs, valid, voxel_size=0.3,
                                     max_points_per_voxel=int(CAP))),
    ]


def run(c_log2: int, timer: bench.StageTimer, k: int = K) -> None:
    c = 1 << c_log2
    print(f"C = 2^{c_log2} = {c}  (delta {max(c // 8, 1024)})", flush=True)
    for name, fn in pieces(c, timer.dev):
        bench.synchronize(timer.dev)
        t0 = time.perf_counter()
        fn()
        bench.synchronize(timer.dev)
        first_s = time.perf_counter() - t0
        ms, _, capture_s = timer.measure(fn, lambda: None, k)
        print(f"  {name:28s} first {first_s:7.4f}s  capture {capture_s:7.4f}s  "
              f"warm {ms:9.4f} ms", flush=True)


def main(argv: list[str] | None = None, k: int = K) -> int:
    ap = tools.parser("What each piece of the map's compaction path costs once and warm.")
    ap.add_argument("c_log2", nargs="*", type=int, default=[12], help="log2 of C (default 12)")
    args = ap.parse_args(argv)
    dev = device_policy.resolve(args.device)
    print(f"backend: {dev.type}", flush=True)
    timer = bench.StageTimer(dev, INSERT_POINTS)
    for cl in args.c_log2:
        run(cl, timer, k)
    tools.report_device(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
