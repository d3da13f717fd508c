"""What the primitives the voxel pipeline leans on cost once and warm (port of
`tools/bench_compile.py`), at the JAX script's cases and sizes.

The port has no XLA compile.  What a user pays once for a piece is its
first eager call (kernel selection, the caching allocator's first blocks)
and the capture of its graph; warm, the graph is replayed k = 50 times
less 50 replays of a one-kernel graph (`bench.StageTimer`).  The sorts and
the binary search run torch's own kernels: a tool, which ports no Pallas
kernel.

    python -m eskf_lio_torch.tools.bench_compile [--device cpu] [name]

Prints `backend: <device>`, then the JAX script's line per case (those
whose name holds `name`, all by default): name, N, `compile`, the seconds
paid once (to 0.1 ms: the JAX line's 10 ms would show most as 0), and the
warm µs per iteration, with how the port runs the case
where the JAX script's op has no one-call counterpart.  Then the device
line.
"""

from __future__ import annotations

import sys
import time
from typing import Callable

import torch

from eskf_lio_torch import bench, tools
from eskf_lio_torch import device as device_policy
from eskf_lio_torch.ops import sortmerge as sm

K_ITERS = 50


def sort_k(k: int):
    """A stable sort of one int32 key with k - 1 int32 columns riding
    along: JAX sorts k operands; the port sorts (key, iota) and gathers
    each column by the permutation (`ops/sortmerge.py::sort_perm`)."""
    def build(n, dev):
        key = torch.arange(n, dtype=torch.int32, device=dev).flip(0)
        cols = [torch.zeros(n, dtype=torch.int32, device=dev) for _ in range(k - 1)]
        return lambda: sm.sort_perm(key, *cols)
    return build, "key sort + a row gather per column"


def gather_rows(w: int):
    def build(n, dev):
        tbl = torch.zeros((n, w), device=dev)
        idx = torch.arange(n, device=dev).flip(0)
        return lambda: tbl[idx]
    return build, None


def scatter_rows(w: int):
    def build(n, dev):
        tbl = torch.zeros((n, w), device=dev)
        idx = torch.arange(n, device=dev).flip(0)
        rows = torch.ones((n, w), device=dev)
        return lambda: tbl.index_put((idx,), rows)
    return build, "index_put into a copy (JAX's .at[].set)"


def scatter_2d():
    """The `_scatter_slots` pattern: [E, 12] scalars into [E/2, 128]."""
    def build(n, dev):
        view = torch.zeros((n // 2, 128), dtype=torch.int32, device=dev)
        b = torch.arange(n, dtype=torch.int64, device=dev) % (n // 2)
        cols = torch.zeros((n, 1), dtype=torch.int64, device=dev) * 16 + torch.arange(12, device=dev)
        vals = torch.ones((n, 12), dtype=torch.int32, device=dev)
        return lambda: view.index_put((b[:, None].expand(-1, 12), cols), vals)
    return build, "index_put into a copy, every index in range (JAX: mode='drop')"


def cumsum():
    def build(n, dev):
        x = torch.ones(n, dtype=torch.int32, device=dev)
        return lambda: torch.cumsum(x, 0)
    return build, None


def searchsorted(q: int):
    def build(n, dev):
        tbl = torch.arange(n, dtype=torch.int32, device=dev)
        qs = torch.arange(q, dtype=torch.int32, device=dev) * (n // q)
        return lambda: torch.searchsorted(tbl, qs)
    return build, None


CASES = [
    # (name, n, (build, how the port runs it))
    ("sort2", 32768, sort_k(2)),
    ("sort3", 32768, sort_k(3)),
    ("sort5", 32768, sort_k(5)),
    ("sort13", 32768, sort_k(13)),
    ("sort2", 131072, sort_k(2)),
    ("sort3", 131072, sort_k(3)),
    ("gather16", 131072, gather_rows(16)),
    ("gather16", 524288, gather_rows(16)),
    ("scatter_rows10", 131072, scatter_rows(10)),
    ("scatter_rows10", 524288, scatter_rows(10)),
    ("scatter2d_slots", 131072, scatter_2d()),
    ("scatter2d_slots", 524288, scatter_2d()),
    ("cumsum", 524288, cumsum()),
    ("searchsorted32k", 524288, searchsorted(32768)),
    ("sort2", 524288, sort_k(2)),
    ("sort3", 524288, sort_k(3)),
]


def case_line(name: str, n: int, build: Callable, note: str | None, timer: bench.StageTimer,
              k_iters: int) -> str:
    dev = timer.dev
    fn = build(n, dev)
    bench.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    bench.synchronize(dev)
    first_s = time.perf_counter() - t0
    ms, _, capture_s = timer.measure(fn, lambda: None, k_iters)
    line = (f"{name:24s} N={n:>8d}  compile {first_s + capture_s:8.4f}s   "
            f"warm {ms * 1e3:9.1f} us/iter")
    return line + (f"  port: {note}" if note else "")


def main(argv: list[str] | None = None, cases: list | None = None,
         k_iters: int = K_ITERS) -> int:
    """`cases` are the JAX script's by default; a test makes them small."""
    ap = tools.parser("What the voxel pipeline's primitives cost once and warm.")
    ap.add_argument("only", nargs="?", default=None, help="run the cases whose name holds this")
    args = ap.parse_args(argv)
    dev = device_policy.resolve(args.device)
    print(f"backend: {dev.type} (compile: the first eager call and the graph's capture)",
          flush=True)
    timer = bench.StageTimer(dev, 1)
    for name, n, (build, note) in cases or CASES:
        if args.only and args.only not in name:
            continue
        print(case_line(name, n, build, note, timer, k_iters), flush=True)
    tools.report_device(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
