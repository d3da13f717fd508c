#!/usr/bin/env python3
"""The benchmark of `eskf_lio_torch` on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of `BENCHMARK.json` from the root of a checkout: it makes the
cell's inputs from the seed, sets the program up and warms it (set-up),
drives it for `--seconds`, checks what it produced against the plain
reference, and prints one JSON line last on standard output: the cell's
end-to-end metrics (`--trace 0`) or its per-layer metrics (`--trace 1`),
`correct`, the device, and last `checks`, each number compared beside its
limit (also the last lines on standard error).  Without a card it exits
with 2 and prints no result; if JAX or the JAX package is loaded once the
window has closed, with 3.
"""

import time

T_START = time.perf_counter()  # set-up counts from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)  # the checkout's root, not this folder


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build caches at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s); torch.cuda.is_available() "
              f"is {torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    card = harness.card_line()
    run = harness.driver(cell).run(cell, args.seed, args.seconds, bool(args.trace),
                                   device="cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": cell.chips,
        "memory_peak_bytes": run["memory_peak_bytes"],
    }
    if args.trace:
        device.update(busy_s=run["busy_s"], window_s=run["window_s"])
    run.setdefault("info", {})["card"] = card
    line = harness.result_line(run, cell, bool(args.trace), device)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
