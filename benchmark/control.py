#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds 1,2,3 [--control-seeds 1,2,3]

runs the cell's driver once per seed in this one process, with a short
window at the cell's own load, and prints one JSON line per seed: the
gaps between the program and the plain reference (`readings`: sound runs,
whose largest over a dozen seeds is each limit's lower reading) and, for
the control seeds, the gaps of the control, the reference computed with
TF32 matrix products put in the program's place (`control_readings`: the
smallest over the seeds is the upper reading).  The benchmark's own runs
never run the control.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    card = harness.card_line()
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        run = harness.driver(cell).run(cell, seed, args.seconds, False, device="cuda",
                                       control=seed in controls)
        info = run["info"]
        print(json.dumps({
            "workload": args.workload, "seed": seed, "card": card, "correct": run["correct"],
            "failed": run["failed"], "checks": run["checks"],
            "readings": info["readings"], "gn_iteration_gap": info["gn_iteration_gap"],
            "gn_forced_rows": info["gn_forced_rows"],
            "control_readings": info.get("control_readings"), "blocks": info["blocks"],
            "ate_cm": run["ate_m"] * 100, "seconds": time.perf_counter() - t0,
            "info": {k: v for k, v in info.items() if k not in ("readings", "control_readings")},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
