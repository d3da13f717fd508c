"""The HEAVY series' ATE attribution, one variable at a time (port of
`tools/ate_matrix.py`), each variant through the bench's `run_series`:

  base        the bench's HEAVY config
  exact       icp_rematch_threshold 0 (re-match every GN iteration)
  budget48k   post-downsample budget 32,768 -> 49,152
  heavy20k    HEAVY's capacities at LIGHT's 20,000 points a sweep
  exact20k    exact at LIGHT's 20,000 points a sweep
  light       the LIGHT series, for scale

    python -m eskf_lio_torch.tools.ate_matrix [--device cpu] [variants...]

Prints one JSON line per variant (all when none is named): the series line
with `variant` (the JAX line's keys, plus the timed half's kernel launches
counted on the device), then the device line.  Each series captures its own
graphs; the previous series' graphs and maps are freed before the next.
"""

from __future__ import annotations

import dataclasses
import gc
import sys

import numpy as np
import torch

from eskf_lio_torch import bench, tools
from eskf_lio_torch import device as device_policy
from eskf_lio_torch.config import Config

NAMES = ("base", "exact", "budget48k", "heavy20k", "exact20k", "light")
BUDGET_48K = 49152


def variants(heavy: Config, light: Config, heavy_pps: int, light_pps: int) -> dict:
    """name -> (config, points a sweep), the JAX script's."""
    exact = dataclasses.replace(heavy, icp_rematch_threshold=0.0)
    return {
        "base": (heavy, heavy_pps),
        "exact": (exact, heavy_pps),
        "budget48k": (dataclasses.replace(heavy, max_scan_points=BUDGET_48K), heavy_pps),
        "heavy20k": (heavy, light_pps),
        "exact20k": (exact, light_pps),
        "light": (light, light_pps),
    }


def series_line(name: str, config: Config, seq, dev: torch.device) -> tuple[dict, np.ndarray]:
    """One variant's line and its trajectory."""
    out = bench.run_series(config, seq, dev)
    out.pop("_probe")
    est = out.pop("_est_positions")
    out["variant"] = name
    return out, est


def main(argv: list[str] | None = None, heavy: Config | None = None,
         light: Config | None = None, heavy_pps: int = bench.HEAVY["points_per_scan"],
         light_pps: int = bench.LIGHT["points_per_scan"],
         duration: float = bench.SEQUENCE_S) -> int:
    """The configs, points a sweep and duration are the JAX script's by
    default; a test makes them small."""
    ap = tools.parser("The HEAVY series' ATE attribution, one variable at a time.")
    ap.add_argument("variants", nargs="*", help=f"of {', '.join(NAMES)} (all by default)")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.variants) - set(NAMES))
    if unknown:
        ap.error(f"unknown variants {unknown}")
    dev = device_policy.resolve(args.device)
    heavy = heavy or bench.make_config(bench.HEAVY["max_raw_points"],
                                       bench.HEAVY["max_scan_points"])
    light = light or bench.make_config(bench.LIGHT["max_raw_points"],
                                       bench.LIGHT["max_scan_points"])
    seqs = {}  # one sequence per density, made on first use
    for name, (config, pps) in variants(heavy, light, heavy_pps, light_pps).items():
        if args.variants and name not in args.variants:
            continue
        if pps not in seqs:
            seqs[pps] = bench.make_sequence(pps, duration=duration)
        line, _ = series_line(name, config, seqs[pps], dev)
        tools.emit(line)
        # the series' graphs and maps go before the next series is captured
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    tools.report_device(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
