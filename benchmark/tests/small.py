"""A cell at a size the CPU runs in seconds, for the benchmark's tests:
the configuration's and mix's files with the capacities and the sweep cut
down (the widths of every array stay the port's)."""

from __future__ import annotations

import json

from benchmark import harness

LIMITS = {"pose_gap_m": 1e-3, "rot_gap_rad": 1e-3, "vel_gap_mps": 1e-2, "cov_gap": 1e-4,
          "map_count_gap": 1e-2, "map_mean_gap_m": 1e-4, "map_cov_gap": 5e-2}


def cell(config: str = "mid360", traffic: str = "replay", limits: dict | None = None) -> harness.Cell:
    conf = json.loads((harness.HERE / "configs" / f"{config}.json").read_text())
    conf["config"].update(max_raw_points=16384, max_scan_points=8192, max_align_points=8192,
                          hash_capacity_log2=16)
    conf["sensor"]["points_per_sweep"] = 12000
    mix = json.loads((harness.HERE / "mixes" / f"{traffic}.json").read_text())
    return harness.Cell(workload={"name": f"{config}.{traffic}", "chips": 1}, config=conf, mix=mix,
                        limits=dict(LIMITS if limits is None else limits),
                        end_to_end=[], per_layer=[], chips=1)
