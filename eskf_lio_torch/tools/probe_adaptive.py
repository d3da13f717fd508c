"""What each variant of the GN re-match costs in `align` on a warm map (port
of `tools/probe_adaptive.py`).

Builds a warm HEAVY map by replaying the bench's sequence cut to 4 s
(`pack_sequence`, `make_init_step`, `make_replay_step`), then predicts and
preprocesses its last row, and times `registration.align` (its GN loop one
WHILE node of the captured graph) for:

  exact      icp_rematch_threshold = 0      (lookup every GN iteration)
  adaptive   = 0.01
  freeze     = 1e9                          (lookup on iteration 0 only)
  every2     threshold 0, relookup_every 2

    python -m eskf_lio_torch.tools.probe_adaptive [--device cpu]

Prints `warm map voxels: N`, then (not a JAX line) the warm-up replay's
kernel launches counted on the device beside the GN iterations, update
rows and predict calls (one a row) they must match, then `{"variant", "align_ms", "iterations"}` per
variant: `align_ms` is k = 30 replays of the captured `align` less k
replays of a one-kernel graph (`bench.StageTimer`); `iterations` is read
once, after the timing.  Then the device line.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from eskf_lio_torch import bench, tools
from eskf_lio_torch import device as device_policy
from eskf_lio_torch.config import Config
from eskf_lio_torch.io import dataset
from eskf_lio_torch.models import eskf, registration
from eskf_lio_torch.ops import preprocess
from eskf_lio_torch.pipeline import odometry as odo
from eskf_lio_torch.pipeline import replay
from eskf_lio_torch.types import Pose

DURATION_S = 4.0
K = 30
VARIANTS = {
    "exact": dict(icp_rematch_threshold=0.0),
    "adaptive": dict(icp_rematch_threshold=0.01),
    "freeze": dict(icp_rematch_threshold=1e9),
    "every2": dict(icp_rematch_threshold=0.0, icp_relookup_every=2),
}


def heavy() -> tuple[Config, dataset.Sequence]:
    """The JAX script's workload: HEAVY's config, the bench's sequence cut to
    4 s."""
    return (bench.make_config(bench.HEAVY["max_raw_points"], bench.HEAVY["max_scan_points"]),
            bench.make_sequence(bench.HEAVY["points_per_scan"], duration=DURATION_S))


def warm_probe(config: Config, seq: dataset.Sequence, dev: torch.device) -> dict:
    """The replay of every row of `seq` (its launches counted), then the
    last row predicted and preprocessed: the warm map, the processed scan
    and the guess that `align` starts from."""
    packed = replay.pack_sequence(config, seq, device=dev)
    _, chunks, scans, _, updates, _ = packed
    step, carry = bench.start_replay(dev, config, packed[0])
    for k in bench.KERNELS:
        k.reset_launches()
    rows = slice(0, chunks.dt.shape[0])
    (state, voxmap, _, _), _, _, diags = bench.run_rows(step, carry, packed, rows)
    bench.synchronize(dev)
    upd = np.asarray(updates)
    warm_up = {
        "launches": {k.name: k.launch_count() for k in bench.KERNELS},
        "gn_iterations": int(diags["icp_iterations"].cpu().numpy()[upd].sum()),
        "update_rows": int(upd.sum()),
        # a predict call a row, a scan's or an overflow row's
        "predict_calls": int(chunks.dt.shape[0]),
    }
    noise = eskf.make_noise_params(config, dev)
    chunk = type(chunks)(*(x[-1] for x in chunks))
    scan = type(scans)(*(x[-1] for x in scans))
    base, hist = eskf.predict_chunk_prefix(state, chunk, noise, base_mask=chunk.t_rel <= 0.0)
    processed = preprocess.preprocess(scan, hist, odo.lidar_extrinsics(config, dev), config)
    return dict(voxmap=voxmap, processed=processed, guess=eskf.pose_of(base),
                voxels=int(voxmap.num_voxels()), warm_up=warm_up)


def variant_lines(probe: dict, config: Config, dev: torch.device, k: int = K) -> list[dict]:
    """Each variant's `align` timed on the probe, and its iterations."""
    timer = bench.StageTimer(dev, config.max_raw_points)
    processed, voxmap, guess = probe["processed"], probe["voxmap"], probe["guess"]
    c = torch.zeros((), device=dev)  # a carried scalar the next iteration reads
    lines = []
    for name, change in VARIANTS.items():
        vcfg = dataclasses.replace(config, **change)

        def align():
            moved = Pose(guess.R, guess.t + c * 1e-12)
            c.copy_(registration.align(processed, voxmap, moved, vcfg).pose.t[0])

        ms = timer.measure(align, c.zero_, k)[0]
        res = registration.align(processed, voxmap, guess, vcfg)
        lines.append({"variant": name, "align_ms": round(ms, 3),
                      "iterations": int(res.iterations)})
    return lines


def main(argv: list[str] | None = None, config: Config | None = None,
         seq: dataset.Sequence | None = None, k: int = K) -> int:
    """`config` and `seq` replace the JAX script's (a test's small run)."""
    args = tools.parser("What each variant of the GN re-match costs in align.").parse_args(argv)
    dev = device_policy.resolve(args.device)
    if config is None or seq is None:
        config, seq = heavy()
    probe = warm_probe(config, seq, dev)
    print("warm map voxels:", probe["voxels"], flush=True)
    tools.emit({"warm_up": probe["warm_up"]})
    for line in variant_lines(probe, config, dev, k):
        tools.emit(line)
    tools.report_device(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
