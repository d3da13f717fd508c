"""Replay the bench's LIGHT-shaped workload and report its accuracy (port of
`tools/ate_check.py`): ATE against ground truth, the per-scan error and GN
iterations around scans 95..115, and the ground-truth speed.

    python -m eskf_lio_torch.tools.ate_check                 # default noises
    python -m eskf_lio_torch.tools.ate_check --ref-noise     # reference YAML noises (1e-6)
    python -m eskf_lio_torch.tools.ate_check --tn 1e-4 --rn 3e-5

Runs `pipeline/replay.py::run_replay` on the card by default (the JAX script
forces the CPU; `--device cpu` runs the plain paths).  Prints the JAX
script's four lines, then the device line.  The errors are taken after the
rigid (Umeyama) alignment the bench scores ATE with: the JAX script
subtracts the raw positions, and the filter starts at the origin where the
synthetic ground truth starts at (5.00, 0.01, 1.37) m, so its raw ATE is
that offset (~4-5 m); the first line gives the raw rmse too.
"""

from __future__ import annotations

import sys

import numpy as np

from eskf_lio_torch import tools
from eskf_lio_torch import device as device_policy
from eskf_lio_torch.config import Config, ImuConfig
from eskf_lio_torch.io import dataset
from eskf_lio_torch.pipeline import replay
from eskf_lio_torch.utils import metrics

POINTS_PER_SCAN = 20000
SEED = 11


def make_config(tn: float, rn: float, max_raw_points: int = 24576,
                max_scan_points: int = 12288, hash_capacity_log2: int = 19) -> Config:
    return Config(
        imu=ImuConfig(gravity=(0.0, 0.0, -9.81)),
        translation_noise=tn, rotation_noise=rn,
        max_raw_points=max_raw_points, max_scan_points=max_scan_points, max_imu_per_scan=64,
        hash_capacity_log2=hash_capacity_log2,
    )


def run(config: Config, seq: dataset.Sequence, device) -> dict:
    """The replay and its errors against ground truth, after the rigid
    (Umeyama) alignment the bench scores ATE with, and raw."""
    positions, _, diags, _ = replay.run_replay(config, seq, device=device)
    gt = np.asarray(seq.gt_positions)
    n = min(len(positions), len(gt))
    R, t, _ = metrics.umeyama_alignment(positions[:n], gt[:n])
    return dict(positions=positions, err=np.linalg.norm(positions[:n] @ R.T + t - gt[:n], axis=1),
                raw_err=np.linalg.norm(positions[:n] - gt[:n], axis=1),
                iterations=diags["icp_iterations"],
                v_gt=np.gradient(gt, np.asarray(seq.gt_times), axis=0))


def main(argv: list[str] | None = None, points_per_scan: int = POINTS_PER_SCAN,
         **capacities) -> int:
    """`points_per_scan` and `capacities` (`make_config`'s keywords) are the
    JAX script's by default; a test makes them small."""
    ap = tools.parser("Replay the bench's LIGHT-shaped workload and report its accuracy.")
    ap.add_argument("--tn", type=float, default=1e-4, help="translation noise")
    ap.add_argument("--rn", type=float, default=3e-5, help="rotation noise")
    ap.add_argument("--ref-noise", action="store_true",
                    help="use the reference YAML update noises (1e-6/1e-6)")
    ap.add_argument("--duration", type=float, default=13.0)
    args = ap.parse_args(argv)
    dev = device_policy.resolve(args.device)
    tn, rn = (1e-6, 1e-6) if args.ref_noise else (args.tn, args.rn)
    config = make_config(tn, rn, **capacities)
    seq = dataset.make_synthetic_sequence(
        duration=args.duration, points_per_scan=points_per_scan, seed=SEED
    )
    out = run(config, seq, dev)
    err, raw = out["err"], out["raw_err"]
    print(
        f"ATE rmse: {np.sqrt((err ** 2).mean()) * 100:.2f} cm  "
        f"max: {err.max() * 100:.2f} cm  port: after the bench's rigid alignment; raw, as "
        f"the JAX script takes it, rmse {np.sqrt((raw ** 2).mean()) * 100:.2f} cm",
        flush=True,
    )
    print("per-scan |error| cm, scans 95..115:", np.round(err[95:115] * 100, 1))
    print("iters 95..115:", out["iterations"][95:115])
    print(
        "gt speed at scans 20/60/100:",
        # (scans past a short sequence's end are left out)
        [round(float(np.linalg.norm(out["v_gt"][i])), 2) for i in (20, 60, 100)
         if i < len(out["v_gt"])],
        flush=True,
    )
    tools.report_device(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
