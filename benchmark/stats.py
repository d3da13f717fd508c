"""The arithmetic of the end-to-end metrics, over every sample of a window.

`ate_rmse` is copied from `eskf_lio_torch/utils/metrics.py` (the
Umeyama rigid alignment, then the RMSE of the positions)."""

from __future__ import annotations

import math

import numpy as np


def percentile(samples, q: float) -> float:
    """The nearest-rank q-th percentile of all samples (a missing sample is
    +inf, so it counts as beyond every limit)."""
    values = sorted(samples)
    if not values:
        return float("nan")
    return float(values[max(math.ceil(q / 100.0 * len(values)) - 1, 0)])


def rate(count: int, seconds: float) -> float:
    """Work completed per second of the whole window."""
    return count / seconds


def umeyama_alignment(src: np.ndarray, dst: np.ndarray):
    """Least-squares rigid alignment src -> dst: (R, t) with dst ≈ R·src + t."""
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    return R, mu_d - R @ mu_s


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE of the position error after the rigid alignment (m)."""
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    if est.shape != gt.shape:
        raise ValueError(f"trajectories of shapes {est.shape} and {gt.shape}")
    R, t = umeyama_alignment(est, gt)
    err = est @ R.T + t - gt
    return float(np.sqrt((err**2).sum(axis=-1).mean()))
