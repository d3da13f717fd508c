"""Trajectory metrics.

A copy of `eskf_lio_tpu/utils/metrics.py` (numpy only), kept in the
PyTorch port so that the port imports nothing of the JAX package.

The reference validates only visually (`README.md:70-73`); the framework's
accuracy gate is ATE (absolute trajectory error) after SE(3)/Sim(3)
alignment — the standard Umeyama closed form.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = False
) -> tuple[np.ndarray, np.ndarray, float]:
    """Least-squares rigid alignment src -> dst.  Returns (R, t, s) with
    dst ≈ s·R·src + t."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(
    est_positions: np.ndarray, gt_positions: np.ndarray, align: bool = True
) -> float:
    """RMSE of position error after optional SE(3) alignment (classic ATE)."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    assert est.shape == gt.shape
    if align:
        R, t, _ = umeyama_alignment(est, gt)
        est = est @ R.T + t
    err = est - gt
    return float(np.sqrt((err**2).sum(axis=-1).mean()))
