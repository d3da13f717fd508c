"""Frozen copy of `eskf_lio_torch/ops/eig3.py` for the benchmark's plain reference.

Kernel calls and device control flow are replaced by the plain versions
in `benchmark/reference/plain.py`; the arithmetic is the port's at the
commit that added the benchmark.  The original docstring follows.

Closed-form symmetric 3x3 eigen-analysis, batched and branchless (port of
`eskf_lio_tpu/ops/eig3.py`).

The reference regularises each per-point covariance to U·diag(1,1,1e-2)·Vᵀ
via Eigen::JacobiSVD (`CloudPreprocessor.cpp:121-123`); for a symmetric PSD
matrix that is I − (1−ε)·n̂n̂ᵀ with n̂ the smallest-eigenvalue eigenvector,
which has a closed form (trigonometric eigenvalues + cross products).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def smallest_eigvec_sym3(A: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric -> [..., 3] unit eigenvector of the smallest
    eigenvalue; ẑ for (near-)isotropic matrices."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    # trigonometric closed-form eigenvalues (Smith's algorithm)
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_EPS))

    # det(B)/2 with B = (A - q I) / p
    inv_p = 1.0 / p
    c00, c11, c22 = b00 * inv_p, b11 * inv_p, b22 * inv_p
    c01, c02, c12 = a01 * inv_p, a02 * inv_p, a12 * inv_p
    detB = (
        c00 * (c11 * c22 - c12 * c12)
        - c01 * (c01 * c22 - c12 * c02)
        + c02 * (c01 * c12 - c11 * c02)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    # eigenvector: null space of (A - λI) via row cross products
    r0 = torch.stack([a00 - lam_min, a01, a02], dim=-1)
    r1 = torch.stack([a01, a11 - lam_min, a12], dim=-1)
    r2 = torch.stack([a02, a12, a22 - lam_min], dim=-1)
    c_a = torch.linalg.cross(r0, r1)
    c_b = torch.linalg.cross(r0, r2)
    c_c = torch.linalg.cross(r1, r2)
    n_a = torch.sum(c_a * c_a, dim=-1)
    n_b = torch.sum(c_b * c_b, dim=-1)
    n_c = torch.sum(c_c * c_c, dim=-1)

    best_ab = torch.where((n_a >= n_b)[..., None], c_a, c_b)
    n_ab = torch.maximum(n_a, n_b)
    best = torch.where((n_ab >= n_c)[..., None], best_ab, c_c)
    n_best = torch.maximum(n_ab, n_c)

    # degenerate (isotropic / repeated eigenvalue): fall back to ẑ
    zhat = torch.zeros_like(best)
    zhat[..., 2] = 1.0
    vec = torch.where((n_best < _EPS)[..., None], zhat, best)
    return vec / torch.linalg.norm(vec, dim=-1, keepdim=True)


def plane_regularize(A: torch.Tensor, plane_factor: float) -> torch.Tensor:
    """U·diag(1,1,ε)·Uᵀ regularisation: I − (1−ε)·n̂n̂ᵀ."""
    n = smallest_eigvec_sym3(A)
    outer = n[..., :, None] * n[..., None, :]
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    return eye - (1.0 - plane_factor) * outer
