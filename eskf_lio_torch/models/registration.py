"""Voxelized GICP registration (port of `eskf_lio_tpu/models/registration.py`).

Iterated Gauss-Newton alignment of a covariance-annotated scan against the
voxel map's per-voxel Gaussians, with the reference's semantics
(`Registration.cpp`): correspondence = the point's own voxel; W =
(Σ_src_world + Σ_voxel)⁻¹, J = [I | −[p]×], solve JᵀWJ·ξ = −JᵀWr with
r = p − μ, left-compose se3-exp(ξ); convergence on cos θ and ‖t‖²,
bounded by `icp_max_iterations`.

The JAX `lax.while_loop` becomes a Python loop that reads `converged` on
the host once per GN iteration (one device sync per iteration; a CUDA
graph or a device-side loop is later work).  The normal equations go
through kernel A (`ops/gn_normal_eq.py`) unless `gn_backend="einsum"`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from eskf_lio_torch.config import Config
from eskf_lio_torch.map import voxel_map as vm
from eskf_lio_torch.ops import gn_normal_eq, lie
from eskf_lio_torch.types import Pose, ProcessedScan


class AlignResult(NamedTuple):
    pose: Pose
    iterations: int  # GN iterations run (host value: the loop counts them)
    converged: bool  # host value: the loop reads it every iteration
    num_correspondences: torch.Tensor  # int64 scalar (last iteration)


def inv3x3_sym(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of symmetric 3×3 matrices (adjugate/det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e = A[..., 1, 1], A[..., 1, 2]
    f = A[..., 2, 2]
    co_a = d * f - e * e
    co_b = c * e - b * f
    co_c = b * e - c * d
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / det
    i00 = co_a * inv_det
    i01 = co_b * inv_det
    i02 = co_c * inv_det
    i11 = (a * f - c * c) * inv_det
    i12 = (b * c - a * e) * inv_det
    i22 = (a * d - b * b) * inv_det
    return torch.stack(
        [
            torch.stack([i00, i01, i02], -1),
            torch.stack([i01, i11, i12], -1),
            torch.stack([i02, i12, i22], -1),
        ],
        dim=-2,
    )


def normal_equations(pts_w, covs_w, mu_map, cov_map, mask):
    """Accumulate JᵀWJ [6,6] and JᵀWr [6] over masked correspondences with
    batched 3×6 products (the JAX package's einsum path)."""
    dtype = pts_w.dtype
    n = pts_w.shape[0]
    W = inv3x3_sym(covs_w + cov_map) * mask[:, None, None].to(dtype)
    eye = torch.eye(3, dtype=dtype, device=pts_w.device).expand(n, 3, 3)
    J = torch.cat([eye, -lie.skew(pts_w)], dim=-1)  # [N, 3, 6]
    r = pts_w - mu_map
    WJ = W @ J  # [N, 3, 6]
    JTJ = torch.einsum("nia,nib->ab", J, WJ)
    JTr = torch.einsum("nia,ni->a", J, (W @ r[:, :, None])[:, :, 0])
    return JTJ, JTr


def solve_increment(JTJ, JTr, num_corr):
    """Solve JᵀWJ ξ = −JᵀWr.  Returns (R_Δ, t_Δ); degenerate systems (<6
    correspondences) give the identity update."""
    dtype = JTJ.dtype
    ok = num_corr >= 6
    reg = 1e-3 * (1.0 - ok.to(dtype)) + 1e-8
    JTJ_safe = JTJ + reg * torch.eye(6, dtype=dtype, device=JTJ.device)
    # solve_ex: no error check, hence no device sync; the result is
    # discarded via `ok` when the system is degenerate
    xi = torch.linalg.solve_ex(JTJ_safe, -JTr)[0]
    xi = torch.where(ok, xi, torch.zeros_like(xi))
    return lie.se3_exp(xi)


def converged_check(R_delta, t_delta, config: Config) -> torch.Tensor:
    """ref `convergenceCheck` (`Registration.cpp:37-50`)."""
    cosine = 0.5 * (torch.trace(R_delta) - 1.0)
    t_sq = torch.sum(t_delta * t_delta)
    return (cosine >= config.icp_cosine_threshold) & (
        t_sq <= config.icp_translation_sq_threshold
    )


def resolve_backend(config: Config) -> str:
    """"einsum", or "fused" for kernel A ("auto" and "pallas"): the fused
    path launches the CUDA kernel on CUDA tensors and runs its plain
    version on CPU tensors."""
    if config.gn_backend not in ("auto", "einsum", "pallas"):
        raise ValueError(
            f"gn_backend must be 'auto', 'einsum' or 'pallas', got "
            f"{config.gn_backend!r}"
        )
    return "einsum" if config.gn_backend == "einsum" else "fused"


def align(
    scan: ProcessedScan,
    voxmap: vm.VoxelMap | None,
    guess: Pose,
    config: Config,
    lookup_fn: Callable | None = None,
) -> AlignResult:
    """Iterated GN alignment (`ICP::align`, `Registration.cpp:7-35`).

    `lookup_fn(points_world) -> (mu [N,3], cov_packed [N,6], hit [N])`
    defaults to the merged two-tier map lookup."""
    if lookup_fn is None:
        def lookup_fn(pts):
            return vm.lookup(
                voxmap, pts,
                voxel_size=config.map_voxel_size,
                max_points_per_voxel=config.max_points_per_voxel,
            )

    backend = resolve_backend(config)
    covs = scan.covs
    covs_packed = vm.pack_cov(covs).contiguous()  # loop-invariant (body frame)
    relook = max(int(config.icp_relookup_every), 1)
    # adaptive lazy re-association (config.icp_rematch_threshold): re-match
    # while the previous increment could have moved a point across a voxel
    # border; default 0 = re-match every iteration (reference parity)
    delta = float(config.icp_rematch_threshold)
    adaptive = delta > 0.0

    R_tot, t_tot = guess.R, guess.t
    it, conv = 0, False
    num_corr = torch.zeros((), dtype=torch.int64, device=scan.points.device)
    corr = None
    disp_prev = float("inf")
    while it < config.icp_max_iterations and not conv:
        pts_w = lie.transform_points(R_tot, t_tot, scan.points)
        if adaptive:
            need = corr is None or disp_prev > delta
        else:
            need = corr is None or it % relook == 0
        if need:
            corr = lookup_fn(pts_w)
        mu, cov_map_packed, hit = corr
        mask = scan.valid & hit

        if backend == "fused":
            # the kernel sums the mask too: no separate count launch
            JTJ, JTr, num_corr = gn_normal_eq.normal_equations_rotated(
                pts_w, covs_packed, R_tot, mu, cov_map_packed, mask
            )
        else:
            num_corr = mask.sum()
            covs_w = R_tot @ covs @ R_tot.T
            JTJ, JTr = normal_equations(
                pts_w, covs_w, mu, vm.unpack_cov(cov_map_packed), mask
            )
        R_d, t_d = solve_increment(JTJ, JTr, num_corr)

        # left-compose (`Registration.cpp:19`)
        R_tot, t_tot = R_d @ R_tot, R_d @ t_tot + t_d
        conv_t = converged_check(R_d, t_d, config)
        if adaptive:
            # bound on any scan point's displacement by this increment,
            # rotating about the scan centroid c
            w = mask.to(pts_w.dtype)
            n_valid = torch.clamp(w.sum(), min=1.0)
            c = (pts_w * w[:, None]).sum(0) / n_valid
            r_c = torch.sqrt(torch.max(((pts_w - c) ** 2).sum(-1) * w))
            theta = torch.arccos(torch.clamp(0.5 * (torch.trace(R_d) - 1.0), -1.0, 1.0))
            drift = (R_d - torch.eye(3, dtype=pts_w.dtype, device=pts_w.device)) @ c + t_d
            disp_prev = float(theta * r_c + torch.linalg.norm(drift))
        it += 1
        conv = bool(conv_t)  # the one host sync of the iteration
    return AlignResult(
        pose=Pose(R_tot, t_tot),
        iterations=it,
        converged=conv,
        # kernel A counts in f32 (exact below 2^24): one cast a scan
        num_correspondences=num_corr.to(torch.int64),
    )
