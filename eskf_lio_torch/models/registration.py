"""Voxelized GICP registration (port of `eskf_lio_tpu/models/registration.py`).

Iterated Gauss-Newton alignment of a covariance-annotated scan against the
voxel map's per-voxel Gaussians, with the reference's semantics
(`Registration.cpp`): correspondence = the point's own voxel; W =
(Σ_src_world + Σ_voxel)⁻¹, J = [I | −[p]×], solve JᵀWJ·ξ = −JᵀWr with
r = p − μ, left-compose se3-exp(ξ); convergence on cos θ and ‖t‖²,
bounded by `icp_max_iterations`.

The JAX `lax.while_loop` (`eskf_lio_tpu/models/registration.py:298`, cond
`it < max & ~conv`) is `utils.graphs.device_while` over a device carry:
inside a captured step a CUDA WHILE node, so the loop runs on the device
with no host read; eagerly a Python loop that reads the condition once per
GN iteration.

Each GN pass is `ops/gn_pass.py::lookup` (the scan to the world and each
point's correspondence in the two-tier map), the normal equations (kernel A,
`ops/gn_normal_eq.py`, unless `gn_backend="einsum"`) and
`gn_pass.increment` (the solve, the left compose, the convergence test),
which writes the loop's next carry in place.  On CUDA tensors each is a
hand-written kernel, so that a pass of the default backend is three
launches; on CPU tensors each runs its plain PyTorch version.  The adaptive
re-match (`lax.cond`, ibid. `:217`) and `icp_relookup_every > 1` are the
lookup's own test, which keeps the cached correspondences where it skips.

The sharded map (`parallel/sharded_map.py`) hands `align` a scan of owner
slices and one map block per slice; `reduce_fn` sums each iteration's
normal equations over the shards before the increment, so that every shard
(and every process) composes the same increment and reads the same
`converged`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from eskf_lio_torch.config import Config
from eskf_lio_torch.map import voxel_map as vm
from eskf_lio_torch.ops import gn_normal_eq, gn_pass, lie
from eskf_lio_torch.ops.gn_pass import solve_increment  # noqa: F401 (re-exported)
from eskf_lio_torch.types import Pose, ProcessedScan
from eskf_lio_torch.utils.graphs import device_while
from eskf_lio_torch.utils.profiling import stage


class AlignResult(NamedTuple):
    pose: Pose
    iterations: torch.Tensor  # int64 scalar: GN iterations run
    converged: torch.Tensor  # bool scalar
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


def _rematch_needed(pts_w, mask, R_d, t_d, delta: float) -> torch.Tensor:
    """The adaptive re-match flag per slice: whether the increment (R_d,
    t_d) may move a matched point farther than `delta`, a bound on any scan
    point's displacement rotating about the scan centroid c."""
    w = mask.to(pts_w.dtype)
    n_valid = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    c = (pts_w * w[..., None]).sum(-2) / n_valid
    r_c = torch.sqrt((((pts_w - c[..., None, :]) ** 2).sum(-1) * w).amax(-1))
    theta = torch.arccos(torch.clamp(0.5 * (torch.trace(R_d) - 1.0), -1.0, 1.0))
    drift = c @ (R_d - torch.eye(3, dtype=pts_w.dtype, device=pts_w.device)).T + t_d
    return (theta * r_c + torch.linalg.norm(drift, dim=-1) > delta).reshape(-1)


def align(
    scan: ProcessedScan,
    voxmap: vm.VoxelMap | Sequence[vm.VoxelMap],
    guess: Pose,
    config: Config,
    reduce_fn: Callable | None = None,
    tracer=None,
) -> AlignResult:
    """Iterated GN alignment (`ICP::align`, `Registration.cpp:7-35`).

    `reduce_fn(JTJ, JTr, num_corr) -> (JTJ, JTr, num_corr)` sees every
    iteration's normal equations before the increment (the JAX package's
    `psum` hook); without it they are used as they are, with no extra launch.

    A scan with a leading axis — points [L, S, 3], covs [L, S, 3, 3], valid
    [L, S]: the owner slices of L map shards held by this process — takes L
    map blocks, slice i looked up in block i, and runs ONE loop for all of
    them: the normal equations are taken slice by slice and stacked as
    [L, 6, 6], [L, 6], [L], and `reduce_fn`, required then, sums them.  The
    adaptive re-match flag stays per slice, as it is per device in the JAX
    package.

    carry = (active, it, conv, R_tot, t_tot, num_corr, mu, cov_map_packed,
    mask) and, with the adaptive re-match, `need` [L]: the first pass writes
    fresh buffers, the loop's passes update the carry in place, which under
    capture is the WHILE node's own, so a pass copies nothing.

    With a tracer, each GN iteration's head is marked (`profiling.stage`, a
    tick named "gn"): a stamp node at the top level for the first pass and
    one in the WHILE node's body, written once a pass on the device."""
    sliced = scan.points.dim() == 3
    n_slices = scan.points.shape[0] if sliced else 1
    blocks = [voxmap] if isinstance(voxmap, vm.VoxelMap) else list(voxmap)
    if len(blocks) != n_slices:
        raise ValueError(f"a scan of {n_slices} slice(s) needs as many map blocks, got "
                         f"{len(blocks)}")
    if sliced and reduce_fn is None:
        raise ValueError("a scan of owner slices needs reduce_fn")
    dev = scan.points.device
    max_it = int(config.icp_max_iterations)
    if max_it <= 0:
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return AlignResult(pose=Pose(guess.R, guess.t), iterations=zero,
                           converged=torch.zeros((), dtype=torch.bool, device=dev),
                           num_correspondences=zero.clone())

    def per_slice(x):
        return x.unbind(0) if sliced else (x,)

    points, valid, covs = (per_slice(x) for x in (scan.points, scan.valid, scan.covs))
    covs_packed = per_slice(vm.pack_cov(scan.covs).contiguous())  # loop-invariant (body frame)
    if resolve_backend(config) == "fused":
        def normal_eq(i, pts_w, R, mu, cov_map_packed, mask):
            # kernel A sums the mask too: no separate count launch
            return gn_normal_eq.normal_equations_rotated(pts_w, covs_packed[i], R, mu,
                                                         cov_map_packed, mask)
    else:
        def normal_eq(i, pts_w, R, mu, cov_map_packed, mask):
            JTJ, JTr = normal_equations(pts_w, R @ covs[i] @ R.T, mu,
                                        vm.unpack_cov(cov_map_packed), mask)
            return JTJ, JTr, mask.sum().to(torch.float32)

    # adaptive lazy re-association (config.icp_rematch_threshold): re-match
    # while the previous increment could have moved a point across a voxel
    # border; default 0 = re-match every iteration (reference parity)
    delta = float(config.icp_rematch_threshold)
    adaptive = delta > 0.0
    lookup_kw = dict(voxel_size=config.map_voxel_size,
                     max_points_per_voxel=config.max_points_per_voxel,
                     key_bits=config.map_key_bits, relook=max(int(config.icp_relookup_every), 1))
    increment_kw = dict(max_iterations=max_it, cosine_threshold=config.icp_cosine_threshold,
                        translation_sq_threshold=config.icp_translation_sq_threshold,
                        deltas=adaptive)

    def body(carry, first: bool = False):
        stage(tracer, "gn", tick=True)
        if first:
            state, corr, it, R_tot, t_tot, need = None, carry, None, guess.R, guess.t, None
        else:
            state, corr = carry[:6], carry[6:9]
            it, R_tot, t_tot = state[1], state[3], state[4]
            need = carry[9] if adaptive else None
        sums, matched = [], []
        for i, (block, *out) in enumerate(zip(blocks, *(per_slice(x) for x in corr))):
            pts_w, mu, cov_map_packed, mask = gn_pass.lookup(
                points[i], valid[i], R_tot, t_tot, block, out=out, it=it,
                need=None if need is None else need[i:i + 1], **lookup_kw)
            sums.append(normal_eq(i, pts_w, R_tot, mu, cov_map_packed, mask))
            matched.append((pts_w, mask))
        JTJ, JTr, num_corr = (torch.stack(x) for x in zip(*sums)) if sliced else sums[0]
        if reduce_fn is not None:
            JTJ, JTr, num_corr = reduce_fn(JTJ, JTr, num_corr)
        new = gn_pass.increment(JTJ, JTr, num_corr, R_tot, t_tot, it, out=state, **increment_kw)
        if not adaptive:
            return (*new, *corr)
        *new, R_d, t_d = new
        need = [_rematch_needed(pts_w, mask, R_d, t_d, delta) for pts_w, mask in matched]
        return (*new, *corr, torch.cat(need) if sliced else need[0])

    # the first pass always runs (it = 0 < max, not converged) and always
    # looks up: outside the loop, so that an eager loop reads its condition
    # once a pass
    rows = scan.points.shape[:-1]
    corr = (scan.points.new_empty((*rows, 3)), scan.points.new_empty((*rows, 6)),
            torch.empty(rows, dtype=torch.bool, device=dev))
    carry = device_while(body, body(corr, first=True), max_it - 1)
    _, it, conv, R_tot, t_tot, num_corr, *_ = carry
    # kernel A counts in f32 (exact below 2^24): one cast a scan
    return AlignResult(pose=Pose(R_tot, t_tot), iterations=it, converged=conv,
                       num_correspondences=num_corr.to(torch.int64))
