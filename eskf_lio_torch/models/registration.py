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
GN iteration.  The adaptive re-match (`lax.cond`, ibid. `:217`) and
`icp_relookup_every > 1` guard the lookup with `device_if`.  The normal
equations go through kernel A (`ops/gn_normal_eq.py`) unless
`gn_backend="einsum"`.

On CUDA tensors with the default lookup and kernel A, each GN pass is
three launches (`_align_on_kernels`): `ops/gn_pass.py`'s lookup kernel,
kernel A, and its increment kernel, which writes the loop's next carry in
place (the re-match guards become the lookup kernel's own test).  Every
CPU run, the einsum backend and the sharded map's hooks keep the torch
chain below, which the kernels' plain versions repeat op for op (and whose
bits the kernels give on the card).

Two hooks serve the sharded map (`parallel/sharded_map.py`): `lookup_fn`
answers from a map shard, and `reduce_fn` sums each iteration's normal
equations over the shards before the solve, so that every shard (and every
process) composes the same increment and reads the same `converged`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from eskf_lio_torch.config import Config
from eskf_lio_torch.map import voxel_map as vm
from eskf_lio_torch.ops import gn_normal_eq, gn_pass, lie
from eskf_lio_torch.ops.gn_pass import solve_increment
from eskf_lio_torch.types import Pose, ProcessedScan
from eskf_lio_torch.utils.graphs import device_if, device_while
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


def converged_check(R_delta, t_delta, config: Config) -> torch.Tensor:
    """ref `convergenceCheck` (`Registration.cpp:37-50`)."""
    return gn_pass.converged(
        R_delta, t_delta, config.icp_cosine_threshold, config.icp_translation_sq_threshold
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


def _align_on_kernels(scan, voxmap, guess, config, tracer) -> AlignResult:
    """`align` on the card with the default lookup and kernel A: each GN pass
    is three launches, `gn_pass.lookup`, kernel A, `gn_pass.increment`.
    The first pass writes fresh buffers; the loop's passes update its carry
    in place, which under capture is the WHILE node's own, so a pass copies
    nothing.  carry =
    (active, it, conv, R_tot, t_tot, num_corr, mu, cov_map_packed, mask)
    and, with the adaptive re-match, `need`."""
    relook = max(int(config.icp_relookup_every), 1)
    delta = float(config.icp_rematch_threshold)
    adaptive = delta > 0.0
    max_it = int(config.icp_max_iterations)
    covs_packed = vm.pack_cov(scan.covs).contiguous()  # loop-invariant (body frame)
    lookup_kw = dict(voxel_size=config.map_voxel_size,
                     max_points_per_voxel=config.max_points_per_voxel,
                     key_bits=config.map_key_bits, relook=relook)
    increment_kw = dict(max_iterations=max_it, cosine_threshold=config.icp_cosine_threshold,
                        translation_sq_threshold=config.icp_translation_sq_threshold,
                        deltas=adaptive)

    def body(carry, first: bool = False):
        stage(tracer, "gn", tick=True)
        if first:
            R_tot, t_tot, it, need, corr, state = guess.R, guess.t, None, None, None, None
        else:
            state, corr = carry[:6], carry[6:9]
            it, R_tot, t_tot = state[1], state[3], state[4]
            need = carry[9] if adaptive else None
        pts_w, mu, cov_map_packed, mask = gn_pass.lookup(
            scan.points, scan.valid, R_tot, t_tot, voxmap, out=corr, it=it, need=need,
            **lookup_kw)
        JTJ, JTr, num_corr = gn_normal_eq.normal_equations_rotated(
            pts_w, covs_packed, R_tot, mu, cov_map_packed, mask)
        new = gn_pass.increment(JTJ, JTr, num_corr, R_tot, t_tot, it, out=state,
                                **increment_kw)
        if not adaptive:
            return (*new, mu, cov_map_packed, mask)
        *new, R_d, t_d = new
        return (*new, mu, cov_map_packed, mask, _rematch_needed(pts_w, mask, R_d, t_d, delta))

    # the first pass always runs (it = 0 < max, not converged) and always
    # looks up: outside the loop, so that an eager loop reads its condition
    # once a pass
    carry = device_while(body, body(None, first=True), max_it - 1)
    _, it, conv, R_tot, t_tot, num_corr, *_ = carry
    return AlignResult(pose=Pose(R_tot, t_tot), iterations=it, converged=conv,
                       num_correspondences=num_corr.to(torch.int64))


def align(
    scan: ProcessedScan,
    voxmap: vm.VoxelMap | None,
    guess: Pose,
    config: Config,
    lookup_fn: Callable | None = None,
    reduce_fn: Callable | None = None,
    tracer=None,
) -> AlignResult:
    """Iterated GN alignment (`ICP::align`, `Registration.cpp:7-35`).

    `lookup_fn(points_world) -> (mu [N,3], cov_packed [N,6], hit [N])`
    defaults to the merged two-tier map lookup.

    `reduce_fn(JTJ, JTr, num_corr) -> (JTJ, JTr, num_corr)` sees every
    iteration's normal equations before the solve (the JAX package's `psum`
    hook); without it they are used as they are, with no extra launch.

    A scan with a leading axis — points [L, S, 3], covs [L, S, 3, 3], valid
    [L, S]: the owner slices of L map shards held by this process — runs
    ONE loop for all of them: `lookup_fn` answers for [L, S, 3] points, the
    normal equations are taken slice by slice (kernel A once per slice) and
    stacked as [L, 6, 6], [L, 6], [L], and `reduce_fn`, required then,
    sums them.  The adaptive re-match predicate stays per slice, as it is
    per device in the JAX package.

    With a tracer, each GN iteration's head is marked (`profiling.stage`, a
    tick named "gn"): a stamp node at the top level for the first pass and
    one in the WHILE node's body, written once a pass on the device."""
    sliced = scan.points.dim() == 3
    if sliced and (lookup_fn is None or reduce_fn is None):
        raise ValueError("a scan of owner slices needs lookup_fn and reduce_fn")
    backend = resolve_backend(config)
    if (lookup_fn is None and reduce_fn is None and backend == "fused" and scan.points.is_cuda
            and int(config.icp_max_iterations) > 0):
        return _align_on_kernels(scan, voxmap, guess, config, tracer)
    if lookup_fn is None:
        def lookup_fn(pts):
            return vm.lookup(
                voxmap, pts,
                voxel_size=config.map_voxel_size,
                max_points_per_voxel=config.max_points_per_voxel,
                key_bits=config.map_key_bits,
            )

    covs = scan.covs
    covs_packed = vm.pack_cov(covs).contiguous()  # loop-invariant (body frame)

    def normal_eq(pts_w, covs, covs_packed, R_tot, mu, cov_map_packed, mask):
        if backend == "fused":
            # the kernel sums the mask too: no separate count launch
            return gn_normal_eq.normal_equations_rotated(
                pts_w, covs_packed, R_tot, mu, cov_map_packed, mask
            )
        covs_w = R_tot @ covs @ R_tot.T
        JTJ, JTr = normal_equations(
            pts_w, covs_w, mu, vm.unpack_cov(cov_map_packed), mask
        )
        return JTJ, JTr, mask.sum()

    relook = max(int(config.icp_relookup_every), 1)
    # adaptive lazy re-association (config.icp_rematch_threshold): re-match
    # while the previous increment could have moved a point across a voxel
    # border; default 0 = re-match every iteration (reference parity)
    delta = float(config.icp_rematch_threshold)
    adaptive = delta > 0.0
    max_it = int(config.icp_max_iterations)
    dev, dtype = scan.points.device, scan.points.dtype
    n_slices = scan.points.shape[0] if sliced else 1

    def body(carry):
        """One GN iteration.  carry = (active, it, conv, R_tot, t_tot,
        num_corr, need, mu, cov_map_packed, hit): `need` is the adaptive
        re-match flag per slice, (mu, cov_map_packed, hit) the cached
        correspondences."""
        stage(tracer, "gn", tick=True)
        _, it, _, R_tot, t_tot, _, need, *corr = carry
        pts_w = lie.transform_points(R_tot, t_tot, scan.points)
        if adaptive:
            def relookup():
                new = lookup_fn(pts_w)
                if not sliced:
                    return new
                # only the slices whose flag is set take the new matches
                return tuple(
                    torch.where(need.view(-1, *(1,) * (x.dim() - 1)), x, old)
                    for x, old in zip(new, corr)
                )
            corr = device_if(need.any(), relookup, outs=corr)
        elif relook > 1:
            corr = device_if(it % relook == 0, lambda: lookup_fn(pts_w), outs=corr)
        else:
            corr = lookup_fn(pts_w)
        mu, cov_map_packed, hit = corr
        mask = scan.valid & hit

        if sliced:
            JTJ, JTr, num_corr = (
                torch.stack(x) for x in zip(*(
                    normal_eq(pts_w[i], covs[i], covs_packed[i], R_tot, mu[i],
                              cov_map_packed[i], mask[i])
                    for i in range(scan.points.shape[0])
                ))
            )
        else:
            JTJ, JTr, num_corr = normal_eq(
                pts_w, covs, covs_packed, R_tot, mu, cov_map_packed, mask
            )
        if reduce_fn is not None:
            JTJ, JTr, num_corr = reduce_fn(JTJ, JTr, num_corr)
        R_d, t_d = solve_increment(JTJ, JTr, num_corr)

        # left-compose (`Registration.cpp:19`)
        R_tot, t_tot = R_d @ R_tot, R_d @ t_tot + t_d
        conv = converged_check(R_d, t_d, config)
        if adaptive:
            need = _rematch_needed(pts_w, mask, R_d, t_d, delta)
        it = it + 1
        active = (it < max_it) & ~conv
        return (active, it, conv, R_tot, t_tot, num_corr.reshape(()).to(torch.float32),
                need, mu, cov_map_packed, hit)

    # the correspondences of the first pass are always looked up: the cache
    # starts empty and every slice needs a match
    n_rows = scan.points.shape[:-1]
    carry = (
        torch.full((), max_it > 0, dtype=torch.bool, device=dev),
        torch.zeros((), dtype=torch.int64, device=dev),
        torch.zeros((), dtype=torch.bool, device=dev),
        guess.R, guess.t,
        torch.zeros((), dtype=torch.float32, device=dev),
        torch.ones(n_slices, dtype=torch.bool, device=dev),
        torch.zeros((*n_rows, 3), dtype=dtype, device=dev),
        torch.zeros((*n_rows, 6), dtype=dtype, device=dev),
        torch.zeros(n_rows, dtype=torch.bool, device=dev),
    )
    if max_it > 0:
        # the first pass always runs (it = 0 < max, not converged): outside
        # the loop, so that an eager loop reads its condition once a pass
        carry = device_while(body, body(carry), max_it - 1)
    _, it, conv, R_tot, t_tot, num_corr, *_ = carry
    return AlignResult(
        pose=Pose(R_tot, t_tot),
        iterations=it,
        converged=conv,
        # kernel A counts in f32 (exact below 2^24): one cast a scan
        num_correspondences=num_corr.to(torch.int64),
    )
