"""The port's VGICP `align` (`eskf_lio_torch/models/registration.py`) vs the
JAX package's, on the three-plane world of `tests/test_registration.py`.

The same map is built in both packages from the same points; the scan is
the world seen from a perturbed pose.  The JAX side runs
`gn_backend="einsum"` (the reference path off-TPU).  The port runs both
its einsum path and its fused path (kernel A's plain version on CPU
tensors).  Both must take the same number of GN iterations and land on
the same pose within 1e-4 (m, and rotation-matrix entries): a few f32
Gauss-Newton steps from the same start.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eskf_lio_torch.config import Config as TConfig
from eskf_lio_torch.map import voxel_map as t_vm
from eskf_lio_torch.models import registration as t_reg
from eskf_lio_torch.ops import lie as t_lie
from eskf_lio_torch.types import Pose as TPose, ProcessedScan as TScan
from eskf_lio_tpu.config import Config as JConfig
from eskf_lio_tpu.map import voxel_map as j_vm
from eskf_lio_tpu.models import registration as j_reg
from eskf_lio_tpu.types import Pose as JPose, ProcessedScan as JScan

torch.set_num_threads(2)

CAP = 1 << 14
N_SCAN = 2048


def make_world(rng, n=6000):
    """Points on three orthogonal planes (floor + 2 walls) with their plane
    covariances: a full 6-DoF constraint."""
    n3 = n // 3
    floor = np.column_stack([rng.uniform(-8, 8, n3), rng.uniform(-8, 8, n3), np.zeros(n3)])
    wall1 = np.column_stack([rng.uniform(-8, 8, n3), np.full(n3, -8.0), rng.uniform(0, 4, n3)])
    wall2 = np.column_stack([np.full(n3, 8.0), rng.uniform(-8, 8, n3), rng.uniform(0, 4, n3)])
    normals = np.vstack([np.tile(v, (n3, 1)) for v in ([0, 0, 1.0], [0, 1.0, 0], [1.0, 0, 0])])
    pts = np.vstack([floor, wall1, wall2]).astype(np.float32)
    covs = np.stack([np.eye(3) - 0.99 * np.outer(v, v) for v in normals]).astype(np.float32)
    return pts, covs


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    pts, covs = make_world(rng)
    packed = covs[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    kw = dict(voxel_size=0.3, max_points_per_voxel=1000)
    t_map, _ = t_vm.insert(t_vm.VoxelMap.create(CAP, device="cpu"), torch.as_tensor(pts),
                           torch.as_tensor(packed), torch.ones(len(pts), dtype=torch.bool), **kw)
    j_map, _ = j_vm.insert(j_vm.VoxelMap.create(CAP), jnp.asarray(pts), jnp.asarray(packed),
                           jnp.ones(len(pts), bool), **kw)
    return pts, covs, t_map, j_map


def scan_from(pts, covs, xi, seed):
    """The world seen from the pose exp(xi): body-frame points, N_SCAN of
    them, with 10 % padding rows."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(pts), N_SCAN, replace=False)
    R, t = t_lie.se3_exp(torch.as_tensor(np.asarray(xi, np.float32)))
    body = ((torch.as_tensor(pts[idx]) - t) @ R).numpy()
    valid = np.arange(N_SCAN) < int(0.9 * N_SCAN)
    return np.where(valid[:, None], body, 0).astype(np.float32), covs[idx], valid


@pytest.mark.parametrize(
    "xi,seed",
    [([0.05, -0.04, 0.02, 0.01, -0.02, 0.03], 1), ([0.1, 0.08, -0.05, -0.02, 0.01, 0.05], 2)],
)
def test_align_matches_jax(world, xi, seed):
    pts, covs, t_map, j_map = world
    body, bcovs, valid = scan_from(pts, covs, xi, seed)
    cfg = dict(max_scan_points=N_SCAN, icp_max_iterations=30, gn_backend="einsum")
    j = j_reg.align(JScan(jnp.asarray(body), jnp.asarray(bcovs), jnp.asarray(valid)), j_map,
                    JPose(jnp.eye(3), jnp.zeros(3)), JConfig(**cfg))
    scan = TScan(torch.as_tensor(body), torch.as_tensor(bcovs), torch.as_tensor(valid))
    guess = TPose.identity("cpu")
    for backend in ("einsum", "auto"):
        t = t_reg.align(scan, t_map, guess, TConfig(**{**cfg, "gn_backend": backend}))
        assert t.iterations == int(j.iterations), backend
        assert t.converged == bool(j.converged)
        assert t.num_correspondences.dtype == torch.int64
        assert int(t.num_correspondences) == int(j.num_correspondences)
        np.testing.assert_allclose(t.pose.t.numpy(), np.asarray(j.pose.t), atol=1e-4)
        np.testing.assert_allclose(t.pose.R.numpy(), np.asarray(j.pose.R), atol=1e-4)
    # and it moved most of the way to the true pose (single-voxel matches
    # on 2048 points leave a residual offset, the same in both packages)
    _, t_true = t_lie.se3_exp(torch.as_tensor(np.asarray(xi, np.float32)))
    err = np.linalg.norm(t.pose.t.numpy() - t_true.numpy())
    assert err < 0.5 * np.linalg.norm(t_true.numpy())


def test_lazy_rematch_options_match_jax(world):
    """icp_relookup_every and icp_rematch_threshold follow the JAX loop."""
    pts, covs, t_map, j_map = world
    body, bcovs, valid = scan_from(pts, covs, [0.05, -0.04, 0.02, 0.01, -0.02, 0.03], 3)
    base = dict(max_scan_points=N_SCAN, icp_max_iterations=30, gn_backend="einsum")
    for extra in (dict(icp_relookup_every=2), dict(icp_rematch_threshold=0.01)):
        j = j_reg.align(JScan(jnp.asarray(body), jnp.asarray(bcovs), jnp.asarray(valid)), j_map,
                        JPose(jnp.eye(3), jnp.zeros(3)), JConfig(**base, **extra))
        t = t_reg.align(TScan(torch.as_tensor(body), torch.as_tensor(bcovs), torch.as_tensor(valid)),
                        t_map, TPose.identity("cpu"), TConfig(**base, **extra))
        assert t.iterations == int(j.iterations), extra
        np.testing.assert_allclose(t.pose.t.numpy(), np.asarray(j.pose.t), atol=1e-4)


def test_degenerate_system_gives_identity_step():
    JTJ = torch.zeros(6, 6)
    R, t = t_reg.solve_increment(JTJ, torch.ones(6), torch.tensor(3))
    np.testing.assert_array_equal(R.numpy(), np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(t.numpy(), np.zeros(3, np.float32))


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        t_reg.resolve_backend(dataclasses.replace(TConfig(), gn_backend="triton"))
