"""The port's VGICP `align` (`eskf_lio_torch/models/registration.py`) vs the
JAX package's, on the three-plane world of `tests/test_registration.py`.

The same map is built in both packages from the same points; the scan is
the world seen from a perturbed pose.  The JAX side runs
`gn_backend="einsum"` (the reference path off-TPU).  The port runs both
its einsum path and its fused path (kernel A's plain version on CPU
tensors).  Both must take the same number of GN iterations and land on
the same pose within 1e-4 (m, and rotation-matrix entries): a few f32
Gauss-Newton steps from the same start.

`test_align_matches_stored_jax_outputs` keeps the JAX package's `align`
on a few scans under each re-match setting (the default, `icp_relookup_every`
2, the adaptive re-match, both set) in `tests/data/align_jax.npz`, with the
world and the scans, and checks the file against the live JAX package; the
card's captured `align` is held to it (`tests/test_torch_gn_pass.py`: the
card has no JAX).  Write the file again with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_registration.py
"""

import dataclasses
from pathlib import Path

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
JAX_OUTPUTS = Path(__file__).parent / "data" / "align_jax.npz"
# the re-match settings of the stored cases; with both set the adaptive test
# decides (the JAX loop's `need`)
REMATCH = {"default": {}, "relook2": dict(icp_relookup_every=2),
           "adaptive": dict(icp_rematch_threshold=0.01),
           "relook2+adaptive": dict(icp_relookup_every=2, icp_rematch_threshold=0.01)}
SCANS = {"a": ([0.05, -0.04, 0.02, 0.01, -0.02, 0.03], 1),
         "b": ([0.1, 0.08, -0.05, -0.02, 0.01, 0.05], 2)}
ALIGN_CASES = [f"{scan}.{rematch}" for scan in SCANS for rematch in REMATCH]


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


MAP_KW = dict(voxel_size=0.3, max_points_per_voxel=1000)


@pytest.fixture(scope="module")
def world():
    return build_world()


def build_world():
    rng = np.random.default_rng(0)
    pts, covs = make_world(rng)
    packed = covs[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    kw = MAP_KW
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


def align_case(world, case: str) -> tuple[dict, dict]:
    """The stored case `case` ("<scan>.<rematch>"): its inputs (the scan and
    the config's re-match fields) and the JAX package's `align` outputs.
    The world's points and packed covariances are stored once, as "world"."""
    pts, covs, _, j_map = world
    scan, rematch = case.split(".")
    body, bcovs, valid = scan_from(pts, covs, *SCANS[scan])
    fields = dict(max_scan_points=N_SCAN, icp_max_iterations=30, **REMATCH[rematch])
    inp = dict(points=body, covs=bcovs, valid=valid,
               relookup_every=np.int64(fields.get("icp_relookup_every", 1)),
               rematch_threshold=np.float32(fields.get("icp_rematch_threshold", 0.0)))
    j = j_reg.align(JScan(jnp.asarray(body), jnp.asarray(bcovs), jnp.asarray(valid)), j_map,
                    JPose(jnp.eye(3), jnp.zeros(3)), JConfig(**fields, gn_backend="einsum"))
    out = dict(out_R=np.asarray(j.pose.R), out_t=np.asarray(j.pose.t),
               out_iterations=np.int64(j.iterations), out_converged=np.bool_(j.converged),
               out_num_correspondences=np.int64(j.num_correspondences))
    return inp, out


@pytest.mark.parametrize("case", ALIGN_CASES)
def test_align_matches_stored_jax_outputs(world, case):
    """The stored case is the live JAX package's, and the port's CPU `align`
    (the fused path) meets it: the same iterations and count, the pose
    within 1e-4."""
    inp, out = align_case(world, case)
    with np.load(JAX_OUTPUTS) as f:
        stored = {**{f"{case}.{k}": v for k, v in {**inp, **out}.items()},
                  **{f"world.{k}": v for k, v in world_arrays(world[0], world[1]).items()}}
        for key, value in stored.items():
            np.testing.assert_array_equal(
                f[key], value,
                err_msg=f"{JAX_OUTPUTS.name}: {key} is stale; write it again "
                        "(JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_registration.py)")
    cfg = TConfig(max_scan_points=N_SCAN, icp_max_iterations=30,
                  icp_relookup_every=int(inp["relookup_every"]),
                  icp_rematch_threshold=float(inp["rematch_threshold"]))
    t = t_reg.align(TScan(*(torch.as_tensor(inp[k]) for k in ("points", "covs", "valid"))),
                    world[2], TPose.identity("cpu"), cfg)
    assert int(t.iterations) == int(out["out_iterations"]), case
    assert bool(t.converged) == bool(out["out_converged"])
    assert int(t.num_correspondences) == int(out["out_num_correspondences"])
    np.testing.assert_allclose(t.pose.t.numpy(), out["out_t"], atol=1e-4)
    np.testing.assert_allclose(t.pose.R.numpy(), out["out_R"], atol=1e-4)


def test_degenerate_system_gives_identity_step():
    JTJ = torch.zeros(6, 6)
    R, t = t_reg.solve_increment(JTJ, torch.ones(6), torch.tensor(3))
    np.testing.assert_array_equal(R.numpy(), np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(t.numpy(), np.zeros(3, np.float32))


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        t_reg.resolve_backend(dataclasses.replace(TConfig(), gn_backend="triton"))


def world_arrays(pts, covs) -> dict:
    """The world as stored: points and packed covariances, from which the
    map is built (`t_vm.insert` into `VoxelMap.create(CAP)` with `MAP_KW`)."""
    return dict(points=pts, covs=covs[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]])


def write_jax_outputs() -> None:
    """Store the world and every `ALIGN_CASES` case's inputs and JAX outputs."""
    world_ = build_world()
    arrays = {f"world.{k}": v for k, v in world_arrays(world_[0], world_[1]).items()}
    for case in ALIGN_CASES:
        for key, value in {k: v for d in align_case(world_, case) for k, v in d.items()}.items():
            arrays[f"{case}.{key}"] = value
    JAX_OUTPUTS.parent.mkdir(exist_ok=True)
    np.savez_compressed(JAX_OUTPUTS, **arrays)
    print(f"wrote {JAX_OUTPUTS} ({JAX_OUTPUTS.stat().st_size} bytes, {len(arrays)} arrays)")


if __name__ == "__main__":
    write_jax_outputs()
