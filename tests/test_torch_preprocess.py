"""The port's preprocessor (`eskf_lio_torch/ops/preprocess.py`) vs the JAX
package on the same scans.

Downsampling from identical points must give the same valid mask and the
same row order (the stable-sort first-point rule and the overflow hash
order are integer logic).  Points compare at atol 1e-5 m (f32 centre +
offset arithmetic at ~10 m) and covariances at atol 1e-4 (f32 moment sums
in other orders feed a closed-form eigenvector).  The deskew compares at
atol 1e-5 m: per-point 3x3 products at ~10 m in f32.

The JAX package's inputs and outputs of the downsample and preprocess cases
(with its neighbourhood covariances before the regularisation) are also
kept in `tests/data/preprocess_jax.npz`, which each case checks against
what it just computed, so that `tests/test_torch_cuda.py` can hold the CUDA
kernels to the JAX package on a machine without JAX.  Written by

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_preprocess.py
"""

import contextlib
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eskf_lio_torch.config import Config as TConfig
from eskf_lio_torch.ops import lie as t_lie
from eskf_lio_torch.ops import preprocess as t_pre
from eskf_lio_torch.types import Pose as TPose, Scan as TScan, StateHistory as THist
from eskf_lio_tpu.config import Config as JConfig
from eskf_lio_tpu.ops import eig3 as j_eig3
from eskf_lio_tpu.ops import preprocess as j_pre
from eskf_lio_tpu.types import Pose as JPose, Scan as JScan, StateHistory as JHist

torch.set_num_threads(2)

# (max_raw_points, max_scan_points): the hash-ordered overflow path
# (scan budget < raw), the no-overflow path, and padding (raw < budget)
SIZES = {"overflow": (4096, 1024), "no_overflow": (4096, 4096), "padding": (2048, 4096)}
PRE_CASES = ("overflow", "no_overflow")
JAX_OUTPUTS = Path(__file__).parent / "data" / "preprocess_jax.npz"


def room_scan(rng, n_raw, n_pts):
    """Points on a floor, two walls and a pillar around the sensor, padded
    to n_raw with an invalid tail."""
    k = n_pts // 4
    parts = [
        np.column_stack([rng.uniform(-8, 8, k), rng.uniform(-8, 8, k), np.full(k, -1.3)]),
        np.column_stack([rng.uniform(-8, 8, k), np.full(k, 6.1), rng.uniform(-1.3, 3, k)]),
        np.column_stack([np.full(k, -7.2), rng.uniform(-8, 8, k), rng.uniform(-1.3, 3, k)]),
        np.column_stack([2 + 0.5 * np.cos(a := rng.uniform(0, 6.3, k)), 1 + 0.5 * np.sin(a),
                         rng.uniform(-1.3, 3, k)]),
    ]
    pts = np.concatenate(parts) + rng.normal(size=(4 * k, 3)) * 0.01
    pts = np.vstack([pts, np.zeros((n_raw - len(pts), 3))]).astype(np.float32)
    valid = np.arange(n_raw) < 4 * k
    t_rel = np.where(valid, -0.1 + 0.1 * np.arange(n_raw) / n_raw, 0).astype(np.float32)
    return pts, t_rel, valid


def history(rng, m=12):
    """A smooth pose history over the sweep, index 0 at -inf, invalid tail."""
    t = np.concatenate([[-np.inf], np.linspace(-0.1, 0.01, m)]).astype(np.float32)
    p = np.cumsum(rng.normal(size=(m + 1, 3)) * 0.02, 0).astype(np.float32)
    r = np.cumsum(rng.normal(size=(m + 1, 3)) * 0.005, 0).astype(np.float32)
    q = t_lie.quat_exp(torch.as_tensor(r)).numpy()
    valid = np.arange(m + 1) < m - 1
    return t, p, q, valid


def downsample_case(case):
    """The inputs of a downsample case: raw points, mask, (raw, scan) sizes."""
    n_raw, n_scan = SIZES[case]
    rng = np.random.default_rng(n_raw + n_scan)
    pts, _, valid = room_scan(rng, n_raw, min(n_raw, 4000))
    return dict(points=pts, valid=valid, sizes=np.asarray([n_raw, n_scan]))


@contextlib.contextmanager
def raw_covariances(into: list):
    """Record the neighbourhood covariances [K, 3, 3] that the JAX package
    hands to `plane_regularize`, before the regularisation."""
    plane_regularize = j_eig3.plane_regularize

    def record(cov, plane_factor):
        into.append(np.asarray(cov))
        return plane_regularize(cov, plane_factor)

    j_eig3.plane_regularize = record
    try:
        yield
    finally:
        j_eig3.plane_regularize = plane_regularize


def jax_outputs(j, raw: list) -> dict:
    return dict(out_points=np.asarray(j.points), out_covs=np.asarray(j.covs),
                out_valid=np.asarray(j.valid), out_raw_cov=raw[0])


def jax_downsample(inp) -> dict:
    n_raw, n_scan = (int(x) for x in inp["sizes"])
    raw = []
    with raw_covariances(raw):
        j = j_pre.downsample_and_covariances(
            jnp.asarray(inp["points"]), jnp.asarray(inp["valid"]),
            JConfig(max_raw_points=n_raw, max_scan_points=n_scan))
    return jax_outputs(j, raw)


def assert_stored(name: str, inp: dict, out: dict) -> None:
    """The stored inputs and JAX outputs of case `name` are these."""
    with np.load(JAX_OUTPUTS) as f:
        for key, value in {**inp, **out}.items():
            np.testing.assert_array_equal(
                f[f"{name}.{key}"], value,
                err_msg=f"{JAX_OUTPUTS.name}: {name}.{key} is stale; write it again "
                        "(JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_preprocess.py)")


@pytest.mark.parametrize("case", sorted(SIZES))
def test_downsample_matches_jax(case):
    """CPU tensors take the plain version: no launch of the kernels."""
    inp = downsample_case(case)
    n_raw, n_scan = (int(x) for x in inp["sizes"])
    pts, valid = inp["points"], inp["valid"]
    tc = TConfig(max_raw_points=n_raw, max_scan_points=n_scan)
    j = jax_downsample(inp)
    assert_stored(f"downsample.{case}", inp, j)
    launches = t_pre.KERNEL.launch_count()
    t = t_pre.downsample_and_covariances(torch.as_tensor(pts), torch.as_tensor(valid), tc)
    assert t_pre.KERNEL.launch_count() == launches
    np.testing.assert_array_equal(t.valid.numpy(), j["out_valid"])
    assert t.valid.sum() > 100
    np.testing.assert_allclose(t.points.numpy(), j["out_points"], atol=1e-5)
    np.testing.assert_allclose(t.covs.numpy(), j["out_covs"], atol=1e-4)


def test_deskew_matches_jax():
    rng = np.random.default_rng(21)
    pts, t_rel, valid = room_scan(rng, 4096, 4000)
    hist = history(rng)
    j = j_pre.deskew(jnp.asarray(pts), jnp.asarray(t_rel), jnp.asarray(valid),
                     JHist(*(jnp.asarray(a) for a in hist)))
    t = t_pre.deskew(torch.as_tensor(pts), torch.as_tensor(t_rel), torch.as_tensor(valid),
                     THist(*(torch.as_tensor(a) for a in hist)))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


def preprocess_case(case):
    """The inputs of a preprocess case: the raw scan, the state history,
    the extrinsics, (raw, scan) sizes."""
    rng = np.random.default_rng(22)
    pts, t_rel, valid = room_scan(rng, 4096, 4000)
    ht, hp, hq, hv = history(rng)
    R = t_lie.so3_exp(torch.tensor([0.01, -0.02, 0.3])).numpy()
    tt = np.asarray([0.1, -0.05, 0.2], np.float32)
    sizes = np.asarray([4096, 2048 if case == "overflow" else 4096])
    return dict(points=pts, t_rel=t_rel, valid=valid, hist_t=ht, hist_p=hp, hist_q=hq,
                hist_valid=hv, R=R, t=tt, sizes=sizes)


def jax_preprocess(inp) -> dict:
    J = lambda *keys: (jnp.asarray(inp[k]) for k in keys)
    n_raw, n_scan = (int(x) for x in inp["sizes"])
    raw = []
    with raw_covariances(raw):
        j = j_pre.preprocess(JScan(*J("points", "t_rel", "valid")),
                             JHist(*J("hist_t", "hist_p", "hist_q", "hist_valid")),
                             JPose(*J("R", "t")),
                             JConfig(max_raw_points=n_raw, max_scan_points=n_scan))
    return jax_outputs(j, raw)


@pytest.mark.parametrize("case", PRE_CASES)
def test_preprocess_matches_jax(case):
    """Extrinsics + deskew + downsample; the same mask and order, on both
    sides of the budget's overflow branch.  CPU tensors take the plain
    version: no launch of the kernels."""
    inp = preprocess_case(case)
    j = jax_preprocess(inp)
    assert_stored(f"preprocess.{case}", inp, j)
    T = lambda *keys: (torch.as_tensor(inp[k]) for k in keys)
    n_raw, n_scan = (int(x) for x in inp["sizes"])
    launches = t_pre.KERNEL.launch_count()
    t = t_pre.preprocess(TScan(*T("points", "t_rel", "valid")),
                         THist(*T("hist_t", "hist_p", "hist_q", "hist_valid")),
                         TPose(*T("R", "t")),
                         TConfig(max_raw_points=n_raw, max_scan_points=n_scan))
    assert t_pre.KERNEL.launch_count() == launches
    np.testing.assert_array_equal(t.valid.numpy(), j["out_valid"])
    np.testing.assert_allclose(t.points.numpy(), j["out_points"], atol=1e-5)
    # the deskewed inputs differ by ~1 ulp; a near-isotropic neighbourhood
    # (corner, pillar edge) has a small eigengap, which turns that into a
    # visible tilt of its plane normal.  So: 99 % of rows at 1e-4, all
    # rows within 0.05 (a normal tilted by < 3 degrees).
    err = np.abs(t.covs.numpy() - j["out_covs"]).reshape(-1, 9).max(1)
    assert np.mean(err <= 1e-4) >= 0.99
    assert err.max() <= 0.05


def test_few_neighbours_get_identity():
    """An isolated point keeps an isotropic covariance (the JAX package's
    deliberate deviation, eskf_lio_tpu/ops/preprocess.py:348-356)."""
    pts = np.zeros((64, 3), np.float32)
    pts[0] = [3.05, 3.05, 3.05]
    valid = np.zeros(64, bool)
    valid[0] = True
    cfg = dataclasses.replace(TConfig(), max_raw_points=64, max_scan_points=32)
    out = t_pre.downsample_and_covariances(torch.as_tensor(pts), torch.as_tensor(valid), cfg)
    assert out.valid.sum() == 1
    np.testing.assert_array_equal(out.covs[0].numpy(), np.eye(3, dtype=np.float32))


def write_jax_outputs() -> None:
    """Store every downsample and preprocess case's inputs and JAX outputs."""
    arrays = {}
    for prefix, cases, make, run in (("downsample", sorted(SIZES), downsample_case, jax_downsample),
                                     ("preprocess", PRE_CASES, preprocess_case, jax_preprocess)):
        for case in cases:
            inp = make(case)
            for key, value in {**inp, **run(inp)}.items():
                arrays[f"{prefix}.{case}.{key}"] = value
    JAX_OUTPUTS.parent.mkdir(exist_ok=True)
    np.savez_compressed(JAX_OUTPUTS, **arrays)
    print(f"wrote {JAX_OUTPUTS} ({JAX_OUTPUTS.stat().st_size} bytes, {len(arrays)} arrays)")


if __name__ == "__main__":
    write_jax_outputs()
