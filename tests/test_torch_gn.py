"""Kernel A of the port (`eskf_lio_torch/ops/gn_normal_eq.py`) vs the JAX
package, on the inputs of `tests/test_gn_pallas.py`.

On CPU tensors the port runs the kernel's plain version (the same closed
form in torch ops).  It is held against the JAX Pallas kernel in interpret
mode (`normal_equations_pallas_rotated`) and against the JAX einsum path
(`registration.normal_equations`), at the tolerance `test_gn_pallas.py`
uses: rtol 1e-5 plus atol 1e-4 of the largest entry (f32 sums of ~1000
terms grouped differently).  The count, the port's third value, is an
integer and is compared exactly.  The CUDA kernel itself is held against
the plain version on the card in `test_torch_cuda.py`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eskf_lio_torch.models import registration as t_reg
from eskf_lio_torch.ops import gn_normal_eq as t_gn
from eskf_lio_torch.ops import lie as t_lie
from eskf_lio_tpu.models import registration as j_reg
from eskf_lio_tpu.ops import gn_pallas

torch.set_num_threads(2)


def _rand_spd(rng, n, scale=0.3):
    A = rng.normal(size=(n, 3, 3)).astype(np.float32) * scale
    return A @ A.transpose(0, 2, 1) + 0.05 * np.eye(3, dtype=np.float32)


def _inputs(n, seed=0, hit_rate=0.7):
    """numpy (pts, covs [n,3,3], mu, covm [n,3,3], mask, R)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 5.0
    covs = _rand_spd(rng, n)
    covm = _rand_spd(rng, n)
    mu = pts + rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    mask = rng.random(n) < hit_rate
    R = np.asarray(t_lie.so3_exp(torch.tensor([0.3, -0.2, 0.5])), np.float32)
    return pts, covs, mu, covm, mask, R


def _pack(c):
    return c[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].copy()


def _port3(pts, covs, mu, covm, mask, R):
    """The port's three values: JTJ, JTr, count."""
    t = torch.as_tensor
    out = t_gn.normal_equations_rotated(
        t(pts), t(_pack(covs)), t(R), t(mu), t(_pack(covm)), t(mask)
    )
    return tuple(x.numpy() for x in out)


def _port(pts, covs, mu, covm, mask, R):
    return _port3(pts, covs, mu, covm, mask, R)[:2]


def _jax_sums(pts, covs, mu, covm, mask, R):
    """The Pallas kernel in interpret mode down to its 28 sums, as
    `gn_pallas._run` calls it: (JTJ, JTr, num_corr)."""
    n = len(pts)
    blk = min(gn_pallas._BLOCK, ((n + 127) // 128) * 128)
    x = gn_pallas.pack_operand(
        jnp.asarray(pts), jnp.asarray(_pack(covs)), jnp.asarray(mu),
        jnp.asarray(_pack(covm)), jnp.asarray(mask),
    )
    x = jnp.pad(x, ((0, 0), (0, (-n) % blk)))
    sums = gn_pallas._gn_call(jnp.asarray(R).reshape(9), x, interpret=True, block=blk)
    return tuple(np.asarray(v) for v in gn_pallas._unpack_sums(sums))


def _close(a, b):
    for x, y in zip(a, b):
        np.testing.assert_allclose(
            x, y, rtol=1e-5, atol=1e-4 * float(np.max(np.abs(y)))
        )


@pytest.mark.parametrize("n", [128, 1000, 4096])
def test_plain_matches_jax_pallas_interpret(n):
    pts, covs, mu, covm, mask, R = _inputs(n, seed=n)
    ref = gn_pallas.normal_equations_pallas_rotated(
        jnp.asarray(pts), jnp.asarray(_pack(covs)), jnp.asarray(R), jnp.asarray(mu),
        jnp.asarray(_pack(covm)), jnp.asarray(mask), interpret=True,
    )
    _close(_port(pts, covs, mu, covm, mask, R), [np.asarray(x) for x in ref])


@pytest.mark.parametrize("n", [128, 1000, 4096])
def test_count_equals_mask_sum_and_jax_num_corr(n):
    """The third value is the number of rows with the mask set: exactly
    `mask.sum()`, and exactly the Pallas kernel's 28th sum."""
    pts, covs, mu, covm, mask, R = _inputs(n, seed=n + 2)
    count = _port3(pts, covs, mu, covm, mask, R)[2]
    assert count.shape == () and count.dtype == np.float32
    assert int(count) == int(mask.sum())
    assert int(count) == int(_jax_sums(pts, covs, mu, covm, mask, R)[2])
    none = _port3(pts, covs, mu, covm, np.zeros_like(mask), R)[2]
    assert int(none) == 0


@pytest.mark.parametrize("n", [128, 1000])
def test_plain_matches_jax_einsum(n):
    pts, covs, mu, covm, mask, R = _inputs(n, seed=n + 1)
    covs_w = np.einsum("ab,nbc,dc->nad", R, covs, R).astype(np.float32)
    ref = j_reg.normal_equations(
        jnp.asarray(pts), jnp.asarray(covs_w), jnp.asarray(mu), jnp.asarray(covm),
        jnp.asarray(mask),
    )
    _close(_port(pts, covs, mu, covm, mask, R), [np.asarray(x) for x in ref])


def test_port_einsum_matches_jax_einsum():
    pts, covs, mu, covm, mask, _ = _inputs(777, seed=9)
    ref = j_reg.normal_equations(*(jnp.asarray(a) for a in (pts, covs, mu, covm, mask)))
    out = t_reg.normal_equations(*(torch.as_tensor(a) for a in (pts, covs, mu, covm, mask)))
    _close([o.numpy() for o in out], [np.asarray(x) for x in ref])


def test_masked_rows_contribute_exactly_zero():
    """Garbage behind mask=False — singular, even non-finite — must not
    leak: the plain version zeroes masked rows before the arithmetic.

    This is where the port deliberately departs from the JAX package: its
    Pallas kernel folds the mask into 1/det, so the same non-finite inputs
    behind the mask turn its sums non-finite (finite inputs agree, as the
    tests above show).  Both halves are pinned here."""
    pts, covs, mu, covm, mask, R = _inputs(512, seed=3)
    good = _port3(pts, covs, mu, covm, mask, R)
    covs_bad, covm_bad, pts_bad = covs.copy(), covm.copy(), pts.copy()
    covs_bad[~mask] = 0.0
    covm_bad[~mask] = np.nan
    pts_bad[~mask] = np.inf
    bad = _port3(pts_bad, covs_bad, mu, covm_bad, mask, R)
    for g, b in zip(good, bad):
        assert np.isfinite(b).all()
        np.testing.assert_array_equal(b, g)
    j_good = _jax_sums(pts, covs, mu, covm, mask, R)
    _close(good[:2], j_good[:2])
    j_bad = _jax_sums(pts_bad, covs_bad, mu, covm_bad, mask, R)
    assert not np.isfinite(j_bad[0]).all() and not np.isfinite(j_bad[1]).all()
    none = _port(pts, covs, mu, covm, np.zeros_like(mask), R)
    assert all((x == 0).all() for x in none)


def test_rotated_equals_prerotated():
    """The in-kernel Σ_w = R Σ Rᵀ equals rotating outside with R = I."""
    pts, covs, mu, covm, mask, R = _inputs(777, seed=9)
    covs_w = np.einsum("ab,nbc,dc->nad", R, covs, R).astype(np.float32)
    _close(
        _port(pts, covs, mu, covm, mask, R),
        _port(pts, covs_w, mu, covm, mask, np.eye(3, dtype=np.float32)),
    )


def test_wrapper_checks_shapes_and_types():
    pts, covs, mu, covm, mask, R = _inputs(64)
    t = torch.as_tensor
    with pytest.raises(ValueError):
        t_gn.normal_equations_rotated(t(pts), t(_pack(covs))[:10], t(R), t(mu),
                                      t(_pack(covm)), t(mask))
    with pytest.raises(TypeError):
        t_gn.normal_equations_rotated(t(pts).double(), t(_pack(covs)), t(R), t(mu),
                                      t(_pack(covm)), t(mask))
