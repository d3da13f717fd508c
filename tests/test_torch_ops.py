"""Port parity for the elementwise and integer ops: lie, voxel, sortmerge,
eig3 (`eskf_lio_torch/ops/*` vs `eskf_lio_tpu/ops/*` on the same numpy
inputs).

Tolerances: the float functions are the same closed forms in f32; libm's
sin/cos/atan2/arccos may differ by an ulp between XLA's CPU backend and
torch, so floats compare at atol 1e-6 / rtol 1e-5 (a few ulps at the
inputs' O(1) scale).  Integer results (voxel keys, hashes, sort orders)
key the map layout and must be bit-exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eskf_lio_torch.ops import eig3 as t_eig3
from eskf_lio_torch.ops import lie as t_lie
from eskf_lio_torch.ops import sortmerge as t_sm
from eskf_lio_torch.ops import voxel as t_vx
from eskf_lio_tpu.ops import eig3 as j_eig3
from eskf_lio_tpu.ops import lie as j_lie
from eskf_lio_tpu.ops import sortmerge as j_sm
from eskf_lio_tpu.ops import voxel as j_vx

torch.set_num_threads(2)

F_TOL = dict(rtol=1e-5, atol=1e-6)


def both(fn_j, fn_t, *arrays):
    """Run the JAX and the torch function on the same numpy inputs."""
    out_j = fn_j(*(jnp.asarray(a) for a in arrays))
    out_t = fn_t(*(torch.as_tensor(np.array(a)) for a in arrays))
    if not isinstance(out_j, tuple):
        out_j, out_t = (out_j,), (out_t,)
    return [np.asarray(a) for a in out_j], [b.numpy() for b in out_t]


def rotvecs(rng, n=64):
    r = rng.normal(size=(max(n, 4), 3)) * 1.2
    r[:4] = [[0, 0, 0], [1e-8, 0, 0], [0, 3e-7, -2e-7], [np.pi - 1e-4, 0, 0]]
    return r[-n:].astype(np.float32)


def quats(rng, n=64):
    q = rng.normal(size=(n, 4))
    q[:2] = [[1, 0, 0, 0], [-1, 1e-8, 0, 0]]
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


LIE_CASES = {
    "skew": lambda rng: (j_lie.skew, t_lie.skew, rotvecs(rng)),
    "so3_exp": lambda rng: (j_lie.so3_exp, t_lie.so3_exp, rotvecs(rng)),
    "quat_exp": lambda rng: (j_lie.quat_exp, t_lie.quat_exp, rotvecs(rng)),
    "left_jacobian": lambda rng: (j_lie.left_jacobian, t_lie.left_jacobian, rotvecs(rng)),
    "quat_log": lambda rng: (j_lie.quat_log, t_lie.quat_log, quats(rng)),
    "quat_to_mat": lambda rng: (j_lie.quat_to_mat, t_lie.quat_to_mat, quats(rng)),
    "quat_conj": lambda rng: (j_lie.quat_conj, t_lie.quat_conj, quats(rng)),
    "quat_mul": lambda rng: (j_lie.quat_mul, t_lie.quat_mul, quats(rng), quats(rng)),
    "quat_rotate": lambda rng: (
        j_lie.quat_rotate, t_lie.quat_rotate, quats(rng), rotvecs(rng)
    ),
    "quat_from_mat": lambda rng: (
        j_lie.quat_from_mat, t_lie.quat_from_mat,
        np.asarray(j_lie.so3_exp(jnp.asarray(rotvecs(rng)))),
    ),
    "so3_log": lambda rng: (
        j_lie.so3_log, t_lie.so3_log,
        np.asarray(j_lie.so3_exp(jnp.asarray(rotvecs(rng)))),
    ),
    "se3_exp": lambda rng: (
        j_lie.se3_exp, t_lie.se3_exp,
        np.concatenate([rng.normal(size=(64, 3)), rotvecs(rng)], 1).astype(np.float32),
    ),
    "quat_slerp": lambda rng: (
        lambda a, b, u: j_lie.quat_slerp(a, b, u),
        lambda a, b, u: t_lie.quat_slerp(a, b, u),
        quats(rng), quats(rng), rng.uniform(0, 1, 64).astype(np.float32),
    ),
    "transform_points": lambda rng: (
        j_lie.transform_points, t_lie.transform_points,
        np.asarray(j_lie.so3_exp(jnp.asarray(rotvecs(rng, 1))))[0],
        rng.normal(size=3).astype(np.float32),
        (rng.normal(size=(500, 3)) * 30).astype(np.float32),
    ),
}


@pytest.mark.parametrize("name", sorted(LIE_CASES))
def test_lie_matches_jax(name):
    fn_j, fn_t, *arrays = LIE_CASES[name](np.random.default_rng(1))
    out_j, out_t = both(fn_j, fn_t, *arrays)
    for a, b in zip(out_j, out_t):
        # transform_points reaches 100 m: compare at its scale
        tol = dict(rtol=1e-5, atol=1e-4) if name == "transform_points" else F_TOL
        np.testing.assert_allclose(b, a, **tol)


def test_interpolate_pose_matches_jax():
    rng = np.random.default_rng(2)
    p0, p1 = rng.normal(size=(2, 3)).astype(np.float32)
    q0, q1 = quats(rng, 2)
    args = (p0, q0, np.float32(-0.05), p1, q1, np.float32(0.01), np.float32(0.0))
    out_j, out_t = both(j_lie.interpolate_pose, t_lie.interpolate_pose, *args)
    for a, b in zip(out_j, out_t):
        np.testing.assert_allclose(b, a, **F_TOL)


def int_keys(rng, n=4096):
    k = rng.integers(-700, 700, size=(n, 3)).astype(np.int32)
    k[:3] = [[-512, -512, -512], [511, 511, 511], [512, -513, 0]]  # span edges
    return k


def test_voxel_key_and_owner_hash_bit_exact():
    rng = np.random.default_rng(3)
    pts = (rng.normal(size=(4096, 3)) * 40).astype(np.float32)
    out_j, out_t = both(lambda p: j_vx.voxel_key(p, 0.3), lambda p: t_vx.voxel_key(p, 0.3), pts)
    np.testing.assert_array_equal(out_t[0], out_j[0])
    for owners in (1, 4, 7):
        out_j, out_t = both(
            lambda k: j_vx.owner_hash(k, owners),
            lambda k: t_vx.owner_hash(k, owners),
            int_keys(rng),
        )
        np.testing.assert_array_equal(out_t[0], out_j[0])


def test_pack_unpack_bit_exact():
    rng = np.random.default_rng(4)
    keys = int_keys(rng)
    origin = np.full(3, -512, np.int32)
    out_j, out_t = both(j_sm.pack_keys, t_sm.pack_keys, keys, origin)
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(b, a)
    out_j, out_t = both(j_sm.unpack_keys,
                        lambda p, o: t_sm.unpack_keys(p, o, t_sm.DEFAULT_KEY_BITS), out_j[0], origin)
    np.testing.assert_array_equal(out_t[0], out_j[0])


def hash_inputs(rng):
    x = rng.integers(-(2**31), 2**31 - 1, size=8192, dtype=np.int64).astype(np.int32)
    x[:6] = [0, 1, -1, 2**31 - 1, -(2**31), 2**31 - 2]
    return x


@pytest.mark.parametrize("name", ["mix32", "unmix32"])
def test_mixers_bit_exact(name):
    x = hash_inputs(np.random.default_rng(5))
    out_j, out_t = both(getattr(j_sm, name), getattr(t_sm, name), x)
    np.testing.assert_array_equal(out_t[0], out_j[0].astype(np.int64))
    # the port's pair is an exact inverse on the full uint32 range
    xt = torch.as_tensor(x)
    back = t_sm.unmix32(t_sm.mix32(xt))
    np.testing.assert_array_equal(back.numpy(), x.astype(np.int64) & 0xFFFFFFFF)


def test_skey_roundtrip_and_bucket_bit_exact():
    rng = np.random.default_rng(6)
    packed = rng.integers(0, 2**30, size=8192).astype(np.int32)
    packed[:2] = [2**31 - 1, 0]  # sentinel + zero key
    out_j, out_t = both(j_sm.skey_of, t_sm.skey_of, packed)
    np.testing.assert_array_equal(out_t[0], out_j[0])
    skey = out_j[0]
    out_j, out_t = both(j_sm.packed_of_skey, t_sm.packed_of_skey, skey)
    np.testing.assert_array_equal(out_t[0], out_j[0])
    np.testing.assert_array_equal(out_t[0], packed)
    for nb in (1, 2, 1024, 1 << 18):
        out_j, out_t = both(
            lambda s: j_sm.bucket_of(s, nb), lambda s: t_sm.bucket_of(s, nb), skey
        )
        np.testing.assert_array_equal(out_t[0], out_j[0])


@pytest.mark.parametrize("take", [None, 100])
def test_sort_perm_stable_bit_exact(take):
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 50, size=3000).astype(np.int32)
    keys[::7] = 2**31 - 1  # sentinel tail must sort last
    rows = rng.normal(size=(3000, 4)).astype(np.float32)
    out_j, out_t = both(
        lambda k, r: j_sm.sort_perm(k, r, take=take),
        lambda k, r: t_sm.sort_perm(k, r, take=take),
        keys, rows,
    )
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(b, a)


def test_unique_segments_bit_exact():
    rng = np.random.default_rng(8)
    keys = np.sort(rng.integers(0, 300, size=2000)).astype(np.int32)
    valid = np.ones(2000, bool)
    valid[-37:] = False
    out_j, out_t = both(j_sm.unique_segments, t_sm.unique_segments, keys, valid)
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(b, a)


def sym_psd(rng, n):
    A = rng.normal(size=(n, 3, 3)).astype(np.float32)
    S = A @ np.swapaxes(A, -1, -2)
    S[0] = np.eye(3)  # isotropic -> ẑ fallback
    S[1] = np.diag([1.0, 1.0, 1e-3])  # a plane
    return S.astype(np.float32)


def test_eig3_matches_jax():
    rng = np.random.default_rng(9)
    A = sym_psd(rng, 256)
    out_j, out_t = both(j_eig3.smallest_eigvec_sym3, t_eig3.smallest_eigvec_sym3, A)
    # the same closed form picks the same sign; atol covers arccos near ±1
    np.testing.assert_allclose(out_t[0], out_j[0], rtol=1e-4, atol=1e-4)
    out_j, out_t = both(
        lambda a: j_eig3.plane_regularize(a, 1e-2),
        lambda a: t_eig3.plane_regularize(a, 1e-2), A,
    )
    np.testing.assert_allclose(out_t[0], out_j[0], rtol=1e-4, atol=1e-4)
