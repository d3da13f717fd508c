"""The port's ESKF (`eskf_lio_torch/models/eskf.py`) vs the JAX package and
vs its own sequential form, on the chunks of `tests/test_eskf_prefix.py`;
and the JAX package's prefix outputs stored for the card's kernel
(`tests/data/imu_prefix_jax.npz`) against the live JAX package.

Tolerances are those of `test_eskf_prefix.py` (position 1e-4 m, quaternion
1e-5, covariance rtol 1e-3 / atol 2e-6): the log-step scans group the f32
products differently from `jax.lax.associative_scan` and from the
sequential recursion.  The pose update compares at rtol 1e-4 / atol 1e-6:
one 6x6 solve and a few 18x18 products in f32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eskf_lio_torch.config import Config as TConfig
from eskf_lio_torch.models import eskf as t_eskf
from eskf_lio_torch.types import ImuChunk as TChunk, Pose as TPose
from eskf_lio_tpu.config import Config as JConfig
from eskf_lio_tpu.models import eskf as j_eskf
from eskf_lio_tpu.types import ImuChunk as JChunk, Pose as JPose
from test_torch_imu_prefix import JAX_CASES, JAX_OUTPUTS, jax_prefix, stored_jax_case

torch.set_num_threads(2)

T_NOISE = t_eskf.make_noise_params(TConfig(), device="cpu")
J_NOISE = j_eskf.make_noise_params(JConfig())


def make_chunk(rng, m, t_end_frac=0.8, invalid_at=None):
    """numpy (dt, t_rel, gyro, accel, valid), as test_eskf_prefix.py."""
    dts = np.full(m, 0.0025, np.float32)
    t_rel = (np.cumsum(dts) - t_end_frac * m * 0.0025).astype(np.float32)
    gyro = 0.3 * rng.normal(size=(m, 3)).astype(np.float32)
    accel = (np.tile([0, 0, -9.7], (m, 1)) + rng.normal(size=(m, 3))).astype(np.float32)
    valid = np.ones(m, bool)
    if invalid_at is not None:
        valid[invalid_at] = False
    return dts, t_rel, gyro, accel, valid


def state_pair(rng=None):
    """The same initial state in both packages (perturbed from init)."""
    j = j_eskf.init_state(JConfig())
    if rng is not None:
        A = rng.normal(size=(18, 18)) * 1e-3
        j = j._replace(
            v=jnp.asarray(rng.normal(size=3), jnp.float32),
            ba=jnp.asarray(rng.normal(size=3) * 0.02, jnp.float32),
            P=jnp.asarray(A @ A.T + 1e-3 * np.eye(18), jnp.float32),
        )
    t = t_eskf.FilterState(*(torch.as_tensor(np.array(x)) for x in j))
    return j, t


def assert_state_close(a, b, atol_p=1e-4, atol_P=2e-6):
    a = [np.asarray(x) for x in a]
    b = [np.asarray(x) for x in b]
    for i in (0, 1, 3, 4, 5):  # p, v, ba, bg, g
        np.testing.assert_allclose(a[i], b[i], atol=atol_p)
    assert min(np.abs(a[2] - b[2]).max(), np.abs(a[2] + b[2]).max()) < 1e-5
    np.testing.assert_allclose(a[6], b[6], rtol=1e-3, atol=atol_P)


CHUNKS = {
    "mid_chunk_end": dict(m=40),
    "full_chunk": dict(m=24, t_end_frac=1.0),
    "invalid_sample": dict(m=16, invalid_at=7),
    "max_capacity": dict(m=64),
}


@pytest.mark.parametrize("name", sorted(CHUNKS))
def test_prefix_matches_jax_and_sequential(name):
    rng = np.random.default_rng(len(name))
    arrays = make_chunk(rng, **CHUNKS[name])
    j_state, t_state = state_pair(rng)
    jc = JChunk(*(jnp.asarray(a) for a in arrays))
    tc = TChunk(*(torch.as_tensor(a) for a in arrays))
    j_base, j_hist = j_eskf.predict_chunk_prefix(j_state, jc, J_NOISE, base_mask=jc.t_rel <= 0)
    t_base, t_hist = t_eskf.predict_chunk_prefix(t_state, tc, T_NOISE, base_mask=tc.t_rel <= 0)
    assert_state_close(t_base, j_base)
    for a, b in zip(t_hist, j_hist):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)

    # vs the port's own sequential form at the last base sample
    _, hist, full = t_eskf.predict_chunk_full(t_state, tc, T_NOISE)
    ok = hist.valid.numpy() & (hist.t_rel.numpy() <= 0)
    seq = t_eskf.state_at(full, int(np.where(ok)[0].max()))
    assert_state_close(t_base, seq)


@pytest.mark.parametrize("label", JAX_CASES)
def test_stored_prefix_outputs_are_the_jax_packages(label):
    """`tests/data/imu_prefix_jax.npz`, to which the card's kernel is held
    (tests/test_torch_imu_prefix.py), holds the live JAX package's
    `predict_chunk_prefix` on its stored inputs."""
    inputs, stored = stored_jax_case(label)
    live = jax_prefix(*inputs)
    assert set(live) == set(stored)
    for key, value in live.items():
        np.testing.assert_array_equal(
            stored[key], value,
            err_msg=f"{JAX_OUTPUTS.name}: {label}.out.{key} is stale; write it again "
                    "(JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_imu_prefix.py jax)")


def test_prefix_long_horizon_covariance():
    """200 samples of f32 regrouping stay within the sequential oracle."""
    rng = np.random.default_rng(11)
    _, state = state_pair()
    for _ in range(5):
        tc = TChunk(*(torch.as_tensor(a) for a in make_chunk(rng, 40, t_end_frac=1.0)))
        final_seq, _ = t_eskf.predict_chunk(state, tc, T_NOISE)
        final_pre, _ = t_eskf.predict_chunk_prefix(state, tc, T_NOISE)
        np.testing.assert_allclose(final_pre.P.numpy(), final_seq.P.numpy(), rtol=5e-3, atol=1e-6)
        state = final_pre


def test_predict_step_matches_jax():
    rng = np.random.default_rng(12)
    j_state, t_state = state_pair(rng)
    dt, gyro, accel = np.float32(0.0025), rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    j = j_eskf.predict_step(j_state, jnp.asarray(dt), jnp.asarray(gyro), jnp.asarray(accel),
                            J_NOISE.q_diag, jnp.asarray(True))
    t = t_eskf.predict_step(t_state, torch.tensor(dt), torch.as_tensor(gyro), torch.as_tensor(accel),
                            T_NOISE.q_diag, torch.tensor(True))
    assert_state_close(t, j, atol_p=1e-6, atol_P=1e-8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_update_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    j_state, t_state = state_pair(rng)
    r = rng.normal(size=3).astype(np.float32) * 0.02
    R_obs = np.asarray(torch.linalg.matrix_exp(torch.tensor(
        [[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]])), np.float32)
    t_obs = rng.normal(size=3).astype(np.float32) * 0.05
    j = j_eskf.pose_update(j_state, JPose(jnp.asarray(R_obs), jnp.asarray(t_obs)), J_NOISE)
    t = t_eskf.pose_update(t_state, TPose(torch.as_tensor(R_obs), torch.as_tensor(t_obs)), T_NOISE)
    for a, b in zip(t, j):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)


def test_noise_and_init_state_match_jax():
    for a, b in zip(T_NOISE, J_NOISE):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(t_eskf.init_state(TConfig(), device="cpu"), j_eskf.init_state(JConfig())):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
