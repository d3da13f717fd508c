"""Frozen copy of `eskf_lio_torch/models/eskf.py` for the benchmark's plain reference.

Kernel calls and device control flow are replaced by the plain versions
in `benchmark/reference/plain.py`; the arithmetic is the port's at the
commit that added the benchmark.  The original docstring follows.

Error-state Kalman filter (port of `eskf_lio_tpu/models/eskf.py`).

Pure functions over the `FilterState` NamedTuple (the reference
`ErrorStateKF`):

* `predict_chunk_prefix` — the parallel-prefix IMU propagation of the main
  path: attitude by a log-step scan of quaternion products, velocity and
  position by cumsums, covariance by suffix products of the 18×18
  transition matrices from a reversed log-step scan.  M ≤ 64 samples, so
  each scan is ≤ 6 rounds of batched products.  `jax.lax.associative_scan`
  groups the products in another order, so results agree with the JAX
  package to f32 rounding, not bit for bit.
* `predict_step` / `predict_chunk` — the sequential form, the test oracle.
* `pose_update` — the 6-DoF measurement update with error injection and
  covariance reset.

All covariance algebra is f32 at full precision: the pipeline disables
TF32 for matrix products (`pipeline/__init__.py`), as the JAX package pins
`precision="highest"`, because reduced precision ruins an 18×18 covariance
at 1e-3 scale.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from benchmark.reference import plain as device_policy
from benchmark.reference.config import Config
from benchmark.reference import lie
from benchmark.reference.types import FilterState, ImuChunk, Pose, StateHistory


class NoiseParams(NamedTuple):
    """Process / measurement noise."""

    q_diag: torch.Tensor  # [12] [σ²_an(3), σ²_gn(3), σ²_aw(3), σ²_gw(3)]
    v_diag: torch.Tensor  # [6] measurement noise diag (trans, rot)


def make_noise_params(
    config: Config, device="cuda", dtype=torch.float32
) -> NoiseParams:
    dev = device_policy.resolve(device)
    s = config.imu.noise_sigmas()
    q = np.concatenate(
        [s["accel_noise"] ** 2, s["gyro_noise"] ** 2,
         s["accel_walk"] ** 2, s["gyro_walk"] ** 2]
    )
    v = np.concatenate(
        [np.full(3, config.translation_noise), np.full(3, config.rotation_noise)]
    )
    # f64 -> f32 on the host, as jnp.asarray(...).astype(float32) does
    return NoiseParams(
        q_diag=torch.as_tensor(q.astype(np.float32), device=dev).to(dtype),
        v_diag=torch.as_tensor(v.astype(np.float32), device=dev).to(dtype),
    )


def init_state(config: Config, device="cuda", dtype=torch.float32) -> FilterState:
    """Initial state: biases/gravity from config, P = init_P·I."""
    dev = device_policy.resolve(device)

    def vec(x):
        return torch.tensor(np.asarray(x, np.float32), dtype=dtype, device=dev)

    return FilterState(
        p=torch.zeros(3, dtype=dtype, device=dev),
        v=torch.zeros(3, dtype=dtype, device=dev),
        q=lie.quat_identity(dev, dtype),
        ba=vec(config.imu.bias_accel),
        bg=vec(config.imu.bias_gyro),
        g=vec(config.imu.gravity),
        P=config.init_P * torch.eye(18, dtype=dtype, device=dev),
    )


def _transition(R, a, dq, dt, keep) -> torch.Tensor:
    """F_x [..., 18, 18]: identity plus the blocks of `ErrorStateKF.cpp:101-107`
    (dq's block only where `keep`, identity elsewhere)."""
    shape = dt.shape
    dtype, dev = dt.dtype, dt.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    F = torch.eye(18, dtype=dtype, device=dev).expand(*shape, 18, 18).clone()
    dtm = dt[..., None, None]
    F[..., 0:3, 3:6] = eye3 * dtm
    F[..., 3:6, 6:9] = -(R @ lie.skew(a)) * dtm
    F[..., 3:6, 9:12] = -R * dtm
    F[..., 3:6, 15:18] = eye3 * dtm
    F[..., 6:9, 6:9] = torch.where(
        keep[..., None, None], lie.quat_to_mat(lie.quat_conj(dq)), eye3
    )
    F[..., 6:9, 12:15] = -eye3 * dtm
    return F


def predict_step(
    state: FilterState,
    dt: torch.Tensor,
    gyro: torch.Tensor,
    accel: torch.Tensor,
    q_diag: torch.Tensor,
    valid: torch.Tensor,
) -> FilterState:
    """One IMU propagation step (ref `ErrorStateKF.cpp:76-113`); invalid or
    negative-dt samples are no-ops."""
    dtype = state.p.dtype
    dt = dt.to(dtype)
    R = lie.quat_to_mat(state.q)
    a = accel - state.ba
    w = gyro - state.bg
    Ra_g = R @ a + state.g
    dq = lie.quat_exp(w * dt)

    p_new = state.p + state.v * dt + 0.5 * Ra_g * dt * dt
    v_new = state.v + Ra_g * dt
    q_new = lie.quat_normalize(lie.quat_mul(state.q, dq))

    F = _transition(R, a, dq, dt, torch.ones_like(dt, dtype=torch.bool))
    q_scaled = q_diag * torch.cat([(dt * dt).expand(6), dt.expand(6)])
    noise = torch.zeros(18, dtype=dtype, device=dt.device)
    noise[3:15] = q_scaled.to(dtype)
    P_new = F @ state.P @ F.T + torch.diag(noise)
    P_new = 0.5 * (P_new + P_new.T)

    new = FilterState(p=p_new, v=v_new, q=q_new, ba=state.ba, bg=state.bg,
                      g=state.g, P=P_new)
    keep = valid & (dt >= 0)
    return FilterState(*(torch.where(keep, n, o) for n, o in zip(new, state)))


def predict_chunk(
    state: FilterState, chunk: ImuChunk, noise: NoiseParams
) -> tuple[FilterState, StateHistory]:
    """Sequential propagation through a whole ImuChunk; returns the final
    state and the pose history (initial state at index 0)."""
    final, hist, _ = predict_chunk_full(state, chunk, noise)
    return final, hist


def predict_chunk_full(state: FilterState, chunk: ImuChunk, noise: NoiseParams):
    """`predict_chunk` plus the full per-sample state trajectory (each
    [M+1, ...], initial state at index 0) — test oracle plumbing."""
    states = [state]
    s = state
    for i in range(chunk.dt.shape[0]):
        s = predict_step(
            s, chunk.dt[i], chunk.gyro[i], chunk.accel[i], noise.q_diag,
            chunk.valid[i],
        )
        states.append(s)
    dev = state.p.device
    hist = StateHistory(
        t_rel=torch.cat(
            [torch.full((1,), -torch.inf, dtype=chunk.t_rel.dtype, device=dev),
             chunk.t_rel]
        ),
        p=torch.stack([x.p for x in states]),
        q=torch.stack([x.q for x in states]),
        valid=torch.cat(
            [torch.ones(1, dtype=torch.bool, device=dev),
             chunk.valid & (chunk.dt >= 0)]
        ),
    )
    full = tuple(
        torch.stack([getattr(x, f) for x in states])
        for f in ("p", "q", "P", "v", "ba", "bg", "g")
    )
    return s, hist, full


def _log_step_scan(x: torch.Tensor, combine: Callable) -> torch.Tensor:
    """Inclusive scan along dim 0 in log2(M) rounds (Hillis-Steele):
    out[i] = x[0] ∘ x[1] ∘ … ∘ x[i] for an associative `combine(earlier,
    later)`."""
    k = 1
    while k < x.shape[0]:
        x = torch.cat([x[:k], combine(x[:-k], x[k:])])
        k *= 2
    return x


def predict_chunk_prefix(
    state: FilterState,
    chunk: ImuChunk,
    noise: NoiseParams,
    base_mask: torch.Tensor | None = None,
) -> tuple[FilterState, StateHistory]:
    """Parallel-prefix IMU propagation.  `base_mask` ([M] bool) selects the
    prefix of samples the returned state integrates (valid & t ≤ scan end);
    the returned `StateHistory` still covers all samples (the overhang poses
    deskew points past scan end)."""
    dtype = state.p.dtype
    dev = state.p.device
    m = chunk.dt.shape[0]
    dt = chunk.dt.to(dtype)
    ok = chunk.valid & (dt >= 0)
    if base_mask is None:
        base_mask = ok
    bmask = ok & base_mask

    dt_ok = torch.where(ok, dt, 0.0)
    a = torch.where(ok[:, None], chunk.accel - state.ba, 0.0)
    w = torch.where(ok[:, None], chunk.gyro - state.bg, 0.0)

    # --- attitude prefix ---------------------------------------------------
    dq = lie.quat_exp(w * dt_ok[:, None])  # identity where masked
    q_prefix = _log_step_scan(dq, lie.quat_mul)  # [M,4]
    q_all = lie.quat_normalize(lie.quat_mul(state.q[None], q_prefix))
    q_hist = torch.cat([state.q[None], q_all])  # [M+1,4]
    R_prev = lie.quat_to_mat(q_hist[:-1])  # R_{j-1}, [M,3,3]

    # --- velocity / position cumsums --------------------------------------
    u = (R_prev @ a[:, :, None])[:, :, 0] + state.g[None]  # [M,3]
    dv = u * dt_ok[:, None]
    v_all = state.v[None] + torch.cumsum(dv, 0)
    v_prev = torch.cat([state.v[None], v_all[:-1]])
    dp = v_prev * dt_ok[:, None] + 0.5 * u * (dt_ok * dt_ok)[:, None]
    p_all = state.p[None] + torch.cumsum(dp, 0)
    p_hist = torch.cat([state.p[None], p_all])

    hist = StateHistory(
        t_rel=torch.cat(
            [torch.full((1,), -torch.inf, dtype=chunk.t_rel.dtype, device=dev),
             chunk.t_rel]
        ),
        p=p_hist,
        q=q_hist,
        valid=torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ok]),
    )

    # --- base nominal state at the last base sample -------------------------
    steps = torch.arange(1, m + 1, dtype=torch.int64, device=dev)
    # a [1] device index: indexing with the 0-dim max would read it on the host
    n_base = torch.max(torch.where(bmask, steps, 0)).reshape(1)
    base_p = p_hist.index_select(0, n_base)[0]
    base_q = q_hist.index_select(0, n_base)[0]
    base_v = torch.cat([state.v[None], v_all]).index_select(0, n_base)[0]

    # --- covariance via suffix transition products -------------------------
    dt_b = torch.where(bmask, dt, 0.0)
    F = _transition(R_prev, a, dq, dt_b, bmask)

    # suffix products S_i = F_n ··· F_{i+1}: prefix_k = rev_1 @ ... @ rev_k
    prefix = _log_step_scan(F.flip(0), torch.matmul)  # [M,18,18]
    S_full = prefix[-1]  # F_n ··· F_1
    eye18 = torch.eye(18, dtype=dtype, device=dev)
    S = torch.cat([prefix.flip(0)[1:], eye18[None]])  # S[i-1] == S_i

    q_scaled = noise.q_diag[None, :] * torch.cat(
        [(dt_b * dt_b)[:, None].expand(m, 6), dt_b[:, None].expand(m, 6)], dim=1
    )  # [M,12]
    D = torch.zeros((m, 18), dtype=dtype, device=dev)
    D[:, 3:15] = q_scaled.to(dtype)

    # Σ_m S_m D_m S_mᵀ as M small products summed over m: one [18, 18M] x
    # [18M, 18] contraction (the einsum) splits its long inner dimension
    # over the CPU's threads, so its bits would follow the thread count
    P_base = S_full @ state.P @ S_full.T + (
        (S * D[:, None, :]) @ S.transpose(1, 2)
    ).sum(0)
    P_base = 0.5 * (P_base + P_base.T)

    base = FilterState(
        p=base_p, v=base_v, q=base_q,
        ba=state.ba, bg=state.bg, g=state.g, P=P_base,
    )
    return base, hist


def state_at(full_hist, idx) -> FilterState:
    """The full filter state at history index `idx`."""
    ps, qs, Ps, vs, bas, bgs, gs = full_hist
    return FilterState(
        p=ps[idx], v=vs[idx], q=qs[idx], ba=bas[idx], bg=bgs[idx],
        g=gs[idx], P=Ps[idx],
    )


def _select_pose_cols(X: torch.Tensor) -> torch.Tensor:
    """Columns (0:3, 6:9) — what H selects — of an [..., 18] array."""
    return torch.cat([X[..., 0:3], X[..., 6:9]], dim=-1)


def pose_update(
    state: FilterState, observed: Pose, noise: NoiseParams
) -> FilterState:
    """6-DoF pose measurement update (ref `ErrorStateKF.cpp:127-145`):
    residual [t_obs − p, Log(Rᵀ_state · R_obs)]; K = P Hᵀ (H P Hᵀ + V)⁻¹;
    P ← (I − K H) P; inject; reset with G[θθ] = I − ½[δθ]×."""
    dtype = state.p.dtype
    dev = state.p.device
    R_state = lie.quat_to_mat(state.q)
    r_rot = lie.so3_log(R_state.T @ observed.R)
    residual = torch.cat([observed.t - state.p, r_rot])

    PHt = _select_pose_cols(state.P)  # [18, 6]
    S = _select_pose_cols(PHt.T).T + torch.diag(noise.v_diag.to(dtype))  # [6,6]
    # solve_ex: no error check, hence no device sync (S is SPD here)
    K = torch.linalg.solve_ex(S.T, PHt.T)[0].T  # [18, 6] = P Hᵀ S⁻¹
    err = K @ residual  # [18]

    KH = torch.zeros((18, 18), dtype=dtype, device=dev)
    KH[:, 0:3] = K[:, 0:3]
    KH[:, 6:9] = K[:, 3:6]
    P_new = state.P - KH @ state.P

    dtheta = err[6:9]
    new = FilterState(
        p=state.p + err[0:3],
        v=state.v + err[3:6],
        q=lie.quat_normalize(lie.quat_mul(state.q, lie.quat_exp(dtheta))),
        ba=state.ba + err[9:12],
        bg=state.bg + err[12:15],
        g=state.g + err[15:18],
        P=P_new,
    )

    G = torch.eye(18, dtype=dtype, device=dev)
    G[6:9, 6:9] = torch.eye(3, dtype=dtype, device=dev) - 0.5 * lie.skew(dtheta)
    P_reset = G @ new.P @ G.T
    P_reset = 0.5 * (P_reset + P_reset.T)
    return new._replace(P=P_reset)


def pose_of(state: FilterState) -> Pose:
    return Pose(R=lie.quat_to_mat(state.q), t=state.p)
