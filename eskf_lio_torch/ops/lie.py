"""Branchless, small-angle-safe SO(3)/SE(3) operations.

Port of `eskf_lio_tpu/ops/lie.py` (the reference's `Utils.cpp`: skew
`:5-11`, rotation-vector exp/log `:22-38`, SE(3) exp with left Jacobian
`:40-63`, pose interpolation `:65-75`).  Batched over leading dims and
branchless: `torch.where` with safe denominators replaces the reference's
`if angle < 1e-6` guard, with the same Taylor fallbacks as the JAX package.
Quaternions are [w, x, y, z].
"""

from __future__ import annotations

import torch

# Taylor-switch threshold: below this angle (rad) use series expansions.
_EPS = 1e-6


def _eye_like(x: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(shape)


def _safe(x: torch.Tensor, small: torch.Tensor) -> torch.Tensor:
    """Replace near-zero values by 1 so divisions never produce inf/nan.
    Results at those lanes are overwritten by the Taylor branch."""
    return torch.where(small, torch.ones_like(x), x)


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _sinc(theta: torch.Tensor) -> torch.Tensor:
    """sin(θ)/θ, Taylor 1 - θ²/6 for small θ."""
    small = theta.abs() < _EPS
    t = _safe(theta, small)
    return torch.where(small, 1.0 - theta * theta / 6.0, torch.sin(t) / t)


def _cosc(theta: torch.Tensor) -> torch.Tensor:
    """(1-cos θ)/θ², Taylor 1/2 - θ²/24 for small θ."""
    small = theta.abs() < _EPS
    t = _safe(theta, small)
    return torch.where(
        small, 0.5 - theta * theta / 24.0, (1.0 - torch.cos(t)) / (t * t)
    )


def _skew_sq(r: torch.Tensor) -> torch.Tensor:
    """[r]ײ = r·rᵀ − (rᵀr)·I, closed form."""
    outer = r[..., :, None] * r[..., None, :]
    nsq = torch.sum(r * r, dim=-1)[..., None, None]
    return outer - nsq * _eye_like(r, outer.shape)


def so3_exp(r: torch.Tensor) -> torch.Tensor:
    """Rotation vector [..., 3] -> rotation matrix [..., 3, 3] (Rodrigues):
    R = I + sinc(θ)·[r]× + cosc(θ)·[r]×²."""
    theta = torch.linalg.norm(r, dim=-1)
    K = skew(r)
    a = _sinc(theta)[..., None, None]
    b = _cosc(theta)[..., None, None]
    return _eye_like(r, K.shape) + a * K + b * _skew_sq(r)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> rotation vector [..., 3] (quaternion
    route, stable near 0 and π)."""
    return quat_log(quat_from_mat(R))


# ---------------------------------------------------------------------------
# Quaternions, [w, x, y, z]
# ---------------------------------------------------------------------------


def quat_identity(device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_mul(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Hamilton product q ⊗ p, batched."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return torch.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_exp(r: torch.Tensor) -> torch.Tensor:
    """Rotation vector [..., 3] -> unit quaternion [..., 4], zero-safe:
    q = [cos(θ/2), sin(θ/2)/θ · r] with sin(θ/2)/θ = 0.5·sinc(θ/2)."""
    half = 0.5 * torch.linalg.norm(r, dim=-1)
    w = torch.cos(half)
    s = 0.5 * _sinc(half)
    return torch.cat([w[..., None], s[..., None] * r], dim=-1)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] -> rotation vector [..., 3] in (-π, π]."""
    q = torch.where(q[..., 0:1] < 0, -q, q)  # short arc: w >= 0
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    vnorm = torch.linalg.norm(q[..., 1:], dim=-1)
    theta = 2.0 * torch.atan2(vnorm, w)
    small = vnorm < _EPS
    scale = torch.where(
        small, 2.0 / torch.clamp(w, min=0.5), theta / _safe(vnorm, small)
    )
    return scale[..., None] * q[..., 1:]


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def quat_from_mat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4], branchless
    4-candidate form (the candidate of the largest component wins)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)

    cw = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cx = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1)
    cy = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1)
    cz = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1)

    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    idx = torch.argmax(mags, dim=-1)  # first maximum, as jnp.argmax
    cands = torch.stack([cw, cx, cy, cz], dim=-2)  # [..., 4, 4]
    gidx = idx[..., None, None].expand(*idx.shape, 1, 4)
    q = torch.gather(cands, -2, gidx)[..., 0, :]
    return quat_normalize(q)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors [..., 3] by unit quaternions [..., 4]."""
    qv = q[..., 1:]
    w = q[..., 0:1]
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + w * t + torch.linalg.cross(qv, t)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, u) -> torch.Tensor:
    """Spherical interpolation between unit quaternions (short arc),
    branchless with a lerp fallback for nearly parallel inputs."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.clamp(dot.abs(), -1.0, 1.0)
    theta = torch.arccos(torch.clamp(dot, 0.0, 1.0))
    small = theta < _EPS
    sin_theta = _safe(torch.sin(theta), small)
    u = torch.as_tensor(u, dtype=q0.dtype, device=q0.device)
    if u.ndim < theta.ndim:
        u = u[..., None]
    w0 = torch.where(small, 1.0 - u, torch.sin((1.0 - u) * theta) / sin_theta)
    w1 = torch.where(small, u, torch.sin(u * theta) / sin_theta)
    return quat_normalize(w0 * q0 + w1 * q1)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


def left_jacobian(r: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(r), [..., 3] -> [..., 3, 3]:
    J = I + cosc(θ)·[r]× + (θ-sin θ)/θ³·[r]×²."""
    theta = torch.linalg.norm(r, dim=-1)
    small = theta.abs() < _EPS
    t = _safe(theta, small)
    c1 = _cosc(theta)
    c2 = torch.where(
        small, 1.0 / 6.0 - theta * theta / 120.0, (t - torch.sin(t)) / (t * t * t)
    )
    K = skew(r)
    return (
        _eye_like(r, K.shape)
        + c1[..., None, None] * K
        + c2[..., None, None] * _skew_sq(r)
    )


def se3_exp(tau: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """se(3) twist [..., 6] (ρ first, φ last) -> (R [..., 3, 3], t [..., 3])
    with t = J_l(φ)·ρ."""
    rho, phi = tau[..., :3], tau[..., 3:]
    R = so3_exp(phi)
    t = (left_jacobian(phi) @ rho[..., None])[..., 0]
    return R, t


def interpolate_pose(p0, q0, t0, p1, q1, t1, t):
    """Pose interpolation at time t: slerp attitude + lerp position, with
    the reference's +1e-6 denominator regulariser."""
    u = (t - t0) / (t1 - t0 + 1e-6)
    return p0 + u[..., None] * (p1 - p0), quat_slerp(q0, q1, u)


def transform_points(
    R: torch.Tensor, t: torch.Tensor, pts: torch.Tensor
) -> torch.Tensor:
    """Apply a rigid transform to [..., N, 3] points (full f32)."""
    return pts @ R.transpose(-1, -2) + t[..., None, :]
