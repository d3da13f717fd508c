"""Scan preprocessing: extrinsics, deskew, voxel downsample, covariance.

Port of `eskf_lio_tpu/ops/preprocess.py` (the reference `CloudPreprocessor`):

* extrinsic LiDAR→IMU transform;
* motion-compensation deskew — each point takes the composed transform of
  its bracketing IMU state (the JAX package fetches it with a one-hot
  matmul for the TPU's matrix unit; a row gather gives the same values);
* voxel downsample keeping the first point per voxel in scan order — one
  stable key sort + segment heads;
* per-point covariance from the 27-voxel neighbourhood, aggregated by three
  separable adjacent-row passes over key-sorted voxel tables, with moments
  about each voxel's own centre, then `eig3.plane_regularize`; identity
  for points with fewer than 3 neighbours.

The per-voxel moment sums go through kernel B (`ops/segscan.py`).  Layouts,
row orders and the overflow path are the JAX package's, so the outputs
compare row for row.

`preprocess` and `downsample_and_covariances` run the plain PyTorch
versions `preprocess_ref` / `downsample_and_covariances_ref` for CPU
tensors and, for CUDA tensors, six hand-written kernels between the key
sorts (`csrc/preprocess.cu`, `KERNEL`) that do the plain versions' float32
arithmetic in their order: the same keys, masks, row order and points.
"""

from __future__ import annotations

import torch

from eskf_lio_torch.config import Config
from eskf_lio_torch.ops import eig3, lie, segscan
from eskf_lio_torch.ops import sortmerge as sm
from eskf_lio_torch.ops import voxel as vx
from eskf_lio_torch.ops._cuda import FLOAT, INT, PTR, CudaKernel, stream_handle
from eskf_lio_torch.types import Pose, ProcessedScan, Scan, StateHistory

_BITS = 10
_MASK = (1 << _BITS) - 1
INT32_MAX = sm.INT32_MAX

KERNEL = CudaKernel(
    "preprocess",
    "preprocess.cu",
    {
        "preprocess_key": [PTR, PTR, INT, FLOAT, PTR, PTR, PTR],
        "preprocess_key_deskew": [PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT,
                                  FLOAT, PTR, PTR, PTR],
        "preprocess_moments": [PTR, PTR, PTR, INT, INT, PTR, PTR, PTR],
        "preprocess_compact": [PTR, PTR, PTR, INT, PTR, PTR],
        "preprocess_pass_z": [PTR, PTR, PTR, PTR, INT, FLOAT, PTR, PTR, PTR],
        "preprocess_pass_y": [PTR, PTR, PTR, PTR, INT, FLOAT, PTR, PTR, PTR],
        "preprocess_pass_x": [PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, FLOAT,
                              FLOAT, FLOAT, PTR, PTR, PTR, PTR],
        "preprocess_max_states": [],
    },
    # no a*b+c contracted where the plain version rounds twice
    flags=("-fmad=false",),
)
# launches of `KERNEL` a call of `preprocess` or `downsample_and_covariances`
LAUNCHES = 6


def deskew(
    points: torch.Tensor,
    t_rel: torch.Tensor,
    valid: torch.Tensor,
    hist: StateHistory,
) -> torch.Tensor:
    """Motion-compensate points to the scan-end frame.  Each point takes the
    pose of the first state with state time > point time, composed with the
    inverse of the pose interpolated at scan end (t_rel = 0)."""
    ts = torch.where(hist.valid, hist.t_rel, torch.inf)
    m1 = ts.shape[0]
    zero = torch.zeros((), dtype=points.dtype, device=points.device)

    # bracketing states around scan end for the end pose (indices clamped,
    # as JAX clamps its gathers)
    idx_b = torch.clamp(torch.searchsorted(ts, zero, right=True) - 1, 0, m1 - 1)
    last_valid = hist.valid.sum() - 1
    idx_a = torch.minimum(torch.clamp(idx_b + 1, 0, m1 - 1), last_valid)
    # gathers by device indices (indexing with a 0-dim tensor would read it
    # on the host)
    ab = torch.stack([idx_b, idx_a]).reshape(2)
    p_ab, q_ab, t_ab = (x.index_select(0, ab) for x in (hist.p, hist.q, ts))
    p_end, q_end = lie.interpolate_pose(
        p_ab[0], q_ab[0], t_ab[0], p_ab[1], q_ab[1], t_ab[1], zero,
    )
    T_end_inv = Pose(lie.quat_to_mat(q_end), p_end).inverse()

    # per-state composed transform T_end⁻¹ ∘ T_state ([M+1] poses)
    R_c = T_end_inv.R @ lie.quat_to_mat(hist.q)
    t_c = hist.p @ T_end_inv.R.T + T_end_inv.t
    table = torch.cat([R_c.reshape(m1, 9), t_c], dim=1)  # [M+1, 12]

    # per-point state index: first state with t_state > t_point
    idx = torch.sum(t_rel[:, None] >= ts[None, :], dim=1)
    idx = torch.minimum(torch.clamp(idx, min=1), last_valid)
    Rt = table[idx]  # [N, 12]
    R_pt = Rt[:, :9].reshape(-1, 3, 3)
    out = (R_pt * points[:, None, :]).sum(-1) + Rt[:, 9:]
    return torch.where(valid[:, None], out, points)


def _shift_moments(m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Parallel-axis shift of packed moments [..., 10] = (m0, m1[3], m2[6])
    about centre c to moments about c - d:
    m1' = m1 + m0·d;  m2'_ab = m2_ab + d_a m1_b + d_b m1_a + m0 d_a d_b."""
    m0 = m[..., 0:1]
    m1 = m[..., 1:4]
    m2 = m[..., 4:10]
    m1s = m1 + m0 * d
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    x, y, z = m1[..., 0], m1[..., 1], m1[..., 2]
    m0s = m0[..., 0]
    m2s = torch.stack(
        [
            m2[..., 0] + 2 * dx * x + m0s * dx * dx,
            m2[..., 1] + dx * y + dy * x + m0s * dx * dy,
            m2[..., 2] + dx * z + dz * x + m0s * dx * dz,
            m2[..., 3] + 2 * dy * y + m0s * dy * dy,
            m2[..., 4] + dy * z + dz * y + m0s * dy * dz,
            m2[..., 5] + 2 * dz * z + m0s * dz * dz,
        ],
        dim=-1,
    )
    return torch.cat([m0, m1s, m2s], dim=-1)


def _shift_rows(x: torch.Tensor, step: int, fill) -> torch.Tensor:
    """x shifted by `step` rows (+1: row i holds x[i+1]), `fill` at the end."""
    pad = torch.full_like(x[:1], fill)
    return torch.cat([x[1:], pad]) if step > 0 else torch.cat([pad, x[:-1]])


def _axis_pass(rkey: torch.Tensor, m: torch.Tensor, d_axis: torch.Tensor) -> torch.Tensor:
    """One separable neighbourhood pass: rows sorted by `rkey` (minor axis
    in the low _BITS bits, INT32_MAX dead tail); sums each row's moments
    with its ±1 minor-axis neighbours, which are adjacent rows when
    present.  `d_axis` [3] is +voxel_size along the pass axis."""
    live = rkey != INT32_MAX
    minor = rkey & _MASK
    nxt_key = _shift_rows(rkey, 1, INT32_MAX)
    nxt_live = _shift_rows(live, 1, False)
    prv_key = _shift_rows(rkey, -1, INT32_MAX)
    prv_live = _shift_rows(live, -1, False)

    plus_ok = live & nxt_live & (nxt_key == rkey + 1) & (minor != _MASK)
    minus_ok = live & prv_live & (prv_key == rkey - 1) & (minor != 0)

    m_nxt = _shift_rows(m, 1, 0.0)
    m_prv = _shift_rows(m, -1, 0.0)
    out = (
        m
        + torch.where(plus_ok[:, None], _shift_moments(m_nxt, d_axis), 0.0)
        + torch.where(minus_ok[:, None], _shift_moments(m_prv, -d_axis), 0.0)
    )
    return torch.where(live[:, None], out, 0.0)


def _rotate_key(packed: torch.Tensor, axis: int) -> torch.Tensor:
    """Re-pack a (x,y,z) packed key so `axis` occupies the minor bits:
    axis=2 -> x|y|z (identity), axis=1 -> x|z|y, axis=0 -> y|z|x.
    Dead keys (INT32_MAX) stay INT32_MAX."""
    x = (packed >> (2 * _BITS)) & _MASK
    y = (packed >> _BITS) & _MASK
    z = packed & _MASK
    if axis == 2:
        r = packed
    elif axis == 1:
        r = (x << (2 * _BITS)) | (z << _BITS) | y
    else:
        r = (y << (2 * _BITS)) | (z << _BITS) | x
    return torch.where(packed == INT32_MAX, INT32_MAX, r)


def downsample_and_covariances_ref(
    points: torch.Tensor,
    valid: torch.Tensor,
    config: Config,
) -> ProcessedScan:
    """First-point-per-voxel downsample + neighbourhood covariance, padded /
    compacted to `config.max_scan_points` (ref
    `voxelDownsampleAndEstimateCovariances`, `CloudPreprocessor.cpp:76-127`),
    in plain PyTorch on any device."""
    n = points.shape[0]
    k_out = config.max_scan_points
    vs = config.downsample_voxel_size
    dtype, dev = points.dtype, points.device

    keys = vx.voxel_key(points, vs)
    # static packing origin: scan points live in the scan-end body frame,
    # bounded by LiDAR range << the ±512-voxel packing span
    origin = torch.full((3,), -512, dtype=torch.int32, device=dev)
    packed, in_range = sm.pack_keys(keys, origin)
    ok = valid & in_range

    # voxel-centred coordinates (f32-friendly moments)
    centers = (keys.to(dtype) + 0.5) * vs
    q = torch.where(ok[:, None], points - centers, 0.0)

    packed_m = torch.where(ok, packed, INT32_MAX)
    packed_s, _, q_s = sm.sort_perm(packed_m, q)
    ok_s = packed_s != INT32_MAX
    qx_s, qy_s, qz_s = q_s[:, 0], q_s[:, 1], q_s[:, 2]

    same = torch.zeros(n, dtype=torch.bool, device=dev)
    same[1:] = packed_s[1:] == packed_s[:-1]
    head = ok_s & ~same
    w = ok_s.to(dtype)[:, None]
    raw = torch.cat(
        [
            w,
            q_s * w,
            torch.stack(
                [
                    qx_s * qx_s, qx_s * qy_s, qx_s * qz_s,
                    qy_s * qy_s, qy_s * qz_s, qz_s * qz_s,
                ],
                dim=-1,
            )
            * w,
        ],
        dim=1,
    )  # [N, 10] per-point moments about the voxel centre
    # per-voxel moments land on each segment's HEAD row (kernel B)
    table_m = segscan.segsum_sorted(packed_s, raw)

    # compact segment heads to the front; each head is (stable sort) the
    # FIRST point of its voxel in scan order
    kcap = min(n, k_out)
    if k_out < n:
        # overflow possible: order heads by a multiplicative hash of the
        # voxel key (int32 wrap-around done in int64: the low 31 bits of the
        # product are the same), so an overflowing scan drops a
        # pseudo-random spatial subset
        h = ((packed_s.to(torch.int64) * -1640531527) & 0x7FFFFFFF).to(torch.int32)
        h = torch.where(h == INT32_MAX, 0, h)
        hkey = torch.where(head, h, INT32_MAX)
    else:
        # no voxel can overflow a budget >= n: keep ascending packed order
        pos = torch.arange(n, dtype=torch.int32, device=dev)
        hkey = torch.where(head, pos, INT32_MAX)
    qm = torch.cat([q_s, table_m], dim=1)  # [N, 13] ride-along rows
    h_sorted, _, hp_sorted, qm_sorted = sm.sort_perm(hkey, packed_s, qm, take=kcap)
    t_live = h_sorted != INT32_MAX
    t_packed = torch.where(t_live, hp_sorted, INT32_MAX)
    t_q = qm_sorted[:, :3]
    t_m = torch.where(t_live[:, None], qm_sorted[:, 3:13], 0.0)
    if k_out < n:
        # restore ascending packed order (the separable passes and the
        # map-merge path both require it)
        t_packed, _, t_qm = sm.sort_perm(t_packed, torch.cat([t_q, t_m], dim=1))
        t_live = t_packed != INT32_MAX
        t_q = t_qm[:, :3]
        t_m = t_qm[:, 3:13]

    # ---- separable 3x3x3 neighbourhood aggregation ------------------------
    # the three axis steps as rows of vs·I, made by one kernel (writing a
    # Python number into a device tensor would be an upload)
    axis_vec = torch.eye(3, dtype=dtype, device=dev) * vs

    m_z = _axis_pass(t_packed, t_m, axis_vec[2])

    ky = _rotate_key(t_packed, 1)
    ky_s, _, packed_y, m_zs = sm.sort_perm(ky, t_packed, m_z)
    m_y = _axis_pass(ky_s, m_zs, axis_vec[1])

    kx = _rotate_key(packed_y, 0)
    kx_s, _, packed_x, m_ys = sm.sort_perm(kx, packed_y, m_y)
    m_x = _axis_pass(kx_s, m_ys, axis_vec[0])

    # back to ascending packed (= head-compacted) order
    _, _, nb = sm.sort_perm(packed_x, m_x)  # [K, 10] 27-nbhd moments

    out_valid = t_live[:kcap]
    out_packed = t_packed[:kcap]
    out_keys = sm.unpack_keys(out_packed, origin, sm.DEFAULT_KEY_BITS)
    out_centers = (out_keys.to(dtype) + 0.5) * vs
    out_points = torch.where(out_valid[:, None], out_centers + t_q[:kcap], 0.0)

    cnt = nb[:kcap, 0]
    denom = torch.clamp(cnt, min=1.0)
    mu_c = nb[:kcap, 1:4] / denom[:, None]  # about the voxel centre
    exx = nb[:kcap, 4] / denom - mu_c[:, 0] * mu_c[:, 0]
    exy = nb[:kcap, 5] / denom - mu_c[:, 0] * mu_c[:, 1]
    exz = nb[:kcap, 6] / denom - mu_c[:, 0] * mu_c[:, 2]
    eyy = nb[:kcap, 7] / denom - mu_c[:, 1] * mu_c[:, 1]
    eyz = nb[:kcap, 8] / denom - mu_c[:, 1] * mu_c[:, 2]
    ezz = nb[:kcap, 9] / denom - mu_c[:, 2] * mu_c[:, 2]
    cov = torch.stack(
        [
            torch.stack([exx, exy, exz], -1),
            torch.stack([exy, eyy, eyz], -1),
            torch.stack([exz, eyz, ezz], -1),
        ],
        dim=-2,
    )  # [K, 3, 3]
    cov_reg = eig3.plane_regularize(cov, config.covariance_plane_factor)

    # <3 neighbours: fully isotropic (the JAX package's deliberate deviation,
    # eskf_lio_tpu/ops/preprocess.py:348-356)
    few = cnt < config.min_neighbors_for_covariance
    eye = torch.eye(3, dtype=dtype, device=dev).expand(cov.shape)
    cov_reg = torch.where(few[:, None, None], eye, cov_reg)

    # pad to the static output budget when the raw cloud was smaller
    if kcap < k_out:
        pad = k_out - kcap
        out_points = torch.cat(
            [out_points, torch.zeros((pad, 3), dtype=dtype, device=dev)]
        )
        cov_reg = torch.cat(
            [cov_reg, torch.eye(3, dtype=dtype, device=dev).expand(pad, 3, 3)]
        )
        out_valid = torch.cat(
            [out_valid, torch.zeros(pad, dtype=torch.bool, device=dev)]
        )
    return ProcessedScan(points=out_points, covs=cov_reg, valid=out_valid)


def preprocess_ref(
    scan: Scan,
    hist: StateHistory,
    T_il: Pose,
    config: Config,
) -> ProcessedScan:
    """Full preprocessing in plain PyTorch: extrinsics → deskew →
    downsample + covariances."""
    pts_imu = T_il.apply(scan.points)
    pts_desk = deskew(pts_imu, scan.t_rel, scan.valid, hist)
    return downsample_and_covariances_ref(pts_desk, scan.valid, config)


def preprocess(
    scan: Scan,
    hist: StateHistory,
    T_il: Pose,
    config: Config,
) -> ProcessedScan:
    """Full preprocessing: extrinsics → deskew → downsample + covariances;
    `preprocess_ref` for CPU tensors, the kernels for CUDA tensors."""
    if scan.points.device.type == "cpu":
        return preprocess_ref(scan, hist, T_il, config)
    return _preprocess_kernels(scan, hist, T_il, config, _data_ptr)


def downsample_and_covariances(
    points: torch.Tensor,
    valid: torch.Tensor,
    config: Config,
) -> ProcessedScan:
    """Downsample + covariances of points already in the body frame, with no
    deskew (the init step); `downsample_and_covariances_ref` for CPU
    tensors, the kernels for CUDA tensors."""
    if points.device.type == "cpu":
        return downsample_and_covariances_ref(points, valid, config)
    return _downsample_kernels(points, valid, config, _data_ptr)


# ---- the CUDA path ----------------------------------------------------------


def _data_ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def _cuda_inputs(points: torch.Tensor, *others: torch.Tensor) -> torch.device:
    dev = points.device
    if dev.type != "cuda" or any(x.device != dev for x in others):
        raise ValueError(
            f"preprocess: tensors on {[str(x.device) for x in (points, *others)]}; all must be "
            "on one CUDA device (or all on the CPU)"
        )
    if points.dtype != torch.float32:
        raise TypeError(f"preprocess: the kernels take float32 points, got {points.dtype}")
    n = points.shape[0]
    if points.shape != (n, 3) or not 1 <= n < 2**31 // 10:
        raise ValueError(
            f"preprocess: points {tuple(points.shape)} must be [N, 3] with 1 <= N < 2^31 / 10"
        )
    return dev


def _launcher(dev: torch.device, ptr):
    """launch(fn, inputs, sizes, outputs): one kernel of `csrc/preprocess.cu`
    on the current stream, with the C entry point's arguments in that
    order: each input (a tensor, or None for an absent one) at the address
    `ptr` gives, each output at its own."""
    stream = stream_handle(dev)
    capturing = torch.cuda.is_current_stream_capturing()

    def launch(fn: str, inputs: tuple, sizes: tuple, outputs: tuple) -> None:
        KERNEL.launch(fn, *map(ptr, inputs), *sizes, *(o.data_ptr() for o in outputs), stream,
                      device=dev, capturing=capturing)

    return launch


def _preprocess_kernels(
    scan: Scan, hist: StateHistory, T_il: Pose, config: Config, ptr,
) -> ProcessedScan:
    """`preprocess_ref` on a CUDA device through `csrc/preprocess.cu`: the
    first kernel takes the raw points through the extrinsics and the deskew
    to their voxel keys, rebuilding the scan-end pose and the per-state
    transforms from `hist` in every block.  `ptr` gives the address a kernel
    reads an input at (`_data_ptr`; `utils/kernel_bounds.py` stages the
    inputs elsewhere)."""
    dev = _cuda_inputs(scan.points, scan.t_rel, scan.valid, T_il.R, T_il.t, *hist)
    n, m1 = scan.points.shape[0], hist.t_rel.shape[0]
    if not 1 <= m1 <= KERNEL.query("preprocess_max_states"):
        raise ValueError(f"preprocess: a state history of {m1} rows is outside the kernel's range")
    launch = _launcher(dev, ptr)
    skey = torch.empty(n, dtype=torch.int32, device=dev)
    q = torch.empty((n, 3), dtype=torch.float32, device=dev)
    launch("preprocess_key_deskew",
           tuple(x.contiguous() for x in (*scan, T_il.R, T_il.t, *hist)),
           (m1, n, config.downsample_voxel_size), (skey, q))
    return _downsample_keyed(skey, q, config, launch)


def _downsample_kernels(
    points: torch.Tensor, valid: torch.Tensor, config: Config, ptr,
) -> ProcessedScan:
    """`downsample_and_covariances_ref` on a CUDA device through
    `csrc/preprocess.cu` (`ptr` as in `_preprocess_kernels`)."""
    dev = _cuda_inputs(points, valid)
    n = points.shape[0]
    launch = _launcher(dev, ptr)
    skey = torch.empty(n, dtype=torch.int32, device=dev)
    q = torch.empty((n, 3), dtype=torch.float32, device=dev)
    launch("preprocess_key", (points.contiguous(), valid.contiguous()),
           (n, config.downsample_voxel_size), (skey, q))
    return _downsample_keyed(skey, q, config, launch)


def _downsample_keyed(skey: torch.Tensor, q: torch.Tensor, config: Config, launch) -> ProcessedScan:
    """The plain version's sorts with the kernels between them, from the
    masked packed keys `skey` [N] and voxel-centred offsets `q` [N, 3]."""
    n = skey.shape[0]
    k_out = config.max_scan_points
    kcap = min(n, k_out)
    vs = config.downsample_voxel_size
    dev = skey.device

    def new(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    skey_s, perm1 = torch.sort(skey, stable=True)
    raw, hkey = new(n, 10), new(n, dtype=torch.int32)
    launch("preprocess_moments", (skey_s, perm1, q), (n, int(k_out < n)), (raw, hkey))
    table_m = segscan.segsum_sorted(skey_s, raw)
    # segment heads to the front: the overflow hash order or ascending
    h_sorted, perm2 = torch.sort(hkey, stable=True)
    perm2 = perm2[:kcap]
    t_packed = new(kcap, dtype=torch.int32)
    launch("preprocess_compact", (h_sorted[:kcap], perm2, skey_s), (kcap,), (t_packed,))
    fk, perm3 = t_packed, None
    if k_out < n:
        fk, perm3 = torch.sort(t_packed, stable=True)  # back to ascending packed order
    m_z, ky = new(kcap, 10), new(kcap, dtype=torch.int32)
    launch("preprocess_pass_z", (fk, perm3, perm2, table_m), (kcap, vs), (m_z, ky))
    ky_s, perm4 = torch.sort(ky, stable=True)
    m_y, kx = new(kcap, 10), new(kcap, dtype=torch.int32)
    launch("preprocess_pass_y", (ky_s, perm4, m_z, fk), (kcap, vs), (m_y, kx))
    kx_s, perm5 = torch.sort(kx, stable=True)
    out = ProcessedScan(new(k_out, 3), new(k_out, 3, 3), new(k_out, dtype=torch.bool))
    launch("preprocess_pass_x", (kx_s, perm5, m_y, perm4, fk, perm3, perm2, perm1, q),
           (kcap, k_out, vs, 1.0 - config.covariance_plane_factor,
            float(config.min_neighbors_for_covariance)), out)
    return out


def reserve_capture(device: torch.device) -> None:
    """Build and load the kernels and make the counter of captured launches
    on `device` before a graph capture (utils/graphs.py); the kernels keep
    no scratch."""
    KERNEL.lib()
    KERNEL.reserve_capture(device, 8)
