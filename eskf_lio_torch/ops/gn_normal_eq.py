"""VGICP Gauss-Newton normal equations: kernel A of the port.

Port of `eskf_lio_tpu/ops/gn_pallas.py`, whose Pallas TPU kernel
`_gn_kernel` streams a packed [19, N] operand through VMEM.  Here the kernel
is CUDA C++ for Hopper (`csrc/gn_normal_eq.cu`): one launch, one point per
thread, the same closed form, a deterministic reduction that the block with
the last ticket finishes, and it reads the align loop's [N,3]/[N,6] arrays
directly (the source note says why).

For each correspondence: Σ_w = R Σ_src Rᵀ; W = (Σ_w + Σ_map)⁻¹ by adjugate
over determinant; r = p − μ; J = [I | −[p]×].  Over the rows with mask set
it sums JᵀWJ [6,6], JᵀWr [6] and the correspondence count (returned as a
0-d f32 tensor, exact for N < 2²⁴).  Masked rows add exactly 0.

`normal_equations_rotated` launches the kernel for CUDA tensors and runs
the plain PyTorch version `normal_equations_rotated_ref` (the same closed
form in torch ops — not the einsum `registration.normal_equations`) only
for CPU tensors.
"""

from __future__ import annotations

import torch

from eskf_lio_torch.ops._cuda import INT, PTR, CudaKernel, stream_handle

KERNEL = CudaKernel(
    "gn_normal_eq",
    "gn_normal_eq.cu",
    {
        "gn_normal_eq_launch": [
            PTR, PTR, PTR, INT, INT, PTR, PTR, PTR, INT, PTR, PTR, PTR
        ],
        "gn_normal_eq_empty_launch": [PTR],
        "gn_normal_eq_scratch_bytes": [],
    },
)

# (row, col) of the 21 upper-triangle sums, row-major (gn_pallas.py:172-177)
_TRI = [
    (0, 0), (0, 1), (0, 2), (0, 3), (0, 4), (0, 5),
    (1, 1), (1, 2), (1, 3), (1, 4), (1, 5),
    (2, 2), (2, 3), (2, 4), (2, 5),
    (3, 3), (3, 4), (3, 5), (4, 4), (4, 5), (5, 5),
]
# position in the 28 sums of each entry of the full symmetric 6x6
_FULL = [
    _TRI.index((min(i, j), max(i, j))) for i in range(6) for j in range(6)
]


def _check(pts_w, covs_packed, R, mu, cov_map_packed, mask) -> int:
    n = pts_w.shape[0]
    if not (
        pts_w.shape == (n, 3) and covs_packed.shape == (n, 6) and R.shape == (3, 3)
        and mu.shape == (n, 3) and cov_map_packed.shape == (n, 6) and mask.shape == (n,)
    ):
        raise ValueError(
            "normal_equations: expected pts_w [N,3], covs_body_packed [N,6], R [3,3], "
            "mu [N,3], cov_map_packed [N,6], mask [N]; got "
            + ", ".join(str(tuple(x.shape)) for x in (pts_w, covs_packed, R, mu, cov_map_packed, mask))
        )
    f32 = torch.float32
    if not (
        pts_w.dtype == f32 and covs_packed.dtype == f32 and R.dtype == f32
        and mu.dtype == f32 and cov_map_packed.dtype == f32 and mask.dtype == torch.bool
    ):
        raise TypeError(
            "normal_equations takes float32 arrays and a bool mask, got "
            + ", ".join(str(x.dtype) for x in (pts_w, covs_packed, R, mu, cov_map_packed, mask))
        )
    dev = pts_w.device
    if not (
        covs_packed.device == dev and R.device == dev and mu.device == dev
        and cov_map_packed.device == dev and mask.device == dev
    ):
        raise ValueError(
            "normal_equations: all inputs must be on one device, got "
            + ", ".join(str(x.device) for x in (pts_w, covs_packed, R, mu, cov_map_packed, mask))
        )
    return n


def normal_equations_rotated(
    pts_w: torch.Tensor,
    covs_body_packed: torch.Tensor,
    R: torch.Tensor,
    mu_map: torch.Tensor,
    cov_map_packed: torch.Tensor,
    mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused form for the GN loop: body-frame packed source covariances +
    the accumulated rotation R, applied per point inside the kernel.
    Returns (JTJ [6,6], JTr [6], count 0-d f32): the count is the number of
    rows with the mask set.

    On a CUDA device the kernel runs on the current stream and keeps its
    scratch (partial sums, ticket) in one buffer per device and stream that
    is reused from call to call; calls on one stream are ordered, so they
    never overlap.  A launch captured into a graph uses the buffer reserved
    for captures instead (`reserve_capture`).  The three results are views
    of one fresh 43-float tensor and stay valid after later calls."""
    n = _check(pts_w, covs_body_packed, R, mu_map, cov_map_packed, mask)
    dev = pts_w.device
    if dev.type == "cpu":
        return normal_equations_rotated_ref(
            pts_w, covs_body_packed, R, mu_map, cov_map_packed, mask
        )
    if dev.type != "cuda":
        raise ValueError(f"normal_equations: unsupported device {dev}")
    if n >= 2**31 // 6:
        raise ValueError(f"normal_equations: N={n} overflows the kernel's int32 sizes")
    # no copy and no launch for a tensor that is contiguous already; R is
    # read through its strides
    pts_w, covs_body_packed = pts_w.contiguous(), covs_body_packed.contiguous()
    mu_map, cov_map_packed = mu_map.contiguous(), cov_map_packed.contiguous()
    mask = mask.contiguous()
    stream = stream_handle(dev)
    capturing = torch.cuda.is_current_stream_capturing()
    if capturing:
        # a captured launch takes the scratch reserved before the capture
        scratch = KERNEL.capture_scratch(dev, KERNEL.query("gn_normal_eq_scratch_bytes"))
    else:
        scratch = KERNEL.scratch.get((dev.index, stream))
    if scratch is None:
        # partial sums and the ticket, which the kernel resets itself
        n_bytes = KERNEL.query("gn_normal_eq_scratch_bytes")
        scratch = torch.zeros(n_bytes // 4, dtype=torch.float32, device=dev)
        KERNEL.scratch[(dev.index, stream)] = scratch
    out = pts_w.new_empty(43)
    KERNEL.launch(
        "gn_normal_eq_launch",
        pts_w.data_ptr(), covs_body_packed.data_ptr(),
        R.data_ptr(), R.stride(0), R.stride(1),
        mu_map.data_ptr(), cov_map_packed.data_ptr(), mask.data_ptr(), n,
        scratch.data_ptr(), out.data_ptr(), stream,
        device=dev, capturing=capturing,
    )
    return out.as_strided((6, 6), (6, 1)), out[36:42], out[42]


def reserve_capture(device: torch.device) -> None:
    """Reserve, before a graph capture, the scratch of captured launches on
    `device` (utils/graphs.py)."""
    KERNEL.reserve_capture(device, KERNEL.query("gn_normal_eq_scratch_bytes"))


def launch_empty_kernel(device: torch.device) -> None:
    """Launch the source's empty `<<<1, 32>>>` kernel on the current stream:
    its device duration is the least any launch takes on the card, which
    `chip_smoke.py` prints beside kernel A's time.  Not counted in
    `KERNEL.launches`."""
    lib = KERNEL.lib()
    err = lib.gn_normal_eq_empty_launch(stream_handle(device))
    if err != 0:
        raise RuntimeError(f"gn_normal_eq_empty_launch failed: CUDA error {err}")


def normal_equations_rotated_ref(
    pts_w: torch.Tensor,
    covs_body_packed: torch.Tensor,
    R: torch.Tensor,
    mu_map: torch.Tensor,
    cov_map_packed: torch.Tensor,
    mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the closed form of
    gn_pallas.py:72-159 on [N] columns, masked rows zeroed before the
    arithmetic so they add exactly 0 whatever they hold.  Returns the
    kernel's three values: JTJ, JTr and the count as a 0-d f32 tensor."""
    sums = _closed_form_terms(
        pts_w, covs_body_packed, R, mu_map, cov_map_packed, mask
    ).sum(dim=0)  # [28]
    full = torch.tensor(_FULL, device=sums.device)
    return sums[full].view(6, 6), sums[21:27], sums[27]


def _closed_form_terms(pts_w, covs, R, mu, covm, mask) -> torch.Tensor:
    """[N, 28] per-point terms: 21 JᵀWJ upper-triangle, 6 JᵀWr, count."""
    m = mask[:, None]
    pts_w = torch.where(m, pts_w, 0.0)
    mu = torch.where(m, mu, 0.0)
    covs = torch.where(m, covs, 0.0)
    covm = torch.where(m, covm, 0.0)
    px, py, pz = pts_w.unbind(-1)
    s00, s01, s02, s11, s12, s22 = covs.unbind(-1)
    mx, my, mz = mu.unbind(-1)
    q00, q01, q02, q11, q12, q22 = covm.unbind(-1)
    r0, r1, r2, r3, r4, r5, r6, r7, r8 = R.reshape(9)
    maskf = mask.to(pts_w.dtype)

    m00 = r0 * s00 + r1 * s01 + r2 * s02
    m01 = r0 * s01 + r1 * s11 + r2 * s12
    m02 = r0 * s02 + r1 * s12 + r2 * s22
    m10 = r3 * s00 + r4 * s01 + r5 * s02
    m11 = r3 * s01 + r4 * s11 + r5 * s12
    m12 = r3 * s02 + r4 * s12 + r5 * s22
    m20 = r6 * s00 + r7 * s01 + r8 * s02
    m21 = r6 * s01 + r7 * s11 + r8 * s12
    m22 = r6 * s02 + r7 * s12 + r8 * s22
    t00 = m00 * r0 + m01 * r1 + m02 * r2
    t01 = m00 * r3 + m01 * r4 + m02 * r5
    t02 = m00 * r6 + m01 * r7 + m02 * r8
    t11 = m10 * r3 + m11 * r4 + m12 * r5
    t12 = m10 * r6 + m11 * r7 + m12 * r8
    t22 = m20 * r6 + m21 * r7 + m22 * r8

    # A lifted to identity on masked rows so the inverse stays finite
    inv_m = 1.0 - maskf
    a00 = t00 + q00 + inv_m
    a01 = t01 + q01
    a02 = t02 + q02
    a11 = t11 + q11 + inv_m
    a12 = t12 + q12
    a22 = t22 + q22 + inv_m

    co00 = a11 * a22 - a12 * a12
    co01 = a02 * a12 - a01 * a22
    co02 = a01 * a12 - a02 * a11
    det = a00 * co00 + a01 * co01 + a02 * co02
    idet = maskf / det  # the mask folded into the inverse
    w00 = co00 * idet
    w01 = co01 * idet
    w02 = co02 * idet
    w11 = (a00 * a22 - a02 * a02) * idet
    w12 = (a01 * a02 - a00 * a12) * idet
    w22 = (a00 * a11 - a01 * a01) * idet

    rx, ry, rz = px - mx, py - my, pz - mz
    vx = w00 * rx + w01 * ry + w02 * rz
    vy = w01 * rx + w11 * ry + w12 * rz
    vz = w02 * rx + w12 * ry + w22 * rz

    b00 = -(w01 * pz - w02 * py)
    b10 = -(w11 * pz - w12 * py)
    b20 = -(w12 * pz - w22 * py)
    b01 = -(w02 * px - w00 * pz)
    b11 = -(w12 * px - w01 * pz)
    b21 = -(w22 * px - w02 * pz)
    b02 = -(w00 * py - w01 * px)
    b12 = -(w01 * py - w11 * px)
    b22 = -(w02 * py - w12 * px)

    d00 = -pz * b10 + py * b20
    d01 = -pz * b11 + py * b21
    d02 = -pz * b12 + py * b22
    d11 = pz * b01 - px * b21
    d12 = pz * b02 - px * b22
    d22 = -py * b02 + px * b12

    g3 = py * vz - pz * vy
    g4 = pz * vx - px * vz
    g5 = px * vy - py * vx

    return torch.stack(
        [
            w00, w01, w02, b00, b01, b02,
            w11, w12, b10, b11, b12,
            w22, b20, b21, b22,
            d00, d01, d02, d11, d12, d22,
            vx, vy, vz, g3, g4, g5,
            maskf,
        ],
        dim=-1,
    )
