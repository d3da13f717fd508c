"""Plain stand-ins for the port's kernels and device control flow.

The reference runs the step's arithmetic eagerly with PyTorch operations
alone: kernel B (`ops/segscan.py`) is its plain version, a segment total by
`index_add_`; kernel A (`ops/gn_normal_eq.py`) its plain closed form; the
captured graph's conditional nodes (`utils/graphs.py`) become Python `if`
and `while` on values read back from the device.  Copied from the port's
plain versions at the commit that added the benchmark.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def resolve(device) -> torch.device:
    """A `torch.device` from a device argument (no default to the card)."""
    return torch.device(device)


def device_if(pred: torch.Tensor, fn: Callable, outs=None, otherwise: Callable | None = None):
    """`fn()` where the 0-dim bool `pred` holds, else `otherwise()` or `outs`."""
    if bool(pred):
        return tuple(fn())
    return tuple(otherwise()) if otherwise is not None else tuple(outs)


def device_while(body: Callable, carry: Sequence[torch.Tensor], max_iterations: int):
    """Run `body` while `carry[0]` holds (the loop ends within
    `max_iterations` by its own counter)."""
    carry = tuple(carry)
    while bool(carry[0]):
        carry = tuple(body(carry))
    return carry


def segsum_sorted(skey_sorted: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Segment totals of `vals` [N, W] grouped by the sorted keys, on every
    row of the segment (the kernel's contract asks the head row only)."""
    n = vals.shape[0]
    same = torch.zeros(n, dtype=torch.bool, device=vals.device)
    same[1:] = skey_sorted[1:] == skey_sorted[:-1]
    seg_id = torch.cumsum((~same).to(torch.int64), 0) - 1
    totals = torch.zeros_like(vals).index_add_(0, seg_id, vals)
    return totals[seg_id]


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


def normal_equations_rotated(
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
