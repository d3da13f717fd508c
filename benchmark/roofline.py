"""The kernels' bounds: the least time one NVIDIA H100 could take for a
call, from the operations and bytes the call needs (copied from
`chip_smoke.py`'s kernel phases).

Published peaks of the H100 SXM (NVIDIA's data sheet, at its 700 W
limit): 3.35 TB/s of HBM3 and 67 TFLOP/s in float32 outside the tensor
cores.  Each input byte is counted read once and each output byte written
once."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# kernel A's arithmetic per live correspondence (gn_normal_eq.cu: 45 + 30
# for R Σ Rᵀ, 6 + 30 for A and W, 3 + 15 for r and W·r, 27 + 18 + 9 for
# the block products, 28 sums)
GN_FLOP_PER_POINT = 211


def bound_ms(n_bytes: float, n_flop: float) -> float:
    """The larger of bytes over the memory rate and operations over the
    float32 peak, in ms."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_flop / PEAK_F32_FLOP_PER_S) * 1e3


def segscan_cost(n: int, w: int) -> tuple[int, int]:
    """(bytes, operations) of kernel B over [n, w] rows: int32 keys and
    f32 values read once, [n, w] written once, one add per value."""
    return n * 4 + 2 * n * w * 4, n * w


def gn_normal_eq_cost(n: int, n_live: int) -> tuple[int, int]:
    """(bytes, operations) of kernel A over n rows of which n_live are
    live: rows of 3 + 6 + 3 + 6 f32 and a mask byte, R, and the 43-float
    result; arithmetic on live rows only."""
    return n * ((3 + 6 + 3 + 6) * 4 + 1) + 9 * 4 + 43 * 4, GN_FLOP_PER_POINT * n_live


def share_percent(bound: float, measured_ms: float) -> float | None:
    """The bound over the measured time, in %; None without a time."""
    if not measured_ms or measured_ms <= 0:
        return None
    return 100.0 * bound / measured_ms
