"""Segmented head-row sums over key-sorted rows: kernel B of the port.

Port of `eskf_lio_tpu/ops/segscan.py`, whose Pallas TPU kernel `_kernel`
streams a segmented suffix scan over [W, B] blocks with a carry in VMEM
scratch across its sequential grid.  Here the kernel is CUDA C++ for Hopper
(`csrc/segscan.cu`: one launch, one read and one write of the rows; the
carry between blocks becomes a read of the few rows after a tile where its
last run ends there, and a deterministic look-ahead over the tiles'
published sums where it does not, as the source note sets out), and it takes
any N with no fallback.

Contract: given `skey_sorted` [N] (sorted ascending) and `vals` [N, W],
every segment's HEAD row (its first row) of the result holds the segment
total; other rows are unspecified.  The downsampler reads head rows only.

`segsum_sorted` launches the kernel for CUDA tensors and runs the plain
PyTorch version `segsum_sorted_ref` only for CPU tensors.
"""

from __future__ import annotations

import torch

from eskf_lio_torch.ops._cuda import INT, PTR, CudaKernel, stream_handle

KERNEL = CudaKernel(
    "segscan",
    "segscan.cu",
    {
        "segscan_launch": [PTR, PTR, INT, INT, PTR, INT, PTR, PTR],
        "segscan_tile_rows": [],
        "segscan_max_width": [],
        "segscan_scratch_bytes": [INT],
    },
)

# tile capacity of the capture scratch reserved on each device
_CAPTURE_TILES: dict[int, int] = {}


def reserve_capture(device: torch.device, n_rows: int) -> None:
    """Reserve, before a graph capture, the scratch of captured launches of
    up to `n_rows` rows on `device` (utils/graphs.py)."""
    tile = KERNEL.query("segscan_tile_rows")
    cap = max((n_rows + tile - 1) // tile, 1024, _CAPTURE_TILES.get(device.index, 0))
    KERNEL.reserve_capture(device, KERNEL.lib().segscan_scratch_bytes(cap))
    _CAPTURE_TILES[device.index] = cap


def _scratch(device: torch.device, stream: int, tiles: int) -> tuple[torch.Tensor, int]:
    """The kernel's scratch buffer on this device and stream and its capacity
    in tiles.  The kernel keeps its ticket, epoch and published tile sums
    there and resets them itself, so the buffer is zeroed once and reused:
    zeroing it again inside a captured graph would restart its epoch on
    every replay, so a capture takes the buffer reserved beforehand."""
    if torch.cuda.is_current_stream_capturing():
        cap = _CAPTURE_TILES.get(device.index, 0)
        if cap < tiles:
            raise RuntimeError(
                f"segsum_sorted: {tiles} tiles exceed the {cap} reserved for captures "
                "on this device (segscan.reserve_capture)"
            )
        return KERNEL.capture_scratch(device, KERNEL.lib().segscan_scratch_bytes(cap)), cap
    key = (device.index, stream)
    held = KERNEL.scratch.get(key)
    if held is None or held[1] < tiles:
        cap = max(tiles, 1024)
        n_bytes = KERNEL.lib().segscan_scratch_bytes(cap)
        held = (torch.zeros(n_bytes // 8, dtype=torch.int64, device=device), cap)
        KERNEL.scratch[key] = held
    return held


def segsum_sorted(skey_sorted: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Per-segment totals of `vals` [N, W] grouped by the sorted key array
    `skey_sorted` [N], delivered on each segment's head row."""
    if vals.device.type == "cpu" and skey_sorted.device.type == "cpu":
        return segsum_sorted_ref(skey_sorted, vals)
    if vals.device.type != "cuda" or skey_sorted.device != vals.device:
        raise ValueError(
            f"segsum_sorted: tensors on {skey_sorted.device} and {vals.device}; "
            "both must be on one CUDA device (or both on the CPU)"
        )
    if skey_sorted.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(
            f"segsum_sorted takes int32 keys and float32 values, got "
            f"{skey_sorted.dtype} and {vals.dtype}"
        )
    if vals.ndim != 2 or skey_sorted.shape != (vals.shape[0],):
        raise ValueError(
            f"segsum_sorted: keys {tuple(skey_sorted.shape)} and values "
            f"{tuple(vals.shape)} must be [N] and [N, W]"
        )
    n, w = vals.shape
    if n == 0:
        return torch.empty_like(vals)
    if not 1 <= w <= KERNEL.query("segscan_max_width"):
        raise ValueError(f"segsum_sorted: width W={w} is outside the kernel's range")
    if n >= 2**31 // max(w, 1):
        raise ValueError(f"segsum_sorted: N={n} overflows the kernel's int32 sizes")
    skey_sorted = skey_sorted.contiguous()
    vals = vals.contiguous()
    tile = KERNEL.query("segscan_tile_rows")
    stream = stream_handle(vals.device)
    scratch, cap = _scratch(vals.device, stream, (n + tile - 1) // tile)
    out = torch.empty_like(vals)
    KERNEL.launch(
        "segscan_launch",
        skey_sorted.data_ptr(), vals.data_ptr(), n, w,
        scratch.data_ptr(), cap, out.data_ptr(), stream,
        device=vals.device, capturing=torch.cuda.is_current_stream_capturing(),
    )
    return out


def segsum_sorted_ref(skey_sorted: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: segment totals (by `index_add_`) broadcast to
    every row of the segment, a superset of the head-row contract."""
    n = vals.shape[0]
    same = torch.zeros(n, dtype=torch.bool, device=vals.device)
    same[1:] = skey_sorted[1:] == skey_sorted[:-1]
    seg_id = torch.cumsum((~same).to(torch.int64), 0) - 1
    totals = torch.zeros_like(vals).index_add_(0, seg_id, vals)
    return totals[seg_id]
