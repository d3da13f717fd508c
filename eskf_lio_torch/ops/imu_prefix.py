"""The parallel-prefix IMU propagation of `models/eskf.py::predict_chunk_prefix`
in one launch (`csrc/imu_prefix.cu`).

No Pallas kernel is replaced: the JAX package leaves the prefix to XLA.  On
the card the plain chain (`eskf.imu_prefix_ref`: two log-step scans, two
cumsums and the noise sum, ~390 small kernels a call) becomes one kernel of
one block that writes every result the chain returns: the history's t_rel,
p, q and valid, and the base state's p, v, q and P (ba, bg and g pass
through).  It gives the chain's bits on the card: the source note names the
order of each of torch's kernels it follows.

`imu_prefix` launches the kernel for CUDA tensors and runs the plain chain
for CPU tensors; it raises on a chunk of more than `MAX_SAMPLES` samples,
on a dtype other than float32 (bool for the masks) and on tensors on more
than one device.  `KERNEL.launch_count()` counts one launch a call
(`LAUNCHES`), captured ones included.
"""

from __future__ import annotations

import torch

from eskf_lio_torch.ops._cuda import INT, PTR, CudaKernel, stream_handle
from eskf_lio_torch.types import FilterState, ImuChunk, StateHistory

KERNEL = CudaKernel(
    "imu_prefix",
    "imu_prefix.cu",
    {
        "imu_prefix_launch": [PTR] * 14 + [INT] + [PTR] * 9,
        "imu_prefix_prepare": [],
    },
    # the plain chain rounds each op once: no a*b+c contracted by nvcc
    flags=("-fmad=false",),
)
# launches of `KERNEL` a call
LAUNCHES = 1
# the longest chunk the kernel takes (one block, the scans in shared memory)
MAX_SAMPLES = 64


def _check(state: FilterState, chunk: ImuChunk, q_diag, base_mask) -> torch.device:
    m = chunk.dt.shape[0] if chunk.dt.dim() == 1 else -1
    spec = [
        ("state.p", state.p, (3,)), ("state.v", state.v, (3,)), ("state.q", state.q, (4,)),
        ("state.ba", state.ba, (3,)), ("state.bg", state.bg, (3,)), ("state.g", state.g, (3,)),
        ("state.P", state.P, (18, 18)), ("chunk.dt", chunk.dt, (m,)),
        ("chunk.t_rel", chunk.t_rel, (m,)), ("chunk.gyro", chunk.gyro, (m, 3)),
        ("chunk.accel", chunk.accel, (m, 3)), ("chunk.valid", chunk.valid, (m,)),
        ("q_diag", q_diag, (12,)),
    ]
    if base_mask is not None:
        spec.append(("base_mask", base_mask, (m,)))
    if not 1 <= m <= MAX_SAMPLES:
        raise ValueError(
            f"imu_prefix: a chunk of 1 to {MAX_SAMPLES} samples, got dt of shape "
            f"{tuple(chunk.dt.shape)}")
    dev = state.p.device
    for name, x, shape in spec:
        dtype = torch.bool if name in ("chunk.valid", "base_mask") else torch.float32
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"imu_prefix: {name} must be {list(shape)} {dtype}, got "
                             f"{list(x.shape)} {x.dtype}")
        if x.device != dev:
            raise ValueError(f"imu_prefix: every tensor on one device; {name} is on {x.device}, "
                             f"state.p on {dev}")
    return dev


def imu_prefix(state: FilterState, chunk: ImuChunk, q_diag: torch.Tensor,
               base_mask: torch.Tensor | None = None) -> tuple[FilterState, StateHistory]:
    """`predict_chunk_prefix` on checked inputs: (the base state, the
    history through every sample).  `q_diag` [12] is the process noise's
    diagonal (`NoiseParams.q_diag`)."""
    dev = _check(state, chunk, q_diag, base_mask)
    if dev.type == "cpu":
        from eskf_lio_torch.models import eskf  # the model imports this module

        return eskf.imu_prefix_ref(state, chunk, q_diag, base_mask)
    if dev.type != "cuda":
        raise ValueError(f"imu_prefix: unsupported device {dev}")
    m = chunk.dt.shape[0]
    capturing = torch.cuda.is_current_stream_capturing()
    if dev.index not in _PREPARED:
        if capturing:
            raise RuntimeError("imu_prefix: the kernel was not prepared on "
                               f"{dev} before the graph capture (reserve_capture)")
        _prepare(dev)
    ins = [x.contiguous() for x in (*state, *chunk[:4])]
    valid = chunk.valid.contiguous()
    mask = None if base_mask is None else base_mask.contiguous()
    hist = StateHistory(
        t_rel=torch.empty(m + 1, device=dev), p=torch.empty((m + 1, 3), device=dev),
        q=torch.empty((m + 1, 4), device=dev),
        valid=torch.empty(m + 1, dtype=torch.bool, device=dev))
    base_p, base_v = torch.empty(3, device=dev), torch.empty(3, device=dev)
    base_q, base_P = torch.empty(4, device=dev), torch.empty((18, 18), device=dev)
    KERNEL.launch(
        "imu_prefix_launch",
        *(x.data_ptr() for x in ins), valid.data_ptr(), 0 if mask is None else mask.data_ptr(),
        q_diag.contiguous().data_ptr(), m,
        *(x.data_ptr() for x in hist), base_p.data_ptr(), base_v.data_ptr(), base_q.data_ptr(),
        base_P.data_ptr(), stream_handle(dev),
        device=dev, capturing=capturing)
    base = FilterState(p=base_p, v=base_v, q=base_q, ba=state.ba, bg=state.bg, g=state.g,
                       P=base_P)
    return base, hist


def reserve_capture(device: torch.device) -> None:
    """Build and load the kernel, let it take its shared memory on `device`
    and make its counter of captured launches there before a graph capture
    (utils/graphs.py); the kernel keeps no scratch."""
    _prepare(device)
    KERNEL.reserve_capture(device, 8)


# devices on which the kernel may take its shared memory (a setting of the
# device's context, made outside any capture)
_PREPARED: set[int] = set()


def _prepare(device: torch.device) -> None:
    if device.index not in _PREPARED:
        with torch.cuda.device(device):
            KERNEL.call("imu_prefix_prepare")
        _PREPARED.add(device.index)
