"""Kernel B over values that end where the device may read (no JAX
counterpart: a check of `csrc/segscan.cu`'s loads).

    python -m eskf_lio_torch.utils.kernel_bounds        # on the card, ~10 s

The values of each call lie in page-locked host memory registered for the
device up to their last byte; the next 64 KiB of the host mapping stay
unregistered, so a load past the values' end is an illegal address at once,
where in device memory it reads a neighbour's bytes unseen unless the
allocation ends a mapped range.  The shapes are N a multiple of the tile rows
(1,024 at W = 10, 512 otherwise) with a multiple of 64 KiB of bytes: the
main path's three kernel-B shapes and two of the generic template.  Keys are
~4 rows a segment, then one run over the last 40 % of the rows (the padding
of a scan), so the tiles take both the halo and the published leads.

Prints `ok N W max_abs_err` per shape (head rows against the plain
version) and a last `kernel_bounds {...}` line.  A fault ends the process's
CUDA context, so callers run this in a process of its own and read its exit
code.  A measuring tool: nothing in the package imports it.
"""

from __future__ import annotations

import ctypes
import json
import mmap
import sys

import numpy as np
import torch

from eskf_lio_torch.ops import segscan
from eskf_lio_torch.ops._cuda import stream_handle

SHAPES = ((8192, 10), (16384, 10), (131072, 10), (1024, 16), (16384, 1))
CHUNK = 1 << 16  # host registrations start and end on 64 KiB borders here
PAD_KEY = 2**31 - 1


def one_call(n: int, w: int, scratch: torch.Tensor, cap: int, rng, dev) -> float:
    """Kernel B once over host-resident values that end a registered range;
    the largest head-row difference from the plain version."""
    nbytes = n * w * 4
    host = mmap.mmap(-1, nbytes + 2 * CHUNK)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(host))
    start = (addr + CHUNK - 1) // CHUNK * CHUNK
    vals = np.frombuffer(host, np.float32, n * w, start - addr).reshape(n, w)
    vals[:] = rng.random((n, w), dtype=np.float32)
    keys_np = np.sort(rng.integers(0, n // 4, n)).astype(np.int32)
    keys_np[int(n * 0.6):] = PAD_KEY
    keys = torch.as_tensor(keys_np, device=dev)
    cudart = torch.cuda.cudart()
    torch.cuda.check_error(cudart.cudaHostRegister(start, nbytes, 0))
    try:
        out = torch.empty((n, w), device=dev)
        segscan.KERNEL.launch(
            "segscan_launch", keys.data_ptr(), start, n, w, scratch.data_ptr(), cap,
            out.data_ptr(), stream_handle(dev), device=dev,
        )
        torch.cuda.synchronize(dev)
        want = segscan.segsum_sorted_ref(keys, torch.as_tensor(vals.copy(), device=dev))
    finally:
        torch.cuda.check_error(cudart.cudaHostUnregister(start))
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = keys[1:] != keys[:-1]
    return float((out - want)[head].abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_bounds: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    cap = 1024
    scratch = torch.zeros(segscan.KERNEL.lib().segscan_scratch_bytes(cap) // 8,
                          dtype=torch.int64, device=dev)
    rng = np.random.default_rng(3)
    errs = []
    for n, w in SHAPES:
        err = one_call(n, w, scratch, cap, rng, dev)
        print("ok", n, w, err, flush=True)
        errs.append({"n": n, "w": w, "max_abs_err": err})
    print("kernel_bounds " + json.dumps({"shapes": errs, "ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
