"""Kernels A and B over inputs that end where the device may read (no JAX
counterpart: a check of the loads of `csrc/gn_normal_eq.cu` and
`csrc/segscan.cu`).

    python -m eskf_lio_torch.utils.kernel_bounds        # on the card, ~10 s

Each host-side input of a call lies in page-locked host memory registered
for the device up to its last byte, which ends a 64 KiB border; the next
64 KiB of the host mapping stay unregistered, so a load past the input's end
is an illegal address at once, where in device memory it reads a
neighbour's bytes unseen unless the allocation ends a mapped range.

* Kernel B: the values.  The shapes are N a multiple of the tile rows
  (1,024 at W = 10, 512 otherwise) with a multiple of 64 KiB of bytes: the
  main path's three kernel-B shapes and two of the generic template.  Keys
  are ~4 rows a segment, then one run over the last 40 % of the rows (the
  padding of a scan), so the tiles take both the halo and the published
  leads.
* Kernel A: the four row arrays (points and map means [N, 3], packed
  covariances [N, 6]) and the mask [N], each ending its own range.  N is
  the main path's 16,384 (one device) and 8,192 (a shard's slice at
  D = 4), whose full chunks take the 16-byte loads, and two ragged N, whose
  last chunk takes the 4-byte ones.

Prints `ok B N W max_abs_err` per kernel-B shape (head rows against the
plain version), `ok A N rel_err` per kernel-A shape (the sums against the
plain version, relative to the sum of the terms' absolute values) and a
last `kernel_bounds {...}` line.  A fault ends the process's CUDA context,
so callers run this in a process of its own and read its exit code.  A
measuring tool: nothing in the package imports it.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import mmap
import sys

import numpy as np
import torch

from eskf_lio_torch.ops import gn_normal_eq as gn
from eskf_lio_torch.ops import lie, segscan
from eskf_lio_torch.ops._cuda import stream_handle

SHAPES = ((8192, 10), (16384, 10), (131072, 10), (1024, 16), (16384, 1))
GN_SHAPES = (16384, 8192, 8191, 1000)
CHUNK = 1 << 16  # host registrations end on 64 KiB borders here
PAD_KEY = 2**31 - 1


@contextlib.contextmanager
def ending_a_range(values: list[np.ndarray]):
    """Copies of `values` in page-locked host memory registered for the
    device, each ending a 64 KiB border with nothing registered after it.
    Yields (host arrays, their device addresses)."""
    cudart = torch.cuda.cudart()
    copies, starts = [], []
    try:
        for a in values:
            span = (a.nbytes + CHUNK - 1) // CHUNK * CHUNK
            host = mmap.mmap(-1, span + 2 * CHUNK)
            addr = ctypes.addressof(ctypes.c_char.from_buffer(host))
            start = (addr + CHUNK - 1) // CHUNK * CHUNK + span - a.nbytes
            copy = np.frombuffer(host, a.dtype, a.size, start - addr).reshape(a.shape)
            copy[...] = a
            torch.cuda.check_error(cudart.cudaHostRegister(start, a.nbytes, 0))
            copies.append(copy)
            starts.append(start)
        yield copies, starts
    finally:
        for start in starts:
            torch.cuda.check_error(cudart.cudaHostUnregister(start))


def one_call(n: int, w: int, scratch: torch.Tensor, cap: int, rng, dev) -> float:
    """Kernel B once over host-resident values that end a registered range;
    the largest head-row difference from the plain version."""
    vals_np = rng.random((n, w), dtype=np.float32)
    keys_np = np.sort(rng.integers(0, n // 4, n)).astype(np.int32)
    keys_np[int(n * 0.6):] = PAD_KEY
    keys = torch.as_tensor(keys_np, device=dev)
    with ending_a_range([vals_np]) as (_, (start,)):
        out = torch.empty((n, w), device=dev)
        segscan.KERNEL.launch(
            "segscan_launch", keys.data_ptr(), start, n, w, scratch.data_ptr(), cap,
            out.data_ptr(), stream_handle(dev), device=dev,
        )
        torch.cuda.synchronize(dev)
    want = segscan.segsum_sorted_ref(keys, torch.as_tensor(vals_np, device=dev))
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = keys[1:] != keys[:-1]
    return float((out - want)[head].abs().max())


def gn_rows(n: int, rng) -> tuple[list[np.ndarray], np.ndarray]:
    """Correspondences like the align loop's: points at LiDAR range, SPD
    packed covariances, map means near the points, a 70 % hit mask; and a
    rotation."""

    def spd():
        A = rng.normal(size=(n, 3, 3)) * 0.3
        C = A @ A.transpose(0, 2, 1) + 0.05 * np.eye(3)
        return C[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]

    pts = rng.normal(size=(n, 3)) * 8.0
    rows = [pts, spd(), pts + rng.normal(size=(n, 3)) * 0.1, spd()]
    rows = [np.ascontiguousarray(a, np.float32) for a in rows]
    return rows + [rng.random(n) < 0.7], rng.normal(size=3).astype(np.float32) * 0.3


def gn_call(n: int, scratch: torch.Tensor, rng, dev) -> float:
    """Kernel A once over host-resident rows and mask, each ending a
    registered range; the largest difference of its sums from the plain
    version's, relative to the sum of the terms' absolute values."""
    rows, ang = gn_rows(n, rng)
    R = lie.so3_exp(torch.as_tensor(ang, device=dev))
    out = torch.empty(43, device=dev)
    with ending_a_range(rows) as (_, (pts, covs, mu, covm, mask)):
        gn.KERNEL.launch(
            "gn_normal_eq_launch", pts, covs, R.data_ptr(), R.stride(0), R.stride(1),
            mu, covm, mask, n, scratch.data_ptr(), out.data_ptr(), stream_handle(dev),
            device=dev,
        )
        torch.cuda.synchronize(dev)
    args = [torch.as_tensor(a, device=dev) for a in rows]
    args.insert(2, R)
    JTJ, JTr, count = gn.normal_equations_rotated_ref(*args)
    terms = gn._closed_form_terms(*args).abs().sum(0)
    scale = torch.cat([terms[torch.tensor(gn._FULL, device=dev)], terms[21:27], terms[27:]])
    diff = (out - torch.cat([JTJ.reshape(-1), JTr, count.reshape(1)])).abs()
    return float((diff / scale.clamp(min=1e-30)).max())


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
        print("ok B", n, w, err, flush=True)
        errs.append({"n": n, "w": w, "max_abs_err": err})
    # the partial sums and the ticket, which the kernel resets itself
    gn_scratch = torch.zeros(gn.KERNEL.query("gn_normal_eq_scratch_bytes") // 4, device=dev)
    gn_errs = []
    for n in GN_SHAPES:
        rel = gn_call(n, gn_scratch, rng, dev)
        print("ok A", n, rel, flush=True)
        gn_errs.append({"n": n, "rel_err": rel})
    print("kernel_bounds " + json.dumps({"shapes": errs, "gn_shapes": gn_errs, "ok": True}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
