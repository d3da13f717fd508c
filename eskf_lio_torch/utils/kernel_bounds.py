"""Kernels A and B, the preprocessor's and the GN pass's kernels over inputs
that end where the device may read (no JAX counterpart: a check of the
loads of `csrc/gn_normal_eq.cu`, `csrc/segscan.cu`, `csrc/preprocess.cu`
and `csrc/gn_pass.cu`).

    python -m eskf_lio_torch.utils.kernel_bounds        # on the card, ~10 s

Each host-side input of a call lies in page-locked host memory registered
for the device up to its last byte, which ends a 64 KiB border; the next
64 KiB of the host mapping stay unregistered, so a load past the input's end
is an illegal address at once, where in device memory it reads a
neighbour's bytes unseen unless the allocation ends a mapped range.

* Kernel B: the values.  The shapes are N a multiple of the tile rows
  (1,024 at W = 10, 512 otherwise): the main path's three kernel-B shapes,
  the bench's LIGHT series' two ([24,576, 10] and [12,288, 10]), the
  insert of `tools.ate_matrix`'s `budget48k` variant ([49,152, 10]) and two
  of the generic template.  Keys
  are ~4 rows a segment, then one run over the last 40 % of the rows (the
  padding of a scan), so the tiles take both the halo and the published
  leads.
* Kernel A: the four row arrays (points and map means [N, 3], packed
  covariances [N, 6]) and the mask [N], each ending its own range.  N is
  the main path's 16,384 (one device), LIGHT's 12,288, 8,192 (a shard's
  slice at D = 4) and 32,768 (`tools.probe_align_parts`), whose full
  chunks take the 16-byte loads, and two ragged N, whose
  last chunk takes the 4-byte ones.
* The preprocessor's six kernels: every input of every launch (the raw
  scan, the state history and extrinsics, and each sort's keys and
  permutation between the kernels), each ending its own range, at N raw
  points and a K-row budget that are multiples of the 256-row blocks:
  mid360's [24,576 -> 12,288] and HEAVY's [131,072 -> 32,768] with the
  deskew, the init step's path (no deskew) at mid360's, and a budget that
  cannot overflow [8,192 -> 8,192].  An input that is a slice (the first K
  rows of a sort) is staged as the slice alone.  The outputs must equal,
  bit for bit, those of the same call on device-resident inputs.
* The GN pass's lookup and increment kernels: every input (the scan's
  points and mask, the pose, the map's origin and both views, the re-match
  flag and the iteration count; kernel A's sums and the count), each ending
  its own range, at mid360's and urban's align rows under their key splits
  and at a ragged N.  The map is small (2,048 main and 1,024 delta buckets)
  and the queries spread over 40^3 voxels, so nearly every bucket of both
  views is probed, the last one of each always.  The outputs must equal,
  bit for bit, those of the same call on device-resident inputs.

Prints `ok B N W max_abs_err` per kernel-B shape (head rows against the
plain version), `ok A N rel_err` per kernel-A shape (the sums against the
plain version, relative to the sum of the terms' absolute values), `ok P N
K path equal` per preprocessor shape, `ok G N bits equal` per GN-pass shape,
and a last `kernel_bounds {...}` line.  A fault ends the process's CUDA context,
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

from eskf_lio_torch.config import Config
from eskf_lio_torch.map import voxel_map as vm
from eskf_lio_torch.ops import gn_normal_eq as gn
from eskf_lio_torch.ops import gn_pass, lie, preprocess, segscan
from eskf_lio_torch.ops._cuda import stream_handle
from eskf_lio_torch.types import Pose, Scan, StateHistory

SHAPES = ((8192, 10), (16384, 10), (131072, 10), (24576, 10), (12288, 10), (49152, 10),
          (1024, 16), (16384, 1))
GN_SHAPES = (16384, 12288, 8192, 32768, 8191, 1000)
# (raw points N, scan budget K, path)
PRE_SHAPES = ((24576, 12288, "deskew"), (131072, 32768, "deskew"), (24576, 12288, "init"),
              (8192, 8192, "deskew"))
# (align rows N, key split)
GN_PASS_SHAPES = ((12288, (10, 10, 10)), (24576, (11, 11, 9)), (1001, (10, 10, 10)))
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


def room_scan(n_raw: int, seed: int, dev, n_states: int = 65) -> tuple[Scan, StateHistory, Pose]:
    """A raw sweep as the step takes it: ~90 % of `n_raw` points on the
    floor, walls and pillars of a 40 x 40 x 5 m room and in clutter, with an
    invalid tail; point times over the 0.1 s sweep; a state history of
    `n_states` rows over it (a smooth motion, the last rows invalid); the
    extrinsics of a tilted, offset sensor."""
    rng = np.random.default_rng(seed)
    n = int(n_raw * 0.9)
    k = n // 5
    u = lambda lo, hi, m: rng.uniform(lo, hi, m)
    ang = u(0, 2 * np.pi, k)
    parts = [
        np.column_stack([u(-20, 20, 2 * k), u(-20, 20, 2 * k), np.full(2 * k, -1.4)]),
        np.column_stack([u(-20, 20, k), np.full(k, 19.5), u(-1.4, 3.6, k)]),
        np.column_stack([3 + 0.4 * np.cos(ang), -2 + 0.4 * np.sin(ang), u(-1.4, 3.6, k)]),
        np.column_stack([u(-20, 20, n - 4 * k), u(-20, 20, n - 4 * k), u(-1.4, 3.6, n - 4 * k)]),
    ]
    pts = np.concatenate(parts) + rng.normal(size=(n, 3)) * 0.01
    pts = np.vstack([pts[rng.permutation(n)], np.zeros((n_raw - n, 3))]).astype(np.float32)
    valid = np.arange(n_raw) < n
    t_rel = np.where(valid, -0.1 + 0.1 * np.arange(n_raw) / n_raw, 0.0).astype(np.float32)
    m = n_states
    t = np.concatenate([[-0.105], np.linspace(-0.1, 0.005, m - 1)]).astype(np.float32)
    p = (np.cumsum(rng.normal(size=(m, 3)) * 0.01, 0) + [0.3, -0.2, 0.05]).astype(np.float32)
    r = (np.cumsum(rng.normal(size=(m, 3)) * 0.003, 0) + [0.01, -0.02, 0.3]).astype(np.float32)
    q = lie.quat_exp(torch.as_tensor(r)).numpy()
    h_valid = np.arange(m) < m - 3
    T = lambda a: torch.as_tensor(a, device=dev)
    R_il = lie.so3_exp(torch.tensor([0.02, -0.01, 0.05], device=dev))
    return (Scan(T(pts), T(t_rel), T(valid)), StateHistory(T(t), T(p), T(q), T(h_valid)),
            Pose(R_il, torch.tensor([-0.011, -0.02329, 0.04412], device=dev)))


def preprocess_call(n: int, k: int, path: str, dev) -> bool:
    """The preprocessor's kernels once on device-resident inputs and once
    with every kernel input staged in host memory that ends a registered
    range (`ending_a_range`); whether the outputs are the same bits."""
    scan, hist, T_il = room_scan(n, n + k, dev)
    cfg = Config(max_raw_points=n, max_scan_points=k)
    with contextlib.ExitStack() as held:

        def staged(t):
            if t is None:
                return 0
            _, (start,) = held.enter_context(ending_a_range([t.cpu().numpy()]))
            return start

        if path == "init":
            pts = T_il.apply(scan.points)
            want = preprocess.downsample_and_covariances(pts, scan.valid, cfg)
            got = preprocess._downsample_kernels(pts, scan.valid, cfg, staged)
        else:
            want = preprocess.preprocess(scan, hist, T_il, cfg)
            got = preprocess._preprocess_kernels(scan, hist, T_il, cfg, staged)
        torch.cuda.synchronize(dev)
        return all(torch.equal(a, b) for a, b in zip(want, got))


def gn_pass_call(n: int, bits, dev) -> bool:
    """The lookup kernel (both re-match guards given) and the increment
    kernel once on device-resident inputs and once with every input staged
    in host memory that ends a registered range; whether the outputs are
    the same bits."""
    rng = np.random.default_rng(n)
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)  # noqa: E731
    kw = dict(voxel_size=0.3, max_points_per_voxel=1000, key_bits=bits)
    m = vm.VoxelMap.create(1 << 12, device=dev, key_bits=bits)
    covs = T(np.tile([0.01, 0.0, 0.0, 0.01, 0.0, 0.01], (3000, 1)))
    for fold in (True, False):  # one insert folded into the main tier, one left in the delta
        near = T(rng.uniform(-1.5, 1.5, (3000, 3)))
        m, _ = vm.insert(m, near, covs, torch.ones(3000, dtype=torch.bool, device=dev), **kw)
        if fold:
            m, _ = vm.compact(m, max_points_per_voxel=1000)
    pts, valid = T(rng.uniform(-6.0, 6.0, (n, 3))), torch.as_tensor(rng.random(n) < 0.9, device=dev)
    R, t = lie.so3_exp(T([0.01, -0.02, 0.015])), T([0.05, -0.03, 0.02])
    if n >= 12288:  # the last bucket of both views is probed
        skey = vm.sm.skey_of(vm.sm.pack_keys(
            vm.vx.voxel_key(lie.transform_points(R, t, pts), 0.3), m.origin, bits)[0])
        for view in (m.view, m.d_view):
            last = view.shape[0] - 1
            assert bool((vm.sm.bucket_of(skey, view.shape[0]) == last).any()), view.shape
    need = torch.ones(1, dtype=torch.bool, device=dev)
    it = torch.tensor(4, device=dev)
    guards = dict(it=it, relook=2, need=need)
    fresh = lambda: (torch.empty((n, 3), device=dev), torch.empty((n, 6), device=dev),  # noqa: E731
                     torch.empty(n, dtype=torch.bool, device=dev))
    want = gn_pass.lookup(pts, valid, R, t, m, out=fresh(), **kw, **guards)
    JTJ, JTr, num = gn.normal_equations_rotated(want[0], covs[:1].expand(n, 6).contiguous(), R,
                                                *want[1:])
    thr = (30, 0.9999, 1e-6)
    carry = lambda: tuple(torch.empty(s, dtype=d, device=dev) for s, d in (  # noqa: E731
        ((), torch.bool), ((), torch.int64), ((), torch.bool), ((3, 3), torch.float32),
        ((3,), torch.float32), ((), torch.float32)))
    want_inc = gn_pass.increment(JTJ, JTr, num, R, t, it, max_iterations=thr[0],
                                 cosine_threshold=thr[1], translation_sq_threshold=thr[2],
                                 deltas=True)
    with contextlib.ExitStack() as held:

        def staged(x):
            if x is None:
                return 0
            _, (start,) = held.enter_context(ending_a_range([x.cpu().numpy()]))
            return start

        got = gn_pass._lookup_kernel(pts, valid, R, t, m, bits, 0.3, 1000, fresh(), it, 2,
                                     need, staged)
        got_inc = gn_pass._increment_kernel(JTJ, JTr, num, R, t, it, *thr, carry(), True,
                                            staged)
        torch.cuda.synchronize(dev)
        return (bool(want[3].any())
                and all(torch.equal(a, b) for a, b in zip(want, got))
                and all(torch.equal(a, b) for a, b in zip(want_inc, got_inc)))


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
    pre = []
    for n, k, path in PRE_SHAPES:
        equal = preprocess_call(n, k, path, dev)
        print("ok P", n, k, path, equal, flush=True)
        pre.append({"n": n, "k": k, "path": path, "equal": equal})
    gn_pass_shapes = []
    for n, bits in GN_PASS_SHAPES:
        equal = gn_pass_call(n, bits, dev)
        print("ok G", n, bits, equal, flush=True)
        gn_pass_shapes.append({"n": n, "key_bits": list(bits), "equal": equal})
    print("kernel_bounds " + json.dumps({"shapes": errs, "gn_shapes": gn_errs,
                                         "pre_shapes": pre, "gn_pass_shapes": gn_pass_shapes,
                                         "ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
