"""One Gauss-Newton pass of `models/registration.py::align` around kernel A:
the correspondence lookup before it and the increment after it.

No Pallas kernel is replaced: the JAX package leaves both to XLA, which
fuses `voxel_map.lookup_packed`'s gathers and `lie.se3_exp` into its loop
body.  On the card each is one hand-written kernel of `csrc/gn_pass.cu`
(the source note says what bounds each and what the design does about it),
so that a pass is three launches: `lookup`, kernel A
(`gn_normal_eq.normal_equations_rotated`), `increment`.

* `lookup` takes the scan's points to the world with the pose the loop
  carries (read on the device) and answers each from the two-tier voxel map:
  `lie.transform_points`, then `voxel_map.lookup`'s mu, packed covariance
  and hit (bit for bit for the same pts_w), and mask = valid & hit.
* `increment` solves kernel A's system with `solve_increment`'s
  regulariser, takes `lie.se3_exp`, left-composes the pose, and writes the
  loop's next carry: active, it + 1, converged, R, t, the count.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (`lookup_ref`, `increment_ref`: the torch chain the kernel
replaces) for CPU tensors.  Both write into `out` buffers when given them,
so that the GN loop's WHILE node updates its carry in place: a pass copies
nothing.  The two kernels are one source and one `KERNEL`, whose
`launch_count()` counts both: `LAUNCHES` = 2 a GN pass.
"""

from __future__ import annotations

import torch

from eskf_lio_torch.ops import lie
from eskf_lio_torch.ops import sortmerge as sm
from eskf_lio_torch.ops._cuda import FLOAT, INT, PTR, CudaKernel, stream_handle

KERNEL = CudaKernel(
    "gn_pass",
    "gn_pass.cu",
    {
        "gn_lookup_launch": [
            PTR, PTR, PTR, PTR, PTR, PTR, INT, PTR, INT, INT, INT, INT, FLOAT, FLOAT,
            PTR, PTR, INT, INT, PTR, PTR, PTR, PTR, PTR,
        ],
        "gn_increment_launch": [
            PTR, PTR, PTR, PTR, PTR, PTR, INT, FLOAT, FLOAT,
            PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR,
        ],
    },
    # the plain version rounds each op once: no a*b+c contracted by nvcc
    flags=("-fmad=false",),
)
# launches of `KERNEL` a GN pass: the lookup and the increment
LAUNCHES = 2


def _fail(what: str, tensors, expected: str):
    raise ValueError(
        f"{what}: expected {expected}; got "
        + ", ".join(f"{tuple(x.shape)} {x.dtype} on {x.device}" for x in tensors)
    )


def _check(what: str, spec) -> torch.device:
    """spec: (tensor, shape with -1 for any size, dtype) triples, all on one
    device; returns it."""
    tensors = [x for x, _, _ in spec]
    dev = tensors[0].device
    for x, shape, dtype in spec:
        ok = x.dtype == dtype and x.device == dev and x.dim() == len(shape) and all(
            s == -1 or s == d for s, d in zip(shape, x.shape)
        )
        if not ok:
            _fail(what, tensors, ", ".join(
                f"{'[' + ','.join('*' if s == -1 else str(s) for s in shape) + ']'} {dtype}"
                for _, shape, dtype in spec) + ", all on one device")
    return dev


def _check_out(what: str, out, expected) -> None:
    """`out` buffers: the expected (shape, dtype) each, contiguous, written
    in place."""
    if len(out) != len(expected):
        raise ValueError(f"{what}: {len(expected)} out buffers, got {len(out)}")
    for o, (shape, dtype) in zip(out, expected):
        if o.shape != shape or o.dtype != dtype or not o.is_contiguous():
            raise ValueError(
                f"{what}: out buffers must be contiguous {[(tuple(s), d) for s, d in expected]}; "
                f"got {[(tuple(x.shape), x.dtype, x.is_contiguous()) for x in out]}"
            )


def _launch(fn: str, dev: torch.device, *args) -> None:
    """One launch on the current stream, counted."""
    KERNEL.launch(fn, *args, stream_handle(dev), device=dev,
                  capturing=torch.cuda.is_current_stream_capturing())


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


# `ptr` of the launches below: each input's device address (its own; the
# private `_lookup_kernel` / `_increment_kernel` take another, with which
# `utils/kernel_bounds.py` stages the inputs in host memory)


# ---- lookup -----------------------------------------------------------------


def lookup(points, valid, R, t, vmap, *, voxel_size: float, max_points_per_voxel: int,
           key_bits=sm.DEFAULT_KEY_BITS, out=None, it=None, relook: int = 1, need=None):
    """pts_w = R p + t, and each row's correspondence in `vmap` (a
    `voxel_map.VoxelMap`).  Returns (pts_w [N,3], mu [N,3], cov_packed
    [N,6], mask [N] = valid & hit).

    `out` = (mu, cov_packed, mask) buffers to write in place (contiguous).
    With them the lookup may be skipped, pts_w still taken, as `align`'s
    re-match guards skip it: given `need` (a [1] bool, the adaptive
    re-match), it runs where `need[0]` holds; else, with `relook` > 1,
    where `it` (a 0-d int64) is a multiple of `relook`.  Where it is
    skipped the buffers keep what they hold."""
    n = points.shape[0]
    dev = _check("gn_pass.lookup", [
        (points, (n, 3), torch.float32), (valid, (n,), torch.bool),
        (R, (3, 3), torch.float32), (t, (3,), torch.float32),
        (vmap.origin, (3,), torch.int32), (vmap.view, (-1, 128), torch.int32),
        (vmap.d_view, (-1, 128), torch.int32),
        *([(it, (), torch.int64)] if it is not None else []),
        *([(need, (1,), torch.bool)] if need is not None else []),
    ])
    bits = sm.check_key_bits(key_bits)
    if int(relook) < 1:
        raise ValueError(f"gn_pass.lookup: relook must be >= 1, got {relook}")
    if out is None and (need is not None or (it is not None and relook > 1)):
        raise ValueError("gn_pass.lookup: a lookup that may be skipped needs its out buffers")
    if out is not None:
        _check_out("gn_pass.lookup", out, [((n, 3), torch.float32), ((n, 6), torch.float32),
                                           ((n,), torch.bool)])
        if any(o.device != dev for o in out):
            raise ValueError("gn_pass.lookup: out buffers on another device")
    if dev.type == "cpu":
        return lookup_ref(points, valid, R, t, vmap, voxel_size=voxel_size,
                          max_points_per_voxel=max_points_per_voxel, key_bits=bits, out=out,
                          it=it, relook=relook, need=need)
    if dev.type != "cuda":
        raise ValueError(f"gn_pass.lookup: unsupported device {dev}")
    if not 1 <= n < 2**31 // 6:
        raise ValueError(f"gn_pass.lookup: N={n} is outside the kernel's range")
    return _lookup_kernel(points, valid, R, t, vmap, bits, voxel_size, max_points_per_voxel,
                          out, it, relook, need, _ptr)


def _lookup_kernel(points, valid, R, t, vmap, bits, voxel_size, max_points_per_voxel,
                   out, it, relook, need, ptr):
    """The lookup kernel's launch on checked CUDA inputs."""
    n, dev = points.shape[0], points.device
    points, valid, R, t = (x.contiguous() for x in (points, valid, R, t))
    view, d_view = vmap.view.contiguous(), vmap.d_view.contiguous()
    if out is None:
        out = (points.new_empty((n, 3)), points.new_empty((n, 6)),
               torch.empty(n, dtype=torch.bool, device=dev))
    pts_w = points.new_empty((n, 3))
    mu, cov, mask = out
    # without an iteration count every call looks up
    relook = int(relook) if it is not None else 1
    _launch("gn_lookup_launch", dev,
            ptr(points), ptr(valid), ptr(R), ptr(t), ptr(vmap.origin.contiguous()),
            ptr(view), view.shape[0], ptr(d_view), d_view.shape[0], *bits, float(voxel_size),
            float(max_points_per_voxel), ptr(need), ptr(it), relook, n,
            pts_w.data_ptr(), mu.data_ptr(), cov.data_ptr(), mask.data_ptr())
    return pts_w, mu, cov, mask


def lookup_ref(points, valid, R, t, vmap, *, voxel_size: float, max_points_per_voxel: int,
               key_bits=sm.DEFAULT_KEY_BITS, out=None, it=None, relook: int = 1, need=None):
    """Plain PyTorch version of `lookup`: `lie.transform_points` and
    `voxel_map.lookup`, merged into `out` by `torch.where` where the lookup
    is skipped."""
    from eskf_lio_torch.map import voxel_map as vm  # the map imports the graphs, which import this

    pts_w = lie.transform_points(R, t, points)
    mu, cov, hit = vm.lookup(vmap, pts_w, voxel_size=voxel_size,
                             max_points_per_voxel=max_points_per_voxel, key_bits=key_bits)
    new = (mu, cov, valid & hit)
    if out is None:
        return (pts_w, *new)
    if need is not None:
        do = need.any()
    elif it is not None and relook > 1:
        do = it % relook == 0
    else:
        do = None
    for o, x in zip(out, new):
        o.copy_(x if do is None else torch.where(do, x, o))
    return (pts_w, *out)


# ---- increment --------------------------------------------------------------


def solve_increment(JTJ, JTr, num_corr):
    """Solve JᵀWJ ξ = −JᵀWr.  Returns (R_Δ, t_Δ); degenerate systems (<6
    correspondences) give the identity update."""
    dtype = JTJ.dtype
    ok = num_corr >= 6
    reg = 1e-3 * (1.0 - ok.to(dtype)) + 1e-8
    JTJ_safe = JTJ + reg * torch.eye(6, dtype=dtype, device=JTJ.device)
    # solve_ex: no error check, hence no device sync; the result is
    # discarded via `ok` when the system is degenerate
    xi = torch.linalg.solve_ex(JTJ_safe, -JTr)[0]
    xi = torch.where(ok, xi, torch.zeros_like(xi))
    return lie.se3_exp(xi)


def converged(R_delta, t_delta, cosine_threshold: float,
              translation_sq_threshold: float) -> torch.Tensor:
    """ref `convergenceCheck` (`Registration.cpp:37-50`)."""
    cosine = 0.5 * (torch.trace(R_delta) - 1.0)
    t_sq = torch.sum(t_delta * t_delta)
    return (cosine >= cosine_threshold) & (t_sq <= translation_sq_threshold)


def increment(JTJ, JTr, num, R, t, it=None, *, max_iterations: int,
              cosine_threshold: float, translation_sq_threshold: float,
              out=None, deltas: bool = False):
    """The end of a GN pass from kernel A's sums: the increment, the
    left-composed pose and the loop's next carry.  Returns (active, it + 1,
    converged, R, t, num) — 0-d bool, 0-d int64, 0-d bool, [3,3], [3], 0-d
    f32 — and, with `deltas`, (R_Δ, t_Δ) after them.

    `it` (0-d int64) is the pass's count before it, 0 when None; `out` =
    buffers of the first six results to write in place (contiguous; R and
    t may be the buffers the pose is read from)."""
    spec = [(JTJ, (6, 6), torch.float32), (JTr, (6,), torch.float32),
            (num, (), torch.float32), (R, (3, 3), torch.float32), (t, (3,), torch.float32)]
    if it is not None:
        spec.append((it, (), torch.int64))
    dev = _check("gn_pass.increment", spec)
    expected = [((), torch.bool), ((), torch.int64), ((), torch.bool), ((3, 3), torch.float32),
                ((3,), torch.float32), ((), torch.float32)]
    if out is not None:
        _check_out("gn_pass.increment", out, expected)
        if any(o.device != dev for o in out):
            raise ValueError("gn_pass.increment: out buffers on another device")
    kw = dict(max_iterations=max_iterations, cosine_threshold=cosine_threshold,
              translation_sq_threshold=translation_sq_threshold, out=out, deltas=deltas)
    if dev.type == "cpu":
        return increment_ref(JTJ, JTr, num, R, t, it, **kw)
    if dev.type != "cuda":
        raise ValueError(f"gn_pass.increment: unsupported device {dev}")
    if out is None:
        out = tuple(torch.empty(shape, dtype=dtype, device=dev) for shape, dtype in expected)
    return _increment_kernel(JTJ, JTr, num, R, t, it, max_iterations, cosine_threshold,
                             translation_sq_threshold, out, deltas, _ptr)


def _increment_kernel(JTJ, JTr, num, R, t, it, max_iterations, cosine_threshold,
                      translation_sq_threshold, out, deltas, ptr):
    """The increment kernel's launch on checked CUDA inputs."""
    dev = JTJ.device
    d = (torch.empty((3, 3), device=dev), torch.empty(3, device=dev)) if deltas else (None, None)
    JTJ, JTr, num, R, t = (x.contiguous() for x in (JTJ, JTr, num, R, t))
    _launch("gn_increment_launch", dev,
            ptr(JTJ), ptr(JTr), ptr(num), ptr(R), ptr(t), ptr(it), int(max_iterations),
            float(cosine_threshold), float(translation_sq_threshold),
            *(o.data_ptr() for o in out), _ptr(d[0]), _ptr(d[1]))
    return (*out, *d) if deltas else tuple(out)


def increment_ref(JTJ, JTr, num, R, t, it=None, *, max_iterations: int,
                  cosine_threshold: float, translation_sq_threshold: float,
                  out=None, deltas: bool = False):
    """Plain PyTorch version of `increment`: `solve_increment`, the
    compose and `converged`."""
    R_d, t_d = solve_increment(JTJ, JTr, num)
    R_new, t_new = R_d @ R, R_d @ t + t_d
    conv = converged(R_d, t_d, cosine_threshold, translation_sq_threshold)
    it_new = (it if it is not None else torch.zeros((), dtype=torch.int64, device=R.device)) + 1
    new = ((it_new < max_iterations) & ~conv, it_new, conv, R_new, t_new,
           num.reshape(()).to(torch.float32))
    if out is not None:
        for o, x in zip(out, new):
            o.copy_(x)
        new = tuple(out)
    return (*new, R_d, t_d) if deltas else new


def reserve_capture(device: torch.device) -> None:
    """Build and load the kernels and make their counter of captured
    launches on `device` before a graph capture (utils/graphs.py); the
    kernels keep no scratch."""
    KERNEL.lib()
    KERNEL.reserve_capture(device, 8)
