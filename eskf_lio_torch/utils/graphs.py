"""Device-resident control flow and captured steps: the port's counterpart
of `jax.jit`, `lax.cond` and `lax.while_loop`.

The JAX package compiles each step into one device program (`@jax.jit`,
`eskf_lio_tpu/pipeline/odometry.py:185,208,232`) whose data-dependent
control stays on the device: the GN loop is a `lax.while_loop`
(`eskf_lio_tpu/models/registration.py:298`), the LSM fold a `lax.cond`
(`eskf_lio_tpu/map/voxel_map.py:615`).  Here a step is captured once into a
CUDA graph (`StepGraph`) and replayed, and inside it `device_if` and
`device_while` become CUDA conditional nodes (IF, WHILE) whose condition a
one-thread kernel sets on the device from a 0-dim bool
(`csrc/graph_cond.cu`): a replay reads nothing back to the host.

PyTorch 2.11 has no public call for conditional nodes, so the node is added
to the graph that the current stream is capturing through the CUDA runtime,
and its body is captured from a second stream, one per nesting depth, whose
allocations go to a memory pool of that depth.  The streams, the pools,
their cuBLAS state and the kernels' capture scratch are made by `prepare`,
before any capture: a capture allocates nothing that outlives the graph.

`device_if` and `device_while` have three behaviours, chosen by state:

* while the current CUDA stream is capturing: conditional nodes;
* eagerly: a Python branch on the predicate, one host read a decision;
* under `select_branches()` (the CPU tests): every branch runs and the
  results are merged with `torch.where` — the same values with no host
  read, which lets a CPU test show that the captured path reads nothing
  back (a WHILE loop runs its body `max_iterations` times, each guarded).

Captures run in CUDA's thread-local capture mode: a call that could break
a capture (a host read, an allocation of a new segment) fails on the
capturing thread, while other threads may make such calls meanwhile, but
none may synchronize the device (CUDA refuses it in every mode).  The body
streams and pools, the capture stream and the kernels' capture scratch are
one per device, shared by every graph: graphs are captured one at a time and
replayed one at a time, on one thread as the port's drivers do.

Branch bodies have no side effects outside the values they return.  Under
capture those values are copied into `outs`, buffers the caller keeps for
the rest of the capture; eagerly and in select mode `outs` is only the value
of the side not taken and nothing is written in place.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import time
from typing import Callable, Sequence

import torch

from eskf_lio_torch.ops import gn_normal_eq, gn_pass, imu_prefix, preprocess, segscan
from eskf_lio_torch.ops._cuda import INT, PTR, CudaKernel, build
from eskf_lio_torch.parallel import distributed as dist

_U64 = ctypes.c_ulonglong
_SIZE = ctypes.c_size_t

GRAPH_COND = CudaKernel(
    "graph_cond",
    "graph_cond.cu",
    {
        "graph_cond_runtime_version": [],
        "graph_cond_handle_create": [PTR, ctypes.POINTER(_U64)],
        "graph_cond_set": [_U64, PTR, PTR],
        "graph_cond_add_node": [PTR, _U64, INT, ctypes.POINTER(PTR)],
        "graph_cond_begin_body": [PTR, PTR],
        "graph_cond_end_body": [PTR, ctypes.POINTER(_SIZE), ctypes.POINTER(_SIZE), INT],
        "graph_cond_captured_nodes": [PTR, ctypes.POINTER(_SIZE)],
        "graph_cond_stamp": [PTR, PTR, ctypes.c_longlong, _U64, PTR],
    },
)
_IF, _WHILE = 0, 1
# cudaGraphNodeType, by value (CUDA 12.4+): what a conditional body holds;
# last, the nodes whose type the runtime does not report (`graph_cond.cu`)
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event",
              "event_record", "ext_semaphore_signal", "ext_semaphore_wait", "mem_alloc",
              "mem_free", "batch_mem_op", "conditional", "unreported")
# conditional nodes nest at most this deep (the GN loop's re-match IF sits
# inside its WHILE)
MAX_DEPTH = 2

# per thread: select mode, body depth, nodes of a capture, devices warmed
_LOCAL = threading.local()
# (device index, depth) -> (body stream, body pool); device index -> the
# stream that captures steps
_BODIES: dict[tuple[int, int], tuple[torch.cuda.Stream, tuple]] = {}
_CAPTURE_STREAMS: dict[int, torch.cuda.Stream] = {}
# captures under way on any thread, and the graphs whose `StepGraph` was
# collected meanwhile: destroying a CUDA graph inside a capture is refused
# (cudaGraphExecDestroy: "operation not permitted when stream is capturing")
# and breaks that capture, after its memory pool was already released, so
# such a graph is kept until no capture runs
_CAPTURES = {"under_way": 0, "parked": 0}  # parked: graphs ever kept so
_PARKED: list = []
_CAPTURES_LOCK = threading.RLock()  # a collection may run while it is held


@contextlib.contextmanager
def select_branches():
    """Run every `device_if` branch and `device_while` iteration and merge
    by `torch.where` (this thread only): the captured path's values without
    a host read, on any device."""
    before = getattr(_LOCAL, "select", False)
    _LOCAL.select = True
    try:
        yield
    finally:
        _LOCAL.select = before


def _selecting() -> bool:
    return getattr(_LOCAL, "select", False)


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def assign(outs: Sequence[torch.Tensor], vals) -> None:
    """Copy each value into its out buffer, unless it is that buffer (the
    same memory, shape, strides and type)."""
    vals = tuple(vals)
    if len(vals) != len(outs):
        raise ValueError(f"a branch returned {len(vals)} values for {len(outs)} outs")
    for o, v in zip(outs, vals):
        same = (v.data_ptr() == o.data_ptr() and v.shape == o.shape
                and v.stride() == o.stride() and v.dtype == o.dtype)
        if not same:
            o.copy_(v)


@contextlib.contextmanager
def _conditional(pred: torch.Tensor, kind: int, repeat_on: torch.Tensor | None = None):
    """Capture the enclosed ops as the body of a conditional node on `pred`
    in the graph the current stream is capturing.  A WHILE node re-reads
    `repeat_on` at the end of each pass of its body."""
    if pred.dtype != torch.bool or pred.dim() != 0:
        raise ValueError(f"a device predicate is a 0-dim bool, got {pred.dtype} {tuple(pred.shape)}")
    dev = pred.device
    stack = _LOCAL.__dict__.setdefault("depth", [])
    if len(stack) >= MAX_DEPTH:
        raise RuntimeError(f"conditional nodes nest deeper than {MAX_DEPTH}")
    body_stream, pool = _BODIES[(dev.index, len(stack))]
    outer = torch.cuda.current_stream(dev).cuda_stream
    handle = _U64()
    GRAPH_COND.call("graph_cond_handle_create", outer, ctypes.byref(handle))
    GRAPH_COND.call("graph_cond_set", handle.value, pred.data_ptr(), outer)
    body = PTR()
    GRAPH_COND.call("graph_cond_add_node", outer, handle.value, kind, ctypes.byref(body))
    GRAPH_COND.call("graph_cond_begin_body", body_stream.cuda_stream, body)
    stack.append(kind)
    try:
        with torch.cuda.stream(body_stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev.index, pool)
            try:
                yield
                if repeat_on is not None:
                    GRAPH_COND.call("graph_cond_set", handle.value, repeat_on.data_ptr(),
                                    body_stream.cuda_stream)
            finally:
                torch._C._cuda_endAllocateToPool(dev.index, pool)
    finally:
        stack.pop()
        n, by_type = _SIZE(), (_SIZE * len(NODE_TYPES))()
        GRAPH_COND.call("graph_cond_end_body", body_stream.cuda_stream, ctypes.byref(n),
                        by_type, len(NODE_TYPES) - 1)
        _LOCAL.nodes = getattr(_LOCAL, "nodes", 0) + n.value
        _LOCAL.__dict__.setdefault("bodies", []).append({
            "kind": "while" if kind == _WHILE else "if", "depth": len(stack),
            "nodes": n.value,
            "by_type": {t: c for t, c in zip(NODE_TYPES, by_type) if c},
        })


def device_if(pred: torch.Tensor, fn: Callable, outs=None, otherwise: Callable | None = None):
    """`lax.cond(pred, fn, otherwise)` on a 0-dim device bool: the values of
    `fn()` where `pred` holds, else those of `otherwise()` (or `outs` as
    they are).  Under capture they are written into `outs` (required then),
    as one IF node on `pred` and, with `otherwise`, one on `~pred`; eagerly
    `pred` is read once.  Returns a tuple of tensors."""
    if _selecting():
        taken = tuple(fn())
        other = tuple(otherwise()) if otherwise is not None else tuple(outs)
        return tuple(torch.where(pred, t, o) for t, o in zip(taken, other))
    if _capturing(pred):
        if outs is None:
            raise ValueError("a captured branch needs the buffers it writes (outs)")
        outs = tuple(outs)
        with _conditional(pred, _IF):
            assign(outs, fn())
        if otherwise is not None:
            with _conditional(~pred, _IF):
                assign(outs, otherwise())
        return outs
    if bool(pred):
        return tuple(fn())
    return tuple(otherwise()) if otherwise is not None else tuple(outs)


def device_while(body: Callable, carry: Sequence[torch.Tensor], max_iterations: int):
    """`lax.while_loop` whose condition is `carry[0]`, a 0-dim device bool:
    `body(carry)` returns the next carry (same shapes and types, its first
    entry the next condition) and may write it in place.  Under capture one
    WHILE node whose buffers are copies of `carry`; eagerly one read a pass;
    in select mode `max_iterations` guarded passes (the loop must end within
    them), each given a copy of the carry, so that a pass past the end
    writes nothing that is kept.  Returns the final carry."""
    carry = tuple(carry)
    if _selecting():
        for _ in range(max_iterations):
            new = tuple(body(tuple(c.clone() for c in carry)))
            carry = tuple(torch.where(carry[0], n, c) for n, c in zip(new, carry))
        return carry
    if _capturing(carry[0]):
        carry = tuple(c.clone() for c in carry)  # the loop's own buffers
        with _conditional(carry[0], _WHILE, repeat_on=carry[0]):
            assign(carry, body(carry))
        return carry
    while bool(carry[0]):
        carry = tuple(body(carry))
    return carry


def _warm(device: torch.device) -> None:
    """First use, on the current stream, of what a step launches through
    cuBLAS and cuSOLVER (their handles keep per-stream workspaces)."""
    a = torch.ones((4, 18, 18), device=device)
    (a @ a).sum()
    a[0, :3, :3] @ a[0, :3, :3]
    torch.einsum("nij,nkj->ik", a, a)
    torch.linalg.solve_ex(torch.eye(6, device=device), torch.ones(6, device=device))
    torch.sort(torch.arange(8, dtype=torch.int32, device=device), stable=True)


def _indexed(device: torch.device) -> torch.device:
    """`cuda` as `cuda:<current>`: buffers are keyed by the index that the
    tensors on the device carry."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    return device


def prepare(device: torch.device, segscan_rows: int) -> torch.cuda.Stream:
    """Everything a capture on `device` must find made (call outside any
    capture): the capture stream, a stream and pool per body depth, the
    cuBLAS / cuSOLVER state of each, the conditional-node library, and the
    kernels' capture scratch for up to `segscan_rows` rows.  Under a process
    group whose collectives a capture can hold (`nccl`), also one all-reduce
    on each of those streams, once per group (`distributed.warm_up`: a
    collective, so every process prepares at the same point of its run, as
    the sharded driver's processes do).  Returns the capture stream."""
    device = _indexed(device)
    # the sources a step launches, one nvcc each started together (none when built)
    build([GRAPH_COND, gn_normal_eq.KERNEL, gn_pass.KERNEL, segscan.KERNEL, preprocess.KERNEL,
           imu_prefix.KERNEL])
    GRAPH_COND.lib()
    gn_normal_eq.reserve_capture(device)
    gn_pass.reserve_capture(device)
    segscan.reserve_capture(device, segscan_rows)
    preprocess.reserve_capture(device)
    imu_prefix.reserve_capture(device)
    if device.index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device.index] = torch.cuda.Stream(device)
        for depth in range(MAX_DEPTH):
            _BODIES[(device.index, depth)] = (
                torch.cuda.Stream(device), torch.cuda.graph_pool_handle()
            )
    # cuBLAS handles are per thread: each capturing thread warms its own;
    # a group's collectives are warmed once per group
    warmed = _LOCAL.__dict__.setdefault("warmed", set())
    group = (device.index, dist.GROUP["generation"])
    libraries = device.index not in warmed
    collectives = dist.backend() == "nccl" and group not in warmed
    if libraries or collectives:
        warmed.update((device.index, group) if collectives else (device.index,))
        current = torch.cuda.current_stream(device)
        streams = [_CAPTURE_STREAMS[device.index]]
        streams += [_BODIES[(device.index, d)][0] for d in range(MAX_DEPTH)]
        for s in streams:
            s.wait_stream(current)
            with torch.cuda.stream(s):
                if libraries:
                    _warm(device)
                if collectives:
                    dist.warm_up(device)
            current.wait_stream(s)
    return _CAPTURE_STREAMS[device.index]


class StepGraph:
    """One step captured into a CUDA graph on its first call and replayed on
    every call.  `fn()` reads and writes only buffers that outlive the graph
    (static inputs, carry and outputs) and returns nothing: what it
    allocates lives in the graph's pool and is dead when it returns.

    `capture_s`, `nodes` (top level and every conditional body),
    `stamp_nodes` (of those, the tracer's: stamps and device counts) and `bodies` (each
    conditional body in capture order: its kind, depth, nodes and nodes by
    type) describe the capture; graphs that never run at once may share a
    `pool`.  With a tracer (`utils.profiling.Tracer`), each capture is a
    `graph_capture` span and its nodes the counters `graph_nodes.<name>` and
    `stamp_nodes.<name>`."""

    def __init__(self, fn: Callable[[], None], device: torch.device, segscan_rows: int,
                 pool=None, tracer=None, name: str = "step"):
        self.fn = fn
        self.tracer = tracer
        self.name = name
        self.device = _indexed(device)
        self.segscan_rows = segscan_rows
        self.pool = pool if pool is not None else torch.cuda.graph_pool_handle()
        self.graph: torch.cuda.CUDAGraph | None = None
        self.capture_s: float | None = None
        self.nodes: int | None = None
        self.stamp_nodes: int | None = None
        self.bodies: list[dict] | None = None

    def capture(self) -> None:
        tr = self.tracer
        if tr is not None:
            tr.begin("graph_capture")
            stamps0 = tr.stamps_captured
        stream = prepare(self.device, self.segscan_rows)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        _LOCAL.nodes, _LOCAL.bodies = 0, []
        top = _SIZE()
        with _CAPTURES_LOCK:
            _CAPTURES["under_way"] += 1
        try:
            # thread-local mode: a capture forbids calls that could break it
            # on its own thread only, so another thread (a driver's caller, a
            # viewer) may read values back meanwhile; in the global mode such
            # a read fails ("operation not permitted when stream is capturing")
            with torch.cuda.graph(graph, pool=self.pool, stream=stream,
                                  capture_error_mode="thread_local"):
                self.fn()
                GRAPH_COND.call("graph_cond_captured_nodes", stream.cuda_stream,
                                ctypes.byref(top))
        finally:
            with _CAPTURES_LOCK:
                _CAPTURES["under_way"] -= 1
                parked = _PARKED[:] if _CAPTURES["under_way"] == 0 else []
                if parked:
                    _PARKED.clear()
            del parked  # destroyed here, outside any capture
        self.capture_s = time.perf_counter() - t0
        self.nodes = top.value + _LOCAL.nodes
        self.bodies = _LOCAL.bodies
        self.graph = graph
        self.stamp_nodes = 0
        if tr is not None:
            tr.end()
            self.stamp_nodes = tr.stamps_captured - stamps0
            tr.count(f"graph_nodes.{self.name}", self.nodes)
            tr.count(f"stamp_nodes.{self.name}", self.stamp_nodes)

    def __call__(self) -> None:
        if self.graph is None:
            self.capture()
        self.graph.replay()

    def __del__(self, _lock=_CAPTURES_LOCK, _captures=_CAPTURES, _parked=_PARKED) -> None:
        # collected inside a capture (a garbage collection may run at any
        # allocation of the capturing thread): keep the graph until it ends.
        # (The module's globals are bound as defaults: at interpreter exit
        # they may be gone before the last graphs.)
        if self.graph is not None:
            with _lock:
                if _captures["under_way"]:
                    _parked.append(self.graph)
                    _captures["parked"] += 1
