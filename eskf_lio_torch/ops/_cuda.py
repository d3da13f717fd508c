"""Build and bind the port's CUDA kernels (no JAX counterpart: Pallas
kernels compile inside `jax.jit`).

Each `csrc/*.cu` source has a plain C interface and becomes one shared
library built by `nvcc` for `sm_90a` at first use, into `build/kernels/` at
the root of the checkout, named by a hash of its source and flags, so a
fresh checkout builds everything on its first call and later processes
reuse the libraries.  The libraries are loaded with `ctypes`; every C entry
point returns `cudaGetLastError()` and `CudaKernel.launch` raises when it is
not 0.  Nothing here runs when a module is imported: the CPU tests import
every module on hosts without `nvcc`.

A kernel launched while a CUDA graph is being captured
(`utils/graphs.py`) runs on every replay of the graph, not once: it takes
its scratch from a buffer reserved for captures before the capture began
(`reserve_capture`), and its launch is counted on the device, by a counter
increment captured beside it, so that `launch_count()` sees every replay.

Processes that start together (a multi-process run on one checkout) do not
race: each builds to a temporary name of its own and renames it into place,
which is atomic, so a library that exists is whole.  Two may build the same
source at once; the second rename replaces an identical file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# ctypes argument kinds for the C signatures
PTR = ctypes.c_void_p
INT = ctypes.c_int


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc was not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "eskf_lio_torch are built from source at first use"
    )


class CudaKernel:
    """One `csrc/` source: its library, its C entry points, the number of
    times the main path launched it, and the device buffers the kernel
    keeps from call to call."""

    def __init__(self, name: str, source: str, functions: dict[str, list]):
        self.name = name
        self.source = CSRC_DIR / source
        self.functions = functions  # C entry point -> ctypes argtypes
        self.launches = 0  # launches made outside a graph capture
        # (device index, stream) -> what the wrapper keeps there: a kernel
        # that resets its own scratch (ticket, epoch, partial sums) gets one
        # zeroed buffer per stream and reuses it, because calls on one
        # stream are ordered
        self.scratch: dict[tuple[int, int], object] = {}
        # device index -> (scratch for captured launches, int64 counter of
        # their executions); reserved before a capture, never inside one.
        # Captured launches share one buffer: a graph runs its launches in
        # order and graphs are replayed one at a time.
        self.capture_state: dict[int, tuple[object, object]] = {}
        self._retired: list = []
        self.build_seconds: float | None = None
        self.build_log = ""
        self._lib: ctypes.CDLL | None = None
        self._constants: dict[str, int] = {}

    def library_path(self) -> Path:
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            build([self])
            lib = ctypes.CDLL(str(self.library_path()))
            for fn, argtypes in self.functions.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            error_string = getattr(lib, f"{self.name}_error_string")
            error_string.argtypes = [ctypes.c_int]
            error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def query(self, fn: str) -> int:
        """The value of a C entry point that launches nothing and returns a
        constant of the source (a block size, a limit), read once."""
        if fn not in self._constants:
            self._constants[fn] = getattr(self.lib(), fn)()
        return self._constants[fn]

    def call(self, fn: str, *args) -> None:
        """Call a C entry point that returns a CUDA error code; raise on an
        error."""
        lib = self.lib()
        err = getattr(lib, fn)(*args)
        if err != 0:
            msg = getattr(lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{self.name}.{fn} failed: CUDA error {err}: {msg}")

    def launch(self, fn: str, *args, device=None, capturing: bool = False) -> None:
        """Call a C entry point that launches the kernel on the given
        stream, raise on a launch error, and count the launch: on the host,
        or, for a launch captured into a graph on `device`, on the device."""
        self.call(fn, *args)
        if capturing:
            self.capture_state[device.index][1].add_(1)
        else:
            self.launches += 1

    def reserve_capture(self, device, n_bytes: int) -> None:
        """Allocate and zero, outside any capture, the scratch that launches
        captured on `device` use (at least `n_bytes`) and their counter."""
        import torch

        held = self.capture_state.get(device.index)
        if held is None or held[0].numel() * 8 < n_bytes:
            if held is not None:
                # graphs captured before may still launch on the old buffer
                self._retired.append(held[0])
            count = held[1] if held else torch.zeros((), dtype=torch.int64, device=device)
            scratch = torch.zeros((n_bytes + 7) // 8, dtype=torch.int64, device=device)
            self.capture_state[device.index] = (scratch, count)

    def capture_scratch(self, device, n_bytes: int):
        """The reserved scratch for a launch being captured on `device`."""
        held = self.capture_state.get(device.index)
        if held is None or held[0].numel() * 8 < n_bytes:
            raise RuntimeError(
                f"{self.name}: no scratch of {n_bytes} bytes was reserved on {device} "
                "before the graph capture (reserve_capture); a capture may not allocate it"
            )
        return held[0]

    def launch_count(self) -> int:
        """Launches so far: those made eagerly and the executions of
        captured ones (one read of each device counter)."""
        return self.launches + sum(int(count) for _, count in self.capture_state.values())

    def reset_launches(self) -> None:
        self.launches = 0
        for _, count in self.capture_state.values():
            count.zero_()


def build(kernels: list[CudaKernel]) -> dict[str, float]:
    """Build every kernel whose library is missing: one `nvcc` per source,
    all started together.  Returns the build seconds by kernel name (0 for
    a library that was already built)."""
    nvcc = None
    jobs = []
    for k in kernels:
        out = k.library_path()
        if out.exists():
            if k.build_seconds is None:
                k.build_seconds = 0.0
            continue
        nvcc = nvcc or nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(k.source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((k, proc, tmp, out, time.perf_counter()))
    for k, proc, tmp, out, t0 in jobs:
        log, _ = proc.communicate()
        k.build_seconds = time.perf_counter() - t0
        k.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {k.source.name}:\n{log}")
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return {k.name: k.build_seconds for k in kernels}


def stream_handle(device) -> int:
    """The current PyTorch CUDA stream of `device`, as a C pointer value."""
    import torch

    # the raw handle without building a `torch.cuda.Stream` object: this is
    # on the hot path of every kernel wrapper
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None and device.index is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream
