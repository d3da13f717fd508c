"""ctypes bindings for the native runtime library (`native/eskf_runtime.cpp`).

The port's copy of `eskf_lio_tpu/io/native_runtime.py`, binding the same
source (`native/` lies outside both packages).  Provides the C++ SPSC
queue and scan packing to Python.  Builds on demand with the repo Makefile;
`pack_scan` has a numpy path for hosts without a compiler, and
`native_available()` says which one runs.  This is host code: nothing here
touches the device.

The port loads a library that only it writes: `build/native/
libeskf_runtime-<hash>.so`, keyed by the sources, the compiler's version
and the host's CPU, made by `make` in a scratch copy
of `native/`'s Makefile and source and moved into place with one atomic
rename.  The JAX package builds `native/libeskf_runtime.so` in place and
without a lock, so a process that loads that file while a JAX process's
`make` is still linking it gets a half-written library: `ctypes.CDLL`
raises "file too short" (1 of 30 starts of both packages' `load()` together
on a fresh checkout).  Processes of the port that start together (a multi-process run) build under
an exclusive file lock (`build/native/.build.lock`), so one process builds
and the others wait for it.  The bench's reference filter
(`native/ref_filter.cpp`) is built the same way (`ref_filter_path`), at
`build/native/ref_filter-<hash>`: the port never writes into `native/`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shlex
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_SOURCES = ("Makefile", "eskf_runtime.cpp")
_TARGET = "libeskf_runtime.so"
_REF_FILTER_SOURCES = ("Makefile", "ref_filter.cpp")
_BUILD_DIR = os.path.abspath(os.path.join(_NATIVE_DIR, "..", "build", "native"))

_lib: Optional[ctypes.CDLL] = None


class NativeRuntimeUnavailable(RuntimeError):
    """The native library is not built and cannot be built on this host."""


def _compiler(cxx: Optional[str]) -> str:
    """The compiler `make` runs: `cxx` when given, else the environment's
    `CXX`, else make's own `g++`."""
    return cxx or os.environ.get("CXX") or "g++"


def _host_key(cxx: str) -> bytes:
    """What a build depends on beside its sources: the compiler's version
    and this host's CPU (the Makefile builds with `-march=native`).  A copy
    of the tree may carry `build/` to another host, whose CPU may lack
    what the binary uses (SIGILL) and whose compiler differs: such a
    binary lies under another name there and is never taken."""
    try:
        version = subprocess.run([*shlex.split(cxx), "--version"], capture_output=True,
                                 timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        version = b"no compiler"
    cpu = [platform.machine().encode()]
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
        for field in (b"model name", b"flags"):
            cpu += [l for l in lines if l.startswith(field)][:1]
    return b"\n".join([version, *cpu])


def _built_path(target: str, sources: tuple[str, ...], cxx: Optional[str] = None) -> str:
    """Where the port's build of a `native/` make target lies, keyed by its
    sources, the compiler and the host's CPU:
    `build/native/<stem>-<hash><suffix>`."""
    digest = hashlib.sha256(_host_key(_compiler(cxx)))
    for name in sources:
        with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
            digest.update(f.read())
    stem, dot, suffix = target.partition(".")
    return os.path.join(_BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}{dot}{suffix}")


def library_path() -> str:
    """Where the port's build of the library lies (see `_built_path`)."""
    return _built_path(_TARGET, _SOURCES)


def _try_build(target: str, sources: tuple[str, ...], out: str, cxx: Optional[str]) -> bool:
    """`make` the target in a scratch copy of the sources and rename it to
    `out`: no reader ever sees a half-written file there.  `cxx`, when
    given, replaces the environment's `CXX`."""
    try:
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
            for name in sources:
                shutil.copy(os.path.join(_NATIVE_DIR, name), tmp)
            subprocess.run(
                ["make", "-C", tmp, target, *([f"CXX={cxx}"] if cxx else [])],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(os.path.join(tmp, target), out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _build(target: str, sources: tuple[str, ...], build_if_missing: bool = True,
           cxx: Optional[str] = None) -> Optional[str]:
    """The path of the port's build of `target`, building it under the
    lock if it is missing; None if it is missing and cannot be built."""
    path = _built_path(target, sources, cxx)
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not os.path.exists(path) and build_if_missing:
            if not _try_build(target, sources, path, cxx):
                return None
    return path if os.path.exists(path) else None


def ref_filter_path() -> Optional[str]:
    """The reference-algorithm filter (`native/ref_filter.cpp`, run by the
    bench), built if missing; None without a toolchain.  Its compiler is
    `g++` on the PATH whatever `CXX` the environment sets: a `CXX` set for
    another toolchain may lack OpenMP (no `libgomp.spec`), which
    `ref_filter` needs.  The library keeps the environment's compiler."""
    return _build("ref_filter", _REF_FILTER_SOURCES, cxx="g++")


def load(build_if_missing: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    path = _build(_TARGET, _SOURCES, build_if_missing)
    if path is None:
        return None
    lib = ctypes.CDLL(path)

    lib.spsc_create.restype = ctypes.c_void_p
    lib.spsc_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.spsc_destroy.argtypes = [ctypes.c_void_p]
    lib.spsc_push.restype = ctypes.c_int
    lib.spsc_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.spsc_pop.restype = ctypes.c_int
    lib.spsc_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.spsc_pop_all.restype = ctypes.c_int64
    lib.spsc_pop_all.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.spsc_size.restype = ctypes.c_int64
    lib.spsc_size.argtypes = [ctypes.c_void_p]

    lib.pack_scan.restype = ctypes.c_int64
    lib.pack_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    _lib = lib
    return lib


def native_available() -> bool:
    """True when `pack_scan` and the SPSC queue run in the C++ library,
    False when `pack_scan` takes its numpy path."""
    return load() is not None


# IMU record layout matching the C side usage: t f64 + gyro f32[3] + a f32[3]
IMU_DTYPE = np.dtype(
    [("t", "<f8"), ("gyro", "<f4", 3), ("accel", "<f4", 3)], align=False
)


class NativeSpscQueue:
    """SPSC queue of fixed-dtype records backed by the C++ ring buffer
    (role of ref `SynchronizedQueue`, `SynchronizedQueue.hpp:9-57`)."""

    def __init__(self, dtype: np.dtype, capacity_pow2: int = 4096):
        lib = load()
        if lib is None:
            raise NativeRuntimeUnavailable("native runtime unavailable")
        self._lib = lib
        self.dtype = np.dtype(dtype)
        self._q = lib.spsc_create(self.dtype.itemsize, capacity_pow2)
        if not self._q:
            raise MemoryError("spsc_create failed")

    def push(self, record: np.ndarray) -> bool:
        rec = np.ascontiguousarray(record.view(self.dtype).reshape(()))
        return bool(
            self._lib.spsc_push(self._q, rec.ctypes.data_as(ctypes.c_void_p))
        )

    def pop(self) -> np.ndarray | None:
        out = np.empty((), dtype=self.dtype)
        ok = self._lib.spsc_pop(self._q, out.ctypes.data_as(ctypes.c_void_p))
        return out if ok else None

    def pop_all(self, max_items: int = 4096) -> np.ndarray:
        out = np.empty(max_items, dtype=self.dtype)
        n = self._lib.spsc_pop_all(
            self._q, out.ctypes.data_as(ctypes.c_void_p), max_items
        )
        return out[:n]

    def __len__(self) -> int:
        return int(self._lib.spsc_size(self._q))

    def __del__(self):
        if getattr(self, "_q", None):
            self._lib.spsc_destroy(self._q)
            self._q = None


def pack_scan(
    xyz: np.ndarray,
    t_abs: np.ndarray,
    t_end: float,
    n_cap: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Pad/truncate a raw scan into the fixed device layout, dropping
    non-finite points.  Uses the native path when available (see
    `native_available`)."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    t_abs = np.ascontiguousarray(t_abs, np.float64)
    lib = load()
    out_xyz = np.empty((n_cap, 3), np.float32)
    out_t = np.empty(n_cap, np.float32)
    out_valid = np.empty(n_cap, np.uint8)
    if lib is not None:
        n = lib.pack_scan(
            xyz.ctypes.data_as(ctypes.c_void_p),
            t_abs.ctypes.data_as(ctypes.c_void_p),
            len(xyz),
            float(t_end),
            n_cap,
            out_xyz.ctypes.data_as(ctypes.c_void_p),
            out_t.ctypes.data_as(ctypes.c_void_p),
            out_valid.ctypes.data_as(ctypes.c_void_p),
        )
        return out_xyz, out_t, out_valid.astype(bool), int(n)
    # numpy path
    finite = np.isfinite(xyz).all(axis=1)
    xyz_f = xyz[finite][:n_cap]
    t_f = t_abs[finite][:n_cap]
    n = len(xyz_f)
    out_xyz[:n] = xyz_f
    out_xyz[n:] = 0
    out_t[:n] = (t_f - t_end).astype(np.float32)
    out_t[n:] = 0
    out_valid[:n] = 1
    out_valid[n:] = 0
    return out_xyz, out_t, out_valid.astype(bool), n
