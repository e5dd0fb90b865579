"""ctypes binding of the native route colorer (``lux_route.cc``).

Counterpart of the route part of ``lux_tpu.native``: the batched
Euler-split edge coloring under Benes route construction
(:mod:`lux_tpu_torch.ops.route`).  The source is this package's own copy;
it is compiled with ``g++ -O3 -std=c++17 -shared -fPIC -pthread`` at
first use into ``lux_tpu_torch/native/build/`` (git-ignored), named by a
hash of the source and flags, so an edit rebuilds and a rerun reuses.
Nothing is built at import.

When no compiler is present or the build fails, :func:`route_color`
returns None and the caller runs the numpy Euler walk instead
(colorings may differ; replays agree).  That is host planning, not a
device kernel; :func:`available` says which colorer will run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from lux_tpu_torch.utils.config import env_int

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "lux_route.cc"
BUILD_DIR = _DIR / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_tried = False
#: guards the one-shot build/bind: the planning pool (ops/expand) calls
#: route_color from several threads at once
_LIB_LOCK = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"liblux_route-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded colorer library (built on first use), or None when it
    cannot be built or loaded."""
    global _lib, _tried
    if _lib is not None:  # a bound lib never changes
        return _lib
    with _LIB_LOCK:
        if _lib is not None or _tried:
            return _lib
        _tried = True  # one failed attempt is final for the process
        out = library_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.lux_route_color_batched_mt.argtypes = [
            i64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, i32p, ctypes.c_int32]
        lib.lux_route_color_batched_mt.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native colorer is (or can be) loaded; builds it."""
    return get_lib() is not None


_TLS = threading.local()


def set_thread_share(divisor: int) -> None:
    """Declare that the CURRENT thread is one of ``divisor`` concurrent
    planning workers (thread-local; the planning pool in ops/expand sets
    it), so the colorer takes cores/divisor threads instead of all
    cores."""
    _TLS.divisor = max(1, int(divisor))


def get_thread_share() -> int:
    return getattr(_TLS, "divisor", 1)


def route_threads() -> int:
    """Host threads for the batched colorer: LUX_ROUTE_THREADS if set
    (>= 1; garbage raises), else every core, divided by the current
    thread's planning-worker share.  The thread count never changes the
    output bytes, only the wall clock."""
    base = env_int("LUX_ROUTE_THREADS", minimum=1)
    if base is None:
        base = os.cpu_count() or 1
    return max(1, base // get_thread_share())


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def route_color(u: np.ndarray, v: np.ndarray, deg: int, nside: int,
                n_threads: int | None = None):
    """Batched Euler-split edge coloring (Benes route construction).

    u, v: (B, n) int64 endpoints of B independent deg-regular bipartite
    multigraphs (ids in [0, nside)).  Returns (B, n) int32 colors, each
    color class a perfect matching, or None when the library is
    unavailable.  ``n_threads`` (default :func:`route_threads`) fans the
    recursion's frames over a native worker pool; the output is bitwise
    identical for every thread count.  The call releases the GIL."""
    lib = get_lib()
    if lib is None:
        return None
    u = np.ascontiguousarray(u, np.int64)
    v = np.ascontiguousarray(v, np.int64)
    assert u.shape == v.shape and u.ndim == 2, (u.shape, v.shape)
    b, n = u.shape
    colors = np.empty((b, n), np.int32)
    if n_threads is None:
        n_threads = route_threads()
    # one thread runs the serial walk inside the same entry
    rc = lib.lux_route_color_batched_mt(
        _ptr(u, ctypes.c_int64), _ptr(v, ctypes.c_int64), b, n, deg, nside,
        _ptr(colors, ctypes.c_int32), n_threads)
    if rc != 0:
        raise ValueError(f"route color failed (rc={rc}): ids out of range "
                         "or deg not a power of two")
    return colors
