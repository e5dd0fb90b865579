"""Build and load the hand-written CUDA kernels under ``lux_tpu_torch/csrc``.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with :mod:`ctypes`.
Nothing is compiled or loaded at import: the first CUDA launch of a
kernel builds its library, and :func:`build_all` / :func:`load_all`
build every missing one, one ``nvcc`` process per source, all started
together.  :func:`launch` calls a bound entry point on the current
stream of a tensor's device, the one host path of every wrapper.

Libraries land in ``lux_tpu_torch/csrc/build/`` (git-ignored), named by a
hash of the sources and flags, so an edit rebuilds and a rerun reuses.
``nvcc`` is taken from ``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``,
else ``PATH``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"

#: kernel name -> its source under csrc/
SOURCES = {
    "spmv_blockcsr": "spmv_blockcsr.cu",
    "spmv_blockcsr_2d": "spmv_blockcsr_2d.cu",
    "mxscan_segmented": "mxscan_segmented.cu",
    "lane_gather": "lane_gather.cu",
    "sublane_gather": "sublane_gather.cu",
    "fused_pass_gather": "fused_pass_gather.cu",
    "mxreduce_pass_gather": "mxreduce_pass_gather.cu",
    "segment_sum_sorted": "segment_sum_sorted.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: C entry point name -> its typed function; written once under _bind_lock,
#: read without it on the hot path
_bound: dict[str, object] = {}
_bind_lock = threading.Lock()


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels of lux_tpu_torch are built from source at first use")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile every kernel in ``names`` (default: all) whose library is
    missing, one ``nvcc`` per source, all in parallel.  Returns
    {name: seconds} for what was built; raises RuntimeError with the
    compiler's output if any build fails.  The ``-Xptxas -v`` report of
    each build is kept beside its library as ``.log``."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not _library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _library_path(n)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    seconds, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {SOURCES[n]} (rc {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's report (registers, shared memory, spills) of the
    built library of ``name``, or "" if it has not been built."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            _libs[name] = lib
        return lib


def bind(name: str, symbol: str, argtypes) -> object:
    """The C entry point ``symbol`` of kernel ``name``'s library, typed
    with ``argtypes`` and an int return, built and loaded on first use."""
    fn = _bound.get(symbol)
    if fn is None:
        with _bind_lock:
            fn = _bound.get(symbol)
            if fn is None:
                fn = getattr(load(name), symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _bound[symbol] = fn
    return fn


def launch(fn, device, *args) -> int:
    """``fn(*args, stream)``: the bound C entry point ``fn`` called with
    the current stream of CUDA ``device`` appended; returns its code.  The
    current device is switched only when ``device`` is not already
    current, and the stream handle is read once, raw where the build
    offers it."""
    import torch

    index = device.index
    current = torch.cuda.current_device()
    if index is not None and index != current:
        with torch.cuda.device(device):
            return fn(*args, torch.cuda.current_stream().cuda_stream)
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    stream = raw(current) if raw is not None else torch.cuda.current_stream().cuda_stream
    return fn(*args, stream)


def load_all() -> None:
    """Build every missing library in parallel, then load them all."""
    build_all()
    for name in SOURCES:
        load(name)
