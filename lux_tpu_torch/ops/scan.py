"""Segmented inclusive scan with restarts at head flags.

Counterpart of ``lux_tpu.ops.pallas_scan``.  :func:`segmented_scan` is
the plain PyTorch version (a log-depth Hillis-Steele ladder over
(value, head) pairs); it serves both the ``scan`` method of
:mod:`lux_tpu_torch.ops.segment` and, after neutralizing invalid slots,
as the plain twin of the kernel (:func:`mxscan_segmented_plain`).

:func:`mxscan_segmented` launches the hand-written CUDA kernel
(``csrc/mxscan_segmented.cu``) on a CUDA tensor and runs the plain
version on a CPU tensor.  The kernel is a blocked scan: each thread scans
16 consecutive elements in registers and a CTA a tile of 8,192; then one
CTA scans the tiles' carries and each tile folds its carry into the
elements before its first head (three deterministic passes, one on an
array of a single tile).  ``mxscan_segmented.launches`` counts kernel
launches (one per call).  bf16 values scan in f32 and round once on the
way out, in the kernel and in its plain twin alike.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Callable, Optional

import torch

from lux_tpu_torch.ops import cuda_build
from lux_tpu_torch.ops.spmv import reduce_neutral

_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_OPS = {"sum": 0, "min": 1, "max": 2}
COMBINERS: dict[str, Callable] = {
    "sum": torch.add, "min": torch.minimum, "max": torch.maximum,
}


def segmented_scan(vals: torch.Tensor, head_flag: torch.Tensor,
                   op: Callable) -> torch.Tensor:
    """Inclusive segmented scan along axis 0: accumulation restarts at
    every ``head_flag`` slot.  ``head_flag`` broadcasts against ``vals``
    ((E,) flags for (E, K) values).  The combine of an earlier a and a
    later b is ``b`` where b starts a segment, else ``op(a, b)``.  The
    ladder runs in place on one copy of ``vals``: a level holds that copy
    and one temporary of its combined tail, and the flags keep their (E,)
    shape, so a wide (E, K) scan never holds a fresh set of values and
    flags a level."""
    n = vals.shape[0]
    if n <= 1:
        return vals
    f = head_flag.reshape(head_flag.shape + (1,) * (vals.dim() - 1))
    v = vals.clone()
    d = 1
    while d < n:
        tail, f_tail = v[d:], f[d:]
        t = op(v[:-d], tail)
        torch.where(f_tail, tail, t, out=t)  # every read of the old tail is done
        tail.copy_(t)
        del t
        f = torch.cat([f[:d], f_tail | f[:-d]])
        d *= 2
    return v


def mxscan_segmented_plain(vals, head_flag, invalid=None, op: str = "sum",
                           valid_end=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`mxscan_segmented`.  bf16 values are
    widened to f32 (exactly), scanned there and rounded once, as the kernel
    does; the ladder in bf16 would round at every level."""
    out_dtype = vals.dtype
    if out_dtype == torch.bfloat16:
        vals = vals.float()
    neutral = reduce_neutral(op, vals.dtype)
    bad = _invalid_mask(vals, invalid, valid_end)
    if bad is not None:
        vals = torch.where(bad, torch.full_like(vals, neutral), vals)
    return segmented_scan(vals, head_flag, COMBINERS[op]).to(out_dtype)


def _invalid_mask(vals, invalid, valid_end) -> Optional[torch.Tensor]:
    if valid_end is None:
        return invalid
    past = torch.arange(vals.shape[0], dtype=torch.int32,
                        device=vals.device) >= valid_end
    return past if invalid is None else past | invalid


_lib_bound = None
_tile_elems = 0
_LIB_LOCK = threading.Lock()  # a planner thread and the caller may bind at once


def _lib():
    global _lib_bound, _tile_elems
    with _LIB_LOCK:
        if _lib_bound is None:
            lib = cuda_build.load("mxscan_segmented")
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.lux_mxscan_segmented.argtypes = [vp, ci, vp, vp, vp, ctypes.c_longlong,
                                                 ci, vp, vp, vp]
            lib.lux_mxscan_segmented.restype = ci
            lib.lux_mxscan_tile_elems.argtypes = []
            lib.lux_mxscan_tile_elems.restype = ci
            _tile_elems = lib.lux_mxscan_tile_elems()
            _lib_bound = lib
        return _lib_bound


def _check(vals, head_flag, invalid, op, valid_end):
    if op not in _OPS:
        raise ValueError(f"mxscan op must be sum|min|max, got {op!r}")
    if vals.dim() != 1:
        raise ValueError(
            "mxscan_segmented is a 1-D kernel; (E, K)-valued reductions "
            "keep the plain scan (ops/segment dispatches the fallback)")
    if vals.dtype not in _KIND:
        raise TypeError(f"mxscan_segmented takes float32, bfloat16 or int32, "
                        f"got {vals.dtype}")
    n = vals.shape[0]
    if head_flag.shape != (n,) or head_flag.dtype != torch.bool:
        raise ValueError(f"head_flag must be bool of shape ({n},)")
    if invalid is not None and (invalid.shape != (n,) or invalid.dtype != torch.bool):
        raise ValueError(f"invalid must be bool of shape ({n},)")
    if valid_end is not None and (valid_end.numel() != 1
                                  or valid_end.dtype != torch.int32):
        raise ValueError("valid_end must be a one-element int32 tensor")
    tensors = [t for t in (vals, head_flag, invalid, valid_end) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"mxscan_segmented inputs span devices {devices}")


def mxscan_segmented(vals: torch.Tensor, head_flag: torch.Tensor,
                     invalid: Optional[torch.Tensor] = None, op: str = "sum",
                     valid_end: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Segmented inclusive scan of ``vals`` (E,) with restarts at
    ``head_flag`` slots.  Invalid slots — ``invalid`` (E,) bool, and/or
    every slot at or past the device scalar ``valid_end`` (one int32) —
    are neutralized before any arithmetic; their outputs are unspecified.
    Returns (E,) in ``vals.dtype``.  f32, bf16 and int32 values: int32
    sums wrap; bf16 sums accumulate in f32 through every pass and round to
    bf16 once; bf16 min/max are exact.  CPU tensors run the plain version;
    CUDA tensors launch the kernel."""
    _check(vals, head_flag, invalid, op, valid_end)
    n = vals.shape[0]
    if n == 0:
        return vals.clone()
    if vals.device.type == "cpu":
        return mxscan_segmented_plain(vals, head_flag, invalid, op, valid_end)
    if vals.device.type != "cuda":
        raise ValueError(f"mxscan_segmented runs on cpu or cuda, not {vals.device}")
    tensors = [t for t in (vals, head_flag, invalid, valid_end) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mxscan_segmented needs contiguous inputs")
    lib = _lib()
    ntiles = -(-n // _tile_elems)
    out = torch.empty_like(vals)
    scratch = torch.empty(4 * ntiles, dtype=torch.int32, device=vals.device)
    with torch.cuda.device(vals.device):
        rc = lib.lux_mxscan_segmented(
            vals.data_ptr(), _KIND[vals.dtype], head_flag.data_ptr(),
            None if invalid is None else invalid.data_ptr(),
            None if valid_end is None else valid_end.data_ptr(),
            n, _OPS[op], out.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mxscan_segmented kernel launch failed: CUDA error {rc}")
    mxscan_segmented.launches += 1
    return out


mxscan_segmented.launches = 0
