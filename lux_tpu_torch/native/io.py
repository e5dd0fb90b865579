"""ctypes bindings of the native host I/O library (``lux_io.cc``) and the
``lux-convert`` executable (``converter_main.cc`` + ``lux_io.cc``).

Counterpart of the I/O part of ``lux_tpu.native``: partial ``.lux``
reads by pread, the counting-sort ``.lux`` writer, the text edge-list
parser, the per-part push-CSR build, the pull layout's source-position
fill, the block-CSR chunk fill, the out-degree histogram, and the ring
and reduce-scatter layouts' owner split and bucket fill.  The
sources are this package's own copies, built like the route colorer
(:func:`lux_tpu_torch.native.build_artifact`) at first use; nothing is
built at import.

This is host code, not a device kernel: each caller keeps its NumPy path
as the fallback when no compiler exists, and as the oracle the tests hold
the native path to (bitwise).  Every binding returns None when the
library is unavailable; :func:`host_path` says which path the callers
take ("native" or "numpy"), and :func:`numpy_path` forces the NumPy one
for a block (timing the two paths side by side, tests).
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from lux_tpu_torch.native import _DIR, artifact_path, build_artifact

SOURCE = _DIR / "lux_io.cc"
CONVERTER_SOURCES = (_DIR / "converter_main.cc", SOURCE)
LIB_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
EXE_FLAGS = ("-O3", "-std=c++17", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_tried = False
#: blocks inside numpy_path(); the library stays loaded
_forced_numpy = 0
#: guards the one-shot build/bind and the numpy_path count
_LOCK = threading.Lock()


def library_path() -> Path:
    return artifact_path("liblux_io", (SOURCE,), LIB_FLAGS, ".so")


def converter_path() -> Path:
    return artifact_path("lux-convert", CONVERTER_SOURCES, EXE_FLAGS)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    c_u32, c_u64 = ctypes.c_uint32, ctypes.c_uint64
    sigs = {
        "lux_read_header": ([ctypes.c_char_p, u32p, u64p], ctypes.c_int),
        "lux_read_rows": ([ctypes.c_char_p, c_u64, c_u64, u64p], ctypes.c_int),
        "lux_read_cols": ([ctypes.c_char_p, c_u32, c_u64, c_u64, u32p], ctypes.c_int),
        "lux_read_weights": ([ctypes.c_char_p, c_u32, c_u64, c_u64, c_u64, i32p],
                             ctypes.c_int),
        "lux_write_from_edges": ([ctypes.c_char_p, c_u32, c_u64, u32p, u32p, i32p],
                                 ctypes.c_int),
        "lux_parse_edge_text": ([ctypes.c_char_p, c_u64, u32p, u32p, i32p],
                                ctypes.c_int64),
        "lux_count_degrees": ([u32p, c_u64, c_u32, u32p], ctypes.c_int),
        "lux_push_part_build": ([i32p, i64p, i32p, c_u64, c_u32, c_u32, u32p, u32p,
                                 i32p, i32p, i32p, f32p, u64p], ctypes.c_int),
        "lux_fill_src_pos": ([i32p, c_u64, u32p, c_u32, c_u32, i32p], ctypes.c_int),
        "lux_blockcsr_fill": ([i64p, c_u32, i32p, f32p, c_u64, c_u32, c_u32, i64p,
                               i32p, i32p, f32p], ctypes.c_int),
        "lux_bucket_split": ([u32p, c_u64, u32p, c_u32, u64p, u64p], ctypes.c_int),
        "lux_bucket_fill": ([u32p, i64p, i32p, c_u64, c_u32, u32p, c_u32, c_u64, i64p,
                             c_u64, i32p, i32p, ctypes.POINTER(ctypes.c_uint8), f32p],
                            ctypes.c_int),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built on first use; None when it cannot be
    built or loaded (one failed attempt is final for the process)."""
    global _lib, _tried
    if _lib is not None:  # a bound lib never changes
        return _lib
    with _LOCK:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        if not out.exists() and not build_artifact((SOURCE,), LIB_FLAGS, out):
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(out)))
        except (OSError, AttributeError):
            return None
        return _lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The library the callers use now: None when it is unavailable or
    inside :func:`numpy_path`."""
    lib = _load()
    return None if _forced_numpy else lib


def available() -> bool:
    """Whether the native library is (or can be) loaded; builds it."""
    return _load() is not None


def host_path() -> str:
    """The path the host builders and readers take now: "native" or
    "numpy"."""
    return "native" if get_lib() is not None else "numpy"


@contextlib.contextmanager
def numpy_path():
    """Run the block on the NumPy paths (the library stays loaded)."""
    global _forced_numpy
    with _LOCK:
        _forced_numpy += 1
    try:
        yield
    finally:
        with _LOCK:
            _forced_numpy -= 1


def converter() -> Optional[Path]:
    """The ``lux-convert`` executable, built on first use; None when it
    cannot be built."""
    out = converter_path()
    with _LOCK:
        if out.exists() or build_artifact(CONVERTER_SOURCES, EXE_FLAGS, out):
            return out
    return None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _check(rc: int, path: str) -> None:
    if rc != 0:
        raise OSError(-rc, os.strerror(-rc), path)


def read_header(path: str):
    """(nv, ne) of a ``.lux`` file, or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    nv, ne = ctypes.c_uint32(), ctypes.c_uint64()
    _check(lib.lux_read_header(os.fsencode(path), ctypes.byref(nv), ctypes.byref(ne)),
           path)
    return int(nv.value), int(ne.value)


def read_range(path: str, nv: int, ne: int, row_lo: int, row_hi: int,
               col_lo: int, col_hi: int, weighted: bool):
    """Partial pread of a ``.lux`` file: the row ends of vertices
    [row_lo, row_hi) and the sources (and weights) of edges [col_lo,
    col_hi).  Returns (row_end u64, cols u32, weights i32 | None), or
    None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    if not (0 <= row_lo <= row_hi <= nv and 0 <= col_lo <= col_hi <= ne):
        raise ValueError(f"range rows [{row_lo}, {row_hi}) cols [{col_lo}, {col_hi}) "
                         f"outside nv={nv} ne={ne}")
    bpath = os.fsencode(path)
    rows = np.empty(row_hi - row_lo, np.uint64)
    cols = np.empty(col_hi - col_lo, np.uint32)
    _check(lib.lux_read_rows(bpath, row_lo, row_hi, _ptr(rows, ctypes.c_uint64)), path)
    _check(lib.lux_read_cols(bpath, nv, col_lo, col_hi, _ptr(cols, ctypes.c_uint32)), path)
    w = None
    if weighted:
        w = np.empty(col_hi - col_lo, np.int32)
        _check(lib.lux_read_weights(bpath, nv, ne, col_lo, col_hi,
                                    _ptr(w, ctypes.c_int32)), path)
    return rows, cols, w


def _as_u32_ids(a: np.ndarray, what: str) -> np.ndarray:
    """``a`` as contiguous uint32, refusing ids a cast would wrap."""
    a = np.asarray(a)
    if a.size and a.dtype.kind in "iu" and (int(a.min()) < 0 or int(a.max()) >= 2**32):
        raise ValueError(f"{what} id out of uint32 range")
    if a.dtype == np.int32 and a.flags.c_contiguous:
        return a.view(np.uint32)  # non-negative: the same bits, no copy
    return np.ascontiguousarray(a, np.uint32)


def write_from_edges(path: str, nv: int, src: np.ndarray, dst: np.ndarray,
                     weights: Optional[np.ndarray] = None) -> bool:
    """Write an edge list as a ``.lux`` file through the native
    counting sort by destination (stable: input order within a
    destination).  False without the library."""
    lib = get_lib()
    if lib is None:
        return False
    src = _as_u32_ids(src, "source")
    dst = _as_u32_ids(dst, "destination")
    if src.shape != dst.shape:
        raise ValueError(f"src {src.shape} and dst {dst.shape} differ")
    wp = None
    if weights is not None:
        weights = np.ascontiguousarray(weights, np.int32)
        if weights.shape != src.shape:
            raise ValueError(f"weights {weights.shape} and src {src.shape} differ")
        wp = _ptr(weights, ctypes.c_int32)
    _check(lib.lux_write_from_edges(os.fsencode(path), nv, len(src),
                                    _ptr(src, ctypes.c_uint32),
                                    _ptr(dst, ctypes.c_uint32), wp), path)
    return True


def parse_edge_text(path: str, weighted: bool = False, cap: Optional[int] = None):
    """Parse a whitespace text edge list ("src dst [weight]" a line;
    blank lines and '#' comments skipped) into (src u32, dst u32,
    weights i32 | None), or None without the library.  ``cap`` bounds the
    edges read (default: the file's line count)."""
    lib = get_lib()
    if lib is None:
        return None
    if cap is None:  # at most one edge a line
        with open(path, "rb") as f:
            cap = sum(chunk.count(b"\n") for chunk in iter(lambda: f.read(1 << 24), b"")) + 1
    src = np.empty(cap, np.uint32)
    dst = np.empty(cap, np.uint32)
    w = np.empty(cap, np.int32) if weighted else None
    n = lib.lux_parse_edge_text(os.fsencode(path), cap, _ptr(src, ctypes.c_uint32),
                                _ptr(dst, ctypes.c_uint32),
                                _ptr(w, ctypes.c_int32) if weighted else None)
    if n < 0:
        raise OSError(-n, os.strerror(-n), path)
    return src[:n], dst[:n], (w[:n] if weighted else None)


def count_degrees(col_idx: np.ndarray, nv: int):
    """Out-degree histogram (int32) of an edge-source array, or None
    without the library."""
    lib = get_lib()
    if lib is None:
        return None
    col = _as_u32_ids(col_idx, "source")
    deg = np.zeros(nv, np.uint32)
    if lib.lux_count_degrees(_ptr(col, ctypes.c_uint32), len(col), nv,
                             _ptr(deg, ctypes.c_uint32)) != 0:
        raise ValueError("source id out of range")
    return deg.astype(np.int32)


def push_part_build(srcs: np.ndarray, row_ptr_slice: np.ndarray,
                    weights: Optional[np.ndarray], nv: int, counts: np.ndarray,
                    dst_row: np.ndarray, w_row: Optional[np.ndarray]):
    """One part's push CSR by a counting sort on the source: writes the
    CSR-ordered local destinations (and weights, int32 in, float32 out)
    into ``dst_row`` (``w_row``) in place and returns (uniq int32,
    rp int32), or None without the library.  ``counts`` is an nv-sized
    uint32 scratch that arrives zeroed and leaves zeroed."""
    lib = get_lib()
    if lib is None:
        return None
    srcs = np.ascontiguousarray(srcs, np.int32)
    row_ptr_slice = np.ascontiguousarray(row_ptr_slice, np.int64)
    n_e = len(srcs)
    if not (dst_row.flags.c_contiguous and dst_row.dtype == np.int32
            and dst_row.shape == (n_e,)):
        raise ValueError("dst_row must be a contiguous int32 row of the slice's length")
    if not (counts.dtype == np.uint32 and counts.flags.c_contiguous
            and counts.shape == (nv,)):
        raise ValueError("counts must be a contiguous (nv,) uint32 scratch")
    wp = None
    if weights is not None:
        if w_row is None or not (w_row.flags.c_contiguous and w_row.dtype == np.float32
                                 and w_row.shape == (n_e,)):
            raise ValueError("w_row must be a contiguous float32 row of the slice's length")
        weights = np.ascontiguousarray(weights, np.int32)
        wp = _ptr(weights, ctypes.c_int32)
    cap_u = max(1, min(n_e, nv))
    touched = np.empty(cap_u, np.uint32)
    uniq = np.empty(cap_u, np.int32)
    rp = np.empty(cap_u + 1, np.int32)
    n_uniq = ctypes.c_uint64()
    rc = lib.lux_push_part_build(
        _ptr(srcs, ctypes.c_int32), _ptr(row_ptr_slice, ctypes.c_int64), wp,
        n_e, len(row_ptr_slice) - 1, nv,
        _ptr(counts, ctypes.c_uint32), _ptr(touched, ctypes.c_uint32),
        _ptr(uniq, ctypes.c_int32), _ptr(rp, ctypes.c_int32),
        _ptr(dst_row, ctypes.c_int32),
        _ptr(w_row, ctypes.c_float) if weights is not None else None,
        ctypes.byref(n_uniq))
    if rc != 0:
        raise ValueError("inconsistent part slice (src out of range or "
                         "row_ptr/n_e mismatch)")
    nt = int(n_uniq.value)
    return uniq[:nt], rp[: nt + 1]


def fill_src_pos(srcs: np.ndarray, cuts: np.ndarray, nv_pad: int, out_row: np.ndarray):
    """The pull layout's source positions of one part's edge slice,
    ``q * nv_pad + (s - cuts[q])`` for the owner q of source s, written
    into ``out_row`` in place.  True, or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    srcs = np.ascontiguousarray(srcs, np.int32)
    cuts = np.ascontiguousarray(cuts, np.uint32)
    if not (out_row.flags.c_contiguous and out_row.dtype == np.int32
            and out_row.shape == srcs.shape):
        raise ValueError("out_row must be a contiguous int32 row of the slice's length")
    if lib.lux_fill_src_pos(_ptr(srcs, ctypes.c_int32), len(srcs),
                            _ptr(cuts, ctypes.c_uint32), len(cuts) - 1, nv_pad,
                            _ptr(out_row, ctypes.c_int32)) != 0:
        raise ValueError("source id beyond the last cut")
    return True


def blockcsr_fill(row_ptr: np.ndarray, src_pos: np.ndarray,
                  weights: Optional[np.ndarray], v_blk: int, t_chunk: int,
                  chunk_start: np.ndarray, e_src: np.ndarray, e_dst: np.ndarray,
                  e_w: Optional[np.ndarray]):
    """The block-CSR chunk fill: every edge to its (chunk, slot) of the
    flat (C*T,) arrays ``e_src``/``e_dst``/``e_w`` (pre-filled with the
    padding values), in place.  True, or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    src_pos = np.ascontiguousarray(src_pos, np.int32)
    chunk_start = np.ascontiguousarray(chunk_start, np.int64)
    for a, dt in ((e_src, np.int32), (e_dst, np.int32)):
        if not (a.flags.c_contiguous and a.dtype == dt and a.ndim == 1):
            raise ValueError("e_src/e_dst must be flat contiguous int32 arrays")
    wp = None
    if weights is not None:
        if e_w is None or not (e_w.flags.c_contiguous and e_w.dtype == np.float32):
            raise ValueError("e_w must be a flat contiguous float32 array")
        weights = np.ascontiguousarray(weights, np.float32)
        wp = _ptr(weights, ctypes.c_float)
    ne, nv = len(src_pos), len(row_ptr) - 1
    blocks = np.arange(len(chunk_start), dtype=np.int64) * v_blk
    span = (row_ptr[np.minimum(blocks + v_blk, nv)] - row_ptr[np.minimum(blocks, nv)])
    if (int(row_ptr[-1]) > ne or len(chunk_start) * v_blk < nv or e_dst.size != e_src.size
            or np.any(chunk_start + -(-span // t_chunk) > e_src.size // t_chunk)):
        raise ValueError("block-CSR arrays do not fit the layout")
    rc = lib.lux_blockcsr_fill(
        _ptr(row_ptr, ctypes.c_int64), len(row_ptr) - 1,
        _ptr(src_pos, ctypes.c_int32), wp, ne, v_blk, t_chunk,
        _ptr(chunk_start, ctypes.c_int64), _ptr(e_src, ctypes.c_int32),
        _ptr(e_dst, ctypes.c_int32),
        _ptr(e_w, ctypes.c_float) if weights is not None else None)
    if rc != 0:
        raise ValueError("inconsistent row_ptr for block-CSR fill")
    return True


def bucket_split(srcs: np.ndarray, cuts: np.ndarray):
    """Stable owner-bucketing of an edge slice by a counting sort: the
    permutation grouping the edges by the part that owns their source
    (original order within a part) and the edges a part.  Returns (order
    int64, counts int64), the same as ``np.argsort(searchsorted(cuts,
    srcs, "right") - 1, kind="stable")`` and its bincount, or None without
    the library."""
    lib = get_lib()
    if lib is None:
        return None
    srcs = _as_u32_ids(srcs, "source")
    cuts = np.ascontiguousarray(cuts, np.uint32)
    num_parts = len(cuts) - 1
    order = np.empty(len(srcs), np.uint64)
    counts = np.zeros(num_parts, np.uint64)
    if lib.lux_bucket_split(_ptr(srcs, ctypes.c_uint32), len(srcs),
                            _ptr(cuts, ctypes.c_uint32), num_parts,
                            _ptr(order, ctypes.c_uint64),
                            _ptr(counts, ctypes.c_uint64)) != 0:
        raise ValueError("source id beyond the last cut")
    return order.astype(np.int64), counts.astype(np.int64)


def bucket_fill(srcs, row_ptr_slice, weights, cuts, B: int, row_map, row_stride: int,
                src_flat, dst_flat, hf_flat, w_flat):
    """One pass over a part's edge slice that writes every materialized
    owner bucket of the ring and reduce-scatter layouts (src_local,
    dst_local, head_flag, weights) in place.  ``*_flat`` are flat
    contiguous int32 / int32 / uint8 / float32 views whose origin is the
    part's (or column's) first slot, pre-filled with the padding values;
    ``row_map[q]`` is owner q's target row (-1: not built here) and
    ``row_stride`` the slots between rows.  True, or None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    srcs = _as_u32_ids(srcs, "source")
    rp = np.ascontiguousarray(row_ptr_slice, np.int64)
    cuts = np.ascontiguousarray(cuts, np.uint32)
    row_map = np.ascontiguousarray(row_map, np.int64)
    wp = None
    if weights is not None:
        if w_flat is None or w_flat.dtype != np.float32 or not w_flat.flags.c_contiguous:
            raise ValueError("w_flat must be a flat contiguous float32 view")
        weights = np.ascontiguousarray(weights, np.int32)
        wp = _ptr(weights, ctypes.c_int32)
    for a, dt in ((src_flat, np.int32), (dst_flat, np.int32), (hf_flat, np.uint8)):
        if a.dtype != dt or not a.flags.c_contiguous:
            raise ValueError(f"bucket target views must be contiguous {np.dtype(dt)}")
    rc = lib.lux_bucket_fill(
        _ptr(srcs, ctypes.c_uint32), _ptr(rp, ctypes.c_int64), wp, len(srcs), len(rp) - 1,
        _ptr(cuts, ctypes.c_uint32), len(cuts) - 1, B, _ptr(row_map, ctypes.c_int64),
        row_stride, _ptr(src_flat, ctypes.c_int32), _ptr(dst_flat, ctypes.c_int32),
        _ptr(hf_flat, ctypes.c_uint8),
        _ptr(w_flat, ctypes.c_float) if w_flat is not None else None)
    if rc != 0:
        raise ValueError(f"bucket fill failed (rc={rc}): bad cuts/row_ptr or bucket overflow")
    return True
