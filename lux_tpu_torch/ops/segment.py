"""Per-destination segment reductions over CSC edge blocks.

Counterpart of ``lux_tpu.ops.segment``.  CSC edges are grouped by
destination, so each reduction is a *sorted* segmented reduction.
Interchangeable strategies, all deterministic on a given device:

  * ``scan``    — plain segmented inclusive scan (ops/scan.segmented_scan)
                  over (value, head_flag) pairs, then each segment's last
                  element.  Accumulation stays within a segment.
  * ``cumsum``  — plain cumsum + difference at row boundaries (sum only;
                  the global prefix magnitude costs float32 precision).
  * ``mxsum``   — the cumsum as blocked lower-triangular matmuls
                  (torch.matmul) + the same difference (sum only).
  * ``mxscan``  — the segmented scan as the hand-written CUDA kernel
                  (ops/scan.mxscan_segmented); 1-D values only, (E, K)
                  values fall back to ``scan``.
  * ``scatter`` — by the int32 ids: a float sum is
                  :func:`segment_sum_sorted`, the hand-written CUDA kernel
                  ``csrc/segment_sum_sorted.cu`` on the card (a fixed
                  order over the sorted ids, no atomics) and ``index_add_``
                  on the CPU (sequential); an integer sum ``index_add_``
                  (exact in any order); min/max ``scatter_reduce_``
                  (order-free).

All take the static-shape padded inputs of lux_tpu_torch.graph.shards
for one part: ``vals`` (E,) or (E, K), ``row_ptr`` (V+1,) int32,
``head_flag`` (E,) bool, ``dst_local`` (E,) int32 with padding == V.
"""
from __future__ import annotations

import ctypes
import math

import torch

from lux_tpu_torch.ops import cuda_build
from lux_tpu_torch.ops.scan import COMBINERS, mxscan_segmented, segmented_scan
from lux_tpu_torch.ops.spmv import reduce_neutral


def _ends_gather(scanned, row_ptr, neutral):
    """Each segment's final accumulated value; ``neutral`` for empty rows."""
    nonempty = row_ptr[1:] > row_ptr[:-1]
    safe = (row_ptr[1:] - 1).clamp(0, max(scanned.shape[0] - 1, 0))
    nonempty = nonempty.reshape(nonempty.shape + (1,) * (scanned.dim() - 1))
    picked = scanned.index_select(0, safe) if scanned.shape[0] else torch.zeros(
        safe.shape + scanned.shape[1:], dtype=scanned.dtype, device=scanned.device)
    return torch.where(nonempty, picked, torch.full_like(picked, neutral))


def _mxscan_csc(vals, row_ptr, head_flag, op):
    """The kernel's scanned array for a csc-encoded reduction: slots at or
    past row_ptr[-1] are padding and are neutralized in the kernel."""
    return mxscan_segmented(vals, head_flag, op=op, valid_end=row_ptr[-1:])


MX_BLOCK = 512  # triangular-matmul tile for the mxsum cumsum


def matmul_cumsum(x: torch.Tensor, block: int = MX_BLOCK) -> torch.Tensor:
    """Inclusive cumsum along axis 0 as blocked triangular matmuls: each
    block's prefix is x2 @ L^T with L lower-triangular ones, block offsets
    by recursing on the block sums.  f32 accumulation throughout."""
    n = x.shape[0]
    if n == 0:
        return x
    pad = (-n) % block
    x32 = x.to(torch.float32)
    xp = torch.cat([x32, x32.new_zeros((pad,) + x.shape[1:])])
    nb = xp.shape[0] // block
    tri = torch.tril(torch.ones((block, block), dtype=torch.float32, device=x.device))
    x2 = xp.reshape(nb, block, -1)  # (nb, block, K)
    intra = torch.matmul(tri, x2)  # intra[b, i, k] = sum_{j<=i} x2[b, j, k]
    tots = intra[:, -1, :]
    incl = matmul_cumsum(tots, block) if nb > block else torch.cumsum(tots, 0)
    out = intra + (incl - tots)[:, None, :]
    return out.reshape((-1,) + x.shape[1:])[:n].to(x.dtype)


def _scatter_dtype(vals: torch.Tensor) -> torch.Tensor:
    """Low-precision floats are widened to f32 for the scatter and rounded
    once on the way out (parity with the reference)."""
    if vals.dtype in (torch.bfloat16, torch.float16):
        return vals.to(torch.float32)
    return vals


def _scatter_into(vals, dst_local, num_segments, reduce):
    """``index_add_`` / ``scatter_reduce_`` into (num_segments, ...) with a
    dump row for the padding sentinel ``dst_local == num_segments``."""
    w = _scatter_dtype(vals)
    out = torch.full((num_segments + 1,) + vals.shape[1:],
                     reduce_neutral(reduce, w.dtype), dtype=w.dtype,
                     device=vals.device)
    idx = dst_local.long().clamp(0, num_segments)
    if reduce == "sum":
        out.index_add_(0, idx, w)
    else:
        idx = idx.reshape(idx.shape + (1,) * (w.dim() - 1)).expand_as(w)
        out.scatter_reduce_(0, idx, w, reduce="amin" if reduce == "min" else "amax")
    return out[:num_segments].to(vals.dtype)


def _scatter(vals, dst_local, num_segments, reduce):
    """The scatter method's reduction by ``dst_local`` into
    (num_segments, ...).  A float sum goes through
    :func:`segment_sum_sorted` (bf16/f16 widened to f32, rounded once on
    the way out), whose order is fixed on every device; an integer sum
    is exact in any order and min/max pick a value whatever the order, so
    those keep ``index_add_`` / ``scatter_reduce_``."""
    if reduce == "sum" and vals.is_floating_point():
        return segment_sum_sorted(_scatter_dtype(vals).contiguous(), dst_local.contiguous(),
                                  num_segments).to(vals.dtype)
    return _scatter_into(vals, dst_local, num_segments, reduce)


# ---------------------------------------------------------------------------
# the sorted-key segment sum (csrc/segment_sum_sorted.cu)
# ---------------------------------------------------------------------------

#: slots of one (E,) span (one CTA), and rows of one (E, K) span
SUM_SPAN_SLOTS = 8192
SUM_SPAN_ROWS = 128
#: bytes of an (E,) span's summary (lux_runs.cuh kPartBytes)
SUM_PART_BYTES = 20


def sum_scratch_bytes(rows: int, k: int) -> int:
    """Bytes of the kernel's span summaries for (rows, k) values: 20 a
    span of 8,192 slots for k = 1, else 12 + 8k a span of 128 rows."""
    if k == 1:
        return SUM_PART_BYTES * -(-rows // SUM_SPAN_SLOTS)
    return -(-rows // SUM_SPAN_ROWS) * (12 + 8 * k)


def keys_sorted(dst_local: torch.Tensor, num_segments: int) -> bool:
    """Whether the keys in [0, num_segments) never decrease along
    ``dst_local`` (the padding sentinel may sit anywhere): the kernel's
    precondition."""
    real = dst_local[(dst_local >= 0) & (dst_local < num_segments)]
    return bool((real[1:] >= real[:-1]).all())


def segment_sum_sorted_plain(vals, dst_local, num_segments: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_sum_sorted`: an
    ``index_add_`` into a dump row for the padding (sequential on the
    CPU, so deterministic there)."""
    return _scatter_into(vals, dst_local, num_segments, "sum")


_VP, _CI, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SUM_ARGTYPES = [_VP, _VP, _CLL, _CI, _CI, _VP, _VP, _CLL, _VP]


def segment_sum_sorted(vals: torch.Tensor, dst_local: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Sum f32 ``vals`` (E,) or (E, K...) by the int32 key ``dst_local``
    (E,) -> (num_segments, ...) f32; keys outside [0, num_segments) are
    padding and are dropped, keys no slot holds come out 0.  The keys in
    range must never decrease along the array (every layout of the port
    keeps them so): checked on the CPU, promised on the card.  CPU
    tensors run the plain version; CUDA tensors launch
    ``csrc/segment_sum_sorted.cu``, whose order of combination is fixed
    (two runs are bitwise equal), counted by
    ``segment_sum_sorted.launches``."""
    e = vals.shape[0] if vals.dim() else -1
    if dst_local.dim() != 1 or dst_local.shape[0] != e:
        raise ValueError(f"segment_sum_sorted: dst_local {tuple(dst_local.shape)} must be "
                         f"(E,) over vals {tuple(vals.shape)}")
    if dst_local.dtype != torch.int32:
        raise TypeError(f"segment_sum_sorted takes int32 keys, got {dst_local.dtype}")
    if vals.device != dst_local.device:
        raise ValueError(f"segment_sum_sorted inputs span devices "
                         f"{{{vals.device}, {dst_local.device}}}")
    if vals.device.type == "cpu":
        if not vals.is_floating_point():
            raise TypeError(f"segment_sum_sorted sums floats, got {vals.dtype}")
        if not keys_sorted(dst_local, num_segments):
            raise ValueError("segment_sum_sorted: the keys in range decrease somewhere; "
                             "the kernel needs them sorted")
        return segment_sum_sorted_plain(vals, dst_local, num_segments)
    if vals.device.type != "cuda":
        raise ValueError(f"segment_sum_sorted runs on cpu or cuda, not {vals.device}")
    if vals.dtype != torch.float32:
        raise TypeError(f"segment_sum_sorted on the card takes float32 values (widen "
                        f"bf16/f16 first), got {vals.dtype}")
    if not (vals.is_contiguous() and dst_local.is_contiguous()):
        raise ValueError("segment_sum_sorted needs contiguous inputs")
    k = math.prod(vals.shape[1:])
    out = torch.empty((num_segments,) + vals.shape[1:], dtype=torch.float32,
                      device=vals.device)
    if k == 0 or num_segments == 0:
        return out
    scratch = torch.empty(sum_scratch_bytes(e, k), dtype=torch.uint8, device=vals.device)
    fn = cuda_build.bind("segment_sum_sorted", "lux_segment_sum_sorted", _SUM_ARGTYPES)
    rc = cuda_build.launch(fn, vals.device, vals.data_ptr(),
                           dst_local.data_ptr(), e, k, num_segments, out.data_ptr(),
                           scratch.data_ptr(), scratch.numel())
    if rc != 0:
        raise RuntimeError(f"segment_sum_sorted kernel launch failed: CUDA error {rc}")
    segment_sum_sorted.launches += 1
    return out


segment_sum_sorted.launches = 0


def segment_sum_csc(vals, row_ptr, head_flag, dst_local=None,
                    method: str = "scan") -> torch.Tensor:
    """Sum ``vals`` (edge-aligned, (E,) or (E, K)) per destination -> (V, ...)."""
    if method == "mxsum" and not vals.dtype.is_floating_point:
        # matmul_cumsum accumulates in f32; integer sums must stay exact
        method = "scan"
    if method == "mxscan" and vals.dim() > 1:
        method = "scan"  # the kernel is 1-D
    if method == "mxscan":
        scanned = _mxscan_csc(vals, row_ptr, head_flag, "sum")
        return _ends_gather(scanned, row_ptr, 0)
    if method == "scan":
        scanned = segmented_scan(vals, head_flag, torch.add)
        return _ends_gather(scanned, row_ptr, 0)
    if method in ("cumsum", "mxsum"):
        c = matmul_cumsum(vals) if method == "mxsum" else torch.cumsum(vals, 0).to(vals.dtype)
        c = torch.cat([c.new_zeros((1,) + vals.shape[1:]), c])
        rp = row_ptr.long()
        return c[rp[1:]] - c[rp[:-1]]
    if method == "scatter":
        if dst_local is None:
            raise ValueError("method='scatter' needs dst_local")
        return _scatter(vals, dst_local, row_ptr.shape[0] - 1, "sum")
    raise ValueError(
        f"segment_sum_csc: unknown method {method!r}; accepted: 'scan', "
        "'mxscan', 'cumsum', 'mxsum', 'scatter'")


def _segment_minmax(vals, row_ptr, head_flag, dst_local, reduce, method):
    neutral = reduce_neutral(reduce, vals.dtype)
    if method == "mxscan" and vals.dim() > 1:
        method = "scan"
    if method == "mxscan":
        scanned = _mxscan_csc(vals, row_ptr, head_flag, reduce)
        return _ends_gather(scanned, row_ptr, neutral)
    if method == "scan":
        scanned = segmented_scan(vals, head_flag, COMBINERS[reduce])
        return _ends_gather(scanned, row_ptr, neutral)
    if method == "scatter":
        if dst_local is None:
            raise ValueError("method='scatter' needs dst_local")
        return _scatter(vals, dst_local, row_ptr.shape[0] - 1, reduce)
    raise ValueError(
        f"segment min/max: unknown method {method!r}; accepted: 'scan', "
        "'mxscan', 'scatter' (cumsum/mxsum are sum-only)")


def segment_min_csc(vals, row_ptr, head_flag, dst_local=None, method="scan"):
    """Min of ``vals`` per destination; empty rows get the dtype max."""
    return _segment_minmax(vals, row_ptr, head_flag, dst_local, "min", method)


def segment_max_csc(vals, row_ptr, head_flag, dst_local=None, method="scan"):
    """Max of ``vals`` per destination; empty rows get the dtype min."""
    return _segment_minmax(vals, row_ptr, head_flag, dst_local, "max", method)


def segment_reduce_by_ends(vals, head_flag, dst_local, num_segments: int,
                           reduce: str = "sum", method: str = "scan"):
    """Per-destination reduction WITHOUT a row_ptr: segment ends are the
    slots where the next slot starts a new segment, and each end's scanned
    value lands in the (num_segments, ...) output.  Padding slots carry
    ``dst_local == num_segments`` and are dropped; empty destinations get
    the neutral element.  Accepts ``scan``, ``scatter`` and ``mxscan``
    (1-D values; the dst_local sentinel is its padding mask);
    ``cumsum``/``mxsum`` and (E, K) ``mxscan`` downgrade to ``scan``."""
    if reduce not in COMBINERS:
        raise ValueError(reduce)
    if method == "scatter":
        return _scatter(vals, dst_local, num_segments, reduce)
    if method in ("cumsum", "mxsum") or (method == "mxscan" and vals.dim() > 1):
        method = "scan"
    if method == "mxscan":
        scanned = mxscan_segmented(vals, head_flag, dst_local >= num_segments,
                                   op=reduce)
    elif method == "scan":
        scanned = segmented_scan(vals, head_flag, COMBINERS[reduce])
    else:
        raise ValueError(
            f"segment_reduce_by_ends: unknown method {method!r}; accepts "
            "'scan', 'scatter', 'mxscan'")
    is_end = torch.cat([head_flag[1:], head_flag.new_ones((1,))])
    idx = torch.where(is_end, dst_local, torch.full_like(dst_local, num_segments))
    # one value per segment lands, so the scatter below is exact and its
    # order does not matter on any device
    return _scatter_into(scanned, idx, num_segments, reduce)


def reducers():
    """Reduce-name -> segment-function table (used by the pull engine)."""
    return {
        "sum": segment_sum_csc,
        "min": segment_min_csc,
        "max": segment_max_csc,
    }
