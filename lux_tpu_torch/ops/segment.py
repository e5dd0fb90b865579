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
  * ``scatter`` — index_add_ / scatter_reduce_ with the int32 ids.

All take the static-shape padded inputs of lux_tpu_torch.graph.shards
for one part: ``vals`` (E,) or (E, K), ``row_ptr`` (V+1,) int32,
``head_flag`` (E,) bool, ``dst_local`` (E,) int32 with padding == V.
"""
from __future__ import annotations

import torch

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


def _scatter(vals, dst_local, num_segments, reduce):
    """Scatter-reduce into (num_segments, ...) with a dump row for the
    padding sentinel ``dst_local == num_segments``."""
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
    # one value per segment lands, so the scatter below is exact
    return _scatter(scanned, idx, num_segments, reduce)


def reducers():
    """Reduce-name -> segment-function table (used by the pull engine)."""
    return {
        "sum": segment_sum_csc,
        "min": segment_min_csc,
        "max": segment_max_csc,
    }
