"""Block-CSR segmented reduction by destination (the PageRank hot loop).

Counterpart of ``lux_tpu.ops.pallas_spmv``.  Edges are re-laid out on the
host into the static block-CSR form: each VERTEX block of ``v_blk``
vertices owns a contiguous run of ``t_chunk``-edge chunks, its edges
sorted by destination, padded at the tail of its last chunk with the
sentinel ``e_dst_rel == v_blk``.  :func:`spmv_blockcsr` reduces the
per-edge values of each block into its vertices; :func:`spmv_blockcsr_2d`
sums K-wide per-edge rows (collaborative filtering's accumulation).

On a CUDA tensor each launches its hand-written kernel; on a CPU tensor
it runs its plain PyTorch version (``*_plain``).
``csrc/spmv_blockcsr.cu`` is one sorted-key segmented reduce over all the
slots, balanced over the card whatever the degrees: a CTA per span of
``SPAN_SLOTS`` slots, then one CTA folds the spans' summaries (which the
wrapper allocates, ``PART_BYTES`` a span).  ``csrc/spmv_blockcsr_2d.cu``
runs one CTA per vertex block.  ``spmv_blockcsr.launches`` and
``spmv_blockcsr_2d.launches`` count kernel launches (one per call).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.ops import cuda_build

V_BLK = 512  # output vertex block
T_CHUNK = 512  # edges per chunk
SPAN_SLOTS = 8192  # slots a CTA of the spmv_blockcsr kernel reduces
PART_BYTES = 20  # its summary of each span, in scratch

#: dtype -> the kernel's value-kind code (csrc/lux_ops.cuh LuxKind)
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_OPS = {"sum": 0, "min": 1, "max": 2}


def _round_up(x, m):
    return -(-x // m) * m


@dataclasses.dataclass
class BlockCSR:
    """Host-precomputed static block-CSR layout for one part.

    Arrays:
      e_src_pos: (C, T) int32   gather positions (padding -> 0)
      e_dst_rel: (C, T) int32   dst - block_base, in [0, v_blk); padding
                                holds v_blk
      e_weight:  (C, T) float32 | None — only for weighted graphs
      chunk_block: (C,) int32   output vertex block of each chunk (sorted)
      chunk_first: (C,) int32   1 on the first chunk of each block
    """

    nv: int
    num_vblocks: int
    num_chunks: int
    e_src_pos: np.ndarray
    e_dst_rel: np.ndarray
    e_weight: Optional[np.ndarray]
    chunk_block: np.ndarray
    chunk_first: np.ndarray
    v_blk: int = V_BLK
    t_chunk: int = T_CHUNK


def build_blockcsr(
    g: HostGraph,
    src_pos: Optional[np.ndarray] = None,
    v_blk: int = V_BLK,
    t_chunk: int = T_CHUNK,
) -> BlockCSR:
    """Re-lay out a CSC graph into chunk-aligned vertex blocks (numpy;
    byte-identical to ``lux_tpu.ops.pallas_spmv.build_blockcsr``).

    ``src_pos`` defaults to the raw source ids (single-part layout).
    Every block gets at least one chunk, so an empty block is one chunk
    of padding."""
    if src_pos is None:
        src_pos = g.col_idx.astype(np.int32)
    num_vblocks = _round_up(g.nv, v_blk) // v_blk
    ne = int(g.row_ptr[-1])

    block_lo = np.asarray(
        g.row_ptr[np.minimum(np.arange(num_vblocks) * v_blk, g.nv)], np.int64)
    block_hi = np.asarray(
        g.row_ptr[np.minimum((np.arange(num_vblocks) + 1) * v_blk, g.nv)],
        np.int64)
    chunks_per_block = np.maximum(1, -(-(block_hi - block_lo) // t_chunk))
    num_chunks = int(chunks_per_block.sum())
    chunk_start = np.zeros(num_vblocks + 1, np.int64)
    np.cumsum(chunks_per_block, out=chunk_start[1:])

    e_src_pos = np.zeros((num_chunks, t_chunk), np.int32)
    e_dst_rel = np.full((num_chunks, t_chunk), v_blk, np.int32)
    e_weight = None
    if g.weights is not None:
        e_weight = np.zeros((num_chunks, t_chunk), np.float32)

    # every edge's chunk and slot computed array-wise, then placed with one
    # flat scatter per array (edges are CSC-ordered, blocks contiguous)
    dst = g.dst_of_edges()
    e_block = np.repeat(np.arange(num_vblocks, dtype=np.int64),
                        block_hi - block_lo)
    within = np.arange(ne, dtype=np.int64) - block_lo[e_block]
    e_chunk = chunk_start[e_block] + within // t_chunk
    flat = e_chunk * t_chunk + within % t_chunk
    e_src_pos.reshape(-1)[flat] = src_pos[:ne]
    e_dst_rel.reshape(-1)[flat] = (
        dst[:ne].astype(np.int64) - e_block * v_blk).astype(np.int32)
    if e_weight is not None:
        e_weight.reshape(-1)[flat] = g.weights[:ne]
    chunk_block = np.repeat(np.arange(num_vblocks, dtype=np.int32),
                            chunks_per_block)
    chunk_first = np.zeros(num_chunks, np.int32)
    chunk_first[chunk_start[:-1]] = 1
    return BlockCSR(
        nv=g.nv,
        num_vblocks=num_vblocks,
        num_chunks=num_chunks,
        e_src_pos=e_src_pos,
        e_dst_rel=e_dst_rel,
        e_weight=e_weight,
        chunk_block=chunk_block,
        chunk_first=chunk_first,
        v_blk=v_blk,
        t_chunk=t_chunk,
    )


def reduce_neutral(op: str, dtype: torch.dtype):
    """The identity of ``op`` in ``dtype`` as a Python scalar: 0 for sum,
    the iinfo bound for integer min/max, +-inf for float min/max."""
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _out_dtype(op: str, dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if op == "sum" else dtype


def _flat_dst(e_dst_rel, chunk_block, v_blk: int, n: int) -> torch.Tensor:
    """(C*T,) global vertex of every slot; padding slots get the dump
    index ``n``."""
    dst = chunk_block.long()[:, None] * v_blk + e_dst_rel.long()
    return torch.where(e_dst_rel < v_blk, dst, n).reshape(-1)


def spmv_blockcsr_plain(edge_vals, e_dst_rel, chunk_block, chunk_first,
                        op: str = "sum", v_blk: int = V_BLK,
                        num_vblocks: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`spmv_blockcsr`: a scatter of every
    real slot into its global vertex (padding goes to a dump slot that is
    cut off).  Sums accumulate in f32; min/max keep the dtype."""
    del chunk_first  # block starts are implied by chunk_block
    n = num_vblocks * v_blk
    dst = _flat_dst(e_dst_rel, chunk_block, v_blk, n)
    dtype = _out_dtype(op, edge_vals.dtype)
    vals = edge_vals.reshape(-1).to(dtype)
    out = torch.full((n + 1,), reduce_neutral(op, dtype), dtype=dtype,
                     device=edge_vals.device)
    if op == "sum":
        out.index_add_(0, dst, vals)
    else:
        out.scatter_reduce_(0, dst, vals, reduce="amin" if op == "min" else "amax")
    return out[:n]


_lib_bound = None


def _lib():
    global _lib_bound
    if _lib_bound is None:
        lib = cuda_build.load("spmv_blockcsr")
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lux_spmv_blockcsr.argtypes = [vp, ci, vp, vp, cl, ci, ci, ci, ci, vp, vp, cl, vp]
        lib.lux_spmv_blockcsr.restype = ci
        _lib_bound = lib
    return _lib_bound


def _check(edge_vals, e_dst_rel, chunk_block, chunk_first, op, v_blk,
           num_vblocks):
    if op not in _OPS:
        raise ValueError(f"spmv_blockcsr op must be sum|min|max, got {op!r}")
    if not num_vblocks:
        raise ValueError("num_vblocks is required (use BlockCSR.num_vblocks)")
    if edge_vals.dim() != 2 or e_dst_rel.shape != edge_vals.shape:
        raise ValueError(
            f"edge_vals {tuple(edge_vals.shape)} and e_dst_rel "
            f"{tuple(e_dst_rel.shape)} must be the same (C, T) shape")
    num_chunks = edge_vals.shape[0]
    for name, t in (("chunk_block", chunk_block), ("chunk_first", chunk_first)):
        if t.shape != (num_chunks,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 of shape ({num_chunks},)")
    if e_dst_rel.dtype != torch.int32:
        raise ValueError("e_dst_rel must be int32")
    allowed = ((torch.float32, torch.bfloat16) if op == "sum"
               else (torch.float32, torch.int32))
    if edge_vals.dtype not in allowed:
        raise TypeError(f"spmv_blockcsr op={op} takes {allowed}, got {edge_vals.dtype}")
    devices = {t.device for t in (edge_vals, e_dst_rel, chunk_block, chunk_first)}
    if len(devices) != 1:
        raise ValueError(f"spmv_blockcsr inputs span devices {devices}")


def spmv_blockcsr(edge_vals: torch.Tensor, e_dst_rel: torch.Tensor,
                  chunk_block: torch.Tensor, chunk_first: torch.Tensor,
                  op: str = "sum", v_blk: int = V_BLK,
                  num_vblocks: int = 0) -> torch.Tensor:
    """Segmented reduction of (C, T) per-slot values by destination ->
    (num_vblocks * v_blk,).  sum takes f32 or bf16 and returns f32;
    min/max take f32 or int32 and keep the dtype.  Vertices with no edge
    get the neutral element.  CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    _check(edge_vals, e_dst_rel, chunk_block, chunk_first, op, v_blk,
           num_vblocks)
    if edge_vals.device.type == "cpu":
        return spmv_blockcsr_plain(edge_vals, e_dst_rel, chunk_block,
                                   chunk_first, op, v_blk, num_vblocks)
    if edge_vals.device.type != "cuda":
        raise ValueError(f"spmv_blockcsr runs on cpu or cuda, not {edge_vals.device}")
    tensors = (edge_vals, e_dst_rel, chunk_block)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("spmv_blockcsr needs contiguous inputs")
    out = torch.empty(num_vblocks * v_blk, dtype=_out_dtype(op, edge_vals.dtype),
                      device=edge_vals.device)
    scratch = torch.empty(PART_BYTES * -(-edge_vals.numel() // SPAN_SLOTS),
                          dtype=torch.uint8, device=edge_vals.device)
    with torch.cuda.device(edge_vals.device):
        rc = _lib().lux_spmv_blockcsr(
            edge_vals.data_ptr(), _KIND[edge_vals.dtype], e_dst_rel.data_ptr(),
            chunk_block.data_ptr(), edge_vals.shape[0], edge_vals.shape[1],
            v_blk, num_vblocks, _OPS[op], out.data_ptr(), scratch.data_ptr(),
            scratch.numel(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spmv_blockcsr kernel launch failed: CUDA error {rc}")
    spmv_blockcsr.launches += 1
    return out


spmv_blockcsr.launches = 0


# ---------------------------------------------------------------------------
# the 2-D variant: K-wide per-slot values (collaborative filtering)
# ---------------------------------------------------------------------------


def spmv_blockcsr_2d_plain(edge_vals, e_dst_rel, chunk_block, chunk_first,
                           v_blk: int = V_BLK, num_vblocks: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`spmv_blockcsr_2d`: an ``index_add_``
    of the flattened (C*T, K) rows, widened to f32, into an (n + 1, K)
    buffer whose dump row takes the padding and is cut off."""
    del chunk_first  # block starts are implied by chunk_block
    n = num_vblocks * v_blk
    k = edge_vals.shape[-1]
    out = torch.zeros((n + 1, k), dtype=torch.float32, device=edge_vals.device)
    out.index_add_(0, _flat_dst(e_dst_rel, chunk_block, v_blk, n),
                   edge_vals.reshape(-1, k).to(torch.float32))
    return out[:n]


def _fn2d():
    """The kernel's C entry point, typed (the library is built, loaded and
    cached by cuda_build.load under its lock; retyping is idempotent)."""
    fn = cuda_build.load("spmv_blockcsr_2d").lux_spmv_blockcsr_2d
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, vp, vp, ci, ci, ci, ci, ci, vp, vp]
    fn.restype = ci
    return fn


def spmv_blockcsr_2d(edge_vals: torch.Tensor, e_dst_rel: torch.Tensor,
                     chunk_block: torch.Tensor, chunk_first: torch.Tensor,
                     v_blk: int = V_BLK, num_vblocks: int = 0) -> torch.Tensor:
    """Segmented SUM of (C, T, K) per-slot values by destination ->
    (num_vblocks * v_blk, K) f32.  Values are f32 or bf16 and accumulate
    in f32; padding slots (``e_dst_rel == v_blk``) are skipped by their
    index; vertices with no edge get 0.  CPU tensors run the plain
    version; CUDA tensors launch the kernel (``csrc/spmv_blockcsr_2d.cu``),
    counted by ``spmv_blockcsr_2d.launches``."""
    if not num_vblocks:
        raise ValueError("num_vblocks is required (use BlockCSR.num_vblocks)")
    if edge_vals.dim() != 3 or e_dst_rel.shape != edge_vals.shape[:2]:
        raise ValueError(
            f"edge_vals {tuple(edge_vals.shape)} must be (C, T, K) over the "
            f"(C, T) e_dst_rel {tuple(e_dst_rel.shape)}")
    num_chunks = edge_vals.shape[0]
    for name, t in (("chunk_block", chunk_block), ("chunk_first", chunk_first)):
        if t.shape != (num_chunks,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 of shape ({num_chunks},)")
    if e_dst_rel.dtype != torch.int32:
        raise ValueError("e_dst_rel must be int32")
    if edge_vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"spmv_blockcsr_2d takes float32 or bfloat16 values, "
                        f"got {edge_vals.dtype}")
    devices = {t.device for t in (edge_vals, e_dst_rel, chunk_block, chunk_first)}
    if len(devices) != 1:
        raise ValueError(f"spmv_blockcsr_2d inputs span devices {devices}")
    if edge_vals.device.type == "cpu":
        return spmv_blockcsr_2d_plain(edge_vals, e_dst_rel, chunk_block, chunk_first,
                                      v_blk, num_vblocks)
    if edge_vals.device.type != "cuda":
        raise ValueError(f"spmv_blockcsr_2d runs on cpu or cuda, not {edge_vals.device}")
    if not all(t.is_contiguous() for t in (edge_vals, e_dst_rel, chunk_block)):
        raise ValueError("spmv_blockcsr_2d needs contiguous inputs")
    k = edge_vals.shape[2]
    out = torch.empty((num_vblocks * v_blk, k), dtype=torch.float32,
                      device=edge_vals.device)
    with torch.cuda.device(edge_vals.device):
        rc = _fn2d()(
            edge_vals.data_ptr(), _KIND[edge_vals.dtype], e_dst_rel.data_ptr(),
            chunk_block.data_ptr(), num_chunks, edge_vals.shape[1], v_blk,
            num_vblocks, k, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spmv_blockcsr_2d kernel launch failed: CUDA error {rc}")
    spmv_blockcsr_2d.launches += 1
    return out


spmv_blockcsr_2d.launches = 0
