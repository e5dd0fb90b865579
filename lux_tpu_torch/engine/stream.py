"""Host-offload edge streaming: pull iterations for graphs whose edge
arrays exceed the card's memory.

Counterpart of ``lux_tpu.engine.stream``.  The O(nv) vertex state stays
on the device; the O(ne) edge arrays stay in HOST memory, and each
iteration streams them through the device in fixed-size chunks:

    for chunk in part: copy the next chunk in      # side stream, overlaps ...
                       partial = gather + reduce(current chunk)   # ... this
    acc = combine(partials); state = apply(acc)

Chunks are CSC edge ranges, so a chunk is a contiguous run of destination
segments (possibly splitting one segment at each border).  Per chunk the
part's row_ptr is re-based and clipped to the chunk (``clip(row_ptr - lo,
0, chunk_e)``), head flags are rebuilt from the re-based pointers at build
time, and the pull engine's own load and segmented reduce run unchanged;
partials combine with the reduce's own op (add, minimum, maximum), chunk
by chunk in chunk order, so min/max results are bitwise the resident
engine's and sums differ only in association.

The transfer path on the card: every chunk's four edge arrays are packed
into ONE pinned host buffer, allocated once at build time (a copy from
pageable memory would be synchronous and overlap nothing), so a chunk is
one ``non_blocking`` copy on a side CUDA stream into one of two device
buffers (the double buffer).  Events order the two streams: the compute
stream waits for a chunk's copy before reading it, and a copy waits for
the compute that last read its buffer.  ``prefetch=True`` issues chunk
k+1's copy before chunk k's compute; ``prefetch=False`` (the A/B switch
for the overlap) makes each copy wait for the previous chunk's compute,
so transfer and compute alternate; both give the same bits.  The
chunk-local row_ptr is derived on the device from one resident copy of
each part's row_ptr.  On the CPU the chunks are read in place.

Peak device bytes: :func:`streamed_hbm_bytes`, which counts this
package's own buffers (see its docstring).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from lux_tpu_torch.engine import methods, pull
from lux_tpu_torch.graph.shards import (LANE, PullShards, ShardArrays, ShardSpec,
                                        alloc_arrays, stacked_to_global, to_device)

#: bytes one edge takes in a transfer: src_pos, dst_local (int32),
#: weights (f32), head_flag (bool)
CHUNK_BYTES_PER_EDGE = 13
_COMBINE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


class StreamChunk(NamedTuple):
    """ONE chunk of one part as the pull engine's load and reduce read it
    (the fields they take from ShardArrays): views into a transfer buffer
    and the re-based row_ptr."""

    row_ptr: Any    # (V+1,) int32 re-based to the chunk, clipped
    src_pos: Any    # (chunk_e,) int32 gather positions
    dst_local: Any  # (chunk_e,) int32 (padding -> nv_pad sentinel)
    head_flag: Any  # (chunk_e,) bool rebuilt from the re-based row_ptr
    weights: Any    # (chunk_e,) float32


class _HostChunk(NamedTuple):
    """Stored form of a chunk: its base offset and views of its packed
    host row (torch tensors)."""

    lo: int
    src_pos: Any
    dst_local: Any
    head_flag: Any
    weights: Any


def _unpack(buf: torch.Tensor, chunk_e: int):
    """(src_pos, dst_local, head_flag, weights) views of one packed chunk
    row of CHUNK_BYTES_PER_EDGE * chunk_e bytes."""
    n = chunk_e
    return (buf[: 4 * n].view(torch.int32), buf[4 * n: 8 * n].view(torch.int32),
            buf[12 * n: 13 * n].view(torch.bool), buf[8 * n: 12 * n].view(torch.float32))


@dataclasses.dataclass
class StreamedPullShards:
    """Host bundle: the chunked edge arrays, packed, and the vertex side."""

    spec: ShardSpec
    cuts: np.ndarray
    chunk_e: int
    #: chunks[p][c]: part p's _HostChunk for edge range [c*chunk_e, ...)
    chunks: list
    #: row_ptrs[p]: the part's ONE global (V+1,) int64 row_ptr; chunks
    #: re-base from it
    row_ptrs: list
    #: vertex-side ShardArrays (P, V) with ZERO-width edge arrays: all a
    #: program's init_state/apply reads (degree, vtx_mask, global_vid)
    varrays: ShardArrays
    #: (P, n_chunks, CHUNK_BYTES_PER_EDGE * chunk_e) uint8: every chunk's
    #: arrays, one row a chunk (pinned when built for the card)
    packed: torch.Tensor

    def scatter_to_global(self, stacked):
        return stacked_to_global(self.cuts, stacked)


#: bytes a part holds a padded vertex for the whole run, beside its state:
#: its resident int32 row_ptr and its vertex-side arrays on the device
#: (vtx_mask, degree, global_vid and the zero-width layout's int32 row_ptr)
_PART_VERTEX_BYTES = 4 + 13
#: copies of the state a run holds: the caller's initial state, the
#: current state, the new parts and their stack
_STATE_COPIES = 4
#: (V,) 4-byte buffers of the active part's reduce, per state column: the
#: accumulator, the chunk's partial and the segment-end gather's
#: temporaries, with one to spare for the allocator's rounding
_REDUCE_PASSES = 6


def _edge_passes(state_width: int) -> int:
    """Per-edge 4-byte compute buffers of the ACTIVE chunk, per state
    column: the gathered source state and the scanned values on the scan
    kernel's 1-D path; a wide (E, K) state (CF) also gathers the
    destination rows and runs the plain scan, and keeps four."""
    return 2 if state_width == 1 else 4


def streamed_hbm_bytes(spec: ShardSpec, chunk_e: int, state_bytes: int = 4,
                       state_width: int = 1) -> int:
    """Peak device bytes of this package's streamed engine: the two
    transfer buffers (the double buffer) and the active chunk's per-edge
    compute buffers (they scale with ``state_width``: CF's (V, K) latents
    make them the largest term); every part's resident row_ptr, vertex
    arrays and state copies; the active chunk's re-based row_ptr and the
    vertex-sized buffers of its reduce.  The terms were fitted to
    ``torch.cuda.max_memory_allocated`` on the card (PERF.md §6): the
    reference's sizing, which counts neither the vertex arrays nor the
    reduce's temporaries, undershot the port's peak by 15 %."""
    V, P, W = spec.nv_pad, spec.num_parts, state_width
    transfer = 2 * CHUNK_BYTES_PER_EDGE * chunk_e
    compute = chunk_e * 4 * W * _edge_passes(W)
    parts = P * V * (_PART_VERTEX_BYTES + _STATE_COPIES * state_bytes * W)
    active = V * (4 + 4 * W * _REDUCE_PASSES)
    return transfer + compute + parts + active


def edge_bytes_total(spec: ShardSpec) -> int:
    """The resident pull engine's device edge bytes (what streaming
    avoids): src_pos, dst_local, weights, head_flag, edge_mask."""
    return spec.num_parts * spec.e_pad * (4 + 4 + 1 + 1 + 4)


def chunk_edges_for_budget(spec: ShardSpec, budget_bytes: int, state_bytes: int = 4,
                           state_width: int = 1) -> int:
    """Largest LANE-aligned chunk_e whose streamed footprint
    (:func:`streamed_hbm_bytes`) fits the budget; raises if not even one
    LANE fits."""
    fixed = streamed_hbm_bytes(spec, 0, state_bytes, state_width)
    per_edge = 2 * CHUNK_BYTES_PER_EDGE + 4 * state_width * _edge_passes(state_width)
    chunk_e = max(0, budget_bytes - fixed) // per_edge // LANE * LANE
    if chunk_e <= 0:
        raise ValueError(
            f"HBM budget {budget_bytes} cannot hold even one {LANE}-edge "
            f"chunk plus the state ({fixed} fixed bytes)")
    return min(chunk_e, spec.e_pad)


def _rebased_row_ptr(rp: np.ndarray, lo: int, chunk_e: int) -> np.ndarray:
    """The chunk-local (V+1,) int32 row_ptr: a pure function of the part's
    global row_ptr and the chunk base."""
    return np.clip(rp - lo, 0, chunk_e).astype(np.int32)


def build_streamed_pull(shards: PullShards, chunk_e: int,
                        pin_memory: bool = False) -> StreamedPullShards:
    """Chunk an in-memory pull layout for streaming.  ``chunk_e`` is the
    static per-chunk edge capacity (LANE-aligned; from
    chunk_edges_for_budget for a byte budget).  ``pin_memory`` pins the
    packed host buffer (needed for asynchronous copies to a card)."""
    if chunk_e % LANE:
        raise ValueError(f"chunk_e must be a multiple of {LANE}")
    spec, arrays = shards.spec, shards.arrays
    P, V, E = spec.num_parts, spec.nv_pad, spec.e_pad
    n_chunks = -(-E // chunk_e)
    packed = torch.empty((P, n_chunks, CHUNK_BYTES_PER_EDGE * chunk_e),
                         dtype=torch.uint8, pin_memory=pin_memory)
    chunks: list = []
    row_ptrs: list = []
    for p in range(P):
        rp = arrays.row_ptr[p].astype(np.int64)
        row_ptrs.append(rp)
        part_chunks = []
        for c in range(n_chunks):
            lo, hi = c * chunk_e, min((c + 1) * chunk_e, E)
            m = hi - lo
            src, dst, head, w = _unpack(packed[p, c], chunk_e)
            rp_c = _rebased_row_ptr(rp, lo, chunk_e)
            head_np = head.numpy()
            head_np[:] = False
            head_np[rp_c[:V][rp_c[:V] < rp_c[1: V + 1]]] = True
            for t, a, fill in ((src, arrays.src_pos, 0), (dst, arrays.dst_local, V),
                               (w, arrays.weights, 0)):
                t_np = t.numpy()
                t_np[:m] = a[p, lo:hi]
                t_np[m:] = fill
            part_chunks.append(_HostChunk(lo, src, dst, head, w))
        chunks.append(part_chunks)
    varrays = alloc_arrays(P, V, 0)._replace(
        vtx_mask=arrays.vtx_mask.copy(), degree=arrays.degree.copy(),
        global_vid=arrays.global_vid.copy())
    return StreamedPullShards(spec=spec, cuts=shards.cuts, chunk_e=chunk_e,
                              chunks=chunks, row_ptrs=row_ptrs, varrays=varrays,
                              packed=packed)


class _Transfer:
    """The double buffer of one run on ``dev``: put(slot, p, c, after)
    starts chunk (p, c)'s copy into buffer ``slot`` once the compute that
    released buffer ``after`` is done; take(slot, p, c) hands the
    compute stream that chunk (waiting for its copy); release(slot) marks
    the end of the compute that reads buffer ``slot``.  On the CPU the
    host rows are read in place."""

    def __init__(self, sh: StreamedPullShards, dev: torch.device):
        self.sh, self.dev = sh, dev
        self.cuda = dev.type == "cuda"
        self.row_ptr = torch.from_numpy(np.stack(sh.row_ptrs).astype(np.int32)).to(dev)
        if not self.cuda:
            return
        nbytes = sh.packed.shape[2]
        self.stream = torch.cuda.Stream(dev)
        self.bufs = [torch.empty(nbytes, dtype=torch.uint8, device=dev) for _ in range(2)]
        for b in self.bufs:
            b.record_stream(self.stream)
        self.ready = [torch.cuda.Event() for _ in range(2)]
        self.free = [torch.cuda.Event() for _ in range(2)]

    def put(self, slot: int, p: int, c: int, after: int) -> None:
        if not self.cuda:
            return
        with torch.cuda.stream(self.stream):
            # an event not yet recorded makes the wait a no-op
            self.stream.wait_event(self.free[after])
            self.bufs[slot].copy_(self.sh.packed[p, c], non_blocking=True)
            self.ready[slot].record(self.stream)

    def take(self, slot: int, p: int, c: int) -> StreamChunk:
        ce = self.sh.chunk_e
        if self.cuda:
            torch.cuda.current_stream(self.dev).wait_event(self.ready[slot])
            src, dst, head, w = _unpack(self.bufs[slot], ce)
        else:
            src, dst, head, w = _unpack(self.sh.packed[p, c], ce)
        rp = (self.row_ptr[p] - self.sh.chunks[p][c].lo).clamp_(0, ce)
        return StreamChunk(rp, src, dst, head, w)

    def release(self, slot: int) -> None:
        if self.cuda:
            self.free[slot].record(torch.cuda.current_stream(self.dev))


def _chunk_partial(prog, method: str, chunk: StreamChunk, full_state, local_state):
    """The pull engine's load and reduce on one chunk: the chunk's
    partial per-destination reduction (V, ...)."""
    gath = pull.pull_gather_part(chunk, full_state, local_state, prog.needs_dst_state)
    return pull.pull_reduce_part(prog, chunk, gath, method)


def _streamed_iteration(prog, sh: StreamedPullShards, method: str, xfer: _Transfer,
                        varr_p: list, state, prefetch: bool):
    """One whole-graph pull iteration with host-resident edges: stream
    every part's chunks through the double buffer, combine the partial
    reductions with the reduce's own op in chunk order, apply."""
    spec = sh.spec
    full = state.reshape((spec.gathered_size,) + tuple(state.shape[2:]))
    seq = [(p, c) for p in range(spec.num_parts) for c in range(len(sh.chunks[p]))]
    combine = _COMBINE[prog.reduce]
    xfer.put(0, *seq[0], after=0)
    new_parts, acc = [], None
    for k, (p, c) in enumerate(seq):
        slot, nxt = k % 2, seq[k + 1] if k + 1 < len(seq) else None
        if prefetch and nxt is not None:
            # the next copy waits only for the compute that last read ITS
            # buffer (chunk k-1), so it overlaps this chunk's compute
            xfer.put(1 - slot, *nxt, after=1 - slot)
        part = _chunk_partial(prog, method, xfer.take(slot, p, c), full, state[p])
        xfer.release(slot)
        acc = part if acc is None else combine(acc, part, out=acc)
        if not prefetch and nxt is not None:
            xfer.put(1 - slot, *nxt, after=slot)  # after this chunk's compute
        if nxt is None or nxt[0] != p:
            new_parts.append(prog.apply(state[p], acc, varr_p[p]))
            acc = None
    return torch.stack(new_parts)


def _setup(prog, sh: StreamedPullShards, state0, method: str):
    dev = state0.device
    method = methods.resolve_sum(method, prog.reduce, methods.default_platform(dev))
    varr = to_device(sh.varrays, dev)
    return (method, _Transfer(sh, dev),
            [varr.part(p) for p in range(sh.spec.num_parts)])


def run_pull_fixed_streamed(prog, sh: StreamedPullShards, state0, num_iters: int,
                            method: str = "auto", prefetch: bool = True):
    """Fixed-iteration pull with host-resident edges, on ``state0``'s
    device.  ``prefetch=False`` alternates transfer and compute (the A/B
    switch for the overlap).  Returns the final (P, V, ...) stacked
    state; ``state0`` is left untouched."""
    method, xfer, varr_p = _setup(prog, sh, state0, method)
    state = state0
    for _ in range(num_iters):
        state = _streamed_iteration(prog, sh, method, xfer, varr_p, state, prefetch)
    return state


def run_pull_until_streamed(prog, sh: StreamedPullShards, state0, max_iters: int,
                            active_fn: Callable, method: str = "auto",
                            prefetch: bool = True):
    """Convergence-driven streamed pull (the components contract: iterate
    until no vertex is active).  ``active_fn(old_local, new_local)``
    counts one part's active vertices; the parts' total is read on the
    host once per iteration.  Returns (final state, iterations run)."""
    method, xfer, varr_p = _setup(prog, sh, state0, method)
    state, it = state0, 0
    while it < max_iters:
        new = _streamed_iteration(prog, sh, method, xfer, varr_p, state, prefetch)
        active = int(torch.stack([active_fn(state[p], new[p])
                                  for p in range(sh.spec.num_parts)]).sum())
        state = new
        it += 1
        if active == 0:
            break
    return state, it
