"""Push-model shards: per-part CSR restricted to local destinations.

Counterpart of ``lux_tpu.graph.push_shards`` (its NumPy argsort path; the
reference's native ``lux_push_part_build`` is not copied here).  The arrays
are numpy and byte-identical to the reference's for the same graph and
part count; :func:`to_device` moves them to a torch device.

Each part keeps out-edge (CSR) structure over the sources that reach it,
holding only the edges whose destination falls in the part's vertex range,
so a frontier scatter writes only the part's own slice.  The part's
*unique sources* are stored sorted with their edge offsets, and a frontier
vertex finds its row by binary search: memory O(part edges), not O(nv).

Shapes (U = u_pad unique-source slots, E = e_pad edge slots):
  uniq_src:      (P, U)   int32 sorted global source ids; INT32_MAX padding.
  csr_row_ptr:   (P, U+1) int32 offsets into the CSR-ordered edge slots.
  csr_dst_local: (P, E)   int32 local dst of each CSR-ordered edge;
                          nv_pad sentinel on padding (drops scatters).
  csr_weight:    (P, E)   float32.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.shards import LANE, PullShards, _round_up, build_pull_shards

SRC_SENTINEL = np.iinfo(np.int32).max


class PushArrays(NamedTuple):
    uniq_src: np.ndarray
    csr_row_ptr: np.ndarray
    csr_dst_local: np.ndarray
    csr_weight: np.ndarray

    def part(self, p: int) -> "PushArrays":
        """The arrays of part ``p`` (leading axis dropped)."""
        return PushArrays(*(a[p] for a in self))


@dataclasses.dataclass(frozen=True)
class PushSpec:
    """Static geometry of the frontier path."""

    u_pad: int  # padded unique-source count per part
    f_cap: int  # sparse frontier queue capacity per part (vertices)
    e_sp: int  # compacted sparse edge-buffer capacity per part
    #: frontier > nv/DEN => dense (pull) round; the reference's
    #: SPARSE_THRESHOLD = 16
    pull_threshold_den: int = 16
    #: the second, smaller sparse tier: a round whose frontier out-edges
    #: fit it walks O(e_sp_small) slots instead of O(e_sp).  0 disables.
    e_sp_small: int = 0


@dataclasses.dataclass
class PushShards:
    """Pull shards (dense rounds) + CSR arrays (sparse frontier rounds)."""

    pull: PullShards
    pspec: PushSpec
    parrays: PushArrays

    @property
    def spec(self):
        return self.pull.spec

    @property
    def arrays(self):
        return self.pull.arrays

    @property
    def cuts(self):
        return self.pull.cuts

    def scatter_to_global(self, stacked):
        return self.pull.scatter_to_global(stacked)


def build_push_shards(
    g: HostGraph,
    num_parts: int,
    f_cap: Optional[int] = None,
    e_sp: Optional[int] = None,
    cuts: Optional[np.ndarray] = None,
) -> PushShards:
    """Partition ``g`` as the pull shards do, and build each part's CSR
    over its own destinations.  ``f_cap``/``e_sp`` default to the
    reference's sizing: nv_pad/16 + 128 queue slots, e_pad/4 + 128
    edge-buffer slots (rounded to 128), and a small tier of e_sp/16.
    ``cuts``: (P+1,) contiguous vertex bounds instead of the
    edge-balanced ones (a recut rebuilds from them)."""
    pull = build_pull_shards(g, num_parts, cuts=cuts)
    spec = pull.spec
    P, e_pad, nv_pad = num_parts, spec.e_pad, spec.nv_pad
    cuts = pull.cuts

    csr_dst_local = np.full((P, e_pad), nv_pad, np.int32)
    csr_weight = np.zeros((P, e_pad), np.float32)
    uniq_all, rp_all = [], []
    for p in range(P):
        vlo, vhi = int(cuts[p]), int(cuts[p + 1])
        elo, ehi = int(g.row_ptr[vlo]), int(g.row_ptr[vhi])
        srcs = g.col_idx[elo:ehi]
        order = np.argsort(srcs, kind="stable")
        s_sorted = srcs[order]
        uniq, counts = (
            np.unique(s_sorted, return_counts=True)
            if len(s_sorted)
            else (np.array([], np.int32), np.array([], np.int64))
        )
        rp = np.zeros(len(uniq) + 1, np.int64)
        np.cumsum(counts, out=rp[1:])
        uniq_all.append(uniq.astype(np.int32))
        rp_all.append(rp.astype(np.int32))
        # part-local dst per edge straight from the row_ptr slice
        dl_slice = np.repeat(
            np.arange(vhi - vlo, dtype=np.int32),
            np.diff(np.asarray(g.row_ptr[vlo: vhi + 1])).astype(np.int64),
        )
        csr_dst_local[p, : ehi - elo] = dl_slice[order]
        if g.weights is not None:
            csr_weight[p, : ehi - elo] = g.weights[elo:ehi][order].astype(np.float32)

    u_pad = max(LANE, _round_up(max(len(u) for u in uniq_all) or 1, LANE))
    uniq_src = np.full((P, u_pad), SRC_SENTINEL, np.int32)
    csr_row_ptr = np.zeros((P, u_pad + 1), np.int32)
    for p in range(P):
        u, rp = uniq_all[p], rp_all[p]
        uniq_src[p, : len(u)] = u
        csr_row_ptr[p, : len(rp)] = rp
        csr_row_ptr[p, len(rp):] = rp[-1] if len(rp) else 0

    if f_cap is None:
        f_cap = _round_up(nv_pad // 16 + 128, LANE)
    if e_sp is None:
        e_sp = _round_up(max(e_pad // 4, LANE) + LANE, LANE)
    # the small tier is worth a second branch only when it shrinks the walk
    e_sp_small = _round_up(max(int(e_sp) // 16, LANE), LANE)
    if e_sp_small >= int(e_sp):
        e_sp_small = 0

    pspec = PushSpec(u_pad=u_pad, f_cap=int(f_cap), e_sp=int(e_sp),
                     e_sp_small=e_sp_small)
    parrays = PushArrays(uniq_src=uniq_src, csr_row_ptr=csr_row_ptr,
                         csr_dst_local=csr_dst_local, csr_weight=csr_weight)
    return PushShards(pull=pull, pspec=pspec, parrays=parrays)


def to_device(parrays: PushArrays, device) -> PushArrays:
    """numpy PushArrays -> torch tensors on ``device``, dtypes kept."""
    return PushArrays(*(
        torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in parrays
    ))
