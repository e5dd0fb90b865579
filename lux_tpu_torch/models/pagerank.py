"""PageRank on the pull engine and on the block-CSR SpMV kernel.

Counterpart of ``lux_tpu.models.pagerank``; the math is the same:
  * ranks are stored PRE-DIVIDED by out-degree (the state holds
    r[v]/deg[v], undivided when deg[v] == 0), so the gather needs no
    degree lookup;
  * one iteration: new[v] = (1-ALPHA)/nv + ALPHA * sum_{u->v} state[u],
    divided by deg[v] when deg[v] != 0;
  * a fixed iteration count, no convergence test.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lux_tpu_torch.engine import pull
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.shards import PullShards, build_pull_shards, to_device
from lux_tpu_torch.ops import spmv
from lux_tpu_torch.program import SpecBacked, library
from lux_tpu_torch.utils.device import resolve_device

#: PageRank damping, defined with the spec it parameterizes
ALPHA = library.ALPHA

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def apply_rank_update(acc: torch.Tensor, degree: torch.Tensor, nv: int,
                      alpha: float = ALPHA) -> torch.Tensor:
    """The recurrence tail for the block-CSR runner: (initRank +
    alpha*acc), divided by out-degree where nonzero.  The teleport is ONE
    f32 rounding of the Python-float quotient (rounding 1-alpha and 1/nv
    separately would drift the last ulp)."""
    init_rank = float(np.float32((1.0 - alpha) / nv))
    pr = init_rank + float(np.float32(alpha)) * acc
    deg = degree.to(torch.float32)
    return torch.where(degree > 0, pr / deg.clamp_min(1.0), pr)


@dataclasses.dataclass(frozen=True)
class PageRankProgram(SpecBacked):
    """PageRank as a named parameter bundle over the declarative spec
    (program.library.PAGERANK): init/edge/apply are evaluated from it.
    ``dtype`` is the state storage dtype ("float32" or "bfloat16");
    accumulation stays float32."""

    nv: int
    alpha: float = ALPHA
    dtype: str = "float32"

    @property
    def spec(self):
        return library.PAGERANK

    def _env(self):
        return {"nv": self.nv, "alpha": self.alpha, "dtype": self.dtype}


@dataclasses.dataclass(frozen=True)
class PPRProgram(PageRankProgram):
    """Personalized PageRank: the teleport mass is a one-hot at ``seed``."""

    seed: int = 0

    @property
    def spec(self):
        return library.PPR

    def _env(self):
        return {**super()._env(), "seed": self.seed}


def pagerank(g: HostGraph | PullShards, num_iters: int = 10,
             num_parts: int = 1, method: str = "auto",
             dtype: str = "float32", device="cuda") -> np.ndarray:
    """Run PageRank on the pull engine; returns the (nv,) pre-divided rank
    vector as numpy."""
    dev = resolve_device(device)
    shards = g if isinstance(g, PullShards) else build_pull_shards(g, num_parts)
    prog = PageRankProgram(nv=shards.spec.nv, dtype=dtype)
    arrays = to_device(shards.arrays, dev)
    state0 = pull.init_state(prog, arrays)
    final = pull.run_pull_fixed(prog, shards.spec, arrays, state0, num_iters,
                                method=method, donate=True)
    return shards.scatter_to_global(final.float().cpu().numpy())


def make_pallas_runner(g: HostGraph, v_blk: int | None = None,
                       t_chunk: int | None = None, dtype: str = "float32",
                       device="cuda", bc=None):
    """Build the block-CSR layout once (or take ``bc``, one already built
    for ``g``); return (run, state0) where
    run(state, num_iters) iterates gather ``s[e_src]`` (torch) -> the
    block-CSR SpMV kernel -> apply, in place on ``state``.  State lives
    on ``num_vblocks * v_blk`` slots; only ``[:nv]`` is meaningful.  (The
    name is the reference's: its block-CSR path is a Pallas kernel.)"""
    dev = resolve_device(device)
    if bc is None:
        bc = spmv.build_blockcsr(g, v_blk=v_blk or spmv.V_BLK,
                                 t_chunk=t_chunk or spmv.T_CHUNK)
    nvp = bc.num_vblocks * bc.v_blk
    deg = g.out_degrees()
    degree = np.zeros(nvp, np.int32)
    degree[: g.nv] = deg
    state0 = np.zeros(nvp, np.float32)
    state0[: g.nv] = np.where(deg > 0, (1.0 / g.nv) / np.maximum(deg, 1), 1.0 / g.nv)
    degree_d = torch.from_numpy(degree).to(dev)
    e_src = torch.from_numpy(bc.e_src_pos).to(dev)
    e_dst = torch.from_numpy(bc.e_dst_rel).to(dev)
    cb = torch.from_numpy(bc.chunk_block).to(dev)
    cf = torch.from_numpy(bc.chunk_first).to(dev)
    store = _DTYPES[dtype]

    e_src_flat = e_src.reshape(-1)

    def run(state: torch.Tensor, num_iters: int) -> torch.Tensor:
        for _ in range(num_iters):
            # (C, T) in the storage dtype; index_select takes the int32
            # positions as they are (advanced indexing would widen them)
            vals = state.index_select(0, e_src_flat).view(e_src.shape)
            acc = spmv.spmv_blockcsr(vals, e_dst, cb, cf, op="sum",
                                     v_blk=bc.v_blk, num_vblocks=bc.num_vblocks)
            state.copy_(apply_rank_update(acc, degree_d, g.nv))
        return state

    return run, torch.from_numpy(state0).to(dev).to(store)


def pagerank_pallas(g: HostGraph, num_iters: int = 10, v_blk: int | None = None,
                    t_chunk: int | None = None, device="cuda") -> np.ndarray:
    """Single-device PageRank on the block-CSR SpMV kernel; returns (nv,)."""
    run, state0 = make_pallas_runner(g, v_blk, t_chunk, device=device)
    return run(state0, num_iters)[: g.nv].float().cpu().numpy()


def _host_iteration(g: HostGraph, stored: np.ndarray,
                    deg: np.ndarray) -> np.ndarray:
    """One exact float64 host application of the recurrence — shared by
    the oracle and the -check validator."""
    acc = np.bincount(g.dst_of_edges(), weights=stored[g.col_idx], minlength=g.nv)
    pr = (1.0 - ALPHA) / g.nv + ALPHA * acc
    return np.where(deg > 0, pr / np.maximum(deg, 1.0), pr)


def pagerank_reference(g: HostGraph, num_iters: int) -> np.ndarray:
    """NumPy float64 oracle of the identical recurrence."""
    deg = g.out_degrees().astype(np.float64)
    nv = g.nv
    state = np.where(deg > 0, (1.0 / nv) / np.maximum(deg, 1.0), 1.0 / nv)
    for _ in range(num_iters):
        state = _host_iteration(g, state, deg)
    return state.astype(np.float32)


def ppr_reference(g: HostGraph, seed: int, num_iters: int) -> np.ndarray:
    """NumPy float64 oracle of the personalized recurrence: the teleport
    mass is a one-hot at ``seed``.  The per-destination sums are one
    ``np.bincount`` an iteration (float64; the reference adds with
    ``np.add.at``, same sums in another order)."""
    deg = g.out_degrees().astype(np.float64)
    mass = np.zeros(g.nv, np.float64)
    mass[seed] = 1.0
    state = np.where(deg > 0, mass / np.maximum(deg, 1.0), mass)
    dst = g.dst_of_edges()
    for _ in range(num_iters):
        acc = np.bincount(dst, weights=state[g.col_idx], minlength=g.nv)
        pr = (1.0 - ALPHA) * mass + ALPHA * acc
        state = np.where(deg > 0, pr / np.maximum(deg, 1.0), pr)
    return state.astype(np.float32)


def check_ranks(g: HostGraph, stored: np.ndarray, num_iters: int | None = None,
                dtype: str = "float32") -> int:
    """Fixed-point validation for `-check`: re-applies one exact host
    iteration and counts vertices whose stored pre-divided rank moved
    beyond tolerance.  The tolerance tracks what a correct engine can
    deliver: the true residual contracts like ALPHA^num_iters, and a
    bfloat16 state carries ~2^-8 relative quantization; it is applied per
    vertex against max(|rank|, mean).  Non-finite ranks always count."""
    stored = np.asarray(stored, np.float64)
    deg = g.out_degrees().astype(np.float64)
    new = _host_iteration(g, stored, deg)
    base = 2e-2 if dtype == "bfloat16" else 1e-3
    tol = base if num_iters is None else max(base, 3.0 * ALPHA ** num_iters)
    scale = max(float(np.mean(np.abs(stored))), 1e-30)
    thresh = tol * np.maximum(np.abs(stored), scale)
    bad = ~np.isfinite(stored) | (np.abs(new - stored) > thresh)
    return int(bad.sum())
