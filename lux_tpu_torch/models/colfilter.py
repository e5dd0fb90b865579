"""Collaborative filtering: batch-gradient matrix factorization on a
weighted bipartite rating graph, on the pull engine and on the 2-D
block-CSR SpMV kernel.

Counterpart of ``lux_tpu.models.colfilter``; the math is the same:
  * the vertex state is a K-dim latent vector, K = 20, initialized to
    sqrt(1/K);
  * per edge (src -> dst, rating w): err = w - <v_src, v_dst>;
  * per destination: accErr = sum over the in-edges of err * v_src;
  * update: v_dst += GAMMA * (accErr - LAMBDA * v_dst), LAMBDA = 0.001,
    GAMMA = 3.5e-7;
  * a fixed iteration count.

Every vertex in range is updated each iteration, including those with no
ratings (pure weight decay).  A bf16 state stores the latents in bf16;
the error terms and the accumulation stay f32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lux_tpu_torch.engine import methods, pull
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.shards import PullShards, build_pull_shards, to_device
from lux_tpu_torch.ops import spmv
from lux_tpu_torch.program import SpecBacked, expr, library
from lux_tpu_torch.utils.device import resolve_device

K = 20
LAMBDA = 1e-3
GAMMA = 3.5e-7

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: The per-edge rating prediction <v_src, v_dst>, "vpu" (multiply + sum
#: over K) or "mxu" (a (rows, K) @ (K, 1) f32 matmul): the function the
#: COLFILTER spec's ``dot_lanes`` evaluates, so both paths share it.
err_dot = expr.dot_lanes


def _resolve_err_dot(mode: str | None) -> str:
    """None follows engine/methods.cf_err_dot_mode (LUX_CF_ERR_DOT, else
    "vpu"); a concrete mode passes through."""
    return methods.cf_err_dot_mode() if mode is None else mode


@dataclasses.dataclass(frozen=True)
class CFProgram(SpecBacked):
    """CF as a named parameter bundle over the declarative spec
    (program.library.COLFILTER): per edge err = rating - <v_src, v_dst>,
    value err * v_src summed by destination, update v += GAMMA * (accErr
    - LAMBDA * v).  ``dtype`` is the state storage dtype ("float32" or
    "bfloat16"); gathers arrive in it, error math and reduce stay f32.
    ``err_dot`` is the error-dot flavor ("vpu" | "mxu")."""

    k: int = K
    lam: float = LAMBDA
    gamma: float = GAMMA
    dtype: str = "float32"
    err_dot: str = "vpu"

    @property
    def spec(self):
        return library.COLFILTER

    def _env(self):
        return {"k": self.k, "lam": self.lam, "gamma": self.gamma,
                "dtype": self.dtype, "err_dot": self.err_dot}


def colfilter(g: HostGraph | PullShards, num_iters: int = 10, num_parts: int = 1,
              k: int = K, lam: float = LAMBDA, gamma: float = GAMMA,
              method: str = "auto", dtype: str = "float32", route=None,
              err_dot: str | None = None, device="cuda") -> np.ndarray:
    """Run CF on the pull engine; returns the (nv, k) latent matrix as
    float32 numpy (a bf16 state is widened on the way out).  ``route``: a
    plan from ops/expand.plan_cf_route_shards (the routed src and dst
    loads).  ``err_dot`` None follows engine/methods.cf_err_dot_mode."""
    dev = resolve_device(device)
    shards = g if isinstance(g, PullShards) else build_pull_shards(g, num_parts)
    if not shards.spec.weighted:
        raise ValueError("CF requires a weighted (rating) graph")
    prog = CFProgram(k=k, lam=lam, gamma=gamma, dtype=dtype,
                     err_dot=_resolve_err_dot(err_dot))
    arrays = to_device(shards.arrays, dev)
    state0 = pull.init_state(prog, arrays)
    final = pull.run_pull_fixed(prog, shards.spec, arrays, state0, num_iters,
                                method=method, route=route, donate=True)
    return shards.scatter_to_global(final.float().cpu().numpy())


def make_pallas_runner(g: HostGraph, k: int = K, lam: float = LAMBDA,
                       gamma: float = GAMMA, v_blk: int | None = None,
                       t_chunk: int | None = None, dtype: str = "float32",
                       err_dot_mode: str | None = None, device="cuda", bc=None):
    """Build the block-CSR layout once (or take ``bc``, one already built
    for ``g``); return (run, state0) where
    run(state, num_iters) iterates, in place on ``state``: gather
    ``s[e_src]`` and ``s[dst]`` (torch ``index_select``) -> err_dot ->
    ``err * src_vec`` -> the 2-D block-CSR SpMV kernel -> update.  State
    lives on ``num_vblocks * v_blk`` rows of width k; only ``[:nv]`` is
    meaningful.  (The name is the reference's: its block-CSR path is a
    Pallas kernel.)"""
    if g.weights is None:
        raise ValueError("CF requires a weighted graph")
    dev = resolve_device(device)
    ed_mode = _resolve_err_dot(err_dot_mode)
    if bc is None:
        bc = spmv.build_blockcsr(g, v_blk=v_blk or spmv.V_BLK,
                                 t_chunk=t_chunk or spmv.T_CHUNK)
    nvp = bc.num_vblocks * bc.v_blk
    shape = bc.e_src_pos.shape
    state0 = np.zeros((nvp, k), np.float32)
    state0[: g.nv] = np.sqrt(1.0 / k)
    e_src = torch.from_numpy(bc.e_src_pos).to(dev).reshape(-1)
    e_dst = torch.from_numpy(bc.e_dst_rel).to(dev)
    w = torch.from_numpy(bc.e_weight).to(dev)
    cb = torch.from_numpy(bc.chunk_block).to(dev)
    cf = torch.from_numpy(bc.chunk_first).to(dev)
    # each slot's destination row in the padded range; padding slots read a
    # real row, harmless because the kernel skips them by e_dst_rel == v_blk
    dst_global = (cb[:, None] * bc.v_blk + e_dst).clamp(0, nvp - 1).reshape(-1)
    gamma32, lam32 = float(np.float32(gamma)), float(np.float32(lam))

    def run(state: torch.Tensor, num_iters: int) -> torch.Tensor:
        for _ in range(num_iters):
            # (C, T, k) f32 gathers; index_select takes the int32 positions
            # as they are (advanced indexing would widen them)
            src_vec = state.index_select(0, e_src).view(*shape, k).float()
            dst_vec = state.index_select(0, dst_global).view(*shape, k).float()
            err = w - err_dot(src_vec, dst_vec, ed_mode)  # (C, T)
            del dst_vec
            vals = src_vec.mul_(err.unsqueeze(-1))  # err * src_vec, in place
            acc = spmv.spmv_blockcsr_2d(vals, e_dst, cb, cf, v_blk=bc.v_blk,
                                        num_vblocks=bc.num_vblocks)
            old = state.float()
            state.copy_(old + gamma32 * (acc - lam32 * old))
        return state

    return run, torch.from_numpy(state0).to(dev).to(_DTYPES[dtype])


def colfilter_pallas(g: HostGraph, num_iters: int = 10, device="cuda",
                     **kw) -> np.ndarray:
    """Single-device CF on the 2-D block-CSR SpMV kernel; returns the
    (nv, k) latent matrix as float32 numpy."""
    run, s0 = make_pallas_runner(g, device=device, **kw)
    return run(s0, num_iters)[: g.nv].float().cpu().numpy()


def colfilter_reference(g: HostGraph, num_iters: int, k: int = K,
                        lam: float = LAMBDA, gamma: float = GAMMA,
                        dtype=np.float32) -> np.ndarray:
    """NumPy oracle of the identical recurrence, in ``dtype`` (float32 as
    the reference's oracle; float64 for a tighter yardstick)."""
    v = np.full((g.nv, k), np.sqrt(1.0 / k), dtype)
    dst = g.dst_of_edges()
    w = g.weights.astype(dtype)
    for _ in range(num_iters):
        src_vec = v[g.col_idx]  # (ne, k)
        dst_vec = v[dst]
        err = w - np.sum(src_vec * dst_vec, axis=-1)
        acc = np.zeros_like(v)
        np.add.at(acc, dst, err[:, None] * src_vec)
        v = v + gamma * (acc - lam * v)
    return v


def rmse(g: HostGraph, v: np.ndarray) -> float:
    """Root-mean-square rating reconstruction error (training metric)."""
    dst = g.dst_of_edges()
    pred = np.sum(v[g.col_idx] * v[dst], axis=-1)
    return float(np.sqrt(np.mean((g.weights - pred) ** 2)))


def init_rmse(g: HostGraph) -> float:
    """Closed-form RMSE of the untrained state: every latent vector is
    sqrt(1/K), so every prediction is exactly K * (1/K) = 1."""
    return float(np.sqrt(np.mean((np.asarray(g.weights, np.float64) - 1.0) ** 2)))


def check_training(g: HostGraph, v: np.ndarray) -> int:
    """Training-progress validation for ``-check`` (the reference's
    extension; Lux ships no CF check): gradient descent must not move the
    float64 training RMSE above the untrained closed form by more than
    1e-4 relative, and the state must stay finite.  At the app's default
    GAMMA the true improvement over a few iterations is tiny, so this
    catches divergence and corruption, not slow progress.  Returns a
    violation count: 1 if the RMSE regressed, plus the non-finite
    entries."""
    v = np.asarray(v)
    bad = int((~np.isfinite(v)).sum())
    if rmse(g, v.astype(np.float64)) > init_rmse(g) * (1 + 1e-4):
        bad += 1
    return bad
