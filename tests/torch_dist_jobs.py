"""Rank jobs of the distributed-engine tests (tests/test_torch_dist.py,
test_torch_ring.py, test_torch_scatter.py, test_torch_placement.py and
the card test in test_torch_cuda.py).

Each job runs inside a rank spawned by
``lux_tpu_torch.parallel.spawn.run_ranks`` and returns what rank 0 holds
(the assembled global state) or what every rank computed.  This module
imports neither jax nor lux_tpu: a spawned rank imports it by name.
Graphs are small seeded RMATs, generated in each rank from the seed.
"""
from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.engine import pull
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.shards import build_pull_shards, to_device
from lux_tpu_torch.models import colfilter as cf_model
from lux_tpu_torch.models import components
from lux_tpu_torch.models.pagerank import PageRankProgram
from lux_tpu_torch.parallel import dist, multihost, pallas_dist, ring, scatter
from lux_tpu_torch.parallel.mesh import make_parts_group
from lux_tpu_torch.parallel.placement import halo_all_gather, halo_reduce_scatter


def graph(spec):
    """The seeded graph of a case: ("rmat", scale, ef, seed[, weighted])
    or ("cf", scale, ef, seed), the CF rating graph."""
    if spec[0] == "cf":
        _, scale, ef, seed = spec
        n_half = (1 << scale) // 2
        return generate.bipartite_ratings(n_half, n_half, (1 << scale) * ef // 2, seed=seed)
    _, scale, ef, seed, *rest = spec
    return generate.rmat(scale, ef, seed=seed, weighted=bool(rest and rest[0]))


def program(name: str, g, k: int = cf_model.K):
    if name == "pagerank":
        return PageRankProgram(nv=g.nv)
    if name == "cf":
        return cf_model.CFProgram(k=k, gamma=1e-3)
    if name == "maxlabel":
        return components.MaxLabelProgram()
    raise ValueError(name)


def _global(pg, block, layout):
    st = multihost.assemble_global(pg, block)
    return None if st is None else layout.scatter_to_global(st)


def run_case(pg, case: dict):
    """One engine run: ``case`` names the graph, the program, the parts,
    the exchange ("allgather", "until", "phases", "ring", "scatter",
    "pallas"), the method and the iterations.  Returns rank 0's global
    state (None on the others), and for "until" the iterations run."""
    g = graph(case["graph"])
    prog = program(case["prog"], g, case.get("k", cf_model.K))
    P, iters, method = case["parts"], case.get("iters", 5), case.get("method", "scan")
    cpg = make_parts_group(P, pg.device)
    ex = case["exchange"]
    if ex == "pallas":
        pp = pallas_dist.build_pallas_parts(g, P, v_blk=case.get("v_blk"),
                                            t_chunk=case.get("t_chunk"),
                                            parts_subset=list(cpg.parts))
        s0 = pallas_dist.init_state_pallas(prog, pp)
        run = (pallas_dist.run_cf_pallas_dist if prog.needs_dst_state
               else pallas_dist.run_pull_fixed_pallas_dist)
        return _global(cpg, run(prog, pp, s0, iters, cpg), pp)
    if ex in ("ring", "scatter"):
        build = ring.build_ring_shards if ex == "ring" else scatter.build_scatter_shards
        sh = build(g, P, parts_subset=list(cpg.parts))
        s0 = pull.init_state(prog, to_device(sh.arrays, "cpu")).to(pg.device)
        drive = ring.run_pull_fixed_ring if ex == "ring" else scatter.run_pull_fixed_scatter
        return _global(cpg, drive(prog, sh, s0, iters, cpg, method), sh)
    sh = build_pull_shards(g, P)
    s0 = pull.init_state(prog, to_device(sh.arrays, "cpu")).to(pg.device)
    if ex == "until":
        block, it = dist.run_pull_until_dist(prog, sh.spec, sh.arrays, s0, case["max_iters"],
                                             components.active_count, cpg, method)
        return _global(cpg, block, sh), it
    if ex == "phases":
        from lux_tpu_torch.parallel.mesh import shard_stacked

        arrays, block = shard_stacked(cpg, sh.arrays), shard_stacked(cpg, s0)
        load, comp, update = dist.compile_pull_phases_dist(prog, cpg, method)
        for _ in range(iters):
            block = update(arrays, block, comp(arrays, load(arrays, block)))
        return _global(cpg, block, sh)
    return _global(cpg, dist.run_pull_fixed_dist(prog, sh.spec, sh.arrays, s0, iters, cpg,
                                                 method), sh)


def run_cases(pg, cases: dict) -> dict:
    """Every case of ``cases`` ({name: case}) in this rank, in order."""
    return {name: run_case(pg, case) for name, case in cases.items()}


def halo_case(pg, P: int, V: int, F: int, seed: int) -> dict:
    """The halo collectives on seeded blocks: every rank's (k, V, F) block
    is rows [r*k, (r+1)*k) of one (P, V, F) array x; the all-gather must
    give x.reshape(P*V, F) on every rank, and the reduce-scatter of
    per-rank partials (x * (rank + 1)) this rank's rows of their sum."""
    cpg = make_parts_group(P, pg.device)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((P, V, F)).astype(np.float32)
    block = torch.from_numpy(x[cpg.lo:cpg.hi]).to(pg.device)
    gathered = halo_all_gather(block, cpg).cpu().numpy()
    partials = torch.from_numpy(x * (cpg.rank + 1)).to(pg.device)
    reduced = halo_reduce_scatter(partials, cpg.k, cpg).cpu().numpy()
    bf = halo_all_gather(block.to(torch.bfloat16), cpg).float().cpu().numpy()
    ints = halo_all_gather(torch.from_numpy((x * 1000).astype(np.int32)[cpg.lo:cpg.hi])
                           .to(pg.device), cpg).cpu().numpy()
    return {"rank": cpg.rank, "lo": cpg.lo, "hi": cpg.hi, "gathered": gathered,
            "reduced": reduced, "bf16": bf, "int32": ints}


def app_runs(pg, app: str, argvs: list) -> list:
    """``apps.<app>.run(argv)`` for each argv in turn in this rank
    (``--distributed`` joins the group the launcher made); rank 0's state
    and every rank's exit code and iterations."""
    import importlib

    out = []
    for argv in argvs:
        res = importlib.import_module(f"lux_tpu_torch.apps.{app}").run(argv)
        out.append({"state": res.ranks if app == "pagerank" else res.state, "rc": res.rc,
                    "iters": res.iters})
    return out


def fail_on_rank(pg, rank: int):
    """Raise on ``rank`` (the others wait in a collective it never joins)."""
    if pg.rank == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    torch.distributed.barrier()
