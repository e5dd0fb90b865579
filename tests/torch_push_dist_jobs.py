"""Rank jobs of the distributed push tests (tests/test_torch_push_dist.py
and the card test in test_torch_cuda.py).

Each job runs inside a rank spawned by
``lux_tpu_torch.parallel.spawn.run_ranks``.  A case returns rank 0's
global state (None on the other ranks) with the iterations and traversed
edges every rank counted.  This module imports neither jax nor lux_tpu:
a spawned rank imports it by name.  Graphs are small seeded RMATs,
generated in each rank from the seed.
"""
from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.engine import delta, push, repartition
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.push_shards import build_push_shards
from lux_tpu_torch.graph.shards import to_device
from lux_tpu_torch.models import components, sssp
from lux_tpu_torch.parallel import multihost, pallas_dist, ring
from lux_tpu_torch.parallel.mesh import make_parts_group


def graph(spec):
    """("rmat", scale, ef, seed[, weighted]) -> the seeded RMAT."""
    _, scale, ef, seed, *rest = spec
    return generate.rmat(scale, ef, seed=seed, weighted=bool(rest and rest[0]))


def hub(g) -> int:
    """The vertex with the most out-edges (a source that reaches far)."""
    return int(np.argmax(np.bincount(g.col_idx, minlength=g.nv)))


def program(name: str, g):
    """"sssp" / "wsssp" from the hub, "sssp0" from vertex 0, "cc"."""
    if name == "sssp":
        return sssp.SSSPProgram(nv=g.nv, start=hub(g))
    if name == "sssp0":
        return sssp.SSSPProgram(nv=g.nv, start=0)
    if name == "wsssp":
        return sssp.WeightedSSSPProgram(nv=g.nv, start=hub(g))
    if name == "cc":
        return components.MaxLabelProgram()
    raise ValueError(name)


def _global(pg, block, layout):
    st = multihost.assemble_global(pg, block)
    return None if st is None else layout.scatter_to_global(st)


def run_case(pg, case: dict):
    """One engine run.  ``case``: the graph, the program ("sssp", "wsssp",
    "cc"), the parts, the engine ("dist", "ring", "pallas", "delta",
    "adaptive", "phases") and its options.  Returns (rank 0's global
    state or None, iterations, traversed edges)."""
    g = graph(case["graph"])
    prog = program(case["prog"], g)
    P, eng = case["parts"], case["engine"]
    cpg = make_parts_group(P, pg.device)
    method = case.get("method", "scan")
    if eng == "pallas":
        sh = pallas_dist.build_push_pallas_shards(g, P, v_blk=case.get("v_blk"),
                                                  t_chunk=case.get("t_chunk"),
                                                  parts_subset=list(cpg.parts))
        block, it, edges = pallas_dist.run_push_pallas_dist(prog, sh, cpg)
    elif eng == "ring":
        sh = ring.build_push_ring_shards(g, P, parts_subset=list(cpg.parts))
        block, it, edges = push.run_push_ring(prog, sh, cpg, method=method,
                                              merge=case.get("merge"))
    elif eng == "delta":
        sh = build_push_shards(g, P)
        block, it, edges = delta.run_push_delta_dist(prog, sh, case["delta"], cpg,
                                                     method=method)
    elif eng == "adaptive":
        res = repartition.run_push_adaptive(
            prog, g, P, chunk=case["chunk"], threshold=case["threshold"], method=method,
            mesh=cpg, exchange=case["exchange"])
        st = res.state if cpg.rank == 0 else None
        return st, res.iters, res.edges, res.reparts
    elif eng == "phases":
        # the initial carry of every part, placed by shard_carry: the same
        # rows push_init_dist builds
        sh = build_push_shards(g, P)
        arrays, parrays, c0 = push.push_init_dist(prog, sh, cpg)
        full = push._init_carry(prog, sh.pspec, to_device(sh.arrays, "cpu"))
        c = push.shard_carry(cpg, full)
        assert all(torch.equal(a, b) for a, b in zip(c[:4], c0[:4]))
        load, comp, update = push.compile_push_phases_dist(prog, cpg, sh.pspec, sh.spec,
                                                           method)
        while True:
            plan = load(parrays, c)
            if plan.active == 0:
                break
            c = update(arrays, c, comp(arrays, parrays, c, plan), plan)
        block, it, edges = c.state, c.it, c.edges
    else:
        sh = build_push_shards(g, P)
        block, it, edges = push.run_push_dist(prog, sh, cpg, method=method,
                                              merge=case.get("merge"))
    return _global(cpg, block, sh), it, edges


def run_cases(pg, cases: dict) -> dict:
    """Every case of ``cases`` ({name: case}) in this rank, in order."""
    return {name: run_case(pg, case) for name, case in cases.items()}


def run_all(pg, cases: dict, apps: list) -> dict:
    """The engine cases, then the (app, argv) runs, in this rank."""
    return {"cases": run_cases(pg, cases),
            "apps": [app_runs(pg, app, [argv])[0] for app, argv in apps]}


def app_runs(pg, app: str, argvs: list) -> list:
    """``apps.<app>.run(argv)`` for each argv in turn in this rank; rank
    0's state and every rank's exit code, iterations and edges.  An argv
    that exits (a refusal) gives its message instead."""
    import importlib

    out = []
    for argv in argvs:
        try:
            res = importlib.import_module(f"lux_tpu_torch.apps.{app}").run(argv)
        except SystemExit as e:
            out.append({"exit": str(e.code)})
            continue
        out.append({"state": res.state, "rc": res.rc, "iters": res.iters,
                    "edges": res.traversed, "estimate": res.estimate_bytes,
                    "recuts": len(res.recuts or ())})
    return out
