"""Rank jobs of the 2-D mesh and workload mesh tests
(tests/test_torch_edge2d.py, test_torch_feat.py and the mesh cases of
test_torch_workloads.py).

Each job runs inside a rank spawned by
``lux_tpu_torch.parallel.spawn.run_ranks`` and returns what the grid's lead
rank assembles (None on the others).  This module imports neither jax nor
lux_tpu: a spawned rank imports it by name.  Graphs are small seeded
graphs, generated in each rank from the seed.
"""
from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.engine import pull
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.shards import build_pull_shards
from lux_tpu_torch.models import colfilter as cf_model
from lux_tpu_torch.models import components
from lux_tpu_torch.models.pagerank import PageRankProgram
from lux_tpu_torch.parallel import edge2d, feat, ring
from lux_tpu_torch.parallel.mesh import make_grid, make_parts_group
from lux_tpu_torch.program import workloads as wl


def graph(spec):
    """("rmat", scale, ef, seed[, weighted]) or ("cf", users, items,
    ratings, seed)."""
    if spec[0] == "cf":
        _, users, items, ratings, seed = spec
        return generate.bipartite_ratings(users, items, ratings, seed=seed)
    _, scale, ef, seed, *rest = spec
    return generate.rmat(scale, ef, seed=seed, weighted=bool(rest and rest[0]))


def program(case: dict, g):
    name = case["prog"]
    if name == "pagerank":
        return PageRankProgram(nv=g.nv, dtype=case.get("dtype", "float32"))
    if name == "maxlabel":
        return components.MaxLabelProgram()
    if name == "bfs":
        return wl.bfs_program(g.nv, case["sources"])
    if name == "cf":
        return cf_model.CFProgram(gamma=case.get("gamma", 1e-3),
                                  dtype=case.get("dtype", "float32"))
    raise ValueError(name)


def _vertex_view(a):
    return type(a)(*(torch.from_numpy(np.ascontiguousarray(x)) for x in a))


def edge2d_case(case: dict):
    """One run of the edge-sharded drivers: this rank builds only its own
    (part, chunk); the initial state comes from the full build's vertex
    arrays.  Returns (the lead rank's (nv, ...) state or None, iterations
    for "until" runs)."""
    g = graph(case["graph"])
    prog = program(case, g)
    P, EP = case["parts"], case["shards"]
    grid = make_grid(P, EP, "edge", "cpu")
    mine = edge2d.build_edge2d_shards(g, P, EP, parts_subset=[grid.parts.rank],
                                      chunks_subset=[grid.index])
    s0 = pull.init_state(prog, _vertex_view(mine.arrays))
    method = case.get("method", "scan")
    if case.get("until"):
        active = (components.active_count if case["prog"] == "maxlabel"
                  else wl.active_changed_scalar)
        block, it = edge2d.run_pull_until_2d(prog, mine, s0, case.get("max_iters", 200),
                                             active, grid, method)
    else:
        block, it = edge2d.run_pull_fixed_2d(prog, mine, s0, case.get("iters", 5), grid,
                                             method), None
    st = edge2d.assemble_global(grid, block)
    return (None if st is None else mine.scatter_to_global(st)), it


def feat_case(case: dict):
    """One run of the feature-sharded CF: over the allgather (this rank's
    parts of the pull layout) or over the ring (its parts' buckets).
    Returns the lead rank's (nv, K) state, or None."""
    g = graph(case["graph"])
    prog = program(case, g)
    P, F = case["parts"], case["shards"]
    grid = make_grid(P, F, "feat", "cpu")
    sh = build_pull_shards(g, P)
    # a stacked (P, V, K) state handed in (the reference's), or the
    # program's initial block built on the rank
    s0 = case.get("state0")
    if s0 is None:
        s0 = feat.init_state_feat(prog, sh.arrays, grid)
    method = case.get("method", "scan")
    if case.get("ring"):
        rs = ring.build_ring_shards(g, P, parts_subset=list(grid.parts.parts), pull=sh)
        block = feat.run_cf_feat_ring(prog, rs, s0, case.get("iters", 4), grid, method)
    else:
        block = feat.run_cf_feat_dist(prog, sh.spec, sh.arrays, s0, case.get("iters", 4),
                                      grid, method)
    st = feat.assemble_global(grid, block)
    return None if st is None else sh.scatter_to_global(st)


def workload_case(pg, case: dict):
    """A spec workload over the ranks (program/workloads with mesh=):
    bfs over the allgather or ring push or the pull-until engine, kcore,
    labelprop.  Every rank holds the global result; rank 0 returns it."""
    g = graph(case["graph"])
    if case.get("symmetrize"):
        g = wl.symmetrize(g)
    P, method = case["parts"], case.get("method", "scan")
    mesh = make_parts_group(P, pg.device)
    name = case["prog"]
    if name == "bfs":
        out = wl.bfs(g, case["sources"], num_parts=P, method=method, mesh=mesh,
                     engine=case.get("engine", "push"),
                     exchange=case.get("exchange", "allgather"))
    elif name == "kcore":
        out = wl.kcore(g, kmax=case.get("kmax", 0), num_parts=P, method=method, mesh=mesh)
    else:
        out = wl.labelprop(g, labels=case["labels"], stride=case["stride"],
                           num_iters=case["iters"], num_parts=P, method=method, mesh=mesh)
    return out if pg.rank == 0 else None


def app_case(pg, case: dict) -> dict:
    """``apps.<app>.run(argv)`` in this rank (``--distributed`` joins the
    group the launcher made): rank 0's state, every rank's exit code."""
    import importlib

    res = importlib.import_module(f"lux_tpu_torch.apps.{case['app']}").run(case["argv"])
    state = res.ranks if case["app"] == "pagerank" else res.state
    return {"state": state if pg.rank == 0 else None, "rc": res.rc, "iters": res.iters,
            "stats": getattr(res, "stats", None)}


def run_cases(pg, cases: dict) -> dict:
    """Every case of ``cases`` ({name: case}) in this rank, in order."""
    out = {}
    for name, case in cases.items():
        kind = case["kind"]
        if kind == "workload":
            out[name] = workload_case(pg, case)
        elif kind == "app":
            out[name] = app_case(pg, case)
        else:
            out[name] = {"edge2d": edge2d_case, "feat": feat_case}[kind](case)
    return out
