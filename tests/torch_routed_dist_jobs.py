"""Rank jobs of the routed distributed tests (tests/test_torch_routed_dist.py).

Each job runs inside a rank spawned by
``lux_tpu_torch.parallel.spawn.run_ranks``.  A case runs one engine twice
on the same layout, routed (``--route-gather``'s plan, this rank's rows
only) and direct, and returns both global results from rank 0 (None on
the others) with every rank's plan-cache counts.  This module imports
neither jax nor lux_tpu: a spawned rank imports it by name.  Graphs are
small seeded graphs, generated in each rank from the seed.
"""
from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.engine import pull, push
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.push_shards import build_push_shards
from lux_tpu_torch.graph.shards import build_pull_shards, to_device
from lux_tpu_torch.models import colfilter as cf_model
from lux_tpu_torch.models import components
from lux_tpu_torch.models.pagerank import PageRankProgram
from lux_tpu_torch.models.sssp import SSSPProgram
from lux_tpu_torch.ops import expand as E
from lux_tpu_torch.parallel import dist, edge2d, feat, multihost, ring, scatter
from lux_tpu_torch.parallel.mesh import make_grid, make_parts_group
from lux_tpu_torch.program import workloads as wl


def graph(spec):
    """("rmat", scale, ef, seed) or ("cf", users, items, ratings, seed)."""
    if spec[0] == "cf":
        _, users, items, ratings, seed = spec
        return generate.bipartite_ratings(users, items, ratings, seed=seed)
    _, scale, ef, seed = spec
    return generate.rmat(scale, ef, seed=seed)


def program(case: dict, g):
    name = case["prog"]
    if name == "pagerank":
        return PageRankProgram(nv=g.nv)
    if name == "maxlabel":
        return components.MaxLabelProgram()
    if name == "sssp":
        return SSSPProgram(nv=g.nv, start=case["start"])
    if name == "cf":
        return cf_model.CFProgram(k=case.get("k", 8), gamma=1e-3)
    raise ValueError(name)


def _view(a):
    return type(a)(*(torch.from_numpy(np.ascontiguousarray(x)) for x in a))


def pull_plan(sh, prog, mode: str, pg, cache_dir=None):
    """This rank's rows of the ``mode`` plan of the pull layout ``sh``,
    through the cached planners when ``cache_dir`` is given; the fused
    modes plan against the template agreed over the ranks."""
    rows = list(pg.parts)
    pf = mode.endswith(("-pf", "-mx"))
    if mode.startswith("fused"):
        template = dist.agree_template(pg, E._group_template(sh.arrays, rows))
        mx = True if mode == "fused-mx" else False
        if cache_dir:
            return E.plan_fused_shards_cached(sh, prog.reduce, cache_dir=cache_dir, pf=pf,
                                              mx=mx, rows=rows, template=template)
        return E.plan_fused_shards(sh, prog.reduce, pf=pf, mx=mx, rows=rows,
                                   template=template)
    if getattr(prog, "k", 1) > 1:
        if cache_dir:
            return E.plan_cf_route_shards_cached(sh, cache_dir=cache_dir, pf=pf, rows=rows)
        return E.plan_cf_route_shards(sh, pf=pf, rows=rows)
    if cache_dir:
        return E.plan_expand_shards_cached(sh, cache_dir=cache_dir, pf=pf, rows=rows)
    return E.plan_expand_shards(sh, pf=pf, rows=rows)


def _global(pg, block, layout):
    st = multihost.assemble_global(pg, block)
    return None if st is None else layout.scatter_to_global(st)


def pull_case(pg, case: dict) -> dict:
    """A 1-D pull exchange (allgather, ring, scatter), routed and direct."""
    g = graph(case["graph"])
    prog = program(case, g)
    P, iters, method = case["parts"], case.get("iters", 4), case.get("method", "scan")
    cpg = make_parts_group(P, pg.device)
    ex, cache_dir = case["exchange"], case.get("cache_dir")
    if ex in ("ring", "scatter"):
        build = ring.build_ring_shards if ex == "ring" else scatter.build_scatter_shards
        sh = build(g, P, parts_subset=list(cpg.parts))
        if ex == "ring":
            plan = (E.plan_ring_route_shards_cached(sh, cache_dir=cache_dir) if cache_dir
                    else E.plan_ring_route_shards(sh))
        else:
            plan = (E.plan_scatter_route_shards_cached(sh, cache_dir=cache_dir) if cache_dir
                    else E.plan_scatter_route_shards(sh))
        s0 = pull.init_state(prog, to_device(sh.arrays, "cpu"))
        drive = ring.run_pull_fixed_ring if ex == "ring" else scatter.run_pull_fixed_scatter
        out = {m: drive(prog, sh, s0, iters, cpg, method, route=r)
               for m, r in (("routed", plan), ("direct", None))}
    else:
        sh = build_pull_shards(g, P)
        plan = pull_plan(sh, prog, case["mode"], cpg, cache_dir)
        s0 = pull.init_state(prog, to_device(sh.arrays, "cpu"))
        out = {m: dist.run_pull_fixed_dist(prog, sh.spec, sh.arrays, s0, iters, cpg, method,
                                           route=r)
               for m, r in (("routed", plan), ("direct", None))}
    res = {m: _global(cpg, b, sh) for m, b in out.items()}
    res["plan_rows"] = int(plan[1][0].shape[0])
    return res


def push_case(pg, case: dict) -> dict:
    """The distributed push over the allgather (expand plans of the pull
    layout) or the ring (bucket plans), routed and direct: rank 0's
    (state, iterations, traversed edges) of each."""
    g = graph(case["graph"])
    prog = program(case, g)
    P, method = case["parts"], case.get("method", "scan")
    cpg = make_parts_group(P, pg.device)
    if case["exchange"] == "ring":
        sh = ring.build_push_ring_shards(g, P, parts_subset=list(cpg.parts))
        plan = E.plan_ring_route_shards(sh)
        drive = push.run_push_ring
    else:
        sh = build_push_shards(g, P)
        plan = E.plan_expand_shards(sh.pull, pf=case.get("pf", False), rows=list(cpg.parts))
        drive = push.run_push_dist
    out = {}
    for m, r in (("routed", plan), ("direct", None)):
        st, it, edges = drive(prog, sh, cpg, method=method, route=r)
        out[m] = (_global(cpg, st, sh), int(it), int(edges))
    return out


def bfs_case(pg, case: dict) -> dict:
    """bfs on the push engine over the ranks (program/workloads, mesh=),
    routed and direct: rank 0's (distances, iterations)."""
    g = graph(case["graph"])
    P = case["parts"]
    mesh = make_parts_group(P, pg.device)
    sh = build_push_shards(g, P)
    plan = E.plan_expand_shards(sh.pull, rows=list(mesh.parts))
    out = {m: wl.bfs(sh, case["sources"], num_parts=P, method="scan", mesh=mesh, route=r)
           for m, r in (("routed", plan), ("direct", None))}
    return out if pg.rank == 0 else None


def edge2d_case(pg, case: dict) -> dict:
    """PageRank on the (parts x edge) grid, each rank building and
    planning its own cell, routed and direct."""
    g = graph(case["graph"])
    prog = program(case, g)
    P, EP = case["parts"], case["shards"]
    grid = make_grid(P, EP, "edge", pg.device)
    mine = edge2d.build_edge2d_shards(g, P, EP, parts_subset=[grid.parts.rank],
                                      chunks_subset=[grid.index])
    plan = E.plan_edge2d_route_shards(mine)
    s0 = pull.init_state(prog, _view(mine.arrays))
    out = {}
    for m, r in (("routed", plan), ("direct", None)):
        block = edge2d.run_pull_fixed_2d(prog, mine, s0, case.get("iters", 4), grid, "scan",
                                         route=r)
        st = edge2d.assemble_global(grid, block)
        out[m] = None if st is None else mine.scatter_to_global(st)
    return out


def feat_case(pg, case: dict) -> dict:
    """CF on the (parts x feat) grid over the allgather, routed (the CF
    plans of this rank's part rows) and direct."""
    g = graph(case["graph"])
    prog = program(case, g)
    P, F = case["parts"], case["shards"]
    grid = make_grid(P, F, "feat", pg.device)
    sh = build_pull_shards(g, P)
    plan = E.plan_cf_route_shards(sh, rows=list(grid.parts.parts))
    s0 = feat.init_state_feat(prog, sh.arrays, grid)
    out = {}
    for m, r in (("routed", plan), ("direct", None)):
        block = feat.run_cf_feat_dist(prog, sh.spec, sh.arrays, s0, case.get("iters", 3),
                                      grid, "scan", route=r)
        st = feat.assemble_global(grid, block)
        out[m] = None if st is None else sh.scatter_to_global(st)
    return out


def app_case(pg, case: dict) -> dict:
    """``apps.<app>.run(argv)`` in this rank: rank 0's state, every rank's
    exit code, iterations and plan-cache counts."""
    import importlib

    E.reset_plan_stats()
    res = importlib.import_module(f"lux_tpu_torch.apps.{case['app']}").run(case["argv"])
    state = res.ranks if case["app"] == "pagerank" else res.state
    return {"state": state if pg.rank == 0 else None, "rc": res.rc, "iters": res.iters,
            "edges": getattr(res, "traversed", None), "plans": E.plan_stats_snapshot()}


def agree_case(pg, case: dict) -> dict:
    """A plan that fails on one rank (``case["fails_on"]``): the fused
    template's all-reduce and the planned-or-not agreement each make
    every rank fail alike instead of leaving the others in the next
    collective.  Returns what each step raised on this rank."""
    from lux_tpu_torch.apps import common

    cpg = make_parts_group(pg.world, pg.device)
    bad = pg.rank == case["fails_on"]
    out = {}
    try:
        dist.agree_template(cpg, None if bad else {3: 1})
        out["template"] = "agreed"
    except RuntimeError as e:
        out["template"] = str(e)
    try:
        common._agree_planned(RuntimeError("no plan here") if bad else None)
        out["planned"] = "agreed"
    except SystemExit as e:
        out["planned"] = str(e)
    out["after"] = dist.agree_template(cpg, {1: pg.rank + 1, 5: 2})
    return out


KINDS = {"agree": agree_case, "pull": pull_case, "push": push_case, "bfs": bfs_case, "edge2d": edge2d_case,
         "feat": feat_case, "app": app_case}


def run_cases(pg, cases: dict) -> dict:
    """Every case of ``cases`` ({name: case}) in this rank, in order, each
    with this rank's plan-cache counts."""
    out = {}
    for name, case in cases.items():
        E.reset_plan_stats()
        res = KINDS[case["kind"]](pg, case)
        if isinstance(res, dict) and case["kind"] != "app":
            res["plans"] = E.plan_stats_snapshot()
        out[name] = res
    return out
