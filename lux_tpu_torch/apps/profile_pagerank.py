"""Device-time breakdown of PageRank, collaborative-filtering, SSSP,
connected-components or k-core runs on the card.

    python -m lux_tpu_torch.apps.profile_pagerank --rmat-scale 20 --rmat-ef 16 \\
        -ni 10 --method pallas [--app colfilter]
    python -m lux_tpu_torch.apps.profile_pagerank --app sssp --rmat-scale 20 \\
        --rmat-ef 16 --method mxscan [--route-gather expand-pf]
    python -m lux_tpu_torch.apps.profile_pagerank --app kcore --rmat-scale 20 \
        --rmat-ef 16 --method mxscan

Takes the app's flags (``--route-gather`` included: its plan is built in
set-up, before any window; and the gather relayouts ``--sort-segments``
and ``--compact-gather``) and ``--app pagerank|colfilter|sssp|components|kcore``
(default pagerank).  PageRank and CF: times ``-ni`` iterations as the
apps do (``apps.common.timed_iterations``), then runs ``-ni`` more under
``torch.profiler``.  SSSP (from ``-start``, else the vertex with the
largest out-degree) and components: times one run to convergence after an
untimed one, as the apps do, counts the host syncs of one more run (CUDA
sync-debug warnings), traces one more under ``torch.profiler``, and runs
the ``-verbose`` phase split once (load, dense and sparse comp, update:
each phase fenced, so their sum exceeds the wall time).  k-core (the
symmetrized view unless ``--directed``): the same for one whole peel,
without the phase split.  Prints one JSON
line: the app's ms per iteration (for the push apps also the run's ms,
iterations, dense rounds, traversed edges and GTEPS), the CUDA kernel time
per iteration from the trace, the device's idle share (1 - traced kernel
time / the app's unprofiled wall time of an equal window; the profiler's
own wall time is inflated by its overhead and is not used), and the
kernels by total device time with their class, as obs/xprof.kernel_table
reads the trace (the classifier ``--profile-dir`` also uses).  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from lux_tpu_torch.apps import colfilter, common, pagerank
from lux_tpu_torch.apps import sssp as sssp_app
from lux_tpu_torch.engine import methods, push
from lux_tpu_torch.models import components as cc_model
from lux_tpu_torch.models import sssp as sssp_model
from lux_tpu_torch.obs import xprof
from lux_tpu_torch.ops import cuda_build, expand
from lux_tpu_torch.utils.config import parse_args
from lux_tpu_torch.utils.device import resolve_device
from lux_tpu_torch.utils.timing import Timer

#: --app -> (its set-up, whether its graph is the weighted rating graph)
APPS = {"pagerank": (pagerank.prepare, False), "colfilter": (colfilter.prepare, True)}
PUSH_APPS = ("sssp", "components")
#: the spec workloads this breakdown runs (apps/run.py's flags)
SPEC_APPS = ("kcore",)


def _trace(fn, dev):
    """The device-time rows of one call of ``fn`` under torch.profiler:
    its chrome trace through obs/xprof.kernel_table (kernels, copies and
    memsets by name, with their class)."""
    with tempfile.TemporaryDirectory() as d:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(dev)
        prof.export_chrome_trace(os.path.join(d, "window.trace.json"))
        return xprof.kernel_table(d)


def _busy_ms(rows) -> float:
    return sum(r["total_ms"] for r in rows)


def _top(rows, n: int) -> list:
    return [{"name": r["name"][:80], "class": r["class"], "ms_per_iter": r["total_ms"] / n,
             "count": r["calls"]} for r in rows[:12]]


def _classes(rows, n: int) -> dict:
    return {k: v / n for k, v in xprof.class_summary(rows).items()}


def _host_syncs(fn) -> int:
    """The synchronizing CUDA calls one call of ``fn`` makes."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def profile_push(app: str, rest: list, dev) -> dict:
    """The push apps' breakdown (see the module docstring)."""
    cfg = parse_args(rest, description=__doc__, push=True, sssp=app == "sssp")
    if cfg.verbose:
        raise SystemExit("profile_pagerank runs the -verbose phase split itself")
    common.resolve_route_auto(cfg)
    g = common.load_graph(cfg, weighted=cfg.weighted)
    shards = sssp_app.build_push_app_shards(g, cfg)
    if app == "sssp":
        given = any(a.split("=", 1)[0] == "-start" for a in rest)
        cfg.start = cfg.start if given else int(np.argmax(g.out_degrees()))
        cls = sssp_model.WeightedSSSPProgram if cfg.weighted else sssp_model.SSSPProgram
        prog = cls(nv=g.nv, start=cfg.start)
    else:
        prog = cc_model.MaxLabelProgram()
    cfg.method = methods.resolve_sum(cfg.method, prog.reduce, "cuda")
    cuda_build.load_all()
    route = common.build_push_route(cfg, shards)
    if route is not None:
        route = expand.plan_to_device(route, dev)
    arrays, parrays, carry0 = push.push_init(prog, shards, dev)

    def converge():
        return push.run_push_chunk(prog, shards.pspec, shards.spec, arrays, parrays,
                                   carry0, cfg.max_iters, cfg.method, route)

    converge()
    timer = Timer(dev)
    out = converge()
    wall_ms = timer.stop() * 1e3
    syncs = _host_syncs(converge)
    kernels = _trace(converge, dev)
    busy_ms = _busy_ms(kernels)
    phases = None
    if route is None:
        _, phases = sssp_app.run_push_verbose(prog, shards, cfg, arrays, parrays,
                                              carry0, dev)
    n = out.it
    return {
        "app": app, "method": cfg.method, "route_gather": cfg.route_gather,
        "start": cfg.start if app == "sssp" else None, "iters": n,
        "dense_rounds": out.dense_rounds, "traversed": out.edges, "nv": g.nv,
        "ne": g.ne, "device": torch.cuda.get_device_name(dev), "ms": wall_ms,
        "gteps": out.edges / wall_ms / 1e6, "ms_per_iter": wall_ms / n,
        "kernel_ms_per_iter": busy_ms / n, "idle_share": 1.0 - busy_ms / wall_ms,
        "host_syncs_per_iter": syncs / n,
        "phase_ms_fenced": None if phases is None else {k: v * 1e3 for k, v in phases.items()},
        "classes_ms_per_iter": _classes(kernels, n), "kernels": _top(kernels, n),
    }


def profile_kcore(rest: list, dev) -> dict:
    """k-core's breakdown: one whole peel, timed after an untimed one."""
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.program import library, workloads
    from lux_tpu_torch.program.spec import bind

    cfg = parse_args(rest, description=__doc__, program=True, prog="kcore")
    g = common.load_graph(cfg)
    g = g if cfg.directed else workloads.symmetrize(g)
    cfg.method = methods.resolve_sum(cfg.method, bind(library.KCORE, kk=1).reduce, "cuda")
    cuda_build.load_all()
    shards = workloads.on_device(build_pull_shards(g, cfg.num_parts), dev)

    def peel():
        return workloads.kcore(shards, kmax=cfg.kmax, max_iters=cfg.max_iters,
                               method=cfg.method, device=dev)

    peel()
    timer = Timer(dev)
    _, k_max, rounds = peel()
    wall_ms = timer.stop() * 1e3
    syncs = _host_syncs(peel)
    kernels = _trace(peel, dev)
    busy_ms = _busy_ms(kernels)
    return {
        "app": "kcore", "method": cfg.method, "k_max": k_max, "rounds": rounds,
        "nv": g.nv, "ne": g.ne, "device": torch.cuda.get_device_name(dev),
        "ms": wall_ms, "gteps": rounds * g.ne / wall_ms / 1e6,
        "ms_per_round": wall_ms / rounds, "kernel_ms_per_round": busy_ms / rounds,
        "idle_ms_per_round": (wall_ms - busy_ms) / rounds,
        "idle_share": 1.0 - busy_ms / wall_ms, "host_syncs_per_round": syncs / rounds,
        "classes_ms_per_round": _classes(kernels, rounds), "kernels": _top(kernels, rounds),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--app", default="pagerank",
                    choices=sorted(APPS) + list(PUSH_APPS) + list(SPEC_APPS))
    ns, rest = ap.parse_known_args(argv)
    if any(a.split("=", 1)[0] == "--profile-dir" for a in rest):
        raise SystemExit("profile_pagerank traces its own window; drop --profile-dir")
    if ns.app in SPEC_APPS:
        dev = resolve_device(parse_args(rest, program=True).device)
        if dev.type != "cuda":
            raise SystemExit("profile_pagerank measures the card; --device cuda")
        print(json.dumps(profile_kcore(rest, dev)), flush=True)
        return 0
    if ns.app in PUSH_APPS:
        dev = resolve_device(parse_args(rest, push=True, sssp=ns.app == "sssp").device)
        if dev.type != "cuda":
            raise SystemExit("profile_pagerank measures the card; --device cuda")
        print(json.dumps(profile_push(ns.app, rest, dev)), flush=True)
        return 0
    cfg = parse_args(rest, description=__doc__, pull=True)
    if cfg.verbose or cfg.ckpt_dir or cfg.ckpt_every:
        raise SystemExit("profile_pagerank times the plain -ni window; drop "
                         "-verbose and the checkpoint flags")
    dev = resolve_device(cfg.device)
    if dev.type != "cuda":
        raise SystemExit("profile_pagerank measures the card; --device cuda")
    prepare, rating = APPS[ns.app]
    common.resolve_route_auto(cfg)
    g = common.load_graph(cfg, weighted=rating, bipartite=rating)
    iterate, state, _ = prepare(cfg, g, dev)
    n = cfg.num_iters
    wall_ms = common.timed_iterations(iterate, state, n, dev) * 1e3
    kernels = _trace(lambda: iterate(state, n), dev)
    busy_ms = _busy_ms(kernels)
    print(json.dumps({
        "app": ns.app, "method": cfg.method, "route_gather": cfg.route_gather,
        "iters": n, "nv": g.nv, "ne": g.ne,
        "device": torch.cuda.get_device_name(dev),
        "ms_per_iter": wall_ms / n, "kernel_ms_per_iter": busy_ms / n,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "classes_ms_per_iter": _classes(kernels, n), "kernels": _top(kernels, n),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
