"""Big graph from disk on one card: the file-based pipeline that users of
Lux drive with graphs such as Twitter-2010 (partial per-part reads).

    python -m lux_tpu_torch.tools.biggraph_check --scale 24 --parts 8
    python -m lux_tpu_torch.tools.biggraph_check --scale 12 --parts 4 --device cpu

Counterpart of the one-card part of the reference's
``tools/biggraph_check.py``.  Generates an RMAT ``--scale`` / ``--ef``
`.lux` file once (``--file``, default under the temporary directory;
about 1.1 GB at scale 24), written by the native counting sort, then:

  1. the streaming out-degree scan (native histogram per chunk),
  2. ``graph/sharded_load.load_pull_shards`` of a ``parts_subset`` (two
     parts) and of all ``--parts`` parts (preads through the native
     library),
  3. the allgather preflight: the memory estimate of ``--parts`` parts
     resident on the card, beside the card's memory,
  4. PageRank (``--iters`` iterations, ``--method``) with the parts stacked
     on the card (``-ng``), timed after an untimed run,
  5. PageRank over the ring and reduce_scatter exchanges (the
     reference's legs): ``--ranks`` ranks (parallel/spawn.run_ranks;
     LUX_DIST_BACKEND, gloo unless set: the ranks share the card), each
     loading only its parts' byte ranges and building only their
     buckets, timed after an untimed run and held to step 4's ranks
     (rtol 1e-4),
  6. the push layout and SSSP from the largest out-degree to
     convergence, timed after an untimed run; with ``--sssp-exchange
     ring`` also the ring push over ``--ranks`` ranks (each building only
     its parts' buckets), timed after an untimed run and held bitwise to
     the one-card distances,

printing one JSON line a step with the host's peak RSS and the card's
peak allocated bytes so far.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time


def rss_gib() -> float:
    """Peak RSS of this process so far, GiB (ru_maxrss is KiB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="big graph from disk on one card")
    ap.add_argument("--scale", type=int, default=24)
    ap.add_argument("--ef", type=int, default=16)
    ap.add_argument("--parts", type=int, default=8, help="parts stacked on the card (-ng)")
    ap.add_argument("--iters", type=int, default=10, help="PageRank iterations")
    ap.add_argument("--method", default="mxscan", help="segment-reduction method")
    ap.add_argument("--file", default=None, help=".lux path (default: the temporary "
                                                 "directory; generated when missing)")
    ap.add_argument("--skip-sssp", action="store_true")
    ap.add_argument("--sssp-exchange", default="allgather", choices=["allgather", "ring"],
                    help="ring: also run SSSP on the ring push over --ranks ranks")
    ap.add_argument("--ranks", type=int, default=2,
                    help="ranks of the ring and reduce_scatter legs (--parts must be a "
                         "multiple); their backend is LUX_DIST_BACKEND, gloo unless "
                         "set (ranks that share a card)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from lux_tpu_torch.engine import pull as pull_eng
    from lux_tpu_torch.engine import push
    from lux_tpu_torch.graph import format as fmt
    from lux_tpu_torch.graph import generate, sharded_load
    from lux_tpu_torch.graph.push_shards import build_push_shards
    from lux_tpu_torch.graph.shards import to_device
    from lux_tpu_torch.models.pagerank import PageRankProgram
    from lux_tpu_torch.models.sssp import SSSPProgram, inf_value
    from lux_tpu_torch.native import io as native_io
    from lux_tpu_torch.ops import cuda_build
    from lux_tpu_torch.utils import preflight
    from lux_tpu_torch.utils.device import resolve_device
    from lux_tpu_torch.utils.timing import Timer

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    t_all = time.monotonic()

    def note(step, **kw):
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        print(json.dumps({"step": step, "rss_gib": round(rss_gib(), 3),
                          "device_peak_bytes": peak, "t_s": round(time.monotonic() - t_all, 3),
                          **kw}), flush=True)

    note("start", host_io=native_io.host_path(),
         device=torch.cuda.get_device_name(dev) if cuda else "cpu")
    path = args.file or os.path.join(tempfile.gettempdir(),
                                     f"lux_rmat{args.scale}_ef{args.ef}.lux")
    if not os.path.exists(path):
        t0 = time.monotonic()
        g = generate.rmat(args.scale, args.ef, seed=0)
        gen_s = time.monotonic() - t0
        t0 = time.monotonic()
        how = fmt.write_lux_edges(path, g.nv, g.col_idx, g.dst_of_edges())
        note("written", nv=g.nv, ne=g.ne, generate_s=gen_s,
             write_s=time.monotonic() - t0, host_io=how,
             file_gib=os.path.getsize(path) / (1 << 30))
        del g
    else:
        note("reusing", file=path, file_gib=os.path.getsize(path) / (1 << 30))

    P = args.parts
    header = fmt.read_lux(path, mmap=True)
    nv, ne = header.nv, header.ne
    t0 = time.monotonic()
    degrees = sharded_load.out_degrees_from_file(path, header=header)
    note("degree_scan", scan_s=time.monotonic() - t0, host_io=native_io.host_path())

    t0 = time.monotonic()
    sub = sharded_load.load_pull_shards(path, P, parts_subset=[0, 1], degrees=degrees)
    sub_bytes = sum(a.nbytes for a in sub.arrays)
    note("subset_load", parts=2, of=P, bytes=sub_bytes, load_s=time.monotonic() - t0,
         host_io=sub.host_io)
    del sub

    t0 = time.monotonic()
    shards = sharded_load.load_pull_shards(path, P, degrees=degrees)
    full_bytes = sum(a.nbytes for a in shards.arrays)
    note("full_load", parts=P, bytes=full_bytes, load_s=time.monotonic() - t0,
         subset_frac=sub_bytes / full_bytes, host_io=shards.host_io)

    est = preflight.scale_residency(preflight.estimate_pull(shards.spec, method=args.method), P)
    fits = preflight.check_fits(est, device=dev)
    note("preflight", exchange="allgather", estimate_bytes=est.total_bytes, fits=fits,
         device_bytes=torch.cuda.get_device_properties(dev).total_memory if cuda else None)

    if cuda:
        cuda_build.load_all()
    prog = PageRankProgram(nv=nv)
    arrays = to_device(shards.arrays, dev)
    state0 = pull_eng.init_state(prog, arrays)
    run = lambda: pull_eng.run_pull_fixed(prog, shards.spec, arrays, state0,  # noqa: E731
                                          args.iters, args.method)
    run()
    timer = Timer(dev)
    out = run()
    secs = timer.stop()
    ranks = shards.scatter_to_global(out.cpu().numpy())
    note("pagerank", parts=P, iters=args.iters, method=args.method, seconds=secs,
         ms_per_iter=secs * 1e3 / args.iters, gteps=args.iters * ne / secs / 1e9,
         finite=bool(np.isfinite(ranks).all()), top_rank=float(ranks.max()))
    del arrays, state0, out, shards
    if cuda:
        torch.cuda.empty_cache()

    from lux_tpu_torch.parallel import multihost, spawn

    backend = os.environ.get(multihost.BACKEND_ENV, "").strip() or "gloo"
    for kind in ("ring", "scatter"):
        res = spawn.run_ranks(args.ranks, "lux_tpu_torch.tools.biggraph_check:exchange_leg",
                              (path, P, kind, args.iters), num_parts=P, device=args.device,
                              backend=backend, deadline_s=3000.0, threads=4,
                              env={multihost.BACKEND_ENV: backend})
        lead = res[0]["result"]
        rel = float(np.max(np.abs(lead["ranks"].astype(np.float64) - ranks)
                           / np.maximum(np.abs(ranks), 1e-30)))
        note(f"pagerank_{kind}", parts=P, ranks=args.ranks, backend=backend,
             k_resident=P // args.ranks, build_s=lead["build_s"],
             estimate_bytes=lead["estimate_bytes"], bucket_pad=lead["bucket_pad"],
             seconds=lead["seconds"], ms_per_iter=lead["seconds"] * 1e3 / args.iters,
             gteps=args.iters * ne / lead["seconds"] / 1e9, split=lead["split"],
             max_rel_err_vs_allgather=rel, agrees=rel <= 1e-4)
        if rel > 1e-4:
            print(f"pagerank over {kind} differs from the allgather run by {rel}",
                  file=sys.stderr)
            return 1

    if not args.skip_sssp:
        t0 = time.monotonic()
        psh = build_push_shards(header, P)
        pest = preflight.scale_residency(preflight.estimate_push(psh.spec, psh.pspec), P)
        note("push_built", build_s=time.monotonic() - t0, host_io=psh.host_io,
             estimate_bytes=pest.total_bytes)
        start = int(np.argmax(degrees))
        sprog = SSSPProgram(nv=nv, start=start)
        arrays, parrays = push.place(psh, dev)
        carry0 = push._init_carry(sprog, psh.pspec, arrays)
        converge = lambda: push.run_push_chunk(  # noqa: E731
            sprog, psh.pspec, psh.spec, arrays, parrays, carry0, 10_000, args.method)
        converge()
        timer = Timer(dev)
        res = converge()
        secs = timer.stop()
        dist = psh.scatter_to_global(res.state.cpu().numpy())
        note("sssp", start=start, iters=res.it, dense_rounds=res.dense_rounds,
             traversed=res.edges, seconds=secs, gteps=res.edges / secs / 1e9,
             reached=int((dist < inf_value(nv)).sum()))
        if args.sssp_exchange == "ring":
            del arrays, parrays, carry0, res, psh
            if cuda:
                torch.cuda.empty_cache()
            got = spawn.run_ranks(args.ranks, "lux_tpu_torch.tools.biggraph_check:sssp_ring_leg",
                                  (path, P, start), num_parts=P, device=args.device,
                                  backend=backend, deadline_s=3000.0, threads=4,
                                  env={multihost.BACKEND_ENV: backend})
            lead = got[0]["result"]
            same = bool(np.array_equal(lead["dist"], dist))
            note("sssp_ring", parts=P, ranks=args.ranks, backend=backend,
                 k_resident=P // args.ranks, build_s=lead["build_s"],
                 estimate_bytes=lead["estimate_bytes"], bucket_pad=lead["bucket_pad"],
                 iters=lead["iters"], traversed=lead["edges"], seconds=lead["seconds"],
                 gteps=lead["edges"] / lead["seconds"] / 1e9, bitwise_one_card=same)
            if not same:
                print("sssp over the ring differs from the one-card run", file=sys.stderr)
                return 1
    note("done")
    return 0


def sssp_ring_leg(pg, path: str, parts: int, start: int) -> dict:
    """One rank of the ring push leg: the push layout with this rank's
    buckets, the ring estimate against its device, an untimed run, then a
    timed one (the ranks lined up by a barrier).  Rank 0 returns the
    distances and the timings."""
    import torch

    from lux_tpu_torch.engine import push
    from lux_tpu_torch.graph import format as fmt
    from lux_tpu_torch.models.sssp import SSSPProgram
    from lux_tpu_torch.ops import cuda_build
    from lux_tpu_torch.parallel.ring import build_push_ring_shards
    from lux_tpu_torch.utils import preflight
    from lux_tpu_torch.utils.timing import Timer

    header = fmt.read_lux(path, mmap=True)
    t0 = time.monotonic()
    sh = build_push_ring_shards(header, parts, parts_subset=list(pg.parts))
    build_s = time.monotonic() - t0
    est = preflight.scale_residency(
        preflight.estimate_push_ring(sh.spec, sh.pspec, sh.e_bucket_pad), pg.k)
    preflight.check_fits(est, device=pg.device)
    if pg.device.type == "cuda":
        cuda_build.load_all()
    prog = SSSPProgram(nv=header.nv, start=start)
    lay = push.place_layout(prog, sh, pg, "scatter")
    carry0 = lay.init()
    lay.loop(carry0, 10_000)
    pg.barrier()
    timer = Timer(pg.device)
    out = lay.loop(carry0, 10_000)
    seconds = timer.stop()
    dist = lay.read(out.state)
    if pg.device.type == "cuda":
        torch.cuda.synchronize()
    return {"dist": dist, "iters": out.it,
            "edges": out.edges, "seconds": seconds, "build_s": build_s,
            "estimate_bytes": est.total_bytes, "bucket_pad": sh.e_bucket_pad}


def exchange_leg(pg, path: str, parts: int, kind: str, iters: int) -> dict:
    """One rank of a distributed PageRank leg: this rank's parts of the
    file (byte-range loads, its buckets only), the memory estimate against
    its device, an untimed run, then a timed one (the ranks lined up by a
    barrier).  Rank 0 returns the ranks and the timings."""
    import torch

    from lux_tpu_torch.apps import common
    from lux_tpu_torch.graph import format as fmt
    from lux_tpu_torch.models.pagerank import PageRankProgram
    from lux_tpu_torch.utils.config import RunConfig

    header = fmt.read_lux(path, mmap=True)
    cfg = RunConfig(file=path, num_parts=parts, num_iters=iters, method="scan",
                    distributed=True, exchange=kind, device=pg.device.type)
    prog = PageRankProgram(nv=header.nv)
    t0 = time.monotonic()
    ds, state = common.setup_dist(cfg, header, pg.device, prog)
    build_s = time.monotonic() - t0
    est = common.estimate_dist(ds.layout, cfg, ds.pg)
    seconds = common.timed_iterations(ds.iterate, state, iters, ds.pg.device, ds.pg.barrier)
    split = ds.exchange_split(state, iters)
    ranks = ds.read(state)
    if pg.device.type == "cuda":
        torch.cuda.synchronize()
    return {"ranks": ranks, "seconds": seconds, "build_s": build_s, "split": split,
            "estimate_bytes": est.total_bytes, "bucket_pad": ds.layout.e_bucket_pad}


if __name__ == "__main__":
    sys.exit(main())
