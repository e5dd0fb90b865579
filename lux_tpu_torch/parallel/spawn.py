"""Run a function on W ranks: spawned processes in one torch.distributed
group, joined with a deadline.

The launcher of the tests, ``chip_smoke.py`` and ``tools/biggraph_check``
(the command line uses ``python -m torch.distributed.run``).  Each rank
is a ``spawn``ed process (never ``fork``: CUDA may be up in the parent)
that joins the group through a ``file://`` rendezvous in a private
directory (no port to collide with), calls ``fn(pg, *args)`` with its
``mesh.PartsGroup``, and sends the result, its kernel launch counters
and its exchange seconds back over a pipe.  A rank that fails fails the
run at once: the others are killed and reaped, and its traceback is
raised here.  So is a group that outlives the deadline (a rank hung in a
collective hangs them all).
"""
from __future__ import annotations

import importlib
import multiprocessing
import os
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Union


class RankFailure(RuntimeError):
    """A rank raised, died, or the group passed its deadline."""


def kernel_launches() -> dict:
    """This process's launch counters of the hand-written kernels."""
    from lux_tpu_torch.ops import scan, shuffle, spmv

    out = {"spmv_blockcsr": spmv.spmv_blockcsr.launches,
           "spmv_blockcsr_2d": spmv.spmv_blockcsr_2d.launches,
           "mxscan_segmented": scan.mxscan_segmented.launches}
    out.update({name: k.launches for name, k in shuffle.KERNELS.items()})
    return out


def reset_launches() -> None:
    from lux_tpu_torch.ops import scan, shuffle, spmv

    spmv.spmv_blockcsr.launches = 0
    spmv.spmv_blockcsr_2d.launches = 0
    scan.mxscan_segmented.launches = 0
    for k in shuffle.KERNELS.values():
        k.launches = 0


def _resolve(target):
    if callable(target):
        return target
    mod, _, name = target.partition(":")
    return getattr(importlib.import_module(mod), name)


def _child(conn, rank, world, workdir, target, args, num_parts, device, backend, threads,
           env):
    import torch

    os.environ.update(env or {})
    torch.set_num_threads(threads)
    from lux_tpu_torch.parallel import multihost

    try:
        pg = multihost.initialize(num_parts, device, backend,
                                  init_method="file://" + os.path.join(workdir, "rendezvous"),
                                  rank=rank, world_size=world, local_rank=rank,
                                  local_world=world, quiet=True)
        result = _resolve(target)(pg, *args)
        conn.send(("ok", {"result": result, "launches": kernel_launches(),
                          "times": pg.times.as_dict(), "device": str(pg.device),
                          "backend": pg.backend}))
        multihost.shutdown()
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        conn.close()
        os._exit(1)
    conn.close()


def _stop(procs) -> None:
    started = [p for p in procs if p.pid is not None]
    for p in started:
        if p.is_alive():
            p.kill()
    for p in started:
        p.join(30)


def run_ranks(world: int, target: Union[str, Callable], args: tuple = (), *,
              num_parts: Optional[int] = None, device: str = "cuda",
              backend: Optional[str] = None, deadline_s: float = 300.0,
              threads: int = 1, env: Optional[dict] = None) -> list:
    """Run ``target(pg, *args)`` on ``world`` spawned ranks over
    ``num_parts`` parts (default: one a rank) and return each rank's
    ``{"result", "launches", "times", "device", "backend"}``, in rank
    order.  ``target`` is a top-level function or "module:function" (a
    spawned process imports it); the ranks run on the card unless
    ``device="cpu"``; ``backend`` as multihost.initialize takes it;
    ``env`` is set in every rank before it starts.  Raises RankFailure
    when a rank fails or ``deadline_s`` passes, after every rank is
    killed and reaped."""
    workdir = tempfile.mkdtemp(prefix="lux_ranks_")
    ctx = multiprocessing.get_context("spawn")
    pipes = [ctx.Pipe(duplex=False) for _ in range(world)]
    procs = [ctx.Process(target=_child, name=f"lux-rank-{r}",
                         args=(pipes[r][1], r, world, workdir, target, args,
                               num_parts or world, device, backend, threads, env))
             for r in range(world)]
    got = {}
    try:
        for p in procs:
            p.start()
        for _, w in pipes:
            w.close()  # the children hold the write ends
        deadline = time.monotonic() + deadline_s
        while len(got) < world:
            for r, (rd, _) in enumerate(pipes):
                if r not in got and rd.poll():
                    try:
                        got[r] = rd.recv()
                    except EOFError:
                        got[r] = ("error", "(the rank exited without a result)")
            errors = {r: v for r, v in got.items() if v[0] == "error"}
            dead = [r for r, p in enumerate(procs)
                    if r not in got and p.exitcode not in (None, 0)]
            if errors or dead:
                _stop(procs)
                raise RankFailure("\n".join(
                    [f"rank {r} failed:\n{v[1]}" for r, v in sorted(errors.items())]
                    + [f"rank {r} exited {procs[r].exitcode}" for r in dead]))
            if time.monotonic() > deadline:
                _stop(procs)
                raise RankFailure(f"{world} ranks passed their {deadline_s:g} s deadline "
                                  f"({len(got)} done)")
            time.sleep(0.01)
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        return [got[r][1] for r in range(world)]
    finally:
        _stop(procs)
        for rd, _ in pipes:
            rd.close()
        shutil.rmtree(workdir, ignore_errors=True)
