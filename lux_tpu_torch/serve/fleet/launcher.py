"""Process launcher for fleet and pod workers.

Counterpart of ``lux_tpu.serve.fleet.launcher``.  The port's workers are
CUDA processes: each gets ``--device`` (default ``cuda``) and inherits
``CUDA_VISIBLE_DEVICES``; nothing here moves a worker to the CPU.  Before
the first CUDA worker starts, the parent builds every kernel library once
(``ops/cuda_build.build_all``), so N workers do not each pay nvcc's time.

Workers start as ``python -m lux_tpu_torch.serve.fleet.worker`` (or
``.pod``) subprocesses with PRIVATE tmpdirs, found by parsing the one
READY JSON line each entrypoint prints.  Nothing is shared between processes but
the loopback sockets (and the card).

Stdlib only (the subprocesses import torch; the launcher imports it only
to build the kernels before CUDA workers start).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from typing import Dict, List, Optional, Sequence


class LaunchError(RuntimeError):
    pass


class ProcHandle:
    """One launched worker process: identity, address, and teardown."""

    def __init__(self, proc: subprocess.Popen, worker_id: str,
                 port: int, pid: int, tmpdir: Optional[str],
                 ready: dict):
        self.proc = proc
        self.worker_id = str(worker_id)
        self.port = int(port)
        self.pid = int(pid)
        self.tmpdir = tmpdir
        self.ready = ready  # the full READY line (delta_generation etc)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        """SIGKILL: the fault-drill shape — no flush, no goodbye."""
        try:
            if self.alive():
                self.proc.kill()
            self.proc.wait(timeout=30.0)
        finally:
            # wait() raising TimeoutExpired (an unreapable child) must
            # not leak the private tmpdir on top of the stuck process
            self._cleanup()

    def terminate(self, timeout_s: float = 30.0) -> int:
        """SIGTERM + wait (the entrypoints translate it to a clean
        stop); escalates to SIGKILL past the deadline."""
        try:
            if self.alive():
                self.proc.terminate()
                try:
                    self.proc.wait(timeout=timeout_s)
                except subprocess.TimeoutExpired:
                    self.proc.kill()
                    self.proc.wait(timeout=30.0)
            return self.proc.returncode
        finally:
            # as in kill(): reclaim the tmpdir even when the post-KILL
            # wait itself times out
            self._cleanup()

    def _cleanup(self) -> None:
        tmp, self.tmpdir = self.tmpdir, None
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _read_ready_line(proc: subprocess.Popen,
                     timeout_s: float) -> dict:
    """Block for the entrypoint's single READY JSON line (a thread owns
    the blocking readline so a hung child can't hang the launcher past
    its deadline)."""
    out: Dict[str, object] = {}
    lines: List[str] = []

    def reader():
        while True:
            line = proc.stdout.readline()
            if not line:
                return
            line = line.strip()
            if not line:
                continue
            lines.append(line)
            try:
                msg = json.loads(line)
            except ValueError:
                continue  # library chatter on stdout — skip it
            if msg.get("ready"):
                out["ready"] = msg
                return

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    if "ready" not in out:
        fate = ("still running" if proc.poll() is None
                else f"exited {proc.returncode}")
        proc.kill()
        raise LaunchError(
            f"worker process never printed a READY line within "
            f"{timeout_s:g}s ({fate}); last output: {lines[-3:]}")
    return out["ready"]  # type: ignore[return-value]


def launch(module: str, args: Sequence[str],
           private_tmp: bool = True,
           env: Optional[dict] = None,
           ready_timeout_s: float = 180.0) -> ProcHandle:
    """Start ``python -m <module> <args>`` and wait for its READY line.

    ``private_tmp``: give the child its OWN TMPDIR (deleted at
    teardown) — the no-shared-filesystem guarantee is enforced by
    construction, not convention.  The child inherits the parent env
    (``CUDA_VISIBLE_DEVICES`` included) with ``env`` overrides applied
    last.
    """
    return _launch_argv(["-m", module, *args], private_tmp, env,
                        ready_timeout_s)


def launch_script(path: str, args: Sequence[str] = (),
                  private_tmp: bool = True,
                  env: Optional[dict] = None,
                  ready_timeout_s: float = 180.0) -> ProcHandle:
    """Like :func:`launch` for a standalone script file that speaks the
    READY-line protocol (tests write small incumbent/worker harness
    scripts and run them as real processes)."""
    return _launch_argv([str(path), *args], private_tmp, env,
                        ready_timeout_s)


def _launch_argv(argv: Sequence[str], private_tmp: bool,
                 env: Optional[dict],
                 ready_timeout_s: float) -> ProcHandle:
    child_env = dict(os.environ)
    # the package root on the child's path: ``-m`` must find this
    # checkout's lux_tpu_torch from any working directory
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, child_env.get("PYTHONPATH")) if p)
    tmpdir = None
    if private_tmp:
        tmpdir = tempfile.mkdtemp(prefix="lux-launch-")
        child_env["TMPDIR"] = tmpdir
        child_env["TMP"] = tmpdir
    if env:
        child_env.update({k: str(v) for k, v in env.items()})
    # the child's stderr lands in its private tmpdir, so a failed start
    # can say why (a worker asked for cuda on a machine without a card
    # raises before its READY line)
    err = (open(os.path.join(tmpdir, "stderr.log"), "w")
           if tmpdir is not None else subprocess.DEVNULL)
    try:
        proc = subprocess.Popen(
            [sys.executable, *argv],
            stdout=subprocess.PIPE, stderr=err,
            text=True, env=child_env,
            start_new_session=True)  # SIGINT to the parent never strays
    finally:
        if tmpdir is not None:
            err.close()
    try:
        try:
            ready = _read_ready_line(proc, ready_timeout_s)
        except LaunchError as e:
            tail = ""
            if tmpdir is not None:
                with open(os.path.join(tmpdir, "stderr.log")) as fh:
                    tail = fh.read()[-2000:]
            raise LaunchError(f"{e}; stderr: {tail}") from None
        return ProcHandle(proc, str(ready["worker_id"]),
                          int(ready["port"]), int(ready["pid"]),
                          tmpdir, ready)
    except BaseException:
        # ANY exit without a handle orphans the child and its tmpdir:
        # a malformed READY line (KeyError/ValueError building the
        # ProcHandle above) is just as much a failed launch as a
        # missing one, and nobody else holds a reference to reap
        try:
            proc.kill()
            proc.wait(timeout=30.0)
        except Exception:  # noqa: BLE001 — never mask the launch error
            pass
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)
        raise


def prebuild_kernels(device: str) -> None:
    """Build every CUDA kernel library once in THIS process before CUDA
    workers start: the libraries are shared files named by a hash of the
    sources, so the workers then only load them (concurrent builds are
    safe, but each would pay nvcc's time).  A no-op for ``cpu``, and
    where no card is visible: the worker then refuses ``cuda`` itself,
    naming the missing device."""
    if str(device).split(":")[0] != "cuda":
        return
    import torch

    if torch.cuda.is_available():
        from lux_tpu_torch.ops import cuda_build

        cuda_build.build_all()


def launch_pod_worker(worker_id: str, host: str = "127.0.0.1",
                      port: int = 0, device: str = "cuda",
                      **kw) -> ProcHandle:
    """One pod member process (serve/fleet/pod.py main) on ``device``."""
    prebuild_kernels(device)
    return launch("lux_tpu_torch.serve.fleet.pod",
                  ["--worker-id", str(worker_id), "--host", host,
                   "--port", str(int(port)), "--device", str(device)],
                  **kw)


def launch_fleet_worker(worker_id: str, extra_args: Sequence[str] = (),
                        host: str = "127.0.0.1", port: int = 0,
                        device: str = "cuda", **kw) -> ProcHandle:
    """One ReplicaWorker process (serve/fleet/worker.py main) on
    ``device`` — the full serving stack, for process-mode fleets and
    failover drills."""
    prebuild_kernels(device)
    return launch("lux_tpu_torch.serve.fleet.worker",
                  ["--worker-id", str(worker_id), "--host", host,
                   "--port", str(int(port)), "--device", str(device),
                   *extra_args], **kw)


def process_spawner(prefix: str = "pw", extra_args: Sequence[str] = (),
                    pod: bool = False, device: str = "cuda",
                    ready_timeout_s: float = 180.0,
                    env: Optional[dict] = None):
    """(spawn, reap) pair matching the Autoscaler contract: ``spawn(i)``
    starts a real worker process on ``device`` and returns its handle
    (exposing ``.worker_id`` and ``.port`` — the scaler then
    add_worker()s it); ``reap(handle)`` SIGTERMs it and reclaims its
    private tmpdir."""

    def spawn(index: int) -> ProcHandle:
        wid = f"{prefix}{int(index)}"
        if pod:
            return launch_pod_worker(wid, device=device, env=env,
                                     ready_timeout_s=ready_timeout_s)
        return launch_fleet_worker(wid, extra_args=extra_args,
                                   device=device, env=env,
                                   ready_timeout_s=ready_timeout_s)

    def reap(handle: ProcHandle) -> None:
        handle.terminate()

    return spawn, reap
