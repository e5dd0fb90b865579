"""The named drill library: each fault drill as a seeded :class:`FaultPlan`.

Counterpart of ``lux_tpu.fault.drills`` (a copy: the port imports
nothing of the reference).  Each factory returns a plan whose JSON form
fully describes the drill (``plan.to_json()``), so "which fault, where,
when" is data a failing test prints:

* :func:`worker_kill_mid_burst`   — a SIGKILL-shaped socket drop on a
  named worker after its Nth query frame.
* :func:`kill_before_marker`      — a crash between delta receipt (batch
  npz durable) and the ``.ok`` marker: recovery must land on the exact
  committed prefix.  ``after_delta_before_marker`` aliases this point.
* :func:`torn_journal_write`      — a batch npz half-written straight to
  its final name (a non-atomic writer or reordered flush), then the
  crash: replay must drop exactly that batch and keep the prefix.
* :func:`controller_kill_at_heartbeat` — kill the controller at its Nth
  heartbeat sweep.
* :func:`wire_chaos`              — seeded probabilistic frame delays and
  drops on query traffic.

The journal drills fire at ``mutate/deltalog.py``'s sites, the other
three at the serving fleet's (``serve/fleet/wire.py``'s ``wire.*`` and
the controller's ``controller.heartbeat``).
Callers bind the kill callbacks the rules name (``plan.bind``).
"""
from __future__ import annotations

from typing import Optional, Sequence

from lux_tpu_torch.fault.plan import FaultPlan, FaultRule


def worker_kill_mid_burst(victim: str, nth_query: int = 5,
                          seed: int = 0) -> FaultPlan:
    """Kill ``victim`` when it RECEIVES its ``nth_query``-th query frame
    (mid-burst by construction when the burst is larger).  Bind the
    trigger: ``plan.bind(f"kill:{victim}", worker.kill)``."""
    return FaultPlan([FaultRule(
        "wire.recv", "kill", owner=victim, op="query",
        after=max(int(nth_query) - 1, 0), count=1,
        callback=f"kill:{victim}",
        note=f"drill: kill {victim} at query #{nth_query}")],
        seed=seed, name=f"worker_kill_mid_burst[{victim}]")


def kill_before_marker(owner: Optional[str] = None, nth_batch: int = 1,
                       seed: int = 0) -> FaultPlan:
    """Crash at ``journal.before_marker`` (batch npz durable, ``.ok``
    marker never written) on the ``nth_batch``-th journaled batch —
    the kill-between-receipt-and-marker window."""
    return FaultPlan([FaultRule(
        "proc", "kill", point="journal.before_marker", owner=owner,
        after=max(int(nth_batch) - 1, 0), count=1,
        note="drill: kill between batch append and .ok marker")],
        seed=seed, name="kill_before_marker")


def torn_journal_write(owner: Optional[str] = None,
                       file: str = "batch_*.npz", nth: int = 1,
                       seed: int = 0) -> FaultPlan:
    """Tear the ``nth``-th matching journal file write: half the bytes
    land at the FINAL path (no marker ever follows), then the injected
    crash — the npz+``.ok`` replay protocol must discard it."""
    return FaultPlan([FaultRule(
        "proc", "torn", point="journal.write", owner=owner, file=file,
        after=max(int(nth) - 1, 0), count=1,
        note="drill: torn journal write (partial npz, no marker)")],
        seed=seed, name="torn_journal_write")


def controller_kill_at_heartbeat(nth: int = 3, seed: int = 0
                                 ) -> FaultPlan:
    """The election drill: kill the CONTROLLER at its ``nth``
    heartbeat sweep (the ``controller.heartbeat`` proc point at the top
    of ``_hb_loop``) — mid-flight, not at a quiet boundary.  Bind the
    trigger: ``plan.bind("kill:controller", ctl.kill)``; a Standby
    (serve/autopilot/election.py) must then detect the silence and
    promote, with the harness doing NOTHING."""
    return FaultPlan([FaultRule(
        "proc", "kill", owner="controller",
        point="controller.heartbeat", after=max(int(nth) - 1, 0),
        count=1, callback="kill:controller",
        note=f"drill: kill controller at heartbeat #{nth}")],
        seed=seed, name="controller_kill_at_heartbeat")


def wire_chaos(seed: int, delay_ms: float = 3.0, delay_prob: float = 0.10,
               drop_prob: float = 0.03,
               ops: Sequence[str] = ("query",)) -> FaultPlan:
    """Background wire noise for the chaos soak: per matching frame,
    a seeded coin delays it ``delay_ms`` or (controller-side sends
    only) drops it entirely — dropped queries are exactly what the
    client envelope's deadline+retry must absorb."""
    rules = []
    for op in ops:
        rules.append(FaultRule("wire.send", "drop", op=op,
                               owner="controller", prob=float(drop_prob),
                               note="chaos: dropped request frame"))
        rules.append(FaultRule("wire.send", "delay", op=op,
                               delay_ms=float(delay_ms),
                               prob=float(delay_prob),
                               note="chaos: delayed request frame"))
        rules.append(FaultRule("wire.recv", "delay", op=op,
                               delay_ms=float(delay_ms),
                               prob=float(delay_prob),
                               note="chaos: delayed delivery"))
    return FaultPlan(rules, seed=seed, name=f"wire_chaos[s{seed}]")
