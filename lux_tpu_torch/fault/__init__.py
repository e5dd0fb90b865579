"""lux_tpu_torch.fault — deterministic fault injection.

Counterpart of ``lux_tpu.fault`` (a copy: the port imports nothing of
the reference).  Two pieces:

* ``plan.py``  — :class:`FaultPlan`/:class:`FaultRule`: seeded,
  JSON-serializable fault schedules fired at the journal protocol
  (``mutate/deltalog.py``) and named process points; every injection is
  a recorder event and a counter.  A plan's JSON is the reference's, so
  a plan either package writes installs in the other.
* ``drills.py`` — the named plan library: the fault drills as seeded
  plans.

The fleet drills fire at the serving fleet's sites: ``wire.send`` /
``wire.recv`` in ``serve/fleet/wire.py`` and the ``controller.heartbeat``
process point; the seeded soaks over a live fleet and the election
drill are ``fault/chaos.py``.

This module owns the process-global installation point.  The fast path
is one attribute read (``_PLAN is None``) so shipped code consults it
for free; installation is locked and either explicit (``install``/
``installed``) or environment-driven (``LUX_FAULT_PLAN`` JSON/path,
resolved once per process on first consultation).

``owner(name)`` sets a thread-local identity so process points fired
from shared code (the journal protocol) match per-owner rules.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from lux_tpu_torch.fault.plan import (  # noqa: F401
    ACTIONS,
    POINT_ALIASES,
    FaultPlan,
    FaultPlanError,
    FaultRule,
    InjectedKill,
)

_LOCK = threading.Lock()
_PLAN: Optional[FaultPlan] = None
#: None until the env var was consulted once (False = consulted, unset)
_ENV_CHECKED = False
_TLS = threading.local()


def install(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process's active plan (replacing any)."""
    global _PLAN, _ENV_CHECKED
    with _LOCK:
        _ENV_CHECKED = True  # an explicit install outranks the env
        _PLAN = plan
    return plan


def uninstall() -> None:
    global _PLAN
    with _LOCK:
        _PLAN = None


class installed:
    """``with fault.installed(plan): ...`` — scoped installation; the
    previous plan (usually None) is restored on exit even when the body
    raises InjectedKill (which drills do by design)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._prev: Optional[FaultPlan] = None

    def __enter__(self) -> FaultPlan:
        global _PLAN, _ENV_CHECKED
        with _LOCK:
            _ENV_CHECKED = True
            self._prev = _PLAN
            _PLAN = self.plan
        return self.plan

    def __exit__(self, *exc) -> bool:
        global _PLAN
        with _LOCK:
            _PLAN = self._prev
        return False


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, resolving ``LUX_FAULT_PLAN`` once per
    process when nothing was installed explicitly."""
    global _PLAN, _ENV_CHECKED
    if _PLAN is not None:
        return _PLAN
    if _ENV_CHECKED:
        return None
    with _LOCK:
        if not _ENV_CHECKED:
            _ENV_CHECKED = True
            _PLAN = FaultPlan.from_env()
    return _PLAN


class owner:
    """Thread-local identity context: ``with fault.owner("w1"): ...``
    makes every site fired on this thread match rules whose ``owner``
    glob names w1 — how the shared journal code attributes its process
    points to the worker running them."""

    def __init__(self, name: Optional[str]):
        self.name = name
        self._prev: Optional[str] = None

    def __enter__(self):
        self._prev = getattr(_TLS, "owner", None)
        _TLS.owner = self.name
        return self

    def __exit__(self, *exc) -> bool:
        _TLS.owner = self._prev
        return False


def current_owner() -> Optional[str]:
    return getattr(_TLS, "owner", None)


def fire(site: str, **ctx) -> Optional[FaultRule]:
    """Consult the active plan at ``site`` (owner auto-filled from the
    thread-local context when the caller did not pass one).  Returns
    the fired rule or None; the CALLER interprets the action."""
    plan = active_plan()
    if plan is None:
        return None
    if "owner" not in ctx or ctx["owner"] is None:
        ctx["owner"] = current_owner()
    return plan.fire(site, **ctx)


def ppoint(point: str, **ctx) -> Optional[FaultRule]:
    """A named PROCESS point (``fault.ppoint("journal.before_marker")``)
    — the generalization of the hand-placed kill drills.  ``kill``
    raises :class:`InjectedKill` here (after the rule's callback, e.g.
    ``worker.kill``, dropped the sockets — the peer-visible shape of a
    SIGKILL at exactly this point); ``delay`` sleeps in place; any
    other action is returned for the site to interpret (``torn`` in
    the journal writer)."""
    rule = fire("proc", point=plan_point(point), **ctx)
    if rule is None:
        return None
    if rule.action == "kill":
        raise InjectedKill(f"injected kill at {point}")
    if rule.action == "delay" and rule.delay_ms > 0:
        import time

        time.sleep(rule.delay_ms / 1e3)
    return rule


def plan_point(point: str) -> str:
    """Resolve documented alias spellings to the placed point names."""
    return POINT_ALIASES.get(point, point)


def arm_kill(point: str, kill_fn: Callable, *,
             owner_id: Optional[str] = None, count: int = 1,
             after: int = 0) -> FaultRule:
    """Arm a one-shot (by default) kill at a named process point —
    ``worker.kill_at`` routes here.  Installs a fresh empty plan when
    none is active, binds ``kill_fn`` and appends the rule, so a test
    can write ``w.kill_at("after_delta_before_marker")`` with no plan
    plumbing at all."""
    global _PLAN, _ENV_CHECKED
    with _LOCK:
        _ENV_CHECKED = True
        if _PLAN is None:
            _PLAN = FaultPlan([], name="armed")
        plan = _PLAN
    cb = f"kill:{owner_id or 'any'}:{plan_point(point)}"
    plan.bind(cb, kill_fn)
    return plan.add(FaultRule(
        "proc", "kill", point=plan_point(point), owner=owner_id,
        count=count, after=after, callback=cb,
        note=f"kill_at({point})"))
