"""VertexProgramSpec — the declarative vertex program — and its compiled
pull form.

Counterpart of ``lux_tpu.program.spec``: the pull and push contracts and
the serve tier's Q-axis lift (:class:`BatchedSpecBacked`).  A spec is
the whole app contract as data: per-vertex state initialization, the
per-edge message, a combiner from the :mod:`lux_tpu_torch.ops.segment`
monoid set, the apply/update rule and the convergence rule.  Every field
is a string in the :mod:`lux_tpu_torch.program.expr` language, so a spec
is hashable, comparable and printable.

Environment names a spec may use (beyond its own parameters):

  init:   vid, degree, vtx_mask              -> per-vertex state
  edge:   src, weight, dst                   -> per-edge message
  apply:  old, acc, vid, degree, vtx_mask    -> new per-vertex state
  frontier: vid, state, vtx_mask             -> initial active mask (push)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from lux_tpu_torch.program import expr

REDUCES = ("sum", "min", "max")
CONVERGENCES = ("fixed", "quiescent")


@dataclasses.dataclass(frozen=True)
class VertexProgramSpec:
    """One declarative vertex program (same fields as the reference, so
    the registry in :mod:`lux_tpu_torch.program.library` is a copy)."""

    name: str
    reduce: str
    init: str
    edge: str
    apply: str = ""
    frontier: str = ""
    convergence: str = "fixed"
    state_width: int = 1
    needs_dst_state: bool = False
    query_param: str = ""

    def __post_init__(self):
        if self.reduce not in REDUCES:
            raise ValueError(
                f"spec {self.name!r}: reduce must be one of {REDUCES}, "
                f"got {self.reduce!r}")
        if self.convergence not in CONVERGENCES:
            raise ValueError(
                f"spec {self.name!r}: convergence must be one of "
                f"{CONVERGENCES}, got {self.convergence!r}")
        for field in ("init", "edge", "apply", "frontier"):
            src = getattr(self, field)
            if src:
                try:
                    expr.check(src)
                except expr.SpecSyntaxError as e:
                    raise expr.SpecSyntaxError(
                        f"spec {self.name!r}.{field}: {e}") from None


def active_changed(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Per-part count of state entries that moved: the ``active_fn`` of
    run_pull_until for quiescent programs."""
    return (old != new).reshape(old.shape[0], -1).sum(1).to(torch.int32)


class SpecBacked:
    """Pull- and push-engine protocol methods evaluated from a declarative
    spec.

    Subclasses provide ``spec`` (a :class:`VertexProgramSpec`) and
    ``_env()`` (the parameter bindings)."""

    def _env(self) -> dict:
        return {}

    def _eval(self, source: str, **env):
        return expr.run(source, {**self._env(), **env})

    @property
    def reduce(self) -> str:
        return self.spec.reduce

    @property
    def needs_dst_state(self) -> bool:
        return self.spec.needs_dst_state

    def init_state(self, global_vid, degree, vtx_mask):
        return self._eval(self.spec.init, vid=global_vid, degree=degree,
                          vtx_mask=vtx_mask)

    def edge_value(self, src_state, weight, dst_state=None):
        return self._eval(self.spec.edge, src=src_state, weight=weight,
                          dst=dst_state)

    def apply(self, old_local, acc, arrays):
        if not self.spec.apply:
            raise ValueError(
                f"spec {self.spec.name!r} is a reduce-only phase (no apply "
                "rule); it cannot run in an update loop")
        return self._eval(self.spec.apply, old=old_local, acc=acc,
                          vid=arrays.global_vid, degree=arrays.degree,
                          vtx_mask=arrays.vtx_mask)

    # --- push engine contract -------------------------------------------
    def init_frontier(self, global_vid, state, vtx_mask):
        if not self.spec.frontier:
            raise ValueError(
                f"spec {self.spec.name!r} declares no frontier rule; "
                "it lowers onto the pull engine only")
        return self._eval(self.spec.frontier, vid=global_vid, state=state,
                          vtx_mask=vtx_mask)

    def relax(self, src_val, weight):
        if self.spec.needs_dst_state:
            raise ValueError(
                f"spec {self.spec.name!r} reads the destination state "
                "per edge; the push (scatter) lowering has no dst read "
                "— run it on the pull engine")
        return self._eval(self.spec.edge, src=src_val, weight=weight,
                          dst=None)


@dataclasses.dataclass(frozen=True)
class SpecProgram(SpecBacked):
    """A spec compiled against concrete parameter bindings.  ``args`` is
    a sorted tuple of (name, value) pairs of hashable values; ``width``
    is the trailing state width this instance runs at."""

    spec: VertexProgramSpec
    args: Tuple[Tuple[str, Any], ...] = ()
    width: int = 0

    def __post_init__(self):
        object.__setattr__(self, "args", tuple(sorted(self.args)))
        hash(self.args)  # fail at construction on unhashable values

    def _env(self) -> dict:
        return dict(self.args)

    @property
    def k(self) -> int:
        return self.width or self.spec.state_width


def bind(spec: VertexProgramSpec, width: int = 0, **params) -> SpecProgram:
    """Sugar: ``bind(library.PAGERANK, nv=..., alpha=0.15, dtype="float32")``."""
    return SpecProgram(spec, tuple(sorted(params.items())), width)


class BatchedSpecBacked:
    """The serve Q-axis lift of a spec (serve/batched.QueryProgram
    contract): state carries a TRAILING query axis, the spec's declared
    ``query_param`` binds to the (Q,) query vector as a leading (1, Q)
    row, and every per-vertex name binds as a trailing (V, 1) lane, so
    the SAME init/edge/apply text lowers to the (V, Q) batched step,
    column for column the single-query program's operations."""

    def _env(self) -> dict:
        return {}

    @property
    def reduce(self) -> str:
        return self.spec.reduce

    @property
    def fixpoint(self) -> bool:
        return self.spec.convergence == "quiescent"

    def _qenv(self, global_vid, degree, vtx_mask, queries) -> dict:
        qp = self.spec.query_param
        if not qp:
            raise ValueError(
                f"spec {self.spec.name!r} declares no query_param; it "
                "has no Q-axis serve lowering")
        return {**self._env(), "vid": global_vid[:, None],
                "degree": degree[:, None], "vtx_mask": vtx_mask[:, None],
                qp: queries[None, :]}

    def init_part(self, global_vid, degree, vtx_mask, queries):
        return expr.run(self.spec.init,
                        self._qenv(global_vid, degree, vtx_mask, queries))

    def edge_value(self, src_state, weights):
        return expr.run(self.spec.edge,
                        {**self._env(), "src": src_state,
                         "weight": weights[:, None], "dst": None})

    def apply(self, old_local, acc, arr, queries):
        env = self._qenv(arr.global_vid, arr.degree, arr.vtx_mask, queries)
        env.update(old=old_local, acc=acc)
        return expr.run(self.spec.apply, env)


@dataclasses.dataclass(frozen=True)
class BatchedSpecProgram(BatchedSpecBacked):
    """Generic Q-lifted program (the serve registry's named classes are
    spec-backed dataclasses over the same machinery)."""

    spec: VertexProgramSpec
    args: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "args", tuple(sorted(self.args)))
        hash(self.args)

    def _env(self) -> dict:
        return dict(self.args)
