"""Carry a layout built by the reference package into this one.

For a graph system the "weights" are the graph layout and the state:
:func:`shards_from_numpy` takes the reference's ``ShardArrays`` /
``BlockCSR`` fields and its stacked state as numpy arrays, for example
``{k: np.asarray(v) for k, v in arrays._asdict().items()}``, and returns
the same arrays as torch tensors on a device, so a test can feed this
package exactly the layout the reference built.

For the routed pull the "weights" are the plan: :func:`route_plan_from_numpy`
takes a plan the reference built (its frozen static, read field by field,
and its arrays as numpy) and returns this package's static dataclasses and
tensors, so a test can replay exactly the reference's coloring.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from lux_tpu_torch.graph.shards import ShardArrays
from lux_tpu_torch.utils.device import resolve_device


def array_to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """One numpy array as a torch tensor on ``device`` with the same dtype
    (int32 stays int32, bool stays bool; a bfloat16 array — the
    ml_dtypes type numpy holds for a bf16 jax array — becomes a torch
    bfloat16 tensor bit for bit)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # jax hands out read-only views
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def shards_from_numpy(d: Mapping[str, Optional[np.ndarray]],
                      device="cuda") -> dict:
    """Every array of ``d`` as a tensor on ``device`` under its own key
    (None values stay None).  When ``d`` holds every ShardArrays field, the
    result also has ``"arrays"``: those tensors as a ShardArrays, ready for
    the pull engine."""
    dev = resolve_device(device)
    out = {k: None if v is None else array_to_tensor(np.asarray(v), dev)
           for k, v in d.items()}
    if all(f in out for f in ShardArrays._fields):
        out["arrays"] = ShardArrays(*(out[f] for f in ShardArrays._fields))
    return out


def _route_static_types() -> dict:
    from lux_tpu_torch.ops import expand, shuffle

    return {cls.__name__: cls for cls in (
        expand.ExpandStatic, expand.FusedStatic, expand.FFStatic,
        expand.FFLevelStatic, shuffle.StaticRoute, shuffle.StaticPass,
        shuffle.StaticRoutePF, shuffle.StaticGroup, shuffle.StaticStep,
        shuffle.StaticMXGroup)}


def _port_static(x, types: dict):
    """One node of a plan static, rebuilt from its fields: a dataclass
    instance of any module is matched by class name."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        name = type(x).__name__
        fields = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    elif isinstance(x, tuple):
        return tuple(_port_static(v, types) for v in x)
    else:
        return x
    cls = types.get(name)
    if cls is None:
        raise TypeError(f"plan static node {name!r} has no counterpart in "
                        "lux_tpu_torch (the CF and bucket routes are not "
                        "ported)")
    mine = {f.name for f in dataclasses.fields(cls)}
    if set(fields) != mine:
        raise ValueError(f"{name}: fields {sorted(fields)} differ from the "
                         f"port's {sorted(mine)}")
    return cls(**{k: _port_static(v, types) for k, v in fields.items()})


def route_plan_from_numpy(static, arrays, device="cuda"):
    """A routed plan built by the reference -> (this package's static,
    tuple of tensors on ``device``), ready for ``run_pull_fixed(route=)``
    or ops/expand's replays.  ``static`` is read by field name, never
    through the reference's classes; ``arrays`` keep their dtypes (uint8
    indices stay uint8)."""
    dev = resolve_device(device)
    port = _port_static(static, _route_static_types())
    return port, tuple(array_to_tensor(np.asarray(a), dev) for a in arrays)
