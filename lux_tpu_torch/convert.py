"""Carry a layout built by the reference package into this one.

For a graph system the "weights" are the graph layout and the state:
:func:`shards_from_numpy` takes the reference's ``ShardArrays`` /
``BlockCSR`` fields and its stacked state as numpy arrays, for example
``{k: np.asarray(v) for k, v in arrays._asdict().items()}``, and returns
the same arrays as torch tensors on a device, so a test can feed this
package exactly the layout the reference built.
"""
from __future__ import annotations

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
