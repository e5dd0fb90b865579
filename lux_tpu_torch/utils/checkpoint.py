"""Checkpoint/resume of vertex state.

Counterpart of ``lux_tpu.utils.checkpoint``, with the same on-disk format
so that a checkpoint written by either package resumes in the other:
NumPy ``.npz`` files named ``ckpt_<iteration>.npz``, written to a
temporary name and renamed into place, with a ``meta`` JSON string.

Checkpoints are ELASTIC: the saved state is the GLOBAL (nv, ...) vertex
vector, de-padded from whatever shard layout produced it, so a resume may
use another part count than the run that saved it (the app restacks the
global arrays onto its own layout).  bfloat16 state is stored widened to
float32 (the .npy format has no bf16 descr; the cast is value-exact) and
narrowed back on resume through ``torch.bfloat16``: the state comes back
as a torch tensor in that case, and as a numpy array otherwise.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def save(path: str, state, iteration: int, meta: Optional[Dict[str, Any]] = None):
    """Save a state array + iteration counter (atomic rename)."""
    state = np.asarray(state)
    tmp = path + ".tmp"
    np.savez(tmp, state=state, iteration=np.int64(iteration),
             meta=json.dumps(meta or {}))
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load(path: str) -> Tuple[np.ndarray, int, Dict[str, Any]]:
    with np.load(path, allow_pickle=False) as z:
        return z["state"], int(z["iteration"]), json.loads(str(z["meta"]))


def _host_global(state_global):
    """A global state as a numpy array, and its dtype's name: a torch
    tensor is brought to the host, bfloat16 widened to float32."""
    if isinstance(state_global, torch.Tensor):
        name = str(state_global.dtype).removeprefix("torch.")
        t = state_global.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy(), name
    a = np.asarray(state_global)
    name = str(a.dtype)
    if a.dtype.name == "bfloat16":  # an ml_dtypes array
        a = a.astype(np.float32)
    return a, name


def save_iteration(directory: str, iteration: int, state_global, app: str) -> str:
    """Save the GLOBAL (nv, ...) state under the canonical name
    ``ckpt_<iteration>.npz`` (the format ``latest`` scans for); creates
    the directory on first use.  ``state_global`` is a numpy array or a
    torch tensor."""
    os.makedirs(directory, exist_ok=True)
    state, dtype = _host_global(state_global)
    meta = {"app": app, "layout": "global", "nv": int(state.shape[0]),
            "dtype": dtype}
    path = os.path.join(directory, f"ckpt_{iteration}.npz")
    save(path, state, iteration, meta)
    return path


def _check_meta(prev: str, meta: dict, app: str, nv: int) -> None:
    if meta.get("app") != app:
        raise SystemExit(f"{prev}: checkpoint is from app {meta.get('app')!r}, "
                         f"refusing to resume {app!r}")
    if int(meta.get("nv", -1)) != nv:
        raise SystemExit(f"{prev}: checkpoint is for nv={meta.get('nv')}, "
                         f"this graph has nv={nv}")


def load_resume(directory: str, app: str, nv: int):
    """Validated elastic resume: the latest checkpoint in ``directory``
    for this app and graph, as (state_global, start_iteration, path), or
    (None, 0, None) when the directory has no checkpoint yet.  A bfloat16
    state comes back as a torch.bfloat16 tensor (narrowed from the
    widened float32 on disk), any other as a numpy array."""
    prev = latest(directory)
    if prev is None:
        return None, 0, None
    state, it, meta = load(prev)
    if meta.get("layout") != "global":
        raise SystemExit(
            f"{prev}: layout-specific checkpoint from an older format; "
            "elastic resume needs global-layout checkpoints — delete the "
            "directory and re-run")
    _check_meta(prev, meta, app, nv)
    if meta.get("dtype") == "bfloat16":
        state = torch.from_numpy(np.ascontiguousarray(state)).to(torch.bfloat16)
    return state, it, prev


def _save_global_ckpt(directory: str, iteration: int, state_global,
                      changed_global, edges: int, app: str, layout: str,
                      extra: Dict[str, Any]) -> str:
    """Shared body of the mask-carrying savers (frontier and delta): the
    GLOBAL state, the GLOBAL bool mask, the exact edge counter as the
    reference's (2,) uint32 [hi, lo] pair, and the layout-tagged meta,
    written atomically."""
    os.makedirs(directory, exist_ok=True)
    state, dtype = _host_global(state_global)
    meta = {"app": app, "layout": layout, "nv": int(state.shape[0]), "dtype": dtype}
    path = os.path.join(directory, f"ckpt_{iteration}.npz")
    tmp = path + ".tmp"
    np.savez(tmp, state=state, changed=np.asarray(changed_global, bool),
             edges=edges_pair(edges), iteration=np.int64(iteration),
             meta=json.dumps(meta), **extra)
    os.replace(tmp + ".npz", path)
    return path


def _load_global_ckpt(prev: str, app: str, nv: int, layout: str,
                      wrong_layout_hint: str) -> dict:
    """Validation and field extraction of a _save_global_ckpt file."""
    with np.load(prev, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("layout") != layout:
            raise SystemExit(f"{prev}: layout {meta.get('layout')!r} is not "
                             f"{layout!r}; {wrong_layout_hint}")
        _check_meta(prev, meta, app, nv)
        return {k: z[k] for k in z.files if k != "meta"}


def edges_pair(edges) -> np.ndarray:
    """An exact edge count as the reference's (2,) uint32 [hi, lo] pair
    (a pair passes through unchanged)."""
    a = np.asarray(edges)
    if a.shape == (2,):
        return a.astype(np.uint32)
    e = int(edges)
    return np.array([e >> 32, e & 0xFFFFFFFF], np.uint32)


def edges_int(pair) -> int:
    """The (2,) uint32 [hi, lo] pair as a Python int."""
    hi, lo = (int(x) for x in np.asarray(pair).astype(np.uint64))
    return (hi << 32) | lo


def save_frontier(directory: str, iteration: int, state_global,
                  changed_global, edges, app: str) -> str:
    """Frontier-app (push engine) checkpoint: the GLOBAL (nv,) state, the
    GLOBAL changed-vertex mask (the frontier, layout-free), and the exact
    traversed-edge count (an int, or the [hi, lo] pair).  Elastic: any
    later part count rebuilds its queues from the mask."""
    return _save_global_ckpt(directory, iteration, state_global, changed_global,
                             edges, app, "global-frontier", {})


def load_resume_frontier(directory: str, app: str, nv: int):
    """Latest frontier checkpoint as (state_global, changed_global, edges,
    start_iteration, path), ``edges`` a Python int; (None, None, None, 0,
    None) when the directory holds none."""
    prev = latest(directory)
    if prev is None:
        return None, None, None, 0, None
    z = _load_global_ckpt(prev, app, nv, "global-frontier",
                          "fixed-iteration, frontier, and delta drivers use "
                          "separate directories")
    return z["state"], z["changed"], edges_int(z["edges"]), int(z["iteration"]), prev


def save_delta(directory: str, iteration: int, state_global, pending_global,
               edges, thr: int, app: str) -> str:
    """Delta-stepping checkpoint: the frontier format (GLOBAL state +
    GLOBAL pending mask + exact edge counter) plus the bucket threshold,
    everything engine/delta.DeltaCarry needs."""
    return _save_global_ckpt(directory, iteration, state_global, pending_global,
                             edges, app, "global-delta", {"thr": np.int32(thr)})


def load_resume_delta(directory: str, app: str, nv: int):
    """Latest delta checkpoint as (state_global, pending_global, edges,
    thr, start_iteration, path), ``edges`` a Python int; (None, None,
    None, 0, 0, None) when the directory holds none."""
    prev = latest(directory)
    if prev is None:
        return None, None, None, 0, 0, None
    z = _load_global_ckpt(prev, app, nv, "global-delta",
                          "use a separate --ckpt-dir per driver kind")
    return (z["state"], z["changed"], edges_int(z["edges"]), int(z["thr"]),
            int(z["iteration"]), prev)


def latest(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    """Most recent checkpoint file in a directory (by iteration suffix)."""
    if not os.path.isdir(directory):
        return None
    best, best_it = None, -1
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(".npz"):
            try:
                it = int(name[len(prefix): -4])
            except ValueError:
                continue
            if it > best_it:
                best, best_it = os.path.join(directory, name), it
    return best
