"""Per-iteration telemetry: a fixed-capacity ring in a device tensor.

Counterpart of ``lux_tpu.obs.ring``.  The engines' loops run on the host
and launch their kernels eagerly, so a per-iteration host read of a
device value would synchronize every iteration.  Instead each engine
writes one small row per iteration into a (cap, cols) float32 tensor on
the state's device:

* ``ring_push`` writes the row with device-side copies and fills only
  (``select`` + ``copy_``/``fill_``): it never calls ``.item()``,
  ``.cpu()`` or a synchronize, and a value that is already on the host
  (the push round's one read) is written by a fill kernel, not copied;
  ``ring_push_residual`` reduces the pull loop's L1 residual straight
  into its row;
* the ring is a pure additional OUTPUT: the engine's state math never
  reads it, so telemetry on leaves every result tensor bitwise the same
  as telemetry off;
* it is fetched to the host ONCE, after the loop (``ring_rows``).

Capacity semantics are the reference's: the ring keeps the LAST ``cap``
rows (wrap-around), with ``n`` counting every push, so a long run still
reports its tail and its exact iteration count.  ``n`` is a host int.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

#: default ring capacity (rows); per-run override is an ordinary
#: function argument, not an env knob — rings are built by drivers
DEFAULT_CAP = 512

#: column schemas, by ring kind (luxview renders these headers)
SCHEMAS = {
    "pull_fixed": ("it", "residual_l1"),
    "pull_until": ("it", "active"),
    "push": ("it", "frontier", "edges_lo", "dense"),
}


class IterRing(NamedTuple):
    """The telemetry ring: ``buf`` is (cap, cols) float32 on the state's
    device, ``n`` the host count of rows ever pushed (> cap = wrapped)."""

    buf: torch.Tensor
    n: int


def new_ring(kind: str, cap: int = DEFAULT_CAP, device="cpu") -> IterRing:
    """Fresh ring for one of the SCHEMAS kinds on ``device``.  float32
    everywhere, as in the reference: the recorded quantities (iteration
    index, counts) are telemetry, not arithmetic."""
    cols = len(SCHEMAS[kind])
    return IterRing(torch.zeros((int(cap), cols), dtype=torch.float32,
                                device=device), 0)


def ring_push(ring: IterRing, *vals) -> IterRing:
    """Write one row at ``n % cap``: a tensor value (a device scalar) is
    copied in on the device, a host number is written by a fill.  No host
    read.  Returns the ring with ``n + 1`` (the buffer is written in
    place)."""
    row = ring.buf[ring.n % ring.buf.shape[0]]
    for col, v in enumerate(vals):
        if isinstance(v, torch.Tensor):
            row[col].copy_(v.reshape(()))
        else:
            row[col].fill_(float(v))
    return IterRing(ring.buf, ring.n + 1)


def ring_push_residual(ring: IterRing, it: int, new: torch.Tensor,
                       old: torch.Tensor) -> IterRing:
    """The ``pull_fixed`` row (``it``, the L1 norm of ``new - old``): the
    norm is reduced straight into the ring's row on the device, so the
    row costs three launches (difference, norm, fill) and no host read."""
    row = ring.buf[ring.n % ring.buf.shape[0]]
    row[0].fill_(float(it))
    torch.linalg.vector_norm(new.float() - old.float(), 1, out=row[1])
    return IterRing(ring.buf, ring.n + 1)


def ring_rows(ring: IterRing):
    """The ONE host fetch, after the loop: (rows ndarray in push order,
    total pushes).  Keeps the last ``cap`` rows when wrapped."""
    import numpy as np

    buf = ring.buf.cpu().numpy()
    n = int(ring.n)
    cap = buf.shape[0]
    if n <= cap:
        return buf[:n], n
    start = n % cap
    return np.concatenate([buf[start:], buf[:start]]), n


def emit_ring(kind: str, ring: IterRing, rec=None, **attrs) -> None:
    """Fetch the ring and write it into the event log as one
    ``telemetry.ring`` point (the run-end flush; luxview's per-iteration
    curves read these)."""
    from lux_tpu_torch import obs

    rows, n = ring_rows(ring)
    r = rec if rec is not None else obs.recorder()
    r.point("telemetry.ring", kind=kind, cols=list(SCHEMAS[kind]),
            n=n, rows=[[float(x) for x in row] for row in rows], **attrs)
