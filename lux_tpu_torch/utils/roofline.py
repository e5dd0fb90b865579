"""Serving summary fields and the pull traffic models of the 2-D grid.

Of ``lux_tpu.utils.roofline`` here are ``serve_summarize``, the pull
iteration's traffic model (:func:`pull_iter_model`, bytes and operations
an iteration must move and issue, whatever the device) and the 2-D
(parts x edge) iteration's (:func:`edge2d_iter_model`), the reference's
formulas; the other models come with the benchmark.  ``ici_bytes`` keeps
the reference's key: the bytes the collectives move between ranks.
"""
from __future__ import annotations

import dataclasses

from lux_tpu_torch.utils.timing import percentiles


def serve_summarize(num_queries: int, elapsed_s: float,
                    traversed_edges: int, latencies_s=None) -> dict:
    """JSON-ready serving fields where the unit of work is a REQUEST:
    queries a second, aggregate traversed-edge GTEPS, and latency
    percentiles (ms).  Batch occupancy lives with the batch records
    (serve/metrics.ServeMetrics.summary)."""
    out = {
        "qps": round(num_queries / elapsed_s, 3) if elapsed_s > 0 else 0.0,
        "queries": int(num_queries),
        "gteps_aggregate": round(traversed_edges / elapsed_s / 1e9, 4)
        if elapsed_s > 0 else 0.0,
        "traversed_edges": int(traversed_edges),
    }
    if latencies_s:
        out["latency_ms"] = {k: round(v * 1e3, 3)
                             for k, v in percentiles(latencies_s).items()}
    return out


@dataclasses.dataclass
class TrafficModel:
    """Bytes an iteration moves through device memory, the useful
    operations it does, and the operations its reduce method issues."""

    bytes_moved: int
    flops: int
    device_flops: int

    def __add__(self, other: "TrafficModel") -> "TrafficModel":
        return TrafficModel(
            self.bytes_moved + other.bytes_moved,
            self.flops + other.flops,
            self.device_flops + other.device_flops,
        )

    def scale(self, n: int) -> "TrafficModel":
        return TrafficModel(
            self.bytes_moved * n, self.flops * n, self.device_flops * n
        )


#: the reference's block-CSR one-hot tile: the multiply-adds it issues to
#: sum one value
PALLAS_V_BLK = 512
#: the reference's mxsum block: multiply-adds a prefix value
MXSUM_T = 512
#: the reference's mxscan tile row: multiply-adds a scanned value in each
#: of its two contractions
MXSCAN_T = 128


def _reduce_bytes_per_edge(method: str, sb: int, w: int) -> float:
    """Reduce-phase bytes an edge value of width ``w`` (state dtype ``sb``
    bytes) moves, by method: a pass over memory costs a read and a
    write."""
    v = sb * w
    if method in ("scan", "cumsum"):
        return 2 * v + 1  # two passes over the values + the head flag
    if method == "mxscan":
        return 2 * v + 3  # one pass + the flag + the packed head/pad byte
    if method == "scatter":
        return 3 * v + 4  # value read, accumulator read and write, dst id
    if method == "mxsum":
        return 2 * v
    if method == "pallas":
        return v
    raise ValueError(f"unknown method {method!r}")


def _reduce_device_flops_per_edge(method: str, w: int) -> int:
    """Operations the reduce ISSUES an edge value (useful: one)."""
    if method == "pallas":
        return 2 * PALLAS_V_BLK * w
    if method == "mxsum":
        return 2 * MXSUM_T * w
    if method == "mxscan":
        return 2 * 2 * MXSCAN_T * w
    return w


def pull_iter_model(
    ne: int,
    nv: int,
    method: str = "scan",
    state_bytes: int = 4,
    width: int = 1,
    weighted: bool = False,
    needs_dst: bool = False,
    apply_flops_per_vertex: int = 3,
    compact_unique: int = 0,
) -> TrafficModel:
    """One pull iteration over the whole graph (engine/pull.py: gather,
    reduce, apply), each array read or written once.  ``needs_dst``: the
    program reads the destination's state (CF's error term);
    ``apply_flops_per_vertex``: the update's operations a vertex lane;
    ``compact_unique``: the unique in-sources over all parts under the
    compact-gather mirror, whose fill costs a position read, a state read
    and a mirror write each."""
    v = state_bytes * width
    gather = 4 + v + (4 if weighted else 0) + ((4 + v) if needs_dst else 0)
    gather_extra = compact_unique * (4 + 2 * v) if compact_unique else 0
    reduce_b = _reduce_bytes_per_edge(method, state_bytes, width)
    vertex = 2 * v + 4  # old state read, new written, degree read
    bytes_moved = ne * int(gather + reduce_b) + nv * vertex + gather_extra
    # useful: one combine an edge lane, plus CF's err = w - <u, v> and err * u
    edge_flops = width + (3 * width if needs_dst else 0)
    flops = ne * edge_flops + nv * apply_flops_per_vertex * width
    dev = ne * (
        _reduce_device_flops_per_edge(method, width)
        + (edge_flops - width)
    ) + nv * apply_flops_per_vertex * width
    return TrafficModel(bytes_moved, flops, dev)


def edge2d_iter_model(
    ne: int,
    nv: int,
    num_parts: int,
    edge_shards: int,
    method: str = "scan",
    state_bytes: int = 4,
    weighted: bool = False,
    apply_flops_per_vertex: int = 3,
) -> dict:
    """One 2-D (parts x edge) iteration (parallel/edge2d.py), summed over
    all P*EP ranks:

      * ``hbm``: the 1-D model's gather and reduce (each edge once) plus
        the apply, which every edge shard runs on its replica, so its
        bytes and issued operations scale by EP (the useful ones do not);
      * ``ici_bytes``: the two collectives an iteration, the parts-axis
        all-gather (each of the P*EP ranks receives (P-1)/P of the state)
        and the edge-axis all-reduce of the (V,) f32 partials (a ring:
        2*(EP-1) * nv/P * 4 bytes a part row).

    Edge sharding divides a rank's edge arrays by EP and multiplies the
    state exchange by EP: a capacity feature, not a speed one."""
    base = pull_iter_model(
        ne, nv, method, state_bytes, 1, weighted, False,
        apply_flops_per_vertex,
    )
    # replicate the vertex apply term (2v + 4 bytes, apply flops) EP-1
    # extra times as ISSUED work
    v = state_bytes
    extra_apply_bytes = (edge_shards - 1) * nv * (2 * v + 4)
    extra_apply_flops = (edge_shards - 1) * nv * apply_flops_per_vertex
    hbm = TrafficModel(
        base.bytes_moved + extra_apply_bytes,
        base.flops,
        base.device_flops + extra_apply_flops,
    )
    gather_ici = num_parts * edge_shards * (
        (num_parts - 1) * nv * state_bytes // max(num_parts, 1)
    )
    psum_ici = num_parts * 2 * (edge_shards - 1) * (nv // max(num_parts, 1)) * 4
    return {"hbm": hbm, "ici_bytes": int(gather_ici + psum_ici),
            "replication_factor": edge_shards}
