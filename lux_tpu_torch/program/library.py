"""The named spec registry: every app the reference package ships, as
config.

A copy of ``lux_tpu.program.library``: spec strings are data, so the same
text evaluates through :mod:`lux_tpu_torch.program.expr` with torch.
PAGERANK, PPR and COLFILTER run on this package's pull engine, SSSP,
SSSP_WEIGHTED and COMPONENTS on its push engine (COMPONENTS on the pull
engine too); the others are kept verbatim so the registry stays one table
for both packages.
"""
from __future__ import annotations

from lux_tpu_torch.program.spec import VertexProgramSpec

#: PageRank damping ALPHA — models/pagerank re-exports it.
ALPHA = 0.15


def _pr_spec(name: str, mass: str, teleport: str,
             query_param: str = "") -> VertexProgramSpec:
    """PageRank-family template: the pre-divided recurrence with the
    teleport MASS as the only degree of freedom — uniform ``1/nv`` for
    PageRank, a one-hot at ``seed`` for personalized PageRank.  One
    template, two specs: the former copy-pasted PPRProgram init/apply
    bodies are this substitution."""
    return VertexProgramSpec(
        name=name,
        reduce="sum",
        # state holds rank PRE-DIVIDED by out-degree (pagerank_gpu.cu:
        # 256-259) so the gather needs no degree lookup
        init=(
            f"mass = {mass}\n"
            "deg = maximum(f32(degree), 1.0)\n"
            "state = where(degree > 0, mass / deg, mass)\n"
            "cast(where(vtx_mask, state, 0.0), dtype)"
        ),
        # reduce in f32 regardless of the storage dtype
        edge="f32(src)",
        # (teleport + ALPHA * acc), re-divided (pr_kernel tail,
        # pagerank_gpu.cu:97-100)
        apply=(
            f"pr = {teleport} + f32(alpha) * acc\n"
            "deg = f32(degree)\n"
            "pr = where(degree > 0, pr / maximum(deg, 1.0), pr)\n"
            "cast(where(vtx_mask, pr, 0.0), dtype)"
        ),
        convergence="fixed",
        query_param=query_param,
    )


#: uniform teleport: initRank = (1-ALPHA)/nv computed as ONE f32 round
#: of the Python-float product (pagerank/pagerank.cc:141-144 parity —
#: f32(1-alpha)*f32(1/nv) would round twice and drift the last ulp)
PAGERANK = _pr_spec("pagerank", mass="f32(1.0 / nv)",
                    teleport="f32((1.0 - alpha) / nv)")

#: personalized: the teleport mass is a one-hot at ``seed``; the seed is
#: the serve Q axis (MultiSourcePPR is this spec with seed = queries)
PPR = _pr_spec("ppr", mass="f32(vid == seed)",
               teleport="f32(1.0 - alpha) * f32(vid == seed)",
               query_param="seed")


def _sssp_spec(name: str, relax: str) -> VertexProgramSpec:
    """SSSP-family template: min-relaxation from ``start`` with INF
    encoded as the ``inf`` parameter (nv for BFS-SSSP hop counts,
    reference parity sssp_gpu.cu:733-744; 1<<30 for weighted costs).
    The relax expression is the only degree of freedom — the former
    WeightedSSSPProgram duplication."""
    return VertexProgramSpec(
        name=name,
        reduce="min",
        init=(
            "far = i32(inf)\n"
            "d = where(vid == start, i32(0), far)\n"
            "where(vtx_mask, d, far)"
        ),
        edge=relax,
        # pull form of the same relaxation (serve's batched engines and
        # the pull-until surface; push's scatter-min needs no apply)
        apply=(
            "new = minimum(old, acc)\n"
            "where(vtx_mask, new, old)"
        ),
        frontier="(vid == start) & vtx_mask",
        convergence="quiescent",
        query_param="start",
    )


SSSP = _sssp_spec("sssp", relax="src + i32(1)")
SSSP_WEIGHTED = _sssp_spec("sssp_weighted", relax="src + i32(weight)")

#: max-label propagation (the CC kernel, components_gpu.cu:85-130):
#: labels init to the vertex id (-1 on padding so it never wins a max),
#: everyone starts active (dense all-ones bitmap, :733-737)
COMPONENTS = VertexProgramSpec(
    name="components",
    reduce="max",
    init="where(vtx_mask, vid, -1)",
    edge="src",
    apply=(
        "new = maximum(old, acc)\n"
        "where(vtx_mask, new, old)"
    ),
    frontier="vtx_mask",
    convergence="quiescent",
)

#: collaborative filtering (col_filter/): K-dim latents at sqrt(1/K),
#: per-edge err = rating - <v_src, v_dst> (the error-dot reads the
#: DESTINATION state per edge — the dst-dependent load only the pull
#: surfaces provide), update v += GAMMA*(accErr - LAMBDA*v).  The
#: error-dot lowering ("vpu" | "mxu") stays a program parameter so the
#: banked ``tpu:cf_err_dot`` winner keeps flowing through unchanged.
COLFILTER = VertexProgramSpec(
    name="colfilter",
    reduce="sum",
    init=(
        "v0 = fullk(vid, k, sqrt(1.0 / k))\n"
        "cast(where(lane(vtx_mask), v0, 0.0), dtype)"
    ),
    edge=(
        "src32 = f32(src)\n"
        "err = weight - dot_lanes(src32, f32(dst), err_dot)\n"
        "lane(err) * src32"
    ),
    apply=(
        "old32 = f32(old)\n"
        "new = old32 + f32(gamma) * (acc - f32(lam) * old32)\n"
        "cast(where(lane(vtx_mask), new, old32), dtype)"
    ),
    convergence="fixed",
    state_width=20,
    needs_dst_state=True,
)


# ---------------------------------------------------------------------------
# the four further workloads: new scenarios as config only
# ---------------------------------------------------------------------------

#: multi-source BFS (frontier/push): hop distance to the NEAREST of the
#: ``sources`` tuple, INF == nv.  Differs from sssp in the seed rule
#: only — which is the point: a new scenario is a spec edit.
BFS = VertexProgramSpec(
    name="bfs",
    reduce="min",
    init=(
        "far = i32(nv)\n"
        "d = where(isin(vid, sources), i32(0), far)\n"
        "where(vtx_mask, d, far)"
    ),
    edge="src + i32(1)",
    apply=(
        "new = minimum(old, acc)\n"
        "where(vtx_mask, new, old)"
    ),
    frontier="isin(vid, sources) & vtx_mask",
    convergence="quiescent",
)

#: one peel level of k-core decomposition (iterative peel): state is an
#: int32 alive flag; the sum reduce counts alive in-neighbors and a
#: vertex survives iff it keeps >= kk of them.  The decomposition
#: driver (workloads.kcore) runs this spec to quiescence per k with a
#: warm start from the previous level's survivors (k-cores nest).
KCORE = VertexProgramSpec(
    name="kcore",
    reduce="sum",
    init="where(vtx_mask, i32(1), i32(0))",
    edge="src",
    apply="where(vtx_mask, old * i32(acc >= kk), i32(0))",
    convergence="quiescent",
)

#: seeded multi-class label propagation (dense pull, WIDE state): every
#: stride-th vertex is a seed pinned to one-hot class ``vid % labels``;
#: everyone else averages the incoming class-probability rows each
#: fixed iteration (vertices with no in-edges keep their prior row).
LABELPROP = VertexProgramSpec(
    name="labelprop",
    reduce="sum",
    init=(
        "seeded = (vid % stride) == 0\n"
        "uni = fullk(vid, labels, 1.0 / labels)\n"
        "base = where(lane(seeded), onehot(vid % labels, labels), uni)\n"
        "where(lane(vtx_mask), base, 0.0)"
    ),
    edge="f32(src)",
    apply=(
        "seeded = (vid % stride) == 0\n"
        "tot = rowsum(acc)\n"
        "norm = where(tot > 0.0, acc / maximum(tot, 1e-30), old)\n"
        "out = where(lane(seeded), onehot(vid % labels, labels), norm)\n"
        "where(lane(vtx_mask), out, 0.0)"
    ),
    convergence="fixed",
)

#: triangle counting phase 1: each vertex's state is the uint32 BITSET
#: of its own id (w words); one sum-reduce pull iteration ORs the
#: in-neighbor bitsets (distinct sources contribute distinct bits, so
#: the integer sum IS the union) into each vertex — the neighborhood
#: sketch phase of the intersection-heavy access pattern.
TRI_NEIGHBORS = VertexProgramSpec(
    name="tri_neighbors",
    reduce="sum",
    init=(
        "bit = u32(1) << u32(vid % 32)\n"
        "bits = where(row(arange(w)) == lane(vid // 32), lane(bit), u32(0))\n"
        "where(lane(vtx_mask), bits, u32(0))"
    ),
    edge="src",
    apply="where(lane(vtx_mask), cast(acc, 'uint32'), old)",
    convergence="fixed",
)

#: triangle counting phase 2 (reduce-only): per edge (u, v), intersect
#: the two gathered bitsets and weight the common-neighbor count by the
#: edge weight; the segmented sum per destination is the weighted
#: triangle incidence.  No apply — this phase lowers through the pull
#: engine's load/comp split (workloads.reduce_phase), which is exactly
#: what "a two-phase program" means to the compiler.
TRI_COUNT = VertexProgramSpec(
    name="tri_count",
    reduce="sum",
    init="f32(0.0)",  # unused: phase 2 consumes phase 1's state
    edge="f32(sum_lanes(popcount(src & dst))) * f32(weight)",
    convergence="fixed",
    needs_dst_state=True,
)


#: name -> spec, for the generic driver and docs
REGISTRY = {
    s.name: s
    for s in (PAGERANK, PPR, SSSP, SSSP_WEIGHTED, COMPONENTS, COLFILTER,
              BFS, KCORE, LABELPROP, TRI_NEIGHBORS, TRI_COUNT)
}
