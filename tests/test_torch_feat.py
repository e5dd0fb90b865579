"""Feature-dimension sharding of CF in lux_tpu_torch (parallel/feat.py on
a parallel/mesh.Grid2D, the colfilter app's --feat-shards arm) against
lux_tpu.parallel.feat on the CPU.

The port's ranks are gloo processes, one spawn group of 4 shared by the
module's tests: a 2 x 2 (parts x feat) grid, the same grid with two parts
resident a part row, a 1 x 4 grid (K = 20 split four ways), bf16 state,
and the ring exchange.  The reference runs in this process on the
conftest's 8-device CPU mesh.  Tolerance: rtol 3e-5 / atol 1e-7 (the
error dot's K-sum splits into F partial sums, and the f32 segment sums
associate differently), as the distributed CF elsewhere; a rerun is
bitwise.
"""
import jax
import numpy as np
import pytest

from lux_tpu.engine import pull as ref_pull
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph.shards import build_pull_shards as ref_build_pull_shards
from lux_tpu.models import colfilter as ref_cf
from lux_tpu.parallel import feat as ref_feat
from lux_tpu.parallel import ring as ref_ring
from lux_tpu_torch.apps import colfilter as cf_app
from lux_tpu_torch.apps import pagerank as pr_app
from lux_tpu_torch.graph import generate
from lux_tpu_torch.models import colfilter as cf_model
from lux_tpu_torch.parallel import spawn

CFG = ("cf", 256, 256, 4096, 9)
APP = ["--rmat-scale", "8", "--rmat-ef", "8", "-ni", "4", "--device", "cpu"]


def _case(parts, shards, **kw):
    return {"kind": "feat", "graph": CFG, "prog": "cf", "parts": parts, "shards": shards,
            "iters": 4, **kw}


CASES = {
    "2x2": _case(2, 2),
    "k_resident": _case(4, 2),
    "four_way": _case(2, 4),
    "bf16": _case(2, 2, dtype="bfloat16"),
    "ring": _case(4, 2, ring=True),
    "ring_bf16": _case(4, 2, ring=True, dtype="bfloat16"),
    "rerun": _case(2, 2),
    "app": {"kind": "app", "app": "colfilter",
            "argv": APP + ["-ng", "2", "--feat-shards", "2", "--distributed", "-check"]},
    "app_ring": {"kind": "app", "app": "colfilter",
                 "argv": APP + ["-ng", "4", "--feat-shards", "2", "--distributed",
                                "--exchange", "ring", "-check"]},
}


def _ref_state0(parts: int) -> np.ndarray:
    """The reference's stacked (P, V, K) initial CF state (numpy)."""
    g = ref_generate.bipartite_ratings(*CFG[1:4], seed=CFG[4])
    sh = ref_build_pull_shards(g, parts)
    return np.asarray(ref_pull.init_state(ref_cf.CFProgram(gamma=1e-3),
                                          jax.tree.map(np.asarray, sh.arrays)))


@pytest.fixture(scope="module")
def w4():
    # the reference's own (P, V, K) state, split on the ranks into (k, V,
    # K/F) blocks (feat.shard_feat) and assembled back (feat.assemble_global)
    cases = dict(CASES, from_ref=_case(4, 2, state0=_ref_state0(4)))
    return spawn.run_ranks(4, "torch_mesh_jobs:run_cases", (cases,), device="cpu",
                           deadline_s=300)


def _ref(case):
    """The reference's feat driver on the CPU mesh: (the (nv, K) state,
    the initial state)."""
    g = ref_generate.bipartite_ratings(*CFG[1:4], seed=CFG[4])
    P, F = case["parts"], case["shards"]
    sh = ref_build_pull_shards(g, P)
    prog = ref_cf.CFProgram(gamma=1e-3, dtype=case.get("dtype", "float32"))
    s0 = ref_pull.init_state(prog, jax.tree.map(np.asarray, sh.arrays))
    mesh = ref_feat.make_mesh_feat(4 // F, F)  # the port's grid of 4 ranks
    if case.get("ring"):
        rs = ref_ring.build_ring_shards(g, P, pull=sh)
        out = ref_feat.run_cf_feat_ring(prog, rs, s0, 4, mesh, method="scan")
    else:
        out = ref_feat.run_cf_feat_dist(prog, sh.spec, sh.arrays, s0, 4, mesh, method="scan")
    return (sh.scatter_to_global(np.asarray(out, np.float32)),
            sh.scatter_to_global(np.asarray(s0, np.float32)))


@pytest.mark.parametrize("name", ["2x2", "k_resident", "four_way", "bf16", "ring",
                                  "ring_bf16"])
def test_feat_matches_reference_and_single_process(name, w4):
    case = CASES[name]
    got = w4[0]["result"][name]
    assert all(r["result"][name] is None for r in w4[1:])
    want, s0 = _ref(case)
    assert got.shape == want.shape == (512, cf_model.K)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=1e-7)
    if case.get("dtype") is None:
        assert np.abs(want - s0).max() > 100 * 1e-7  # the change is what is held
    single = cf_model.colfilter(generate.bipartite_ratings(*CFG[1:4], seed=CFG[4]), 4,
                                num_parts=case["parts"], gamma=1e-3, method="scan",
                                dtype=case.get("dtype", "float32"), device="cpu")
    np.testing.assert_allclose(got, single, rtol=3e-5, atol=1e-7)


def test_rerun_is_bitwise(w4):
    out = w4[0]["result"]
    assert out["2x2"].tobytes() == out["rerun"].tobytes()


def test_feat_from_the_reference_state_agrees_slot_for_slot(w4):
    """Started from the reference's stacked state, split over the grid and
    assembled back, the port's blocks line up with the reference's slots:
    the result is the run from the port's own initial state, bitwise, and
    the reference's within rtol 3e-5 / atol 1e-7."""
    out = w4[0]["result"]
    assert out["from_ref"].tobytes() == out["k_resident"].tobytes()
    want, _ = _ref(CASES["k_resident"])
    np.testing.assert_allclose(out["from_ref"], want, rtol=3e-5, atol=1e-7)


@pytest.mark.parametrize("name,parts", [("app", 2), ("app_ring", 4)])
def test_colfilter_app_feat_shards(name, parts, w4):
    """`apps.colfilter --feat-shards 2 --distributed` over the allgather and
    the ring: every rank's -check passes, rank 0 alone holds the state,
    within rtol 3e-5 / atol 1e-7 of the single-process run."""
    outs = [r["result"][name] for r in w4]
    assert all(o["rc"] == 0 for o in outs) and all(o["state"] is None for o in outs[1:])
    single = cf_app.run(APP + ["-ng", str(parts), "--method", "scan"])
    np.testing.assert_allclose(outs[0]["state"], single.state, rtol=3e-5, atol=1e-7)


@pytest.mark.parametrize("extra,match", [
    (["--feat-shards", "2"], "requires --distributed"),
    (["--feat-shards", "2", "--distributed", "--exchange", "scatter"], "--exchange scatter"),
    (["--feat-shards", "3", "--distributed"], "must divide"),
    (["--feat-shards", "10", "-ng", "4", "--distributed"], "at least that many devices"),
    (["--feat-shards", "2", "--distributed", "--method", "pallas"], "kernel path"),
    (["--feat-shards", "2", "--distributed", "-verbose"], "not wired"),
    (["--feat-shards", "2", "--distributed", "--exchange", "ring", "--method", "mxsum"],
     "scan or scatter"),
    (["--feat-shards", "2", "--distributed", "--edge-shards", "2"], "--edge-shards"),
])
def test_cli_refusals(extra, match):
    with pytest.raises(SystemExit, match=match):
        cf_app.run(APP + extra)


def test_feat_refused_for_scalar_state_apps():
    with pytest.raises(SystemExit, match="colfilter only"):
        pr_app.run(["--rmat-scale", "6", "-ng", "2", "--distributed", "--feat-shards", "2",
                    "--device", "cpu"])
