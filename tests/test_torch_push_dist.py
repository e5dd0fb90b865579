"""The distributed push engine of lux_tpu_torch (engine/push.run_push_dist
and run_push_ring, parallel/pallas_dist.run_push_pallas_dist,
engine/delta.run_push_delta_dist, engine/repartition with a group, the
push apps' --distributed arm) against lux_tpu on the CPU.

The port's ranks are gloo processes spawned by
``parallel/spawn.run_ranks``: one group of W = 2 (k = 2 resident parts a
rank, and the app runs) and one of W = 4 (k = 1 and 2), each shared by
the module's tests; the rank jobs are in tests/torch_push_dist_jobs.py.
The reference runs in this process on the conftest's 8-device CPU mesh
(W of its devices), its Pallas kernel in interpret mode.  Every program
is an int32 min or max, so the tolerance is bitwise: state, iterations
and traversed edges, against the reference and against the port's
single-process run at the same parts.
"""
import jax
import numpy as np
import pytest
import torch

from lux_tpu.engine import delta as ref_delta
from lux_tpu.engine import push as ref_push
from lux_tpu.engine import repartition as ref_rep
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph.push_shards import build_push_shards as ref_build_push_shards
from lux_tpu.models import components as ref_cc
from lux_tpu.models import sssp as ref_sssp
from lux_tpu.parallel import pallas_dist as ref_pd
from lux_tpu.parallel import ring as ref_ring
from lux_tpu.parallel.mesh import make_mesh, make_mesh_for_parts
from lux_tpu_torch.apps import common
from lux_tpu_torch.apps import components as cc_app
from lux_tpu_torch.apps import sssp as sssp_app
from lux_tpu_torch.engine import delta, push
from lux_tpu_torch.graph.push_shards import build_push_shards
from lux_tpu_torch.ops import merge_tree
from lux_tpu_torch.parallel import mesh, pallas_dist, ring, spawn
from lux_tpu_torch.utils import preflight
from lux_tpu_torch.utils.config import parse_args

import torch_push_dist_jobs as jobs

G9 = ("rmat", 9, 8, 21)
GW9 = ("rmat", 9, 8, 21, True)

CASES_W2 = {
    "bulk_sssp": {"graph": G9, "prog": "sssp", "parts": 4, "engine": "dist"},
    "tree_cc": {"graph": G9, "prog": "cc", "parts": 4, "engine": "dist", "merge": "tree"},
    "ring_sssp": {"graph": G9, "prog": "sssp", "parts": 4, "engine": "ring"},
    "ring_cc_tree": {"graph": G9, "prog": "cc", "parts": 4, "engine": "ring",
                     "method": "scatter", "merge": "tree"},
    "pallas_sssp": {"graph": G9, "prog": "sssp", "parts": 2, "engine": "pallas",
                    "v_blk": 128, "t_chunk": 128},
    "pallas_wsssp": {"graph": GW9, "prog": "wsssp", "parts": 2, "engine": "pallas",
                     "v_blk": 128, "t_chunk": 128},
    "pallas_cc": {"graph": G9, "prog": "cc", "parts": 2, "engine": "pallas",
                  "v_blk": 128, "t_chunk": 128},
    "delta": {"graph": GW9, "prog": "wsssp", "parts": 4, "engine": "delta", "delta": 16},
    "adaptive_allgather": {"graph": G9, "prog": "sssp0", "parts": 4, "engine": "adaptive",
                           "exchange": "allgather", "chunk": 1, "threshold": 1.0},
    "adaptive_ring": {"graph": G9, "prog": "sssp0", "parts": 4, "engine": "adaptive",
                      "exchange": "ring", "chunk": 2, "threshold": 1.01},
    "phases": {"graph": G9, "prog": "sssp", "parts": 4, "engine": "phases"},
}
CASES_W4 = {
    "bulk_sssp_k1": {"graph": G9, "prog": "sssp", "parts": 4, "engine": "dist"},
    "tree_sssp_k2": {"graph": G9, "prog": "sssp", "parts": 8, "engine": "dist",
                     "merge": "tree"},
    "ring_cc_k1": {"graph": G9, "prog": "cc", "parts": 4, "engine": "ring"},
    "ring_sssp_k2": {"graph": G9, "prog": "sssp", "parts": 8, "engine": "ring"},
    "pallas_cc_k1": {"graph": G9, "prog": "cc", "parts": 4, "engine": "pallas",
                     "v_blk": 128, "t_chunk": 128},
    "pallas_wsssp_k1": {"graph": GW9, "prog": "wsssp", "parts": 4, "engine": "pallas",
                        "v_blk": 128, "t_chunk": 128},
    "delta_k2": {"graph": GW9, "prog": "wsssp", "parts": 8, "engine": "delta", "delta": 16},
    "adaptive_allgather_k2": {"graph": G9, "prog": "sssp0", "parts": 8,
                              "engine": "adaptive", "exchange": "allgather", "chunk": 2,
                              "threshold": 1.01},
    "adaptive_ring_k1": {"graph": G9, "prog": "sssp0", "parts": 4, "engine": "adaptive",
                         "exchange": "ring", "chunk": 1, "threshold": 1.0},
}

APP = ["--rmat-scale", "9", "--rmat-ef", "8", "--seed", "21", "--device", "cpu", "-check"]
APP_RUNS = {
    "allgather": ["-ng", "4", "--distributed", "--method", "scan"],
    "ring": ["-ng", "4", "--distributed", "--exchange", "ring"],
    "pallas": ["-ng", "2", "--distributed", "--method", "pallas"],
}


#: the drivers' other arms through the apps across 2 ranks: (app, argv)
APP_ARMS = {
    "repartition": ("sssp", ["--method", "scan", "--repartition-every", "1",
                             "--repartition-threshold", "1.0"]),
    "repartition-ring": ("sssp", ["--exchange", "ring", "--repartition-every", "1",
                                  "--repartition-threshold", "1.0"]),
    "delta": ("sssp", ["--method", "scan", "--weighted", "--delta", "8"]),
    "components": ("components", ["--method", "scan", "--repartition-every", "2"]),
}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("push_dist_ckpt"))


def _app_argvs(ckpt):
    """The app runs of the W = 2 group: each exchange for both apps, then
    a checkpointed SSSP cut after 2 iterations at 4 parts and resumed at 2."""
    runs = [("sssp", APP + a) for a in APP_RUNS.values()]
    runs += [("components", APP + a) for a in APP_RUNS.values()]
    ck = ["--rmat-scale", "9", "--rmat-ef", "8", "--seed", "21", "--device", "cpu",
          "--distributed", "--ckpt-dir", ckpt, "--ckpt-every", "1"]
    runs += [("sssp", ck + ["-ng", "4", "--max-iters", "2"]),
             ("sssp", ck + ["-ng", "2", "-check"])]
    runs += [(app, APP + ["-ng", "4", "--distributed"] + a) for app, a in APP_ARMS.values()]
    return runs


@pytest.fixture(scope="module")
def w2(ckpt_dir):
    return spawn.run_ranks(2, "torch_push_dist_jobs:run_all",
                           (CASES_W2, _app_argvs(ckpt_dir)), device="cpu", deadline_s=300)


@pytest.fixture(scope="module")
def w4():
    return spawn.run_ranks(4, "torch_push_dist_jobs:run_all", (CASES_W4, []), device="cpu",
                           deadline_s=300)


def _ref_prog(name, g):
    start = jobs.hub(g) if name in ("sssp", "wsssp") else 0
    if name in ("sssp", "sssp0"):
        return ref_sssp.SSSPProgram(nv=g.nv, start=start)
    if name == "wsssp":
        return ref_sssp.WeightedSSSPProgram(nv=g.nv, start=start)
    return ref_cc.MaxLabelProgram()


_REF = {}


def _reference(case, world):
    """The reference's run of ``case`` on ``world`` of the mesh's devices:
    (global state, iterations, traversed edges[, recuts]); once a case."""
    key = (repr(sorted(case.items())), world)
    if key not in _REF:
        _REF[key] = _reference_run(case, world)
    return _REF[key]


def _reference_run(case, world):
    spec = case["graph"]
    g = ref_generate.rmat(spec[1], spec[2], seed=spec[3], weighted=len(spec) > 4)
    prog = _ref_prog(case["prog"], g)
    P, eng = case["parts"], case["engine"]
    method = case.get("method", "scan")
    if eng == "pallas":
        sh = ref_pd.build_push_pallas_shards(g, P, v_blk=case["v_blk"],
                                             t_chunk=case["t_chunk"])
        st, it, e = ref_pd.run_push_pallas_dist(prog, sh, make_mesh(P), interpret=True)
        return sh.scatter_to_global(np.asarray(st)), int(it), ref_push.edges_total(e)
    msh = make_mesh_for_parts(P, jax.devices()[:world])
    if eng == "adaptive":
        res = ref_rep.run_push_adaptive(prog, g, P, chunk=case["chunk"],
                                        threshold=case["threshold"], method=method,
                                        mesh=msh, exchange=case["exchange"])
        return res.state, int(res.iters), ref_push.edges_total(res.edges), res.reparts
    if eng == "ring":
        sh = ref_ring.build_push_ring_shards(g, P)
        st, it, e = ref_push.run_push_ring(prog, sh, msh, method=method,
                                           merge=case.get("merge", "bulk"))
    elif eng == "delta":
        sh = ref_build_push_shards(g, P)
        st, it, e = ref_delta.run_push_delta_dist(prog, sh, case["delta"], msh,
                                                  method=method)
    else:  # dist, phases (the phases are the bulk engine's bodies)
        sh = ref_build_push_shards(g, P)
        st, it, e = ref_push.run_push_dist(prog, sh, msh, method=method,
                                           merge=case.get("merge", "bulk"))
    return sh.scatter_to_global(np.asarray(st)), int(it), ref_push.edges_total(e)


def _single(case):
    """The port's single-process run at the same parts: (state, it, edges)."""
    g = jobs.graph(case["graph"])
    prog = jobs.program(case["prog"], g)
    sh = build_push_shards(g, case["parts"])
    if case["engine"] == "delta":
        st, it, e = delta.run_push_delta(prog, sh, case["delta"], method="scan",
                                         device="cpu")
    else:
        st, it, e = push.run_push(prog, sh, method="scan", device="cpu")
    return sh.scatter_to_global(st.numpy()), it, e


def _held(groups, name, case, world):
    got = groups[0]["result"]["cases"][name]
    # every rank counted the same rounds and edges; only rank 0 holds the state
    assert all(r["result"]["cases"][name][1:] == got[1:] for r in groups)
    assert all(r["result"]["cases"][name][0] is None for r in groups[1:])
    want = _reference(case, world)
    np.testing.assert_array_equal(got[0], want[0])
    assert tuple(got[1:]) == tuple(want[1:])
    if case["engine"] != "adaptive":
        single = _single(case)
        np.testing.assert_array_equal(got[0], single[0])
        assert tuple(got[1:3]) == tuple(single[1:])


@pytest.mark.parametrize("name", list(CASES_W2))
def test_w2_k2_matches_reference_bitwise(name, w2):
    _held(w2, name, CASES_W2[name], 2)


@pytest.mark.parametrize("name", list(CASES_W4))
def test_w4_matches_reference_bitwise(name, w4):
    _held(w4, name, CASES_W4[name], 4)


def test_adaptive_cases_recut():
    """The repartition cases do recut (else they would test the static
    loop only): the reference's run of each makes at least one."""
    for cases, world in ((CASES_W2, 2), (CASES_W4, 4)):
        for name, case in cases.items():
            if case["engine"] == "adaptive":
                assert _reference(case, world)[3] > 0, name


def _app_result(w2, i):
    return [r["result"]["apps"][i] for r in w2]


@pytest.mark.parametrize("app,exchange", [(a, x) for a in ("sssp", "components")
                                          for x in APP_RUNS])
def test_apps_distributed_check(app, exchange, w2, ckpt_dir):
    """``apps.sssp``/``apps.components --distributed -check`` across 2
    ranks: rank 0 holds the state, which is bitwise the single-process
    app's; every rank's exit code is 0 and its counts agree."""
    i = [a for a, _ in _app_argvs(ckpt_dir)].index(app) + list(APP_RUNS).index(exchange)
    ranks = _app_result(w2, i)
    assert all(r["rc"] == 0 for r in ranks)
    assert ranks[1]["state"] is None
    assert all((r["iters"], r["edges"]) == (ranks[0]["iters"], ranks[0]["edges"])
               for r in ranks)
    # the memory estimate each rank printed and checked before set-up: its k
    # resident parts of the exchange's layout (common.estimate_push_dist)
    P = 2 if exchange == "pallas" else 4
    pg = mesh.PartsGroup(num_parts=P, rank=0, world=2, device=torch.device("cpu"),
                         backend="gloo")
    g = jobs.graph(G9)
    layout = {"allgather": lambda: build_push_shards(g, P),
              "ring": lambda: ring.build_push_ring_shards(g, P, parts_subset=[0, 1]),
              "pallas": lambda: pallas_dist.build_push_pallas_shards(
                  g, P, parts_subset=[0])}[exchange]()
    cfg = parse_args(APP + APP_RUNS[exchange], push=True)
    est = common.estimate_push_dist(layout, cfg, pg)
    assert all(r["estimate"] == est.total_bytes for r in ranks)
    if exchange == "allgather":
        base = preflight.scale_residency(preflight.estimate_push(layout.spec, layout.pspec), 2)
        assert est.total_bytes > base.total_bytes
    mod = sssp_app if app == "sssp" else cc_app
    parts = str(P)
    single = mod.run(APP + ["-ng", parts, "--method", "scan"])
    np.testing.assert_array_equal(ranks[0]["state"], single.state)
    assert (ranks[0]["iters"], ranks[0]["edges"]) == (single.iters, single.traversed)


def test_app_checkpoint_resumes_at_another_part_count(w2, ckpt_dir):
    """A distributed SSSP cut after 2 iterations at 4 parts (rank 0 wrote
    its checkpoints), resumed by a distributed run at 2 parts: the final
    distances, iterations and edges are the uninterrupted run's."""
    cut, resumed = (_app_result(w2, i) for i in (6, 7))
    assert cut[0]["iters"] == 2
    assert all(r["rc"] == 0 for r in resumed)
    single = sssp_app.run(APP + ["-ng", "2", "--method", "scan"])
    np.testing.assert_array_equal(resumed[0]["state"], single.state)
    assert (resumed[0]["iters"], resumed[0]["edges"]) == (single.iters, single.traversed)


@pytest.mark.parametrize("arm", list(APP_ARMS))
def test_app_arms_distributed(arm, w2, ckpt_dir):
    """--repartition-every (allgather and ring) and --delta through the
    one frontier driver across 2 ranks: every rank's exit code 0, rank 0's
    state bitwise the single-process app's, iterations and edges equal on
    every rank; the recutting runs recut on every rank alike."""
    app, argv = APP_ARMS[arm]
    i = len(_app_argvs(ckpt_dir)) - len(APP_ARMS) + list(APP_ARMS).index(arm)
    ranks = _app_result(w2, i)
    assert all(r["rc"] == 0 for r in ranks) and ranks[1]["state"] is None
    mod = sssp_app if app == "sssp" else cc_app
    plain = [a for a in argv if a not in ("--exchange", "ring")]
    single = mod.run(APP + ["-ng", "4"] + plain)
    np.testing.assert_array_equal(ranks[0]["state"], single.state)
    assert all((r["iters"], r["edges"]) == (single.iters, single.traversed) for r in ranks)
    if arm.startswith("repartition"):  # SSSP's sparse BFS tail recuts
        assert ranks[0]["recuts"] == ranks[1]["recuts"] > 0


@pytest.mark.parametrize("argv,msg", [
    (["--method", "pallas"], "add --distributed"),
    (["--method", "pallas", "-ng", "2", "--distributed", "--exchange", "ring"],
     "cannot combine with --exchange ring"),
    (["--exchange", "scatter", "--distributed"], "invalid choice"),
    (["--exchange", "ring"], "requires --distributed"),
    # routed distributed delta-stepping stays refused, as in the reference
    (["--distributed", "--weighted", "--delta", "4", "--route-gather", "expand"],
     "--distributed --delta"),
], ids=["argv0-add --distributed", "argv1-cannot combine with --exchange ring",
        "argv2-invalid choice", "argv3-requires --distributed",
        # the id this case had while the distributed routed gather was not ported
        "argv4-7.5"])
def test_app_refusals(argv, msg, capsys):
    """The reference's refusals, before any rank joins a group."""
    with pytest.raises(SystemExit) as e:
        sssp_app.run(APP + argv)
    assert msg in str(e.value) + capsys.readouterr().err


def test_pallas_push_refuses_sum_programs_and_shapes():
    class FakeSum:
        reduce = "sum"

    g = jobs.graph(G9)
    sh = pallas_dist.build_push_pallas_shards(g, 2, v_blk=128, t_chunk=128)
    pg = mesh.PartsGroup(num_parts=2, rank=0, world=2, device=torch.device("cpu"),
                         backend="gloo")
    with pytest.raises(ValueError, match="min/max frontier programs"):
        pallas_dist.run_push_pallas_dist(FakeSum(), sh, pg)
    pg4 = mesh.PartsGroup(num_parts=4, rank=0, world=2, device=torch.device("cpu"),
                          backend="gloo")
    with pytest.raises(ValueError, match="one part a rank"):
        pallas_dist.run_push_pallas_dist(jobs.program("cc", g),
                                         pallas_dist.build_push_pallas_shards(g, 4), pg4)
    # the dense rounds route their gather only: a fused plan is refused,
    # and the block-CSR push has no routed form
    with pytest.raises(ValueError, match="route their gather only"):
        push.run_push_dist(jobs.program("cc", g), build_push_shards(g, 2), pg,
                           route=(object(), ()))
    with pytest.raises(ValueError, match="no routed form"):
        push.place_layout(jobs.program("cc", g), sh, pg, route=(object(), ()))


def test_push_layouts_are_the_references():
    """PushRingShards and PushPallasShards share one partition and are the
    reference's arrays byte for byte (a rank's subset: those rows)."""
    g, rg = jobs.graph(GW9), ref_generate.rmat(9, 8, seed=21, weighted=True)
    mine = ring.build_push_ring_shards(g, 4, parts_subset=[2, 3])
    ref = ref_ring.build_push_ring_shards(rg, 4)
    np.testing.assert_array_equal(mine.cuts, ref.cuts)
    assert mine.e_bucket_pad == ref.e_bucket_pad and mine.parts_subset == [2, 3]
    for f in ref.rarrays._fields:
        np.testing.assert_array_equal(getattr(mine.rarrays, f),
                                      np.asarray(getattr(ref.rarrays, f))[2:], err_msg=f)
    for f in ref.parrays._fields:
        np.testing.assert_array_equal(getattr(mine.parrays, f),
                                      np.asarray(getattr(ref.parrays, f)), err_msg=f)
    pmine = pallas_dist.build_push_pallas_shards(g, 4, v_blk=128, t_chunk=128)
    pref = ref_pd.build_push_pallas_shards(rg, 4, v_blk=128, t_chunk=128)
    assert (pmine.num_vblocks, pmine.v_blk, pmine.t_chunk) == (
        pref.num_vblocks, pref.v_blk, pref.t_chunk)
    for f in pref.pl._fields:
        np.testing.assert_array_equal(getattr(pmine.pl, f), np.asarray(getattr(pref.pl, f)),
                                      err_msg=f)


@pytest.mark.parametrize("world", [1, 2, 3, 4, 5, 8])
def test_bruck_schedule_is_the_references(world):
    from lux_tpu.ops import merge_tree as ref_mt

    assert merge_tree.bruck_schedule(world) == ref_mt.bruck_schedule(world)
