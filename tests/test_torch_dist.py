"""The distributed pull engine of lux_tpu_torch (parallel/dist.py,
pallas_dist.py, multihost.py, spawn.py and the apps' --distributed arm)
against lux_tpu.parallel on the CPU.

The port's ranks are gloo processes (W = 2 and 4) spawned by
``parallel/spawn.run_ranks`` with a file:// rendezvous in a private
directory, one spawn group for each W shared by the module's tests; the
reference runs in this process on the conftest's 8-device CPU mesh, its
Pallas kernels in interpret mode.  Tolerances: the allgather exchange
changes only the exchange, so it is bitwise the port's single-process
``run_pull_fixed`` at the same P and method and within rtol 1e-5 of the
reference; min programs bitwise; the block-CSR PageRank rtol 1e-5, CF
rtol 3e-5 / atol 1e-7 (f32 sums in another order).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from lux_tpu.engine import pull as ref_pull
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph.shards import build_pull_shards as ref_build_pull_shards
from lux_tpu.models import colfilter as ref_cf
from lux_tpu.models import components as ref_cc
from lux_tpu.models import pagerank as ref_pr
from lux_tpu.parallel import dist as ref_dist
from lux_tpu.parallel import pallas_dist as ref_pd
from lux_tpu.parallel.mesh import make_mesh, make_mesh_for_parts
from lux_tpu_torch.engine import pull
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.shards import build_pull_shards, to_device
from lux_tpu_torch.models import components
from lux_tpu_torch.models import pagerank as pr
from lux_tpu_torch.parallel import mesh, multihost, pallas_dist, spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PR9 = ("rmat", 9, 8, 21)
CC8 = ("rmat", 8, 4, 5)
CF8 = ("cf", 8, 8, 3)

CASES_W2 = {
    "allgather": {"graph": PR9, "prog": "pagerank", "parts": 4, "exchange": "allgather",
                  "iters": 5},
    "phases": {"graph": PR9, "prog": "pagerank", "parts": 4, "exchange": "phases",
               "iters": 5},
    "until": {"graph": CC8, "prog": "maxlabel", "parts": 4, "exchange": "until",
              "max_iters": 100},
}
CASES_W4 = {
    "allgather": {"graph": PR9, "prog": "pagerank", "parts": 8, "exchange": "allgather",
                  "iters": 5},
    "pallas": {"graph": PR9, "prog": "pagerank", "parts": 4, "exchange": "pallas",
               "iters": 4, "v_blk": 128, "t_chunk": 128},
    "cf": {"graph": CF8, "prog": "cf", "k": 8, "parts": 4, "exchange": "pallas",
           "iters": 4, "v_blk": 128, "t_chunk": 128},
}


@pytest.fixture(scope="module")
def w2():
    return spawn.run_ranks(2, "torch_dist_jobs:run_cases", (CASES_W2,), device="cpu",
                           deadline_s=300)


@pytest.fixture(scope="module")
def w4():
    return spawn.run_ranks(4, "torch_dist_jobs:run_cases", (CASES_W4,), device="cpu",
                           deadline_s=300)


def _rmat(mod, spec):
    """The RMAT of a case's graph spec, from ``mod`` (either package's
    generator: the same draws)."""
    return mod.rmat(spec[1], spec[2], seed=spec[3])


def _ref_pagerank_dist(spec, parts, world, iters):
    g = _rmat(ref_generate, spec)
    sh = ref_build_pull_shards(g, parts)
    prog = ref_pr.PageRankProgram(nv=g.nv)
    s0 = ref_pull.init_state(prog, jax.tree.map(np.asarray, sh.arrays))
    mesh_ = make_mesh_for_parts(parts, jax.devices()[:world])
    out = ref_dist.run_pull_fixed_dist(prog, sh.spec, sh.arrays, s0, iters, mesh_,
                                       method="scan")
    return sh.scatter_to_global(np.asarray(out))


@pytest.mark.parametrize("world,parts", [(2, 4), (4, 8)])
def test_allgather_pagerank_matches_reference_and_single_process(world, parts, w2, w4):
    res = (w2 if world == 2 else w4)[0]["result"]["allgather"]
    g = _rmat(generate, PR9)
    single = pr.pagerank(g, 5, num_parts=parts, method="scan", device="cpu")
    np.testing.assert_array_equal(res, single)
    np.testing.assert_allclose(res, _ref_pagerank_dist(PR9, parts, world, 5), rtol=1e-5)
    # every rank other than 0 returns nothing
    assert all(r["result"]["allgather"] is None for r in (w2 if world == 2 else w4)[1:])


def test_verbose_phases_are_bitwise_the_fused_run(w2):
    out = w2[0]["result"]
    np.testing.assert_array_equal(out["phases"], out["allgather"])


def test_until_min_program_is_bitwise(w2):
    labels, iters = w2[0]["result"]["until"]
    g = _rmat(generate, CC8)
    sh = build_pull_shards(g, 4)
    prog = components.MaxLabelProgram()
    arrays = to_device(sh.arrays, "cpu")
    want, want_iters = pull.run_pull_until(prog, sh.spec, arrays, pull.init_state(prog, arrays),
                                           100, components.active_count_stacked, method="scan")
    np.testing.assert_array_equal(labels, sh.scatter_to_global(want.numpy()))
    assert iters == want_iters
    rg = _rmat(ref_generate, CC8)
    rsh = ref_build_pull_shards(rg, 4)
    rprog = ref_cc.MaxLabelProgram()
    s0 = ref_pull.init_state(rprog, jax.tree.map(np.asarray, rsh.arrays))
    ref, ref_iters = ref_dist.run_pull_until_dist(
        rprog, rsh.spec, rsh.arrays, s0, 100, ref_cc.active_count,
        make_mesh_for_parts(4, jax.devices()[:2]), method="scan")
    np.testing.assert_array_equal(labels, rsh.scatter_to_global(np.asarray(ref)))
    assert iters == int(ref_iters)
    assert ref_cc.check_labels(rg, labels) == 0


def test_pallas_pagerank_matches_reference(w4):
    got = w4[0]["result"]["pallas"]
    g = _rmat(ref_generate, PR9)
    pp = ref_pd.build_pallas_parts(g, 4, v_blk=128, t_chunk=128)
    prog = ref_pr.PageRankProgram(nv=pp.spec.nv)
    out = ref_pd.run_pull_fixed_pallas_dist(prog, pp, ref_pd.init_state_pallas(prog, pp), 4,
                                            make_mesh(4), interpret=True)
    np.testing.assert_allclose(got, pp.scatter_to_global(np.asarray(out)), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(got, ref_pr.pagerank_reference(g, 4), rtol=1e-5)


def test_pallas_cf_matches_reference(w4):
    got = w4[0]["result"]["cf"]
    g = ref_generate.bipartite_ratings(128, 128, (1 << 8) * 8 // 2, seed=3)
    pp = ref_pd.build_pallas_parts(g, 4, v_blk=128, t_chunk=128)
    prog = ref_cf.CFProgram(k=8, gamma=1e-3)
    out = ref_pd.run_cf_pallas_dist(prog, pp, ref_pd.init_state_pallas(prog, pp), 4,
                                    make_mesh(4), interpret=True)
    assert got.shape == (g.nv, 8)
    np.testing.assert_allclose(got, pp.scatter_to_global(np.asarray(out)), rtol=3e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got, ref_cf.colfilter_reference(g, 4, k=8, gamma=1e-3),
                               rtol=3e-5, atol=1e-7)


@pytest.mark.parametrize("parts,subset", [(3, None), (4, [2]), (4, [0, 3])])
def test_pallas_parts_layout_is_the_reference(parts, subset):
    """The block-CSR parts are byte for byte the reference's; a subset
    build holds those rows of the full build (the chunk count of every
    part decides the shapes)."""
    g = generate.rmat(8, 4, seed=23, weighted=True)
    rg = ref_generate.rmat(8, 4, seed=23, weighted=True)
    mine = pallas_dist.build_pallas_parts(g, parts, v_blk=128, t_chunk=128,
                                          parts_subset=subset)
    ref = ref_pd.build_pallas_parts(rg, parts, v_blk=128, t_chunk=128)
    rows = list(range(parts)) if subset is None else subset
    assert mine.parts_subset == rows and mine.num_vblocks == ref.num_vblocks
    for name in ref.arrays._fields:
        np.testing.assert_array_equal(getattr(mine.arrays, name),
                                      np.asarray(getattr(ref.arrays, name))[rows],
                                      err_msg=name)


def test_pallas_dist_refuses_what_the_reference_refuses():
    g = generate.rmat(6, 4, seed=1)
    pp = pallas_dist.build_pallas_parts(g, 2)
    pg = mesh.PartsGroup(num_parts=2, rank=0, world=2, device=torch.device("cpu"),
                         backend="gloo")
    with pytest.raises(ValueError, match="sum-reduce"):
        pallas_dist.run_pull_fixed_pallas_dist(components.MaxLabelProgram(), pp, None, 1, pg)
    with pytest.raises(ValueError, match="CF shape"):
        pallas_dist.run_cf_pallas_dist(pr.PageRankProgram(nv=g.nv), pp, None, 1, pg)
    pg4 = mesh.PartsGroup(num_parts=4, rank=0, world=2, device=torch.device("cpu"),
                          backend="gloo")
    with pytest.raises(ValueError, match="one part a rank"):
        pallas_dist.run_pull_fixed_pallas_dist(pr.PageRankProgram(nv=g.nv),
                                               pallas_dist.build_pallas_parts(g, 4), None, 1,
                                               pg4)
    with pytest.raises(ValueError, match="multiple of the rank count"):
        mesh.PartsGroup(num_parts=3, rank=0, world=2, device=torch.device("cpu"),
                        backend="gloo")


def test_nccl_on_a_shared_card_is_refused(monkeypatch):
    """NCCL needs a card a rank: more local ranks than cards is an error
    that names the setting, never a silent gloo; NCCL off a card too."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv(multihost.BACKEND_ENV, raising=False)
    with pytest.raises(ValueError, match=f"{multihost.BACKEND_ENV}=gloo"):
        multihost.resolve_backend(torch.device("cuda"), "nccl", local_world=2)
    with pytest.raises(ValueError, match=f"{multihost.BACKEND_ENV}=gloo"):
        multihost.resolve_backend(torch.device("cuda"), None, local_world=2)
    assert multihost.resolve_backend(torch.device("cuda"), "nccl", local_world=1) == "nccl"
    monkeypatch.setenv(multihost.BACKEND_ENV, "gloo")
    assert multihost.resolve_backend(torch.device("cuda"), None, local_world=2) == "gloo"
    with pytest.raises(ValueError, match="runs on cards"):
        multihost.resolve_backend(torch.device("cpu"), "nccl")
    monkeypatch.setenv(multihost.BACKEND_ENV, "mpi")
    with pytest.raises(ValueError, match="must be one of"):
        multihost.resolve_backend(torch.device("cpu"))


def test_a_failed_rank_fails_the_run():
    with pytest.raises(spawn.RankFailure, match="rank 1 failed"):
        spawn.run_ranks(2, "torch_dist_jobs:fail_on_rank", (1,), device="cpu",
                        deadline_s=120)


def test_checkpointed_dist_run_resumes_bitwise(tmp_path):
    """--ckpt-every under --distributed: rank 0 writes the global state
    between chunks; a later run (-verbose: the fenced phases) resumes
    from it and ends bitwise the uninterrupted single-process run."""
    ck = str(tmp_path / "ck")
    base = ["--rmat-scale", "8", "--rmat-ef", "6", "-ng", "4", "--distributed", "--device",
            "cpu", "--ckpt-dir", ck, "--ckpt-every", "2"]
    res = spawn.run_ranks(2, "torch_dist_jobs:app_runs",
                          ("pagerank", [base + ["-ni", "4"], base + ["-ni", "6", "-verbose"]]),
                          num_parts=4, device="cpu", deadline_s=240)
    first, resumed = res[0]["result"]
    assert (first["iters"], resumed["iters"]) == (4, 2) and first["rc"] == resumed["rc"] == 0
    assert sorted(os.listdir(ck)) == ["ckpt_2.npz", "ckpt_4.npz", "ckpt_6.npz"]
    want = pr.pagerank(generate.rmat(8, 6, seed=0), 6, num_parts=4, method="scan",
                       device="cpu")
    np.testing.assert_array_equal(resumed["state"], want)
    assert res[1]["result"][1]["state"] is None


CF_APP = ["--rmat-scale", "8", "--rmat-ef", "8", "-ni", "4", "--device", "cpu", "-check"]
CF_APP_RUNS = {"allgather": ["-ng", "4", "--method", "scan"],
               "ring": ["-ng", "4", "--exchange", "ring", "--method", "scan"],
               "pallas": ["-ng", "2", "--method", "pallas"]}


@pytest.fixture(scope="module")
def cf_apps():
    """``apps.colfilter.run`` under --distributed over 2 gloo ranks: the
    allgather and ring exchanges at 4 parts (2 resident a rank) and the
    block-CSR kernel path at one part a rank."""
    argvs = [CF_APP + ["--distributed"] + extra for extra in CF_APP_RUNS.values()]
    res = spawn.run_ranks(2, "torch_dist_jobs:app_runs", ("colfilter", argvs), num_parts=4,
                          device="cpu", deadline_s=300)
    return res


def _ref_cf_app(exchange: str):
    """The reference's engine for the CF app's run: its rating graph of
    CF_APP, the app's program (gamma 3.5e-7) and initial state, 4
    iterations on the CPU mesh of 2 devices; returns (initial, final)
    (nv, K) states."""
    from lux_tpu.parallel import ring as ref_ring

    g = ref_generate.bipartite_ratings(128, 128, (1 << 8) * 8 // 2, seed=0)
    prog = ref_cf.CFProgram()
    if exchange == "pallas":
        pp = ref_pd.build_pallas_parts(g, 2)
        s0 = ref_pd.init_state_pallas(prog, pp)
        out = ref_pd.run_cf_pallas_dist(prog, pp, s0, 4, make_mesh(2), interpret=True)
        return pp.scatter_to_global(np.asarray(s0)), pp.scatter_to_global(np.asarray(out))
    mesh_ = make_mesh_for_parts(4, jax.devices()[:2])
    if exchange == "ring":
        sh = ref_ring.build_ring_shards(g, 4)
        s0 = ref_pull.init_state(prog, jax.tree.map(np.asarray, sh.arrays))
        out = ref_ring.run_pull_fixed_ring(prog, sh, s0, 4, mesh_, method="scan")
    else:
        sh = ref_build_pull_shards(g, 4)
        s0 = ref_pull.init_state(prog, jax.tree.map(np.asarray, sh.arrays))
        out = ref_dist.run_pull_fixed_dist(prog, sh.spec, sh.arrays, s0, 4, mesh_,
                                           method="scan")
    return sh.scatter_to_global(np.asarray(s0)), sh.scatter_to_global(np.asarray(out))


@pytest.mark.parametrize("exchange", list(CF_APP_RUNS))
def test_colfilter_app_across_two_ranks(exchange, cf_apps, monkeypatch):
    """The CF app's --distributed arm on each exchange: rank 0 alone holds
    the state, every rank's -check passes, and the state and its change
    over the run (the app's gamma moves the latents by ~1e-5) match the
    reference's engine at rtol 3e-5 / atol 1e-7; allgather is bitwise
    the port's single-process run at the same P and method."""
    i = list(CF_APP_RUNS).index(exchange)
    got = cf_apps[0]["result"][i]
    assert got["rc"] == 0 and got["iters"] == 4
    assert all(r["result"][i]["rc"] == 0 and r["result"][i]["state"] is None
               for r in cf_apps[1:])
    from lux_tpu import native as ref_native

    # the reference's builders on their NumPy paths: its native library is not built here
    monkeypatch.setattr(ref_native, "_lib", None)
    monkeypatch.setattr(ref_native, "_tried", True)
    s0, ref = _ref_cf_app(exchange)
    assert got["state"].shape == ref.shape == (256, 20)
    np.testing.assert_allclose(got["state"], ref, rtol=3e-5, atol=1e-7)
    assert np.abs(ref - s0).max() > 100 * 1e-7  # the change is what is held
    np.testing.assert_allclose(got["state"] - s0, ref - s0, rtol=3e-5, atol=1e-7)
    if exchange == "allgather":
        from lux_tpu_torch.apps import colfilter as cf_app

        single = cf_app.run(CF_APP + CF_APP_RUNS["allgather"])
        np.testing.assert_array_equal(got["state"], single.state)


def test_cli_ring_pagerank_over_two_ranks(tmp_path):
    """`python -m torch.distributed.run --nproc-per-node 2 -m
    lux_tpu_torch.apps.pagerank --distributed --exchange ring -ng 4
    -verbose`: every rank joins gloo, rank 0 alone prints the result, the
    exchange split (-verbose) and a passing check."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "lux_tpu_torch.apps.pagerank", "--rmat-scale", "8",
           "--rmat-ef", "6", "-ni", "5", "-ng", "4", "--distributed", "--exchange", "ring",
           "--device", "cpu", "-check", "-verbose"]
    out = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("[PASS] pagerank") == 1  # rank 0 only
    assert "backend gloo" in out.stdout and "exchange: " in out.stdout
    assert out.stdout.count("top-5 rank") == 1 and out.stdout.count("ELAPSED TIME") == 1
    assert out.stdout.count("distributed: rank") == 2
