"""The reduce-scatter exchange of lux_tpu_torch (parallel/scatter.py)
against lux_tpu.parallel.scatter on the CPU.

The transposed bucket layouts (full and subset builds, weighted and not,
native and NumPy fills) are held bitwise to the reference's builder.  The
engine runs as 2 gloo ranks with 2 resident parts each (one spawn group
for the module); the reference runs in this process on the conftest's
CPU mesh.  PageRank rtol 1e-5 against the reference's scatter and 1e-4
against the float64 oracle.  CF and min/max programs are refused with
the reference's messages, by the engine and by the apps.
"""
import jax
import numpy as np
import pytest

import lux_tpu.native as ref_native
from lux_tpu.engine import pull as ref_pull
from lux_tpu.graph import generate as ref_generate
from lux_tpu.models import pagerank as ref_pr
from lux_tpu.parallel import scatter as ref_scatter
from lux_tpu.parallel.mesh import make_mesh_for_parts
from lux_tpu_torch.apps import colfilter as cf_app
from lux_tpu_torch.graph import generate
from lux_tpu_torch.models import colfilter as cf_model
from lux_tpu_torch.models import components
from lux_tpu_torch.native import io as native_io
from lux_tpu_torch.parallel import scatter, spawn

PR = ("rmat", 9, 8, 41)
CASES = {
    "pagerank": {"graph": PR, "prog": "pagerank", "parts": 4, "exchange": "scatter",
                 "iters": 5},
    "pagerank_scatter_method": {"graph": PR, "prog": "pagerank", "parts": 4,
                                "exchange": "scatter", "iters": 5, "method": "scatter"},
}


@pytest.fixture(autouse=True)
def _reference_numpy(monkeypatch):
    """The reference's builders on their NumPy paths: its native library
    is never built here."""
    monkeypatch.setattr(ref_native, "_lib", None)
    monkeypatch.setattr(ref_native, "_tried", True)


@pytest.fixture(scope="module")
def ranks():
    return spawn.run_ranks(2, "torch_dist_jobs:run_cases", (CASES,), num_parts=4,
                           device="cpu", deadline_s=300)[0]["result"]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("subset", [None, [0, 2], [3]])
@pytest.mark.parametrize("host", ["native", "numpy"])
def test_scatter_bucket_layout_is_the_reference(weighted, subset, host):
    g = generate.rmat(8, 6, seed=87, weighted=weighted)
    rg = ref_generate.rmat(8, 6, seed=87, weighted=weighted)
    if host == "numpy":
        with native_io.numpy_path():
            mine = scatter.build_scatter_shards(g, 4, parts_subset=subset)
    else:
        mine = scatter.build_scatter_shards(g, 4, parts_subset=subset)
    assert mine.host_io == host
    ref = ref_scatter.build_scatter_shards(rg, 4)
    rows = list(range(4)) if subset is None else subset
    assert mine.parts_subset == rows and mine.e_bucket_pad == ref.e_bucket_pad
    for name in ref.sarrays._fields:
        np.testing.assert_array_equal(getattr(mine.sarrays, name),
                                      np.asarray(getattr(ref.sarrays, name))[rows],
                                      err_msg=name)


def test_scatter_pagerank_k_resident_matches_reference(ranks):
    rg = ref_generate.rmat(PR[1], PR[2], seed=PR[3])
    ss = ref_scatter.build_scatter_shards(rg, 4)
    prog = ref_pr.PageRankProgram(nv=rg.nv)
    s0 = ref_pull.init_state(prog, jax.tree.map(np.asarray, ss.arrays))
    out = ref_scatter.run_pull_fixed_scatter(prog, ss, s0, 5,
                                             make_mesh_for_parts(4, jax.devices()[:2]),
                                             method="scan")
    want = ss.scatter_to_global(np.asarray(out))
    np.testing.assert_allclose(ranks["pagerank"], want, rtol=1e-5)
    np.testing.assert_allclose(ranks["pagerank"], ref_pr.pagerank_reference(rg, 5), rtol=1e-4)
    np.testing.assert_allclose(ranks["pagerank_scatter_method"], ranks["pagerank"],
                               rtol=1e-5)


@pytest.mark.parametrize("prog,msg", [
    (components.MaxLabelProgram(), "sum-reducible"),
    (cf_model.CFProgram(), "destination state")])
def test_scatter_refuses_cf_and_min_max(prog, msg):
    """The engine refuses before any set-up or collective."""
    sh = scatter.build_scatter_shards(generate.rmat(6, 4, seed=1), 2)
    with pytest.raises(ValueError, match=msg):
        scatter.run_pull_fixed_scatter(prog, sh, None, 1, None)


def test_apps_refuse_scatter_for_cf():
    with pytest.raises(SystemExit, match="sum-reducible program without per-edge"):
        cf_app.run(["--rmat-scale", "6", "-ni", "1", "--device", "cpu", "--distributed",
                    "--exchange", "scatter", "-ng", "2"])
    with pytest.raises(SystemExit, match="requires --distributed"):
        cf_app.run(["--rmat-scale", "6", "-ni", "1", "--device", "cpu", "--exchange",
                    "scatter"])
    with pytest.raises(SystemExit, match="scan or scatter"):
        cf_app.run(["--rmat-scale", "6", "-ni", "1", "--device", "cpu", "--distributed",
                    "--exchange", "ring", "--method", "mxscan", "-ng", "2"])
