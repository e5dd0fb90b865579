"""The ring exchange of lux_tpu_torch (parallel/ring.py) against
lux_tpu.parallel.ring on the CPU.

The bucket layouts (full and subset builds, weighted and not, native and
NumPy fills) are held bitwise to the reference's builder.  The engine
runs as 2 gloo ranks with 2 parts each (k = 2 resident parts), one spawn
group shared by the module's tests; the reference runs in this process
on the conftest's CPU mesh.  Tolerances: PageRank rtol 1e-5 against the
reference's ring and 1e-4 against the float64 oracle; the max-label
program bitwise; CF at its full (V, 20) width rtol 3e-5 / atol 1e-7.
"""
import jax
import numpy as np
import pytest

import lux_tpu.native as ref_native
from lux_tpu.engine import pull as ref_pull
from lux_tpu.graph import generate as ref_generate
from lux_tpu.models import colfilter as ref_cf
from lux_tpu.models import components as ref_cc
from lux_tpu.models import pagerank as ref_pr
from lux_tpu.parallel import ring as ref_ring
from lux_tpu.parallel.mesh import make_mesh_for_parts
from lux_tpu_torch.graph import generate
from lux_tpu_torch.native import io as native_io
from lux_tpu_torch.parallel import ring, spawn

PR = ("rmat", 9, 8, 31)
CC = ("rmat", 8, 4, 32)
CF = ("cf", 8, 8, 33)

CASES = {
    "pagerank": {"graph": PR, "prog": "pagerank", "parts": 4, "exchange": "ring",
                 "iters": 5},
    "pagerank_scatter": {"graph": PR, "prog": "pagerank", "parts": 4, "exchange": "ring",
                         "iters": 5, "method": "scatter"},
    "maxlabel": {"graph": CC, "prog": "maxlabel", "parts": 4, "exchange": "ring",
                 "iters": 30},
    "cf": {"graph": CF, "prog": "cf", "parts": 4, "exchange": "ring", "iters": 4},
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


def _ref_graph(spec):
    if spec[0] == "cf":
        n_half = (1 << spec[1]) // 2
        return ref_generate.bipartite_ratings(n_half, n_half, (1 << spec[1]) * spec[2] // 2,
                                              seed=spec[3])
    return ref_generate.rmat(spec[1], spec[2], seed=spec[3])


def _ref_ring(prog, spec, iters, method="scan"):
    g = _ref_graph(spec)
    rs = ref_ring.build_ring_shards(g, 4)
    s0 = ref_pull.init_state(prog, jax.tree.map(np.asarray, rs.arrays))
    out = ref_ring.run_pull_fixed_ring(prog, rs, s0, iters,
                                       make_mesh_for_parts(4, jax.devices()[:2]),
                                       method=method)
    return g, rs.scatter_to_global(np.asarray(out))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("subset", [None, [1, 3], [2]])
@pytest.mark.parametrize("host", ["native", "numpy"])
def test_ring_bucket_layout_is_the_reference(weighted, subset, host):
    g = generate.rmat(8, 6, seed=97, weighted=weighted)
    rg = ref_generate.rmat(8, 6, seed=97, weighted=weighted)
    if host == "numpy":
        with native_io.numpy_path():
            mine = ring.build_ring_shards(g, 4, parts_subset=subset)
    else:
        mine = ring.build_ring_shards(g, 4, parts_subset=subset)
    assert mine.host_io == host
    ref = ref_ring.build_ring_shards(rg, 4)
    rows = list(range(4)) if subset is None else subset
    assert mine.parts_subset == rows and mine.e_bucket_pad == ref.e_bucket_pad
    for name in ref.rarrays._fields:
        np.testing.assert_array_equal(getattr(mine.rarrays, name),
                                      np.asarray(getattr(ref.rarrays, name))[rows],
                                      err_msg=name)
    # every edge in exactly one bucket of the full build
    if subset is None:
        assert int((mine.rarrays.dst_local < mine.spec.nv_pad).sum()) == g.ne


def test_ring_subset_from_a_placement_slice():
    from lux_tpu_torch.parallel.placement import PlacementTree

    g = generate.rmat(8, 6, seed=90)
    tree = PlacementTree.build(4, 2)
    a = ring.build_ring_shards(g, 4, placement=tree, host=1)
    b = ring.build_ring_shards(g, 4, parts_subset=[2, 3])
    assert a.parts_subset == [2, 3]
    for x, y in zip(a.rarrays, b.rarrays):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="not both"):
        ring.build_ring_shards(g, 4, parts_subset=[0], placement=tree)


def test_ring_pagerank_matches_reference(ranks):
    g, want = _ref_ring(ref_pr.PageRankProgram(nv=1 << 9), PR, 5)
    np.testing.assert_allclose(ranks["pagerank"], want, rtol=1e-5)
    np.testing.assert_allclose(ranks["pagerank"], ref_pr.pagerank_reference(g, 5), rtol=1e-4)
    np.testing.assert_allclose(ranks["pagerank_scatter"], ranks["pagerank"], rtol=1e-5)


def test_ring_min_program_is_bitwise(ranks):
    g, want = _ref_ring(ref_cc.MaxLabelProgram(), CC, 30)
    np.testing.assert_array_equal(ranks["maxlabel"], want)
    assert ref_cc.check_labels(g, ranks["maxlabel"]) == 0


def test_ring_cf_wide_state(ranks):
    prog = ref_cf.CFProgram(gamma=1e-3)
    g, want = _ref_ring(prog, CF, 4)
    got = ranks["cf"]
    assert got.shape == (g.nv, ref_cf.K)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=1e-7)
    np.testing.assert_allclose(got, ref_cf.colfilter_reference(g, 4, gamma=1e-3),
                               rtol=3e-5, atol=1e-7)


def test_ring_refuses_prefix_methods():
    with pytest.raises(ValueError, match="scan or scatter"):
        ring.resolve_bucketed("mxscan", "sum", "cpu")
    with pytest.raises(ValueError, match="scan or scatter"):
        ring.resolve_bucketed("cumsum", "sum", "cpu")
    # auto resolves to a method the buckets run, on the card too
    assert ring.resolve_bucketed("auto", "sum", "cpu") == "scan"
    assert ring.resolve_bucketed("auto", "min", "cuda") == "scan"
