"""Bitwise determinism of the port: identical reruns give identical bits.

Mirrors the reference's tests/test_determinism.py (its seven tests) on
lux_tpu_torch, on the CPU: each path runs twice under ``--method scatter``
where it has a method, and the two runs are held bitwise; each is also
held to lux_tpu (tolerances of the contract: f32 PageRank sums rtol 1e-5,
CF rtol 3e-5 / atol 1e-7, min programs bitwise).  On the card the scatter
method's float sums go through the sorted-key kernel, whose order is
fixed; ``tests/test_torch_cuda.py`` holds its two runs bitwise there.  The
distributed runs are gloo ranks spawned once for the module
(``parallel/spawn.run_ranks``, the jobs of ``tests/torch_dist_jobs.py``).
"""
import jax
import numpy as np
import pytest

from lux_tpu.engine import pull as ref_pull
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph.shards import build_pull_shards as ref_build_pull_shards
from lux_tpu.models import colfilter as ref_cf
from lux_tpu.models import components as ref_cc
from lux_tpu.models import pagerank as ref_pr
from lux_tpu.models import sssp as ref_sssp
from lux_tpu_torch.engine import pull
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.shards import build_pull_shards, to_device
from lux_tpu_torch.models import colfilter as cf
from lux_tpu_torch.models import components
from lux_tpu_torch.models import pagerank as pr
from lux_tpu_torch.models import sssp
from lux_tpu_torch.parallel import spawn

DIST_PR = ("rmat", 9, 8, 101)
PALLAS_PR = ("rmat", 8, 8, 104)
PALLAS_CF = ("cf", 7, 12, 105)
SCATTER_PR = ("rmat", 9, 8, 105)
CASES = {
    "allgather": {"graph": DIST_PR, "prog": "pagerank", "parts": 8, "exchange": "allgather",
                  "iters": 6, "method": "scatter"},
    "pallas": {"graph": PALLAS_PR, "prog": "pagerank", "parts": 2, "exchange": "pallas",
               "iters": 5, "v_blk": 128, "t_chunk": 128},
    "pallas_cf": {"graph": PALLAS_CF, "prog": "cf", "k": 8, "parts": 2, "exchange": "pallas",
                  "iters": 5, "v_blk": 128, "t_chunk": 128},
    "k_resident_scatter": {"graph": SCATTER_PR, "prog": "pagerank", "parts": 16,
                           "exchange": "scatter", "iters": 6, "method": "scatter"},
}


def bits(a):
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


@pytest.fixture(scope="module")
def twice():
    """Every case of CASES run twice in one spawn group of 2 gloo ranks;
    rank 0's two global states by case."""
    cases = {f"{name}/{run}": case for name, case in CASES.items() for run in "ab"}
    res = spawn.run_ranks(2, "torch_dist_jobs:run_cases", (cases,), device="cpu",
                          deadline_s=300)[0]["result"]
    return {name: (res[f"{name}/a"], res[f"{name}/b"]) for name in CASES}


def test_pagerank_bitwise_deterministic():
    g = generate.rmat(9, 8, seed=100)
    a = pr.pagerank(g, 10, method="scatter", device="cpu")
    b = pr.pagerank(g, 10, method="scatter", device="cpu")
    assert bits(a) == bits(b)
    want = np.asarray(ref_pr.pagerank(ref_generate.rmat(9, 8, seed=100), num_iters=10))
    np.testing.assert_allclose(a, want, rtol=1e-5)


def test_pagerank_dist_bitwise_deterministic(twice):
    a, b = twice["allgather"]
    assert bits(a) == bits(b)
    g = ref_generate.rmat(DIST_PR[1], DIST_PR[2], seed=DIST_PR[3])
    np.testing.assert_allclose(a, np.asarray(ref_pr.pagerank(g, num_iters=6, num_parts=8)),
                               rtol=1e-5)


def test_sssp_and_cc_bitwise_deterministic():
    g = generate.rmat(9, 8, seed=102)
    rg = ref_generate.rmat(9, 8, seed=102)
    d = sssp.sssp(g, start=0, method="scatter", device="cpu")
    assert bits(d) == bits(sssp.sssp(g, start=0, method="scatter", device="cpu"))
    np.testing.assert_array_equal(d, np.asarray(ref_sssp.sssp(rg, start=0)))
    lab = components.connected_components_push(g, method="scatter", device="cpu")
    assert bits(lab) == bits(components.connected_components_push(g, method="scatter",
                                                                   device="cpu"))
    np.testing.assert_array_equal(lab, np.asarray(ref_cc.connected_components_push(rg)))


def test_cf_bitwise_deterministic():
    g = generate.bipartite_ratings(50, 40, 600, seed=103)
    a = cf.colfilter(g, num_iters=8, gamma=1e-3, method="scatter", device="cpu")
    b = cf.colfilter(g, num_iters=8, gamma=1e-3, method="scatter", device="cpu")
    assert bits(a) == bits(b)
    want = np.asarray(ref_cf.colfilter(ref_generate.bipartite_ratings(50, 40, 600, seed=103),
                                       num_iters=8, gamma=1e-3))
    np.testing.assert_allclose(a, want, rtol=3e-5, atol=1e-7)


def test_pallas_dist_bitwise_deterministic(twice):
    """The distributed block-CSR engines (kernels 1 and 7; no method)
    rerun bitwise."""
    a, b = twice["pallas"]
    assert bits(a) == bits(b)
    g = ref_generate.rmat(PALLAS_PR[1], PALLAS_PR[2], seed=PALLAS_PR[3])
    np.testing.assert_allclose(a, ref_pr.pagerank_reference(g, 5), rtol=1e-5)
    ca, cb = twice["pallas_cf"]
    assert bits(ca) == bits(cb)
    _, scale, ef, seed = PALLAS_CF
    gw = ref_generate.bipartite_ratings(1 << (scale - 1), 1 << (scale - 1),
                                        (1 << scale) * ef // 2, seed=seed)
    np.testing.assert_allclose(ca, ref_cf.colfilter_reference(gw, 5, k=8, gamma=1e-3),
                               rtol=3e-5, atol=1e-7)


def test_sorted_layout_bitwise_deterministic():
    """The sort-segments relayout is a fixed order: reruns on it are
    bitwise identical under scatter, and within rtol 1e-5 of the
    reference's run on its own sorted layout."""
    g = generate.rmat(9, 8, seed=104)
    outs = []
    for _ in range(2):
        sh = build_pull_shards(g, 2, sort_segments=True)
        prog = pr.PageRankProgram(nv=sh.spec.nv)
        arr = to_device(sh.arrays, "cpu")
        out = pull.run_pull_fixed(prog, sh.spec, arr, pull.init_state(prog, arr), 6,
                                  method="scatter")
        outs.append(sh.scatter_to_global(out.numpy()))
    assert bits(outs[0]) == bits(outs[1])
    rsh = ref_build_pull_shards(ref_generate.rmat(9, 8, seed=104), 2, sort_segments=True)
    rprog = ref_pr.PageRankProgram(nv=rsh.spec.nv)
    rarr = jax.tree.map(np.asarray, rsh.arrays)
    want = ref_pull.run_pull_fixed(rprog, rsh.spec, rarr, ref_pull.init_state(rprog, rarr), 6)
    np.testing.assert_allclose(outs[0], rsh.scatter_to_global(np.asarray(want)), rtol=1e-5)


def test_scatter_k_resident_bitwise_deterministic(twice):
    """k-resident reduce-scatter (8 parts a rank) under the scatter
    method: bitwise reruns."""
    a, b = twice["k_resident_scatter"]
    assert bits(a) == bits(b)
    g = ref_generate.rmat(SCATTER_PR[1], SCATTER_PR[2], seed=SCATTER_PR[3])
    np.testing.assert_allclose(a, np.asarray(ref_pr.pagerank(g, num_iters=6, num_parts=16)),
                               rtol=1e-5)
