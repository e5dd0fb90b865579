"""Delta-stepping (engine/delta.py) of lux_tpu_torch vs lux_tpu's, on the CPU.

The same weighted graphs (numpy, from a seed) go through the reference's
``run_push_delta`` (XLA on the CPU) and the port's with device="cpu".
Weighted SSSP is an integer min monoid, so everything is held bitwise:
the final states, the round counts and the traversed-edge counts; and the
distances equal the chaotic push's and scipy's Dijkstra.
"""
import numpy as np
import pytest
import torch

from lux_tpu.engine import delta as ref_delta
from lux_tpu.engine import push as ref_push
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph.push_shards import build_push_shards as ref_build
from lux_tpu.models import sssp as ref_sssp
from lux_tpu_torch import convert
from lux_tpu_torch.apps import sssp as app
from lux_tpu_torch.engine import delta, push
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.csc import from_edge_list
from lux_tpu_torch.graph.push_shards import build_push_shards
from lux_tpu_torch.models import components as cc
from lux_tpu_torch.models import sssp
from lux_tpu_torch.ops import expand

DELTAS = (1, 5, 20)


@pytest.fixture(scope="module")
def graphs():
    return (generate.rmat(9, 8, seed=3, weighted=True, max_weight=20),
            ref_generate.rmat(9, 8, seed=3, weighted=True, max_weight=20))


@pytest.fixture(scope="module")
def start(graphs):
    return int(np.argmax(graphs[0].out_degrees()))


@pytest.fixture(scope="module")
def layouts(graphs):
    return {p: (build_push_shards(graphs[0], p), ref_build(graphs[1], p)) for p in (1, 3)}


@pytest.fixture(scope="module")
def ref_runs(layouts, start):
    """The reference's (state, rounds, edges) per (parts, Δ); its results
    do not depend on its method, so it runs "scatter", the quickest to
    compile."""
    memo = {}

    def get(parts, d):
        if (parts, d) not in memo:
            sh = layouts[parts][1]
            prog = ref_sssp.WeightedSSSPProgram(nv=sh.spec.nv, start=start)
            st, it, e = ref_delta.run_push_delta(prog, sh, d, method="scatter")
            memo[parts, d] = np.asarray(st), int(it), ref_push.edges_total(e)
        return memo[parts, d]

    return get


def _port(shards, start, d, method="scan", **kw):
    prog = sssp.WeightedSSSPProgram(nv=shards.spec.nv, start=start)
    st, it, e = delta.run_push_delta(prog, shards, d, method=method, device="cpu", **kw)
    assert isinstance(it, int) and isinstance(e, int)
    return st.numpy(), it, e


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:], f"(rounds, edges): port {got[1:]}, reference {want[1:]}"


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("d", DELTAS)
@pytest.mark.parametrize("method", ["scan", "scatter", "mxscan"])
def test_delta_matches_reference(layouts, ref_runs, start, parts, d, method):
    """Bitwise: state, rounds, traversed edges."""
    _assert_same(_port(layouts[parts][0], start, d, method), ref_runs(parts, d))


@pytest.mark.parametrize("pf", [False, True])
@pytest.mark.parametrize("d", [5, 20])
def test_delta_routed_matches_reference(layouts, ref_runs, start, pf, d):
    """An expand(-pf) route on the dense rounds changes no bit (the
    reference holds its routed delta run bitwise to its direct one)."""
    sh = layouts[1][0]
    route = expand.plan_expand_shards(sh.pull, pf=pf)
    _assert_same(_port(sh, start, d, "mxscan", route=route), ref_runs(1, d))


def test_delta_equals_chaotic_and_dijkstra(graphs, layouts, start):
    scipy_sparse = pytest.importorskip("scipy.sparse")
    from scipy.sparse.csgraph import dijkstra

    g, sh = graphs[0], layouts[3][0]
    prog = sssp.WeightedSSSPProgram(nv=g.nv, start=start)
    chaotic, _, e_c = push.run_push(prog, sh, method="scan", device="cpu")
    got = {d: sh.scatter_to_global(_port(sh, start, d)[0]) for d in DELTAS}
    edges = {d: _port(sh, start, d)[2] for d in DELTAS}
    dst = g.dst_of_edges()
    order = np.lexsort((g.weights, g.col_idx, dst))
    s, t, w = g.col_idx[order], dst[order], g.weights[order]
    first = np.ones(g.ne, bool)
    first[1:] = (s[1:] != s[:-1]) | (t[1:] != t[:-1])
    A = scipy_sparse.csr_matrix((w[first], (s[first], t[first])), shape=(g.nv, g.nv))
    want = dijkstra(A, directed=True, indices=start)
    want = np.where(np.isfinite(want), want, sssp.inf_value(g.nv, True)).astype(np.int64)
    for d in DELTAS:
        np.testing.assert_array_equal(got[d], sh.scatter_to_global(chaotic.numpy()))
        np.testing.assert_array_equal(got[d], want)
        # bucket order relaxes fewer edges; Δ = 20 (the weight ceiling)
        # approaches the chaotic engine
        assert edges[d] <= e_c, (d, edges[d], e_c)
    assert edges[1] <= edges[5] <= edges[20] and edges[1] < e_c


def test_zero_weight_edges_settle():
    """0-weight edges re-enter the same bucket and converge exactly, as in
    the reference."""
    e = np.array([[0, 1, 0], [1, 2, 0], [2, 3, 4], [0, 3, 5], [3, 4, 1]], np.int64)
    g = from_edge_list(e[:, 0], e[:, 1], nv=5, weights=e[:, 2])
    from lux_tpu.graph.csc import from_edge_list as ref_from_edge_list

    rg = ref_from_edge_list(e[:, 0], e[:, 1], nv=5, weights=e[:, 2])
    got = sssp.sssp(g, start=0, weighted=True, delta=2, device="cpu")
    assert got.tolist() == [0, 0, 0, 4, 5]
    np.testing.assert_array_equal(got, ref_sssp.sssp(rg, start=0, weighted=True, delta=2))


def test_validation_errors(graphs, layouts):
    sh = layouts[1][0]
    prog = sssp.WeightedSSSPProgram(nv=sh.spec.nv)
    for d in (0, -3):
        with pytest.raises(ValueError, match="delta must be positive"):
            delta.run_push_delta(prog, sh, d, device="cpu")
    with pytest.raises(ValueError, match="min-relaxation"):
        delta.run_push_delta(cc.MaxLabelProgram(), sh, 2, device="cpu")
    with pytest.raises(ValueError, match="WEIGHTED"):
        sssp.sssp(generate.rmat(7, 4, seed=1), delta=2, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        sssp.sssp(graphs[0], weighted=True, delta=2, exchange="ring", device="cpu")


def test_mid_run_carry_from_reference(layouts, ref_runs, start):
    """The reference's carry after 4 rounds, carried into the port
    (convert.delta_carry_from_numpy), finishes bitwise as the reference's
    whole run does."""
    sh, rsh = layouts[3]
    prog_r = ref_sssp.WeightedSSSPProgram(nv=sh.spec.nv, start=start)
    import jax
    import jax.numpy as jnp

    arrays = jax.tree.map(jnp.asarray, rsh.arrays)
    parrays = jax.tree.map(jnp.asarray, rsh.parrays)
    loop = ref_delta._compile_delta_loop(prog_r, rsh.pspec, rsh.spec, "scatter", 5)
    mid = loop(arrays, parrays, ref_delta._init_carry(prog_r, rsh.pspec, arrays, 5),
               jnp.int32(4))
    carry = convert.delta_carry_from_numpy(
        {k: np.asarray(v) for k, v in mid._asdict().items()}, device="cpu")
    assert carry.it == 4
    prog = sssp.WeightedSSSPProgram(nv=sh.spec.nv, start=start)
    arr, parr = push.place(sh, "cpu")
    out = delta.run_delta_chunk(prog, sh.pspec, sh.spec, 5, arr, parr, carry, 10_000, "scan")
    _assert_same((out.state.numpy(), out.it, out.edges), ref_runs(3, 5))


def test_cli_delta(capsys):
    hub = str(int(np.argmax(generate.rmat(9, 8, seed=0, weighted=True).out_degrees())))
    res = app.run(["--rmat-scale", "9", "--weighted", "--delta", "8", "-check",
                   "--device", "cpu", "-start", hub])
    out = capsys.readouterr().out
    assert res.rc == 0 and "[PASS] sssp" in out
    chaotic = app.run(["--rmat-scale", "9", "--weighted", "--device", "cpu", "-start", hub])
    np.testing.assert_array_equal(res.state, chaotic.state)
    assert res.traversed < chaotic.traversed
    routed = app.run(["--rmat-scale", "9", "--weighted", "--delta", "8", "--device", "cpu",
                      "-start", hub, "--route-gather", "expand-pf", "--method", "mxscan"])
    np.testing.assert_array_equal(routed.state, res.state)
    assert (routed.iters, routed.traversed) == (res.iters, res.traversed)


@pytest.mark.parametrize("argv,msg", [
    (["--delta", "4"], "add --weighted"),
    (["--weighted", "--delta", "-2"], "must be positive"),
    (["--weighted", "--delta", "4", "-verbose"], "does not combine"),
    (["--weighted", "--delta", "4", "-ng", "2", "--repartition-every", "2"],
     "does not combine")])
def test_cli_delta_refusals(argv, msg, capsys):
    with pytest.raises(SystemExit) as e:
        app.main(["--rmat-scale", "6", "--device", "cpu"] + argv)
    assert msg in str(e.value) + capsys.readouterr().err


def test_delta_state_dtype_and_threshold_on_device(layouts, start):
    sh = layouts[1][0]
    prog = sssp.WeightedSSSPProgram(nv=sh.spec.nv, start=start)
    arr, parr, c0 = delta.delta_init(prog, sh, 7, device="cpu")
    assert c0.thr.dtype == torch.int32 and int(c0.thr) == 7 and int(c0.active) == 1
    c = delta.run_delta_chunk(prog, sh.pspec, sh.spec, 7, arr, parr, c0, 3, "scan")
    assert c.it == 3 and c0.it == 0  # the input carry is left untouched
    assert int(c.thr) % 7 == 0
