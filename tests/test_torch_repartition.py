"""Adaptive repartitioning (engine/repartition.py) and the push engine's
load counter of lux_tpu_torch vs lux_tpu's, on the CPU.

The same graphs (numpy, from a seed) go through the reference's
``run_push_adaptive`` (XLA on the CPU) and the port's with device="cpu":
the recut sequence (iteration, old cuts, new cuts), the iterations and
traversed edges, and the final state are held bitwise, and the state
equals the static run's.  The recut policy's pieces (``weighted_cuts``,
``part_work``, ``vertex_weights``) are float64 host code, held exactly.
"""
import numpy as np
import pytest

from lux_tpu.engine import push as ref_push
from lux_tpu.engine import repartition as ref_rep
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph import partition as ref_partition
from lux_tpu.graph.push_shards import build_push_shards as ref_build
from lux_tpu.models import components as ref_cc
from lux_tpu.models import sssp as ref_sssp
from lux_tpu_torch import convert
from lux_tpu_torch.apps import components as cc_app
from lux_tpu_torch.apps import sssp as sssp_app
from lux_tpu_torch.engine import push, repartition
from lux_tpu_torch.graph import generate, partition
from lux_tpu_torch.graph.push_shards import build_push_shards
from lux_tpu_torch.models import components as cc
from lux_tpu_torch.models import sssp


def _progs(app, nv, start):
    if app == "sssp":
        return ref_sssp.SSSPProgram(nv=nv, start=start), sssp.SSSPProgram(nv=nv, start=start)
    return ref_cc.MaxLabelProgram(), cc.MaxLabelProgram()


@pytest.fixture(scope="module")
def graphs():
    return generate.rmat(11, 8, seed=3), ref_generate.rmat(11, 8, seed=3)


def _adaptive(app, graphs, parts, chunk, threshold, port_shards=None, ref_shards=None,
              start=0):
    """(port result, port recuts, reference result, reference recuts)."""
    g, rg = graphs
    rp, pp = _progs(app, g.nv, start)
    seen_r, seen_p = [], []
    ref = ref_rep.run_push_adaptive(
        rp, rg, parts, chunk=chunk, threshold=threshold, method="scatter",
        shards=ref_shards,
        on_repartition=lambda it, o, n, w: seen_r.append((it, o.tolist(), n.tolist())))
    got = repartition.run_push_adaptive(
        pp, g, parts, chunk=chunk, threshold=threshold, method="scan", device="cpu",
        shards=port_shards,
        on_repartition=lambda it, o, n, w: seen_p.append((it, o.tolist(), n.tolist())))
    return got, seen_p, ref, seen_r


def _static(app, g, parts, start=0):
    """The static run; SSSP's source is vertex 0 unless given (its BFS
    has a long sparse tail)."""
    prog = _progs(app, g.nv, start)[1]
    sh = build_push_shards(g, parts)
    st, it, e = push.run_push(prog, sh, method="scan", device="cpu")
    return sh.scatter_to_global(st.numpy()), it, e


@pytest.mark.parametrize("app,chunk,threshold", [
    ("sssp", 2, 1.01), ("sssp", 1, 1.0), ("cc", 1, 1.0), ("cc", 2, 1.01)])
def test_adaptive_matches_reference_and_static(graphs, app, chunk, threshold):
    got, seen_p, ref, seen_r = _adaptive(app, graphs, 4, chunk, threshold)
    assert seen_p == seen_r
    assert got.reparts == ref.reparts == len(seen_p)
    assert (got.iters, got.edges) == (int(ref.iters), ref_push.edges_total(ref.edges))
    np.testing.assert_array_equal(got.state, ref.state)
    np.testing.assert_array_equal(got.shards.cuts, ref.shards.cuts)
    static = _static(app, graphs[0], 4)
    np.testing.assert_array_equal(got.state, static[0])
    assert (got.iters, got.edges) == static[1:]
    if app == "sssp":  # the sparse BFS tail must recut at these thresholds
        assert got.reparts >= 1
    for _, old, new in seen_p:
        assert old != new and new[0] == 0 and new[-1] == graphs[0].nv


def test_overflow_defers_recut(graphs):
    """SSSP from the hub vertex with queues of 64 slots: the first two
    windows end with an overflowed queue (a truncated queue cannot be
    rebuilt), so neither may recut, in both packages, where the run with
    room in its queues recuts after the first; the state still equals
    the static run's."""
    g, rg = graphs
    hub = int(np.argmax(g.out_degrees()))
    port_sh = build_push_shards(g, 4, f_cap=64)
    ref_sh = ref_build(rg, 4, f_cap=64)
    got, seen_p, ref, seen_r = _adaptive("sssp", graphs, 4, 1, 1.0, port_sh, ref_sh, hub)
    _, free, _, _ = _adaptive("sssp", graphs, 4, 1, 1.0, start=hub)
    assert free[0][0] == 1  # with room in the queues the run recuts at once ...
    assert seen_p == seen_r and seen_p[0][0] > 2  # ... here it defers past two windows
    assert got.reparts == ref.reparts
    np.testing.assert_array_equal(got.state, _static("sssp", g, 4, hub)[0])
    np.testing.assert_array_equal(got.state, ref.state)


@pytest.mark.parametrize("parts", [2, 3, 5])
def test_weighted_cuts_and_part_work_match_reference(parts):
    rng = np.random.default_rng(parts)
    for w in (rng.random(1000) * 50, np.zeros(100), np.ones(3),
              np.where(np.arange(1024) < 128, 100.0, 1.0)):
        np.testing.assert_array_equal(partition.weighted_cuts(w, parts),
                                      ref_partition.weighted_cuts(w, parts))
    g = generate.rmat(9, 6, seed=parts)
    cuts = partition.edge_balanced_cuts(g.row_ptr, parts)
    vids = rng.integers(0, g.nv, 300)
    np.testing.assert_array_equal(partition.part_of_vertex(cuts, vids),
                                  ref_partition.part_of_vertex(cuts, vids))
    sp = rng.integers(0, 1 << 31, parts)
    for dense in (0, 3):
        work = repartition.part_work(sp, dense, cuts, g.row_ptr)
        np.testing.assert_array_equal(work, ref_rep.part_work(sp, dense, cuts, g.row_ptr))
        assert repartition.imbalance(work) == ref_rep.imbalance(work)
        np.testing.assert_array_equal(repartition.vertex_weights(work, cuts, g.row_ptr),
                                      ref_rep.vertex_weights(work, cuts, g.row_ptr))


def test_sp_work_saturates_instead_of_wrapping():
    """The per-part load counter near 2^32 saturates (a hot part stays
    hot) as the reference's uint32 does, never wraps; dense rounds add
    nothing; it stays exact far past float32's 2^24."""
    near = 0xFFFF_FF00
    out = push._acc_load((near, 1000), (0x200, 0x200), False)
    assert out == (0xFFFF_FFFF, 1000 + 0x200)
    assert push._acc_load(out, (12345, 0), False)[0] == 0xFFFF_FFFF  # absorbing
    assert push._acc_load(out, (777, 777), True) == out
    assert push._acc_load((20_000_000, 0), (3, 0), False) == (20_000_003, 0)
    import jax.numpy as jnp

    ref = ref_push.PushCarry(None, None, None, None, None, None, None,
                             jnp.asarray([near, 1000], jnp.uint32), jnp.int32(0))
    want = ref_push._acc_load(ref, jnp.asarray([0x200, 0x200], jnp.int32), jnp.bool_(False))[0]
    assert tuple(int(x) for x in np.asarray(want)) == out


@pytest.mark.parametrize("app", ["sssp", "cc"])
def test_sp_work_and_mid_run_carry_match_reference(graphs, app):
    """The port's carry after a window holds the reference's sp_work and
    dense rounds; the reference's mid-run carry, carried into the port
    (convert.push_carry_from_numpy), finishes as the reference does."""
    import jax
    import jax.numpy as jnp

    g, rg = graphs
    start = int(np.argmax(g.out_degrees()))
    rp, pp = _progs(app, g.nv, start)
    rsh, sh = ref_build(rg, 3), build_push_shards(g, 3)
    arrays, parrays, c0 = ref_push.push_init(rp, rsh)
    loop = ref_push.compile_push_chunk(rp, rsh.pspec, rsh.spec, "scatter")
    mid = loop(arrays, parrays, c0, jnp.int32(3))
    end = loop(arrays, parrays, c0, jnp.int32(10_000))
    parr = push.place(sh, "cpu")
    mine = push.run_push_chunk(pp, sh.pspec, sh.spec, *parr,
                               push._init_carry(pp, sh.pspec, parr[0]), 3, "scan")
    assert mine.sp_work == tuple(int(x) for x in np.asarray(mid.sp_work))
    assert mine.dense_rounds == int(mid.dense_rounds) and mine.it == int(mid.it)
    carry = convert.push_carry_from_numpy(
        {k: np.asarray(v) for k, v in mid._asdict().items()}, device="cpu")
    assert carry.sp_work == mine.sp_work and carry.edges == mine.edges
    out = push.run_push_chunk(pp, sh.pspec, sh.spec, *parr, carry, 10_000, "scan")
    np.testing.assert_array_equal(out.state.numpy(), np.asarray(end.state))
    assert (out.it, out.edges) == (int(end.it), ref_push.edges_total(end.edges))
    assert out.sp_work == tuple(int(x) for x in np.asarray(end.sp_work))
    del jax


def test_refusals_and_wrappers(graphs):
    g = graphs[0]
    prog = cc.MaxLabelProgram()
    for kw, exc in (({"exchange": "ring", "sort_segments": True}, ValueError),
                    ({"exchange": "ring"}, ValueError),
                    ({"exchange": "scatter"}, ValueError), ({"chunk": 0}, ValueError)):
        with pytest.raises(exc):
            repartition.run_push_adaptive(prog, g, 2, device="cpu", **kw)
    want = cc.connected_components_push(g, device="cpu")
    np.testing.assert_array_equal(
        cc.connected_components_push(g, num_parts=4, repartition_every=1,
                                     repartition_threshold=1.0, device="cpu"), want)


@pytest.mark.parametrize("app", ["sssp", "components"])
def test_cli_repartition(app, capsys):
    """-ng 4 --repartition-every 2 through the apps, with -check; equal to
    the static -ng 4 run."""
    mod = sssp_app if app == "sssp" else cc_app
    g = generate.rmat(11, 8, seed=0)
    base = ["--rmat-scale", "11", "--device", "cpu", "-ng", "4"]
    res = mod.run(base + ["--repartition-every", "2", "--repartition-threshold", "1.01",
                          "-check"], graph=g)
    out = capsys.readouterr().out
    assert res.rc == 0 and "repartition(s)" in out
    static = mod.run(base, graph=g)
    np.testing.assert_array_equal(res.state, static.state)
    assert (res.iters, res.traversed, res.dense_rounds) == (
        static.iters, static.traversed, static.dense_rounds)
    assert len(res.recuts) == int(out.split(" repartition(s)")[0].split()[-1])
    if app == "sssp":
        assert res.recuts, "the BFS tail recuts at threshold 1.01"


@pytest.mark.parametrize("argv,msg", [
    (["--repartition-every", "2", "-verbose"], "not available"),
    (["--repartition-every", "-1"], "must be positive"),
    (["--repartition-every", "2", "--route-gather", "expand"], "cannot combine"),
    (["--repartition-every", "2", "--ckpt-dir", "d", "--ckpt-every", "1"],
     "does not combine")])
def test_cli_repartition_refusals(argv, msg, capsys):
    with pytest.raises(SystemExit) as e:
        sssp_app.main(["--rmat-scale", "6", "--device", "cpu", "-ng", "2"] + argv)
    assert msg in str(e.value) + capsys.readouterr().err


def test_placed_layout_is_the_only_copy(graphs):
    """``placed=`` hands the adaptive driver a layout already on the
    device: it runs on that layout (nothing placed twice), releases its
    statics at the first recut before the rebuilt layout is placed, and
    the result is bitwise the run that placed its own."""
    g, _ = graphs
    prog = sssp.SSSPProgram(nv=g.nv, start=0)  # its sparse BFS tail recuts
    sh = build_push_shards(g, 4)
    placed = []
    real = push.place_layout

    def counted(*a, **kw):
        placed.append(a[1])
        return real(*a, **kw)

    lay = push.place_layout(prog, sh, None, "scan", "cpu")
    seen = []
    try:
        push.place_layout = counted
        got = repartition.run_push_adaptive(
            prog, g, 4, chunk=1, threshold=1.0, method="scan", device="cpu", placed=lay,
            on_repartition=lambda it, o, n, w: seen.append(it))
    finally:
        push.place_layout = real
    assert got.reparts == len(seen) == len(placed) > 0
    assert all(s is not sh for s in placed)  # only the recuts' layouts were placed
    assert lay.view is None and lay.arrays is None and lay.parrays is None
    want = repartition.run_push_adaptive(prog, g, 4, chunk=1, threshold=1.0, method="scan",
                                         device="cpu", shards=sh)
    np.testing.assert_array_equal(got.state, want.state)
    assert (got.iters, got.edges, got.reparts) == (want.iters, want.edges, want.reparts)
