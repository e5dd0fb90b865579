"""serve/fleet/pod in lux_tpu_torch, on the CPU: a pod of PodWorkers
(threads, ``device="cpu"``, real loopback sockets) holding ONE 8-part
graph is bitwise the port's single-process pull engine for hosts in
{1, 2, 3} (the uneven 3/3/2 split included), under a mutation overlay,
and for PageRank's fixed iterations; the single-process results are held
against the reference's (``tests/test_pod.py``'s cases, mirrored).  The
port's pod driver also runs the reference's pod workers over the wire
(the frames decode in both packages).  A corrupt stream never stages,
and a tree that does not fit is refused."""
import numpy as np
import pytest

from lux_tpu.engine import pull as ref_pull
from lux_tpu.graph import csc as ref_csc
from lux_tpu.graph.shards import build_pull_shards as ref_build_pull
from lux_tpu.models.sssp import SSSPProgram as RefSSSP
from lux_tpu.program.spec import active_changed as ref_active_changed
from lux_tpu.serve.fleet.pod import PodWorker as RefPodWorker
from lux_tpu_torch.engine import pull
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.format import write_lux
from lux_tpu_torch.graph.shards import build_pull_shards, to_device
from lux_tpu_torch.models.components import MaxLabelProgram
from lux_tpu_torch.models.pagerank import PageRankProgram
from lux_tpu_torch.models.sssp import SSSPProgram
from lux_tpu_torch.parallel.placement import PlacementTree
from lux_tpu_torch.program.spec import active_changed
from lux_tpu_torch.serve.fleet.pod import PodError, PodWorker, _rpc, run_pull_pod

P = 8  # parts — H=3 exercises the uneven 3/3/2 slice split
PR_RTOL = 1e-5


@pytest.fixture(scope="module")
def pod_graph(tmp_path_factory):
    """Graph, snapshot and the single-process 8-part SSSP run, from the
    hub vertex so convergence takes several rounds."""
    g = generate.rmat(10, 8, seed=3)
    snap = str(tmp_path_factory.mktemp("pod") / "g.lux")
    write_lux(snap, g)
    shards = build_pull_shards(g, P)
    arrays = to_device(shards.arrays, "cpu")
    start = int(np.argmax(g.out_degrees()))
    prog = SSSPProgram(nv=g.nv, start=start)
    single, iters = pull.run_pull_until(prog, shards.spec, arrays,
                                        pull.init_state(prog, arrays), 10_000,
                                        active_changed, method="auto")
    return {"g": g, "snap": snap, "shards": shards, "arrays": arrays,
            "start": start, "single": single.numpy(), "iters": int(iters)}


def _ref_shards(g, parts=P):
    rg = ref_csc.HostGraph(g.nv, g.ne, g.row_ptr.copy(), g.col_idx.copy())
    return ref_build_pull(rg, parts)


def _pod(n, cls=PodWorker, **kw):
    return [cls(f"p{i}", **kw).start() for i in range(n)]


def test_single_process_sssp_matches_the_reference(pod_graph):
    """The pod's yardstick, the port's single-process 8-part run, is the
    reference's single-host engine bitwise."""
    rsh = _ref_shards(pod_graph["g"])
    prog = RefSSSP(nv=rsh.spec.nv, start=pod_graph["start"])
    want, iters = ref_pull.run_pull_until(prog, rsh.spec, rsh.arrays,
                                          ref_pull.init_state(prog, rsh.arrays), 10_000,
                                          ref_active_changed, method="auto")
    assert int(iters) == pod_graph["iters"]
    assert np.array_equal(np.asarray(want), pod_graph["single"])


@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_pod_bitwise_matches_single_process(pod_graph, hosts):
    ws = _pod(hosts, device="cpu")
    res = run_pull_pod([(w.host, w.port) for w in ws], pod_graph["snap"], P,
                       app="sssp", start=pod_graph["start"])
    assert res["iters"] == pod_graph["iters"]
    assert res["state"].dtype == pod_graph["single"].dtype
    np.testing.assert_array_equal(res["state"], pod_graph["single"])
    tree = PlacementTree.build(P, hosts)
    spans = sorted((w["lo"], w["hi"]) for w in res["workers"].values())
    assert spans == [(s.lo, s.hi) for s in tree.slices]
    assert {w["method"] for w in res["workers"].values()} == {"scan"}
    assert set(res["phases"]) == {"plan", "exchange", "converge"}
    assert all(v >= 0.0 for v in res["phases"].values())
    # CPU tensors run the plain versions: no kernel counted anywhere
    assert all(sum(w["launches"].values()) == 0 for w in res["workers"].values())


def test_pod_step_launches_count_from_pod_build(pod_graph, monkeypatch):
    """A member's step reply counts the launches of ITS run only: counts
    its process made before the run's pod_build are not reported."""
    from lux_tpu_torch.ops import scan

    monkeypatch.setattr(scan.mxscan_segmented, "launches", 7)
    ws = _pod(2, device="cpu")
    res = run_pull_pod([(w.host, w.port) for w in ws], pod_graph["snap"], P,
                       app="sssp", start=pod_graph["start"])
    assert scan.mxscan_segmented.launches == 7  # the CPU runs launch nothing
    assert all(w["launches"]["mxscan_segmented"] == 0 for w in res["workers"].values())


def test_pod_components_bitwise(pod_graph):
    shards, arrays = pod_graph["shards"], pod_graph["arrays"]
    prog = MaxLabelProgram()
    want, iters = pull.run_pull_until(prog, shards.spec, arrays,
                                      pull.init_state(prog, arrays), 10_000, active_changed)
    ws = _pod(2, device="cpu")
    res = run_pull_pod([(w.host, w.port) for w in ws], pod_graph["snap"], P,
                       app="components")
    assert res["iters"] == int(iters)
    np.testing.assert_array_equal(res["state"], want.numpy())


def test_pod_overlay_bitwise(pod_graph):
    """Mutation overlays ride the wire: rows sliced per worker by the
    same tree, answers bitwise the single-process overlay run."""
    from lux_tpu_torch.mutate import overlay as ovl
    from lux_tpu_torch.mutate.deltalog import DeltaLog

    g, shards, arrays = pod_graph["g"], pod_graph["shards"], pod_graph["arrays"]
    rng = np.random.default_rng(0)
    dlog = DeltaLog(g)
    dele = rng.choice(g.ne, 25, replace=False)
    dlog.apply(g.col_idx[dele], g.dst_of_edges()[dele], np.zeros(25, np.int8))
    dlog.apply(rng.integers(0, g.nv, 25), rng.integers(0, g.nv, 25), np.ones(25, np.int8))
    ostatic, oarr = ovl.build_pull_overlay(shards, dlog, cap=256)
    prog = SSSPProgram(nv=g.nv, start=pod_graph["start"])
    want, iters = pull.run_pull_until(prog, shards.spec, arrays,
                                      pull.init_state(prog, arrays), 10_000,
                                      active_changed, overlay=(ostatic, oarr))
    assert not np.array_equal(want.numpy(), pod_graph["single"])
    ws = _pod(3, device="cpu")
    res = run_pull_pod([(w.host, w.port) for w in ws], pod_graph["snap"], P,
                       app="sssp", start=pod_graph["start"], overlay=(ostatic, oarr))
    assert res["iters"] == int(iters)
    np.testing.assert_array_equal(res["state"], want.numpy())


def test_pod_pagerank_fixed_iters(pod_graph):
    """PageRank runs exactly num_iters rounds, bitwise the single-process
    fixed driver, which is within rtol 1e-5 of the reference's."""
    shards, arrays = pod_graph["shards"], pod_graph["arrays"]
    prog = PageRankProgram(nv=shards.spec.nv)
    want = pull.run_pull_fixed(prog, shards.spec, arrays, pull.init_state(prog, arrays), 3)
    ws = _pod(2, device="cpu")
    res = run_pull_pod([(w.host, w.port) for w in ws], pod_graph["snap"], P,
                       app="pagerank", num_iters=3)
    assert res["iters"] == 3
    np.testing.assert_array_equal(res["state"], want.numpy())
    from lux_tpu.models.pagerank import PageRankProgram as RefPR

    rsh = _ref_shards(pod_graph["g"])
    rprog = RefPR(nv=rsh.spec.nv)
    ref = np.asarray(ref_pull.run_pull_fixed(rprog, rsh.spec, rsh.arrays,
                                             ref_pull.init_state(rprog, rsh.arrays), 3))
    np.testing.assert_allclose(res["state"], ref, rtol=PR_RTOL, atol=0)


def test_port_driver_runs_the_reference_pod_workers(pod_graph):
    """The pod protocol's frames decode in both packages: the port's
    run_pull_pod drives two of the REFERENCE's PodWorkers to the
    reference's answer (bitwise the port's single-process run)."""
    ws = _pod(2, cls=RefPodWorker)
    res = run_pull_pod([(w.host, w.port) for w in ws], pod_graph["snap"], P,
                       app="sssp", start=pod_graph["start"])
    assert res["iters"] == pod_graph["iters"]
    np.testing.assert_array_equal(res["state"], pod_graph["single"])


def test_pod_rejects_corrupt_stream_then_recovers(pod_graph):
    """A digest mismatch can never be staged: pod_build errors loudly,
    and a re-stream on the SAME connection succeeds."""
    from lux_tpu_torch.serve.fleet.stream import stream_file
    from lux_tpu_torch.serve.fleet.wire import Conn

    w = PodWorker("px", device="cpu").start()
    try:
        conn = Conn.connect(w.host, w.port, timeout_s=10.0, peer="pod", owner="test")
        try:
            def rpc(m):
                return _rpc(conn, m)[0]

            meta = stream_file(conn, pod_graph["snap"], "t", 256 * 1024, rpc=rpc)
            build = {"op": "pod_build", "token": "t", "num_parts": P,
                     "placement": PlacementTree.build(P, 1).to_wire(),
                     "host": 0, "app": "sssp", "start": pod_graph["start"]}
            with pytest.raises(PodError, match="digest mismatch"):
                _rpc(conn, {**build, "sha256": "0" * 64})
            with pytest.raises(PodError, match="no snapshot stream"):
                _rpc(conn, {**build, "sha256": meta["sha256"]})
            with pytest.raises(PodError, match="before pod_build"):
                _rpc(conn, {"op": "pod_step"}, np.zeros(4, np.int32))
            meta = stream_file(conn, pod_graph["snap"], "t", 256 * 1024, rpc=rpc)
            reply, state0 = _rpc(conn, {**build, "sha256": meta["sha256"]})
            assert (reply["lo"], reply["hi"]) == (0, P)
            assert state0.shape == (P, pod_graph["shards"].spec.nv_pad)
            stats, _ = _rpc(conn, {"op": "stats"})
            assert stats["builds"] == 1 and stats["device"] == "cpu"
        finally:
            conn.close()
    finally:
        w.stop()


def test_pod_tree_shape_mismatches_error(pod_graph):
    ws = _pod(2, device="cpu")
    try:
        with pytest.raises(PodError, match="names 1 hosts"):
            run_pull_pod([(w.host, w.port) for w in ws], pod_graph["snap"], P,
                         tree=PlacementTree.build(P, 1), shutdown=False)
    finally:
        for w in ws:
            w.stop()
    # a tree that disagrees with the graph's cut count is refused by the
    # WORKER (the tree travels on the wire; the check is remote)
    ws = _pod(1, device="cpu")
    with pytest.raises(PodError, match="covers 4 parts"):
        run_pull_pod([(w.host, w.port) for w in ws], pod_graph["snap"], P,
                     tree=PlacementTree.build(4, 1))
    with pytest.raises(PodError, match="unknown pod app"):
        run_pull_pod([(w.host, w.port) for w in _pod(1, device="cpu")],
                     pod_graph["snap"], P, app="bfs")
