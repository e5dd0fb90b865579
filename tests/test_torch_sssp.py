"""SSSP in lux_tpu_torch vs lux_tpu, on the CPU: the model entry point,
its host oracles and the CLI.  Integer min-relaxation, so everything is
held bitwise: distances, iteration counts, traversed edges."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lux_tpu.engine import push as ref_push
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph.push_shards import build_push_shards as ref_build
from lux_tpu.models import sssp as ref_sssp
from lux_tpu_torch.apps import sssp as app
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.csc import from_edge_list
from lux_tpu_torch.models import sssp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def graphs():
    return generate.rmat(9, 8, seed=31), ref_generate.rmat(9, 8, seed=31)


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("start", [0, 77])
def test_sssp_matches_reference_and_bfs(graphs, parts, start):
    got = sssp.sssp(graphs[0], start=start, num_parts=parts, device="cpu")
    want = ref_sssp.sssp(graphs[1], start=start, num_parts=parts, method="scatter")
    assert got.dtype == np.int32 and got.shape == (graphs[0].nv,)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, sssp.bfs_reference(graphs[0], start))
    assert sssp.check_distances(graphs[0], got) == 0


def test_bfs_oracle_matches_reference(graphs):
    for start in (0, 5, 300):
        np.testing.assert_array_equal(sssp.bfs_reference(graphs[0], start),
                                      ref_sssp.bfs_reference(graphs[1], start))


def test_path_graph():
    n = 300
    g = from_edge_list(np.arange(n - 1), np.arange(1, n), n)
    np.testing.assert_array_equal(sssp.sssp(g, start=0, device="cpu"), np.arange(n))


def test_unreachable_stay_inf():
    """Two disjoint chains; from the first, the second stays INF (== nv)."""
    n = 64
    src = np.concatenate([np.arange(0, 31), np.arange(32, 63)])
    g = from_edge_list(src, src + 1, n)
    got = sssp.sssp(g, start=0, device="cpu")
    np.testing.assert_array_equal(got[:32], np.arange(32))
    assert np.all(got[32:] == n) and sssp.inf_value(n) == n


def test_weighted_extension_matches_reference():
    g = generate.rmat(8, 6, seed=38, weighted=True, max_weight=9)
    rg = ref_generate.rmat(8, 6, seed=38, weighted=True, max_weight=9)
    got = sssp.sssp(g, start=3, weighted=True, num_parts=2, device="cpu")
    want = np.asarray(ref_sssp.sssp(rg, start=3, weighted=True, num_parts=2, method="scatter"))
    np.testing.assert_array_equal(got, want)
    assert sssp.check_distances(g, got, weighted=True) == 0
    assert sssp.inf_value(g.nv, weighted=True) == 1 << 30
    assert (got < 1 << 30).sum() > 1
    # the engine's counters too
    prog_r = ref_sssp.WeightedSSSPProgram(nv=g.nv, start=3)
    ref = ref_push.run_push(prog_r, ref_build(rg, 2), method="scatter")
    from lux_tpu_torch.engine import push
    from lux_tpu_torch.graph.push_shards import build_push_shards

    mine = push.run_push(sssp.WeightedSSSPProgram(nv=g.nv, start=3),
                         build_push_shards(g, 2), method="mxscan", device="cpu")
    np.testing.assert_array_equal(mine[0].numpy(), np.asarray(ref[0]))
    assert (mine[1], mine[2]) == (int(ref[1]), ref_push.edges_total(ref[2]))


def test_argument_errors(graphs):
    g = graphs[0]
    with pytest.raises(ValueError, match="out of range"):
        sssp.sssp(g, start=g.nv, device="cpu")
    with pytest.raises(ValueError, match="edge-weighted"):
        sssp.sssp(g, weighted=True, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        sssp.sssp(g, device="cpu", exchange="ring")
    with pytest.raises(ValueError, match="single-device"):
        sssp.sssp(g, device="cpu", mesh=object(), route=object())
    # ported since: the adaptive driver gives the static distances, and
    # delta-stepping refuses unweighted runs as the reference does
    np.testing.assert_array_equal(
        sssp.sssp(g, device="cpu", num_parts=3, repartition_every=4),
        sssp.sssp(g, device="cpu"))
    with pytest.raises(ValueError, match="WEIGHTED"):
        sssp.sssp(g, device="cpu", delta=3)


def test_check_distances_matches_reference(graphs):
    dist = sssp.sssp(graphs[0], start=0, device="cpu")
    bad = dist.copy()
    bad[np.nonzero((dist >= 2) & (dist < graphs[0].nv))[0][:3]] = 0
    for d in (dist, bad):
        assert sssp.check_distances(graphs[0], d) == ref_sssp.check_distances(graphs[1], d)
    assert sssp.check_distances(graphs[0], bad) > 0


APP = ["--rmat-scale", "9", "--device", "cpu"]


@pytest.mark.parametrize("extra", [[], ["-verbose"]])
def test_cli_exits_zero(extra):
    """`python -m lux_tpu_torch.apps.sssp --rmat-scale 9 --device cpu -check`."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-m", "lux_tpu_torch.apps.sssp", *APP, "-check",
                          *extra], env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[PASS] sssp check: 0 violations" in out.stdout
    assert ("activeNodes(" in out.stdout) == bool(extra)


@pytest.mark.parametrize("extra", [["--method", "mxscan"], ["--method", "scatter"],
                                   ["--route-gather", "expand"], ["--route-gather"],
                                   ["--weighted"], ["-verbose", "--max-iters", "3"]])
def test_app_matches_reference_engine(extra, capsys):
    """The app's state, iterations and traversed edges are the reference
    engine's on the same graph and start (cut at --max-iters, where the
    check would fail: the run stops short of the fixpoint)."""
    capped = "--max-iters" in extra
    res = app.run(APP + ["-start", "11"] + ([] if capped else ["-check"]) + extra)
    assert res.rc == 0 and ("[PASS]" in capsys.readouterr().out) != capped
    weighted = "--weighted" in extra
    rg = ref_generate.rmat(9, 8, seed=0, weighted=weighted)
    cls = ref_sssp.WeightedSSSPProgram if weighted else ref_sssp.SSSPProgram
    state, it, edges = ref_push.run_push(cls(nv=rg.nv, start=11), ref_build(rg, 1),
                                         max_iters=res.iters, method="scatter")
    sh = ref_build(rg, 1)
    np.testing.assert_array_equal(res.state, sh.scatter_to_global(np.asarray(state)))
    assert (res.iters, res.traversed) == (int(it), ref_push.edges_total(edges))
    assert res.route_gather == ("expand-pf" if extra == ["--route-gather"] else
                                "expand" if "expand" in extra else "")
    if "-verbose" in extra:
        assert res.iters == 3 and set(res.phases) == {"load", "dense", "sparse", "update"}


def test_app_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["--rmat-scale", "6"])


@pytest.mark.parametrize("argv,msg", [
    (["--method", "pallas"], "add --distributed"),
    (["--method", "cumsum"], "sum-reduce programs only"),
    (["-verbose", "--route-gather", "expand"], "cannot combine with -verbose"),
    (["--route-gather", "fused"], "invalid choice"),
    (["-start", "100000"], "out of range"),
    (["--exchange", "ring"], "requires --distributed"), (["--delta", "4"], "add --weighted"),
    (["--dtype", "bfloat16"], "unrecognized")])
def test_app_refusals(argv, msg, capsys):
    with pytest.raises(SystemExit) as e:
        app.main(APP + argv)
    assert msg in str(e.value) + capsys.readouterr().err
