"""Connected components in lux_tpu_torch vs lux_tpu, on the CPU: the push
and pull forms, the host oracles, the on-device -check walk and the CLI.
Integer max-propagation, so everything is held bitwise."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lux_tpu.engine import push as ref_push
from lux_tpu.engine import validate as ref_validate
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph.push_shards import build_push_shards as ref_build
from lux_tpu.models import components as ref_cc
from lux_tpu.models import sssp as ref_sssp
from lux_tpu_torch.apps import components as app
from lux_tpu_torch.engine import push, validate
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.push_shards import build_push_shards
from lux_tpu_torch.models import components as cc
from lux_tpu_torch.models import sssp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fixpoint(g):
    """The max-label fixpoint, iterated on the host as tests/test_push.py
    does."""
    want = np.arange(g.nv)
    dst = g.dst_of_edges()
    while True:
        new = want.copy()
        np.maximum.at(new, dst, want[g.col_idx])
        if np.array_equal(new, want):
            return want
        want = new


@pytest.fixture(scope="module")
def graphs():
    return generate.rmat(9, 6, seed=35), ref_generate.rmat(9, 6, seed=35)


@pytest.fixture(scope="module")
def ref_labels(graphs):
    return np.asarray(ref_cc.connected_components_push(graphs[1], method="scatter"))


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("method", ["scan", "scatter", "mxscan"])
def test_push_form_matches_reference_and_fixpoint(graphs, ref_labels, parts, method):
    got = cc.connected_components_push(graphs[0], num_parts=parts, method=method,
                                       device="cpu")
    assert got.dtype == np.int32 and got.shape == (graphs[0].nv,)
    np.testing.assert_array_equal(got, ref_labels)
    np.testing.assert_array_equal(got, _fixpoint(graphs[0]))
    assert cc.check_labels(graphs[0], got) == 0


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("method", ["scan", "mxscan"])
def test_pull_form_matches_reference(graphs, ref_labels, parts, method):
    got = cc.connected_components(graphs[0], num_parts=parts, method=method, device="cpu")
    want = np.asarray(ref_cc.connected_components(graphs[1], num_parts=parts, method=method))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref_labels)


def test_fixpoint_oracle_on_a_uniform_graph():
    rg = ref_generate.uniform_random(200, 1500, seed=36)
    from lux_tpu_torch.graph.csc import HostGraph

    g = HostGraph(rg.nv, rg.ne, rg.row_ptr.copy(), rg.col_idx.copy())
    got = cc.connected_components_push(g, device="cpu")
    np.testing.assert_array_equal(got, _fixpoint(g))
    np.testing.assert_array_equal(cc.fixpoint_labels(g), _fixpoint(g))
    np.testing.assert_array_equal(got, np.asarray(ref_cc.connected_components_push(rg)))


def test_active_counts():
    old = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    new = torch.tensor([[1, 9, 3], [0, 5, 0]], dtype=torch.int32)
    assert int(cc.active_count(old[0], new[0])) == 1
    assert cc.active_count_stacked(old, new).tolist() == [1, 2]


def test_unported_arguments_raise(graphs):
    """The reference's engine options that take a group: the ring
    needs one (a parallel.mesh.PartsGroup), and the model driver's
    route= stays a single-device option, as the reference's
    (models/components.py); the routed distributed push runs through
    engine/push and the apps (tests/test_torch_routed_dist.py)."""
    with pytest.raises(ValueError, match="needs a mesh"):
        cc.connected_components_push(graphs[0], device="cpu", exchange="ring")
    with pytest.raises(ValueError, match="single-device"):
        cc.connected_components_push(graphs[0], device="cpu", mesh=object(), route=object())
    # ported since: the adaptive driver gives the static labels
    np.testing.assert_array_equal(
        cc.connected_components_push(graphs[0], device="cpu", num_parts=3,
                                     repartition_every=2),
        cc.connected_components_push(graphs[0], device="cpu"))


def _states(app_name, g, rg, parts):
    """(port shards, port stacked state tensor, reference shards,
    reference stacked state) after convergence."""
    if app_name == "sssp":
        progs = ref_sssp.SSSPProgram(nv=rg.nv, start=0), sssp.SSSPProgram(nv=g.nv, start=0)
    else:
        progs = ref_cc.MaxLabelProgram(), cc.MaxLabelProgram()
    rsh, sh = ref_build(rg, parts), build_push_shards(g, parts)
    rstate = np.asarray(ref_push.run_push(progs[0], rsh, method="scatter")[0])
    state = push.run_push(progs[1], sh, method="scatter", device="cpu")[0]
    np.testing.assert_array_equal(state.numpy(), rstate)
    return sh, state, rsh, rstate


def test_count_violations_sssp_clean_and_corrupted():
    """The on-device walk counts exactly what the host checks count, and
    what the reference's walk counts."""
    g, rg = generate.rmat(9, 8, seed=111), ref_generate.rmat(9, 8, seed=111)
    sh, state, rsh, rstate = _states("sssp", g, rg, 2)
    fn, rfn = validate.sssp_violation(inf=g.nv), ref_validate.sssp_violation(inf=g.nv)
    assert validate.count_violations(sh.pull, state, fn) == 0
    dist = sh.scatter_to_global(state.numpy())
    cand = np.nonzero((g.out_degrees() > 0) & (dist >= 2) & (dist < g.nv))[0]
    far = int(cand[0])
    p = int(np.searchsorted(sh.cuts, far, side="right") - 1)
    bad = state.clone()
    bad[p, far - int(sh.cuts[p])] = 0
    dev = validate.count_violations(sh.pull, bad, fn)
    assert dev == sssp.check_distances(g, sh.scatter_to_global(bad.numpy())) > 0
    assert dev == ref_validate.count_violations(rsh.pull, bad.numpy(), rfn)


def test_count_violations_weighted_and_cc():
    g = generate.rmat(8, 6, seed=112, weighted=True, max_weight=5)
    sh = build_push_shards(g, 3)
    prog = sssp.WeightedSSSPProgram(nv=g.nv, start=1)
    state = push.run_push(prog, sh, device="cpu")[0]
    assert validate.count_violations(sh.pull, state, validate.sssp_violation(prog.inf, True)) == 0
    rg = ref_generate.rmat(9, 6, seed=35)
    g = generate.rmat(9, 6, seed=35)
    sh, state, rsh, _ = _states("cc", g, rg, 4)
    assert validate.count_violations(sh.pull, state, validate.cc_violation()) == 0
    v = int(np.nonzero(g.in_degrees() > 0)[0][0])  # a vertex with in-edges
    p = int(np.searchsorted(sh.cuts, v, side="right") - 1)
    bad = state.clone()
    bad[p, v - int(sh.cuts[p])] = -1
    dev = validate.count_violations(sh.pull, bad, validate.cc_violation())
    assert dev == cc.check_labels(g, sh.scatter_to_global(bad.numpy())) > 0
    assert dev == ref_validate.count_violations(rsh.pull, bad.numpy(), ref_validate.cc_violation())


APP = ["--rmat-scale", "9", "--device", "cpu"]


@pytest.mark.parametrize("extra", [[], ["-verbose"]])
def test_cli_exits_zero(extra):
    """`python -m lux_tpu_torch.apps.components --rmat-scale 9 --device cpu -check`."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-m", "lux_tpu_torch.apps.components", *APP,
                          "-check", *extra], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[PASS] components check: 0 violations" in out.stdout
    assert ("activeNodes(" in out.stdout) == bool(extra)


@pytest.mark.parametrize("extra", [["--method", "mxscan"], ["--route-gather", "expand-pf"],
                                   ["-verbose"]])
def test_app_matches_reference_engine(extra, capsys):
    res = app.run(APP + ["-check"] + extra)
    assert res.rc == 0 and "[PASS]" in capsys.readouterr().out
    rg = ref_generate.rmat(9, 8, seed=0)
    rsh = ref_build(rg, 1)
    state, it, edges = ref_push.run_push(ref_cc.MaxLabelProgram(), rsh, method="scatter")
    np.testing.assert_array_equal(res.state, rsh.scatter_to_global(np.asarray(state)))
    assert (res.iters, res.traversed) == (int(it), ref_push.edges_total(edges))
    assert 0 < res.dense_rounds <= res.iters


def test_app_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["--rmat-scale", "6"])


@pytest.mark.parametrize("argv,msg", [
    (["-start", "3"], "not ported"), (["--weighted"], "not ported"),
    (["--method", "pallas"], "add --distributed"),
    (["--route-gather", "fused-mx"], "invalid choice")])
def test_app_refusals(argv, msg, capsys):
    with pytest.raises(SystemExit) as e:
        app.main(APP + argv)
    assert msg in str(e.value) + capsys.readouterr().err
