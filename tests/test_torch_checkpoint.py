"""Checkpoint/resume (utils/checkpoint.py and the apps' --ckpt-dir /
--ckpt-every) of lux_tpu_torch, against lux_tpu's on the CPU.

The format is the reference's, so a checkpoint written by either package
resumes in the other (f32 and bf16 state; the iteration, frontier and
delta forms).  An interrupted-then-resumed run is held bitwise to an
uninterrupted one (state, iterations and traversed edges) for PageRank,
SSSP, delta-stepping SSSP and components, also across part counts
(-ng 1 <-> 3: the checkpoints are global, elastic).
"""
import os

import numpy as np
import pytest
import torch

from lux_tpu.utils import checkpoint as ref_ckpt
from lux_tpu_torch.apps import components as cc_app
from lux_tpu_torch.apps import pagerank as pr_app
from lux_tpu_torch.apps import sssp as sssp_app
from lux_tpu_torch.graph import generate
from lux_tpu_torch.utils import checkpoint as ckpt


def _bf16(a):
    import ml_dtypes

    return a.astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_iteration_checkpoints_cross_packages(tmp_path, dtype):
    rng = np.random.default_rng(1)
    state = rng.random((37,), dtype=np.float32)
    # reference writes, port resumes
    ref_dir = str(tmp_path / "ref")
    ref_ckpt.save_iteration(ref_dir, 4, _bf16(state) if dtype == "bfloat16" else state, "pagerank")
    got, it, path = ckpt.load_resume(ref_dir, "pagerank", 37)
    assert it == 4 and path.endswith("ckpt_4.npz")
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        want = torch.from_numpy(state).to(torch.bfloat16)
        assert torch.equal(got, want)
    else:
        assert got.dtype == np.float32 and got.tobytes() == state.tobytes()
    # port writes (a torch tensor or a numpy array), reference resumes
    for k, src in enumerate((torch.from_numpy(state), state)):
        port_dir = str(tmp_path / f"port{k}")
        if dtype == "bfloat16":
            src = torch.from_numpy(state).to(torch.bfloat16) if k == 0 else _bf16(state)
        ckpt.save_iteration(port_dir, 6, src, "pagerank")
        back, it2, _ = ref_ckpt.load_resume(port_dir, "pagerank", 37)
        assert it2 == 6 and str(back.dtype) == dtype
        want = _bf16(state) if dtype == "bfloat16" else state
        assert np.asarray(back).tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("form", ["frontier", "delta"])
def test_mask_checkpoints_cross_packages(tmp_path, form):
    rng = np.random.default_rng(2)
    state = rng.integers(0, 1 << 30, 50).astype(np.int32)
    mask = rng.random(50) < 0.3
    edges = (3 << 32) + 12345  # past 2^32: the [hi, lo] pair carries it
    for writer, reader in ((ref_ckpt, ckpt), (ckpt, ref_ckpt)):
        d = str(tmp_path / writer.__name__.replace(".", "_"))
        e = np.array([3, 12345], np.uint32) if writer is ref_ckpt else edges
        if form == "frontier":
            writer.save_frontier(d, 7, state, mask, e, "sssp")
            s, m, got_e, it, _ = reader.load_resume_frontier(d, "sssp", 50)
        else:
            writer.save_delta(d, 7, state, mask, e, 40, "sssp")
            s, m, got_e, thr, it, _ = reader.load_resume_delta(d, "sssp", 50)
            assert thr == 40
        assert it == 7
        np.testing.assert_array_equal(s, state)
        np.testing.assert_array_equal(m, mask)
        got_int = got_e if isinstance(got_e, int) else ckpt.edges_int(got_e)
        assert got_int == edges


def test_resume_validation(tmp_path):
    d = str(tmp_path)
    assert ckpt.load_resume(d, "pagerank", 5) == (None, 0, None)
    assert ckpt.load_resume_frontier(str(tmp_path / "none"), "sssp", 5)[0] is None
    ckpt.save_iteration(d, 2, np.zeros(5, np.float32), "pagerank")
    ckpt.save_iteration(d, 10, np.zeros(5, np.float32), "pagerank")
    assert ckpt.latest(d).endswith("ckpt_10.npz")
    with pytest.raises(SystemExit, match="refusing to resume"):
        ckpt.load_resume(d, "colfilter", 5)
    with pytest.raises(SystemExit, match="nv=5"):
        ckpt.load_resume(d, "pagerank", 6)
    with pytest.raises(SystemExit, match="layout"):
        ckpt.load_resume_frontier(d, "pagerank", 5)


def _pr(tmp, extra, ni):
    argv = ["--rmat-scale", "9", "--rmat-ef", "6", "-ni", str(ni), "--device", "cpu",
            "--method", "mxscan"] + extra
    return pr_app.run(argv)


@pytest.mark.parametrize("parts", [(1, 1), (1, 3), (3, 1)])
def test_pagerank_interrupted_resume_bitwise(tmp_path, parts):
    """-ni 4 with --ckpt-every 2, then -ni 8 resuming from iteration 4
    (on the same or another part count), equals -ni 8 uninterrupted on
    the resuming run's part count, bit for bit."""
    d = str(tmp_path / "ck")
    first = _pr(tmp_path, ["--ckpt-dir", d, "--ckpt-every", "2", "-ng", str(parts[0])], 4)
    assert first.iters == 4 and sorted(os.listdir(d)) == ["ckpt_2.npz", "ckpt_4.npz"]
    resumed = _pr(tmp_path, ["--ckpt-dir", d, "--ckpt-every", "2", "-ng", str(parts[1])], 8)
    assert resumed.iters == 4
    whole = _pr(tmp_path, ["-ng", str(parts[1])], 8)
    if parts[0] == parts[1]:
        assert resumed.ranks.tobytes() == whole.ranks.tobytes()
    else:  # another part count sums in another order
        np.testing.assert_allclose(resumed.ranks, whole.ranks, rtol=2e-5, atol=1e-9)


def test_pagerank_verbose_and_plain_resume(tmp_path, capsys):
    """-verbose with checkpoints prints the fenced phases; --ckpt-dir alone
    resumes and runs the rest in one timed window."""
    d = str(tmp_path / "ck")
    a = _pr(tmp_path, ["--ckpt-dir", d, "--ckpt-every", "3", "-verbose"], 3)
    assert "loadTime(" in capsys.readouterr().out
    b = _pr(tmp_path, ["--ckpt-dir", d], 6)
    assert "resumed from" in capsys.readouterr().out and b.iters == 3
    assert b.ranks.tobytes() == _pr(tmp_path, [], 6).ranks.tobytes()
    del a


def _hub(weighted):
    return str(int(np.argmax(generate.rmat(10, 8, seed=0, weighted=weighted).out_degrees())))


PUSH_CASES = {
    "sssp": (sssp_app, ["-start", _hub(False)]),
    "sssp-delta": (sssp_app, ["-start", _hub(True), "--weighted", "--delta", "6"]),
    "components": (cc_app, []),
}


@pytest.mark.parametrize("parts", [(1, 1), (1, 3), (3, 1)])
@pytest.mark.parametrize("case", sorted(PUSH_CASES))
def test_push_interrupted_resume_bitwise(tmp_path, case, parts):
    """A run cut at --max-iters 2 (checkpoint every iteration), then
    resumed to convergence (on the same or another part count), ends with
    the uninterrupted run's state, iterations and traversed edges."""
    app, extra = PUSH_CASES[case]
    d = str(tmp_path / "ck")
    base = ["--rmat-scale", "10", "--device", "cpu"] + extra
    ck = ["--ckpt-dir", d, "--ckpt-every", "1"]
    cut = app.run(base + ck + ["-ng", str(parts[0]), "--max-iters", "2"])
    assert cut.iters == 2 and os.path.exists(os.path.join(d, "ckpt_2.npz"))
    resumed = app.run(base + ck + ["-ng", str(parts[1]), "-check"])
    whole = app.run(base + ["-ng", str(parts[1])])
    assert resumed.rc == 0
    np.testing.assert_array_equal(resumed.state, whole.state)
    assert (resumed.iters, resumed.traversed) == (whole.iters, whole.traversed)


@pytest.mark.parametrize("argv,msg", [
    (["--ckpt-dir", "d"], "pass BOTH"), (["--ckpt-every", "2"], "requires --ckpt-dir"),
    (["--ckpt-dir", "d", "--ckpt-every", "2", "-verbose"], "does not combine"),
    (["--ckpt-dir", "d", "--ckpt-every", "2", "--route-gather", "expand"],
     "cannot combine")])
def test_needs_both_flags(argv, msg, capsys):
    with pytest.raises(SystemExit) as e:
        sssp_app.main(["--rmat-scale", "6", "--device", "cpu"] + argv)
    assert msg in str(e.value) + capsys.readouterr().err


def test_pallas_refuses_checkpoints(capsys):
    for extra in (["--ckpt-dir", "d"], ["-verbose"]):
        with pytest.raises(SystemExit, match="not wired to the kernel path"):
            pr_app.main(["--rmat-scale", "6", "--device", "cpu", "--method", "pallas"] + extra)
