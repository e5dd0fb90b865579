"""Host-offload streaming (engine/stream.py) of lux_tpu_torch vs lux_tpu's,
on the CPU.

The same graphs (numpy, from a seed) are chunked by the reference's
``build_streamed_pull`` and the port's at the SAME ``chunk_e`` (chosen so
every part really splits into several chunks), and run through the
reference's streamed drivers (XLA on the CPU) and the port's with
device="cpu".  Tolerances: PageRank rtol 2e-5 / atol 1e-9 (f32 sums of
another association, the reference's own streamed-vs-resident bound);
weighted CF rtol 3e-5 / atol 1e-7 (likewise); max-label components
bitwise; the chunk layout (base offsets, edge arrays, rebuilt head flags,
re-based row_ptr) byte for byte.
"""
import re

import numpy as np
import pytest
import torch

from lux_tpu.engine import pull as ref_pull
from lux_tpu.engine import stream as ref_stream
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph.shards import build_pull_shards as ref_build
from lux_tpu.models import colfilter as ref_cf
from lux_tpu.models import components as ref_cc
from lux_tpu.models import pagerank as ref_pr
from lux_tpu_torch.apps import colfilter as cf_app
from lux_tpu_torch.apps import components as cc_app
from lux_tpu_torch.apps import pagerank as pr_app
from lux_tpu_torch.engine import pull, stream
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.shards import LANE, build_pull_shards, to_device
from lux_tpu_torch.models import colfilter as cf
from lux_tpu_torch.models import components as cc
from lux_tpu_torch.models import pagerank as pr

CHUNK_E = 1024


@pytest.fixture(scope="module")
def graphs():
    return generate.rmat(10, 8, seed=21), ref_generate.rmat(10, 8, seed=21)


@pytest.fixture(scope="module")
def streamed(graphs):
    """(port, reference) streamed layouts per part count."""
    out = {}
    for p in (1, 3):
        sh, rsh = build_pull_shards(graphs[0], p), ref_build(graphs[1], p)
        out[p] = (stream.build_streamed_pull(sh, CHUNK_E),
                  ref_stream.build_streamed_pull(rsh, CHUNK_E), sh)
    return out


def _ref_run(prog, rssh, iters=None, active_fn=None):
    import jax
    import jax.numpy as jnp

    s0 = ref_pull.init_state(prog, jax.tree.map(jnp.asarray, rssh.varrays))
    if active_fn is None:
        return np.asarray(ref_stream.run_pull_fixed_streamed(prog, rssh, s0, iters,
                                                             method="scan"))
    st, it = ref_stream.run_pull_until_streamed(prog, rssh, s0, 1000, active_fn,
                                                method="scan")
    return np.asarray(st), int(it)


def _state0(prog, ssh):
    return pull.init_state(prog, to_device(ssh.varrays, "cpu"))


@pytest.mark.parametrize("parts", [1, 3])
def test_chunks_equal_reference(streamed, parts):
    """Every chunk's base, edge arrays and rebuilt head flags equal the
    reference's; the device-derived re-based row_ptr equals
    ``_rebased_row_ptr``; each part really has several chunks."""
    ssh, rssh, _ = streamed[parts]
    assert len(ssh.chunks[0]) >= 3
    xfer = stream._Transfer(ssh, torch.device("cpu"))
    for p in range(parts):
        np.testing.assert_array_equal(ssh.row_ptrs[p], rssh.row_ptrs[p])
        assert len(ssh.chunks[p]) == len(rssh.chunks[p])
        for c, (a, b) in enumerate(zip(ssh.chunks[p], rssh.chunks[p])):
            assert a.lo == b.lo
            for f in ("src_pos", "dst_local", "head_flag", "weights"):
                got = getattr(a, f).numpy()
                assert got.dtype == getattr(b, f).dtype and got.tobytes() == \
                    getattr(b, f).tobytes(), (p, c, f)
            np.testing.assert_array_equal(
                xfer.take(c % 2, p, c).row_ptr.numpy(),
                ref_stream._rebased_row_ptr(rssh.row_ptrs[p], b.lo, CHUNK_E))


def test_head_flags_rebuilt_across_chunk_boundary(streamed):
    """A destination segment split across a chunk border gets a head at
    the border (the re-based row_ptr encodes it); padding keeps the
    sentinel; at least one segment really is split."""
    ssh, _, sh = streamed[1]
    V, split = sh.spec.nv_pad, 0
    rp = ssh.row_ptrs[0]
    for c, ch in enumerate(ssh.chunks[0]):
        m = int(min(sh.spec.e_pad - ch.lo, CHUNK_E))
        dst = ch.dst_local.numpy()
        if m and dst[0] < V:
            assert bool(ch.head_flag[0])
            split += int(rp[dst[0]] < ch.lo)  # the segment began in an earlier chunk
        assert (dst[m:] == V).all()
    assert split >= 1


@pytest.mark.parametrize("parts", [1, 3])
def test_streamed_pagerank_matches_reference(graphs, streamed, parts):
    ssh, rssh, sh = streamed[parts]
    g = graphs[0]
    want = _ref_run(ref_pr.PageRankProgram(nv=g.nv), rssh, 5)
    prog = pr.PageRankProgram(nv=g.nv)
    s0 = _state0(prog, ssh)
    for method in ("scan", "mxscan", "scatter"):
        got = stream.run_pull_fixed_streamed(prog, ssh, s0, 5, method=method).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-9)
    # and the resident engine's run, within the same bound
    resident = pull.run_pull_fixed(prog, sh.spec, to_device(sh.arrays, "cpu"), s0, 5,
                                   method="scan").numpy()
    np.testing.assert_allclose(got, resident, rtol=2e-5, atol=1e-9)


@pytest.mark.parametrize("parts", [1, 3])
def test_streamed_components_bitwise(graphs, streamed, parts):
    ssh, rssh, sh = streamed[parts]
    want, want_it = _ref_run(ref_cc.MaxLabelProgram(), rssh, active_fn=ref_cc.active_count)
    prog = cc.MaxLabelProgram()
    for method in ("scan", "mxscan", "scatter"):
        got, it = stream.run_pull_until_streamed(prog, ssh, _state0(prog, ssh), 1000,
                                                 cc.active_count, method=method)
        np.testing.assert_array_equal(got.numpy(), want)
        assert it == want_it
    np.testing.assert_array_equal(sh.scatter_to_global(got.numpy()),
                                  cc.fixpoint_labels(graphs[0]))


def test_streamed_weighted_cf_chunks():
    """Weighted, destination-dependent CF streams too: the chunk carries
    the weights and the destination gather."""
    g = generate.bipartite_ratings(96, 64, 1024, seed=22)
    rg = ref_generate.bipartite_ratings(96, 64, 1024, seed=22)
    sh, rsh = build_pull_shards(g, 2), ref_build(rg, 2)
    ssh, rssh = stream.build_streamed_pull(sh, 512), ref_stream.build_streamed_pull(rsh, 512)
    assert len(ssh.chunks[0]) >= 2
    want = _ref_run(ref_cf.CFProgram(gamma=1e-3), rssh, 3)
    prog = cf.CFProgram(gamma=1e-3)
    got = stream.run_pull_fixed_streamed(prog, ssh, _state0(prog, ssh), 3, method="scan")
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=1e-7)


def test_prefetch_off_bitwise(streamed, graphs):
    ssh = streamed[3][0]
    prog = pr.PageRankProgram(nv=graphs[0].nv)
    s0 = _state0(prog, ssh)
    a = stream.run_pull_fixed_streamed(prog, ssh, s0, 4, method="mxscan")
    b = stream.run_pull_fixed_streamed(prog, ssh, s0, 4, method="mxscan", prefetch=False)
    assert torch.equal(a, b)


def test_memory_sizing():
    """The port's own sizing, fitted to the card's peak memory (the
    reference's undershot it by 15 %): two 13-byte transfer buffers an
    edge, and two 4-byte compute buffers an edge and state column (four
    for a wide state); every part's int32 row_ptr, 13 bytes of vertex
    arrays and four state copies a vertex; the active chunk's re-based
    row_ptr and six vertex-sized reduce buffers a state column.  The
    chunk for a budget is the largest LANE multiple that fits."""
    from lux_tpu_torch.graph.shards import ShardSpec

    spec = ShardSpec(num_parts=2, nv=5000, ne=90_000, nv_pad=2560, e_pad=45_056,
                     weighted=False)
    for ce, sb, w in ((0, 4, 1), (4096, 4, 1), (4096, 2, 20)):
        want = (2 * 13 * ce + ce * 4 * w * (2 if w == 1 else 4)
                + 2 * 2560 * (4 + 13 + 4 * sb * w) + 2560 * (4 + 4 * w * 6))
        assert stream.streamed_hbm_bytes(spec, ce, sb, w) == want
    budget = stream.streamed_hbm_bytes(spec, 0) + 34 * 4096 + 33
    ce = stream.chunk_edges_for_budget(spec, budget)
    assert ce % LANE == 0 and stream.streamed_hbm_bytes(spec, ce) <= budget
    assert stream.streamed_hbm_bytes(spec, ce + LANE) > budget
    assert stream.chunk_edges_for_budget(spec, 1 << 40) == spec.e_pad
    with pytest.raises(ValueError, match="cannot hold"):
        stream.chunk_edges_for_budget(spec, 1000)
    assert stream.edge_bytes_total(spec) == 2 * 45_056 * 14
    with pytest.raises(ValueError, match="multiple"):
        stream.build_streamed_pull(build_pull_shards(generate.rmat(6, 4), 1), 100)


def _chunks(out):
    m = re.search(r"streamed: (\d+) chunk", out)
    return int(m.group(1)) if m else 0


def test_cli_streamed_pagerank_and_cf(capsys):
    base = ["--rmat-scale", "10", "--rmat-ef", "8", "-ni", "5", "--device", "cpu", "-check"]
    res = pr_app.run(base + ["--stream-hbm-gib", "0.00007", "-ng", "2"])
    out = capsys.readouterr().out
    assert res.rc == 0 and "[PASS]" in out and _chunks(out) >= 2
    assert res.streamed.n_chunks >= 2 and res.streamed.resident_bytes <= res.streamed.budget_bytes
    resident = pr_app.run(base + ["-ng", "2"])
    np.testing.assert_allclose(res.ranks, resident.ranks, rtol=2e-5, atol=1e-9)
    cf_res = cf_app.run(["--rmat-scale", "9", "-ni", "3", "--device", "cpu", "-check",
                         "--stream-hbm-gib", "0.0015"])
    out = capsys.readouterr().out
    assert cf_res.rc == 0 and _chunks(out) >= 2


def test_cli_streamed_components(capsys):
    argv = ["--rmat-scale", "10", "--device", "cpu", "-check"]
    res = cc_app.run(argv + ["--stream-hbm-gib", "0.00012"])
    out = capsys.readouterr().out
    assert res.rc == 0 and "[PASS] components" in out and _chunks(out) >= 2
    np.testing.assert_array_equal(res.state, cc_app.run(argv).state)


@pytest.mark.parametrize("argv,msg", [
    (["--method", "pallas"], "does not combine"), (["-verbose"], "does not combine"),
    (["--ckpt-dir", "d"], "does not combine"), (["--route-gather", "expand"],
                                                "does not combine"),
    (["--stream-hbm-gib", "0.000001"], "cannot hold")])
def test_cli_streamed_refusals(argv, msg, capsys):
    argv = ["--rmat-scale", "8", "--device", "cpu", "--stream-hbm-gib", "0.01"] + argv
    with pytest.raises((SystemExit, ValueError)) as e:
        pr_app.main(argv)
    assert msg in str(e.value) + capsys.readouterr().err
