"""The scatter method's float sum, ``ops/segment.segment_sum_sorted``, on
the CPU: its plain version against lux_tpu's ``segment`` (f32 rtol 1e-5,
the same sums in another order), its shapes, padding sentinel and
refusals; and the kernel's precondition — the keys in range never
decrease — over every layout whose keys reach it on the card: the plain
layout, ``--sort-segments``, ``--compact-gather``, ring buckets, scatter
lanes, edge2d cells, the feat grid's parts and ring buckets, the push's
dense parts (allgather and ring) and the streamed chunks.  The CPU
wrapper checks the precondition on every call, so the engines driven
here under ``method="scatter"`` prove it on the keys they really pass.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lux_tpu.ops import segment as ref_segment
from lux_tpu_torch.engine import pull, stream
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.push_shards import build_push_shards
from lux_tpu_torch.graph.shards import build_pull_shards, to_device
from lux_tpu_torch.models import colfilter as cf
from lux_tpu_torch.models import pagerank as pr
from lux_tpu_torch.ops import segment
from lux_tpu_torch.parallel import edge2d, ring, scatter


def _keys(rng, n, e, pad_every=0):
    keys = np.sort(rng.integers(0, n, e)).astype(np.int32)
    if pad_every:
        keys[::pad_every] = n
    return keys


@pytest.mark.parametrize("k", [1, 3, 64])
@pytest.mark.parametrize("pad_every", [0, 7])
def test_plain_sum_matches_reference(k, pad_every):
    """Sums by sorted keys with padding at the tail or between the keys:
    the port's scatter sum (index_add_ on the CPU) against lux_tpu's
    segment_sum_csc(method="scatter") and a float64 sum."""
    rng = np.random.default_rng(10 * k + pad_every)
    n, e = 300, 5000
    keys = np.concatenate([_keys(rng, n, e, pad_every), np.full(64, n, np.int32)])
    shape = (keys.size,) if k == 1 else (keys.size, k)
    vals = rng.random(shape, dtype=np.float32)
    got = segment.segment_sum_sorted(torch.from_numpy(vals), torch.from_numpy(keys), n)
    assert got.shape == (n,) + shape[1:] and got.dtype == torch.float32
    want = np.zeros((n + 1,) + shape[1:])
    np.add.at(want, np.minimum(keys, n), vals.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want[:n], rtol=1e-5)
    rp = np.zeros(n + 1, np.int32)  # the reference's scatter reads dst_local only
    ref = ref_segment.segment_sum_csc(jnp.asarray(vals), jnp.asarray(rp),
                                      jnp.zeros(keys.size, bool), jnp.asarray(keys),
                                      method="scatter")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_scatter_method_widens_low_precision_once():
    """bf16 and f16 values are summed in f32 and rounded once; integer sums
    and min/max keep their order-free paths and never reach the sorted
    sum."""
    rng = np.random.default_rng(3)
    keys = torch.from_numpy(_keys(rng, 50, 2000))
    v32 = torch.from_numpy(rng.random(2000, dtype=np.float32))
    for dt in (torch.bfloat16, torch.float16):
        v = v32.to(dt)
        got = segment._scatter(v, keys, 50, "sum")
        assert got.dtype == dt
        assert torch.equal(got, segment.segment_sum_sorted(v.float(), keys, 50).to(dt))
    calls = []
    orig = segment.segment_sum_sorted
    try:
        segment.segment_sum_sorted = lambda *a: calls.append(a) or orig(*a)
        ints = torch.from_numpy(rng.integers(0, 9, 2000).astype(np.int32))
        assert segment._scatter(ints, keys, 50, "sum").dtype == torch.int32
        unsorted = keys.flip(0)  # min/max need no order
        segment._scatter(v32, unsorted, 50, "min")
        segment._scatter(v32, unsorted, 50, "max")
        assert calls == []
        segment._scatter(v32, keys, 50, "sum")
        assert len(calls) == 1
    finally:
        segment.segment_sum_sorted = orig


def test_refusals_and_empty():
    keys = torch.tensor([0, 2, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="sorted"):
        segment.segment_sum_sorted(torch.ones(3), keys, 3)
    # the sentinel (and keys past it) may sit anywhere
    ok = torch.tensor([0, 3, 1, 9, 2], dtype=torch.int32)
    assert segment.segment_sum_sorted(torch.ones(5), ok, 3).tolist() == [1.0, 1.0, 1.0]
    with pytest.raises(TypeError, match="int32"):
        segment.segment_sum_sorted(torch.ones(3), keys.long(), 3)
    with pytest.raises(ValueError, match=r"\(E,\)"):
        segment.segment_sum_sorted(torch.ones(4), keys, 3)
    with pytest.raises(TypeError, match="floats"):
        segment.segment_sum_sorted(torch.ones(3, dtype=torch.int32), keys.sort().values, 3)
    empty = segment.segment_sum_sorted(torch.zeros((0, 5)), torch.zeros(0, dtype=torch.int32), 4)
    assert empty.shape == (4, 5) and not bool(empty.any())
    assert segment.sum_scratch_bytes(8193, 1) == 2 * segment.SUM_PART_BYTES
    assert segment.sum_scratch_bytes(129, 20) == 2 * (12 + 8 * 20)


def _rows(a):
    """Every 1-D row of an (..., E) key array."""
    a = np.asarray(a)
    return a.reshape(-1, a.shape[-1])


def _layout_keys(name):
    """[(keys (E,), num_segments)] of every reduction a layout feeds."""
    g = generate.rmat(9, 8, seed=31)
    if name in ("plain", "sort_segments", "compact_gather"):
        sh = build_pull_shards(g, 3, sort_segments=name == "sort_segments",
                               compact_gather=name == "compact_gather")
        return [(r, sh.spec.nv_pad) for r in _rows(sh.arrays.dst_local)]
    if name == "ring":
        sh = ring.build_ring_shards(g, 4)
        return [(r, sh.spec.nv_pad) for r in _rows(sh.rarrays.dst_local)]
    if name == "scatter":
        sh = scatter.build_scatter_shards(g, 4)
        return [(r, sh.spec.nv_pad) for r in _rows(sh.sarrays.dst_local)]
    if name == "edge2d":
        sh = edge2d.build_edge2d_shards(g, 2, 2)
        return [(r, sh.spec.nv_pad) for r in _rows(sh.arrays2d.dst_local)]
    if name == "feat":  # run_cf_feat_dist reads the pull parts, run_cf_feat_ring buckets
        gw = generate.bipartite_ratings(128, 128, 1024, seed=4)
        sh, rs = build_pull_shards(gw, 2), ring.build_ring_shards(gw, 2)
        return ([(r, sh.spec.nv_pad) for r in _rows(sh.arrays.dst_local)]
                + [(r, rs.spec.nv_pad) for r in _rows(rs.rarrays.dst_local)])
    if name == "push_dense":
        ps, prs = build_push_shards(g, 3), ring.build_push_ring_shards(g, 4)
        return ([(r, ps.spec.nv_pad) for r in _rows(ps.pull.arrays.dst_local)]
                + [(r, prs.spec.nv_pad) for r in _rows(prs.rarrays.dst_local)])
    assert name == "stream"
    ss = stream.build_streamed_pull(build_pull_shards(g, 2), 512)
    return [(c.dst_local.numpy(), ss.spec.nv_pad) for part in ss.chunks for c in part]


@pytest.mark.parametrize("name", ["plain", "sort_segments", "compact_gather", "ring",
                                  "scatter", "edge2d", "feat", "push_dense", "stream"])
def test_every_layout_keeps_its_keys_sorted(name):
    """Each layout's destinations, once the padding sentinel is set aside,
    never decrease along a part, bucket, lane, cell or chunk: the sorted
    sum's precondition, met at build time (nothing is sorted per call)."""
    rows = _layout_keys(name)
    assert rows and sum(int((r < n).sum()) for r, n in rows) > 0
    for keys, n in rows:
        assert segment.keys_sorted(torch.from_numpy(np.ascontiguousarray(keys)), n)


@pytest.fixture
def sum_calls(monkeypatch):
    """Every call of the sorted sum, recorded (the wrapper itself checks
    the keys' order on the CPU)."""
    calls = []
    orig = segment.segment_sum_sorted

    def spy(vals, keys, n):
        calls.append((tuple(vals.shape), n))
        return orig(vals, keys, n)

    monkeypatch.setattr(segment, "segment_sum_sorted", spy)
    return calls


@pytest.mark.parametrize("layout", [{}, {"sort_segments": True}, {"compact_gather": True}])
def test_pull_engine_scatter_goes_through_the_sorted_sum(sum_calls, layout):
    g = generate.rmat(8, 8, seed=5)
    sh = build_pull_shards(g, 2, **layout)
    prog = pr.PageRankProgram(nv=g.nv)
    arr = to_device(sh.arrays, "cpu")
    got = pull.run_pull_fixed(prog, sh.spec, arr, pull.init_state(prog, arr), 3,
                              method="scatter")
    want = pull.run_pull_fixed(prog, sh.spec, arr, pull.init_state(prog, arr), 3,
                               method="scan")
    assert len(sum_calls) == 3 * 2
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)


def test_wide_and_streamed_sums_go_through_the_sorted_sum(sum_calls):
    """CF's (E, K) sum, the serving engine's (E, Q) lanes and the streamed
    chunks all reach the sorted sum with their own keys."""
    from lux_tpu_torch.serve.batched import BatchedEngine

    gw = generate.bipartite_ratings(64, 64, 800, seed=6)
    cf.colfilter(gw, 2, gamma=1e-3, method="scatter", device="cpu")
    assert any(len(s) == 2 and s[1] == cf.K for s, _ in sum_calls)
    sum_calls.clear()
    g = generate.rmat(8, 8, seed=7)
    BatchedEngine(build_pull_shards(g, 1), "ppr", 4, method="scatter", num_iters=2,
                  device="cpu").run(np.arange(4, dtype=np.int32))
    assert any(s == (build_pull_shards(g, 1).spec.e_pad, 4) for s, _ in sum_calls)
    sum_calls.clear()
    ss = stream.build_streamed_pull(build_pull_shards(g, 2), 512)
    prog = pr.PageRankProgram(nv=g.nv)
    s0 = pull.init_state(prog, to_device(ss.varrays, "cpu"))
    stream.run_pull_fixed_streamed(prog, ss, s0, 2, method="scatter", prefetch=False)
    assert sum_calls and all(s == (512,) for s, _ in sum_calls)
