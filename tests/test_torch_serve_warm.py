"""serve/warm in lux_tpu_torch vs lux_tpu, on the CPU: engine keys, the
pre-warm and hit accounting, layout invalidation, the LRU bound, method
resolution, and ONE device copy of the shard arrays shared by every
engine of a layout."""
import numpy as np
import pytest

from lux_tpu.graph import csc as ref_csc
from lux_tpu.graph.shards import build_pull_shards as ref_build_pull
from lux_tpu.serve import warm as ref_warm
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.shards import build_pull_shards
from lux_tpu_torch.models.sssp import bfs_reference
from lux_tpu_torch.serve.metrics import ServeMetrics
from lux_tpu_torch.serve.warm import (DEFAULT_Q_BUCKETS, EngineKey, WarmEngineCache,
                                      layout_key)


@pytest.fixture(scope="module")
def small():
    g = generate.rmat(8, 4, seed=4)
    return g, build_pull_shards(g, 2)


def test_prewarm_and_hit_accounting(small):
    g, shards = small
    cache = WarmEngineCache(shards, apps=("sssp",), q_buckets=(1, 4), device="cpu")
    assert cache.warm_buckets("sssp") == ()
    spent = cache.prewarm()
    assert spent > 0 and cache.warm_buckets("sssp") == (1, 4)
    eng, warm = cache.get("sssp", 4)
    assert warm and eng.q == 4
    assert cache.stats()["warm_hits"] == 1
    _, warm = cache.get("sssp", 2)  # an unwarmed bucket is a cold build
    assert not warm
    _, warm2 = cache.get("sssp", 2)
    assert warm2
    st = cache.stats()
    assert st["cold_traces"] == 1 and st["warm_hits"] == 2
    assert 0 < st["warm_hit_ratio"] < 1
    out = eng.run(np.asarray([0, 1, 2, 3], np.int32))
    assert out.state.shape == (4, g.nv)


def test_stats_keys_match_reference(small):
    g, shards = small
    rg = ref_csc.HostGraph(g.nv, g.ne, g.row_ptr.copy(), g.col_idx.copy())
    ref = ref_warm.WarmEngineCache(ref_build_pull(rg, 2), apps=("sssp",), q_buckets=(1,))
    mine = WarmEngineCache(shards, apps=("sssp",), q_buckets=(1,), device="cpu")
    assert set(mine.stats()) == set(ref.stats())
    assert layout_key(shards) == ref_warm.layout_key(ref_build_pull(rg, 2))
    assert DEFAULT_Q_BUCKETS == ref_warm.DEFAULT_Q_BUCKETS
    mine.prewarm()
    ref.prewarm()
    for c in (mine, ref):
        c.get("sssp", 1)
        c.get("sssp", 3)
    a, b = mine.stats(), ref.stats()
    for k in ("engines", "engines_warm", "max_engines", "occupancy", "evictions",
              "warm_hits", "cold_traces", "warm_hit_ratio"):
        assert a[k] == b[k], k


def test_engine_key_binds_layout(small):
    g, shards = small
    cache = WarmEngineCache(shards, apps=("sssp",), q_buckets=(2,), device="cpu")
    cache.prewarm()
    assert cache.is_warm("sssp", 2)
    other = build_pull_shards(g, 4)  # different part geometry
    assert layout_key(other) != layout_key(shards)
    cache.install_shards(other)
    assert not cache.is_warm("sssp", 2)  # old-layout engines dropped
    cache.prewarm()
    eng, _ = cache.get("sssp", 2)
    hub = int(np.argmax(g.out_degrees()))
    out = eng.run(np.asarray([hub, 0], np.int32))
    np.testing.assert_array_equal(out.state[0], bfs_reference(g, hub))
    assert eng.shards is other


def test_engines_share_one_device_copy(small):
    _, shards = small
    cache = WarmEngineCache(shards, apps=("sssp", "ppr"), q_buckets=(1, 3, 8),
                            device="cpu")
    cache.prewarm()
    engines = [cache.get(app, q)[0] for app in ("sssp", "ppr") for q in (1, 3, 8)]
    assert len({id(e) for e in engines}) == 6
    placed = cache._device_arrays
    for e in engines:
        for mine, shared in zip(e._arrays, placed):
            assert mine.data_ptr() == shared.data_ptr()


def test_lru_bound_evicts_and_counts(small, monkeypatch):
    _, shards = small
    metrics = ServeMetrics()
    cache = WarmEngineCache(shards, apps=("sssp",), q_buckets=(1, 2, 3),
                            max_engines=2, metrics=metrics, device="cpu")
    cache.prewarm()
    assert cache.evictions == 1 and metrics.evictions == 1
    assert cache.warm_buckets("sssp") == (2, 3)
    cache.get("sssp", 2)  # refresh 2: 3 is now the oldest
    cache.get("sssp", 1)  # cold build, evicts 3
    assert cache.warm_buckets("sssp") == (1, 2)
    st = cache.stats()
    assert (st["engines"], st["evictions"], st["occupancy"]) == (2, 2, 1.0)
    monkeypatch.setenv("LUX_SERVE_ENGINE_CAP", "5")
    assert WarmEngineCache(shards, device="cpu").max_engines == 5
    monkeypatch.setenv("LUX_SERVE_ENGINE_CAP", "0")
    with pytest.raises(ValueError, match="LUX_SERVE_ENGINE_CAP"):
        WarmEngineCache(shards, device="cpu")
    with pytest.raises(ValueError, match="q buckets"):
        WarmEngineCache(shards, q_buckets=(0, 1), max_engines=4, device="cpu")


def test_method_resolution(small, monkeypatch):
    _, shards = small
    cache = WarmEngineCache(shards, apps=("sssp", "ppr"), q_buckets=(1,), device="cpu")
    # no measured CPU row in the port: auto is the portable scan for both
    assert cache.key("sssp", 1) == EngineKey("sssp", "scan", layout_key(shards), 1)
    assert cache.key("ppr", 1).method == "scan"
    explicit = WarmEngineCache(shards, apps=("ppr",), method="scatter", device="cpu")
    assert explicit.key("ppr", 8).method == "scatter"
    # the card's platform row: auto is the measured winner there
    monkeypatch.setenv("LUX_METHOD_PLATFORM", "cuda")
    assert WarmEngineCache(shards, apps=("sssp",), device="cpu").key(
        "sssp", 1).method == "mxscan"


def test_set_overlay_needs_overlay_static(small):
    from lux_tpu_torch.mutate import overlay as ovl

    _, shards = small
    cache = WarmEngineCache(shards, device="cpu")
    assert cache.current_overlay() is None
    with pytest.raises(ValueError, match="overlay_static"):
        cache.set_overlay(1, ovl.empty_overlay_arrays(shards, 128))


def test_live_cache_serves_the_installed_overlay(small):
    """A live cache starts at generation 0 (the empty overlay: answers of
    the base graph), serves the installed overlay (answers of the merged
    graph, bitwise a BFS of it and an engine on the compacted graph) and
    drops it on install_shards."""
    from lux_tpu_torch.mutate import OP_DELETE, OP_INSERT, MutableGraph
    from lux_tpu_torch.serve.batched import BatchedEngine

    g, _ = small
    mg = MutableGraph(g, num_parts=2, cap=256)
    st, _ = mg.pull_overlay()
    cache = WarmEngineCache(mg.pull_shards, apps=("sssp",), q_buckets=(2,),
                            overlay_static=st, device="cpu")
    cache.prewarm()
    gen, _, deg = cache.current_overlay()
    assert gen == 0 and deg is None
    srcs = [0, 3]
    eng, warm = cache.get("sssp", 2)
    assert warm
    out = eng.run(srcs, oarrays=cache.current_overlay()[1])
    for i, s in enumerate(srcs):
        np.testing.assert_array_equal(out.state[i], bfs_reference(g, s))
    rng = np.random.default_rng(1)
    dele = rng.choice(g.ne, 20, replace=False)
    mg.apply(g.col_idx[dele], g.dst_of_edges()[dele], np.full(20, OP_DELETE, np.int8))
    mg.apply(rng.integers(0, g.nv, 30), rng.integers(0, g.nv, 30),
             np.full(30, OP_INSERT, np.int8))
    cache.set_overlay(7, mg.pull_overlay()[1])
    gen, oarr, _ = cache.current_overlay()
    assert gen == 7
    got = eng.run(srcs, oarrays=oarr)
    merged = mg.log.merged_graph()
    mg.compact()
    cold = BatchedEngine(mg.pull_shards, "sssp", 2, device="cpu").run(srcs)
    np.testing.assert_array_equal(got.state, cold.state)
    for i, s in enumerate(srcs):
        np.testing.assert_array_equal(got.state[i], bfs_reference(merged, s))
    cache.install_shards(mg.pull_shards)
    assert cache.current_overlay()[0] == 0
