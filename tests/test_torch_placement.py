"""The fleet's small parts in lux_tpu_torch vs lux_tpu, on the CPU:
``parallel/placement.PlacementTree`` (the same balanced split, host
lookup and wire form as the reference for a grid of parts x hosts),
``utils/backoff`` (the same jittered delays under one seed), and
``graph/sharded_load`` (partial `.lux` loads whose part rows are bitwise
``build_pull_shards``'s, and the reference's)."""
import numpy as np
import pytest

from lux_tpu.graph import format as ref_format
from lux_tpu.graph import sharded_load as ref_sharded
from lux_tpu.parallel import placement as ref_placement
from lux_tpu.utils import backoff as ref_backoff
from lux_tpu_torch.graph import format as fmt
from lux_tpu_torch.graph import generate, sharded_load
from lux_tpu_torch.graph.shards import build_pull_shards
from lux_tpu_torch.parallel import placement
from lux_tpu_torch.utils import backoff

GRID = [(1, 1), (2, 1), (8, 1), (8, 2), (8, 3), (8, 4), (8, 8), (7, 3), (5, 8),
        (16, 3), (16, 5), (13, 4), (1, 4), (64, 7)]


@pytest.mark.parametrize("parts,hosts", GRID)
def test_placement_tree_build_matches_reference(parts, hosts):
    """The balanced node-major split, the host lookup of every part and
    the wire form are the reference's."""
    mine = placement.PlacementTree.build(parts, hosts, devices_per_host=2)
    ref = ref_placement.PlacementTree.build(parts, hosts, devices_per_host=2)
    assert mine.to_wire() == ref.to_wire()
    assert [mine.host_of(p) for p in range(parts)] == \
        [ref.host_of(p) for p in range(parts)]
    assert [tuple(mine.parts_of(h)) for h in range(hosts)] == \
        [tuple(ref.parts_of(h)) for h in range(hosts)]
    # the wire form crosses packages both ways
    assert ref_placement.PlacementTree.from_wire(mine.to_wire()) == ref
    assert placement.PlacementTree.from_wire(ref.to_wire()) == mine


def test_placement_tree_refuses_bad_trees():
    HS = placement.HostSlice
    with pytest.raises(ValueError, match="contiguously"):
        placement.PlacementTree(4, (HS(0, 0, 2), HS(1, 3, 4)))
    with pytest.raises(ValueError, match="num_parts"):
        placement.PlacementTree(5, (HS(0, 0, 2), HS(1, 2, 4)))
    with pytest.raises(ValueError, match="dense"):
        placement.PlacementTree(4, (HS(0, 0, 2), HS(2, 2, 4)))
    with pytest.raises(ValueError, match="version"):
        placement.PlacementTree.from_wire({"version": 9, "num_parts": 1,
                                           "slices": []})
    with pytest.raises(IndexError):
        placement.PlacementTree.build(4, 2).host_of(4)


def test_local_tree_is_the_single_host_tree():
    t = placement.local_tree(8)
    assert t.num_hosts == 1 and tuple(t.parts_of(0)) == tuple(range(8))
    assert t == placement.PlacementTree.single_host(8, t.slices[0].devices)


@pytest.mark.parametrize("seed", [0, 1, 7, 1234])
def test_backoff_delays_match_reference(seed):
    mine = backoff.Backoff(base_ms=5.0, cap_ms=80.0, seed=seed)
    ref = ref_backoff.Backoff(base_ms=5.0, cap_ms=80.0, seed=seed)
    got = [mine.next_s() for _ in range(40)]
    assert got == [ref.next_s() for _ in range(40)]
    assert all(0.0 <= d <= 0.08 for d in got)
    mine.reset()  # the next ceiling is the base again, the RNG runs on
    ref.reset()
    assert mine.attempt == 0 and mine.next_s() == ref.next_s() <= 0.005


def test_backoff_env_knobs_and_retry_call(monkeypatch):
    monkeypatch.setenv("LUX_BACKOFF_BASE_MS", "1")
    monkeypatch.setenv("LUX_BACKOFF_CAP_MS", "2")
    b = backoff.Backoff()
    assert (b.base_ms, b.cap_ms) == (1.0, 2.0)
    monkeypatch.setenv("LUX_BACKOFF_BASE_MS", "-1")
    with pytest.raises(ValueError, match="LUX_BACKOFF_BASE_MS"):
        backoff.Backoff()
    monkeypatch.delenv("LUX_BACKOFF_BASE_MS")

    class Shed(Exception):
        retry_after_ms = 1.0

    calls, seen = [], []

    def fn():
        calls.append(1)
        if len(calls) < 3:
            raise Shed()
        return "ok"

    assert backoff.retry_call(fn, retry_on=(Shed,), deadline_s=5.0,
                              on_retry=lambda e, n: seen.append(n)) == "ok"
    assert seen == [1, 2]

    def never():
        raise Shed()

    with pytest.raises(Shed):
        backoff.retry_call(never, retry_on=(Shed,), deadline_s=0.02)
    with pytest.raises(KeyError):  # outside retry_on: escapes at once
        backoff.retry_call(lambda: {}["x"], retry_on=(Shed,), deadline_s=5.0)
    flips = iter([False, False, True])
    assert backoff.poll_until(lambda: next(flips), timeout_s=5.0, base_ms=0.1)
    assert not backoff.poll_until(lambda: False, timeout_s=0.01, base_ms=0.1)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    g = generate.rmat(10, 8, seed=2, weighted=True)
    path = str(tmp_path_factory.mktemp("sharded") / "g.lux")
    fmt.write_lux(path, g)
    return g, path


@pytest.mark.parametrize("parts,subset", [(1, None), (4, None), (4, [2]), (8, [0, 1, 2]),
                                          (8, [5, 6, 7]), (8, [3, 1]), (3, [1, 2])])
def test_load_pull_shards_parts_bitwise(snapshot, parts, subset):
    """Each loaded row is bitwise the same part of build_pull_shards, and
    the reference's partial load of the same parts."""
    g, path = snapshot
    full = build_pull_shards(g, parts)
    got = sharded_load.load_pull_shards(path, parts, parts_subset=subset)
    ref = ref_sharded.load_pull_shards(path, parts, parts_subset=subset)
    rows = list(range(parts)) if subset is None else subset
    assert got.spec == full.spec
    assert np.array_equal(got.cuts, full.cuts)
    for name, a, b, r in zip(got.arrays._fields, got.arrays, full.arrays, ref.arrays):
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b[rows]), name
        assert np.array_equal(a, np.asarray(r)), name


def test_sharded_load_helpers_match_reference(snapshot):
    g, path = snapshot
    assert np.array_equal(sharded_load.out_degrees_from_file(path, chunk_edges=1000),
                          g.out_degrees())
    assert np.array_equal(sharded_load.out_degrees_from_file(path),
                          ref_sharded.out_degrees_from_file(path))
    for parts in (1, 4, 8):
        assert sharded_load.compact_width_from_file(path, parts) == \
            ref_sharded.compact_width_from_file(path, parts)
    hdr = fmt.read_lux(path)
    for lo, hi in ((0, 0), (0, 17), (100, 513), (1000, g.nv)):
        mine = fmt.read_lux_range(path, lo, hi, header=hdr)
        ref = ref_format.read_lux_range(path, lo, hi)
        for a, b in zip(mine, ref):
            assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="outside"):
        fmt.read_lux_range(path, 5, g.nv + 1)
    got = sharded_load.load_pull_shards(path, 2, sort_segments=True, compact_gather=True)
    ref = ref_sharded.load_pull_shards(path, 2, sort_segments=True, compact_gather=True)
    for name, a, r in zip(got.arrays._fields, got.arrays, ref.arrays):
        assert a.dtype == np.asarray(r).dtype and np.array_equal(a, np.asarray(r)), name


@pytest.fixture(scope="module")
def halo_ranks():
    from lux_tpu_torch.parallel import spawn

    return {w: spawn.run_ranks(w, "torch_dist_jobs:halo_case", (8, 4, 3, 5), num_parts=8,
                               device="cpu", deadline_s=240)
            for w in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])  # k = 4 and k = 2 parts a rank
def test_halo_all_gather_flattens_in_global_part_order(world, halo_ranks):
    """The all-gather of every rank's (k, V, F) block is the (P, V, F)
    array flattened in global part order (the NumPy oracle of the
    reference's test, tests/test_placement.py: x.reshape(P*V, F)), on
    every rank, for f32, bf16 bit patterns and int32."""
    x = np.random.default_rng(5).standard_normal((8, 4, 3)).astype(np.float32)
    for r in halo_ranks[world]:
        out = r["result"]
        k = 8 // world
        assert (out["lo"], out["hi"]) == (out["rank"] * k, (out["rank"] + 1) * k)
        np.testing.assert_array_equal(out["gathered"], x.reshape(32, 3))
        np.testing.assert_array_equal(
            out["bf16"], torch_bf16(x).reshape(32, 3))
        np.testing.assert_array_equal(out["int32"], (x * 1000).astype(np.int32).reshape(32, 3))


@pytest.mark.parametrize("world", [2, 4])
def test_halo_reduce_scatter_sums_per_destination(world, halo_ranks):
    """Each rank contributes x * (rank + 1); rank r gets the sum over the
    contributors of its own k parts' rows."""
    x = np.random.default_rng(5).standard_normal((8, 4, 3)).astype(np.float64)
    total = x * sum(range(1, world + 1))
    for r in halo_ranks[world]:
        out = r["result"]
        np.testing.assert_allclose(out["reduced"], total[out["lo"]:out["hi"]], rtol=1e-6)


def torch_bf16(x):
    import torch

    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def test_local_tree_follows_the_process_group(monkeypatch):
    """Under an initialized process group the tree has one host a rank,
    and multihost.local_part_range is this rank's slice."""
    import torch.distributed as tdist

    from lux_tpu_torch.parallel import multihost

    monkeypatch.setattr(tdist, "is_initialized", lambda: True)
    monkeypatch.setattr(tdist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(tdist, "get_rank", lambda group=None: 2)
    t = placement.local_tree(8)
    assert t.num_hosts == 4 and tuple(t.parts_of(2)) == (4, 5)
    assert tuple(multihost.local_part_range(8)) == (4, 5)
    assert t.to_wire() == ref_placement.PlacementTree.build(8, 4, t.slices[0].devices).to_wire()
