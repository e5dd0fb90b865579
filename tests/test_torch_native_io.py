"""The native host I/O layer of lux_tpu_torch (native/io.py over its own
copy of lux_io.cc) vs the port's NumPy paths and the reference's
builders, on the CPU.  Host code, integer layouts: everything is held
bitwise.

The reference's builders run on their NumPy paths here (its native
library is switched off for this module), so no test of this file builds
the reference's library.  The graphs are small seeded RMATs, weighted and
unweighted, plus one with a hub and empty parts.
"""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import lux_tpu.native as ref_native
from lux_tpu.graph import csc as ref_csc
from lux_tpu.graph import format as ref_format
from lux_tpu.graph import push_shards as ref_push_shards
from lux_tpu.graph import shards as ref_shards
from lux_tpu.graph import sharded_load as ref_sharded
from lux_tpu.ops import pallas_spmv as ref_spmv
from lux_tpu_torch import native
from lux_tpu_torch.graph import format as fmt
from lux_tpu_torch.graph import generate, push_shards, shards, sharded_load
from lux_tpu_torch.graph.csc import HostGraph, from_edge_list
from lux_tpu_torch.native import io as nio
from lux_tpu_torch.ops import spmv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reference_numpy(monkeypatch):
    monkeypatch.setattr(ref_native, "_lib", None)
    monkeypatch.setattr(ref_native, "_tried", True)


@pytest.fixture(scope="module", autouse=True)
def _port_native():
    if not nio.available():
        pytest.skip("no C++ compiler: the native host library cannot be built")


def _hub_graph(weighted: bool) -> HostGraph:
    """RMAT 9 edges into the first 300 vertices, vertex 5 pointing at every
    one of them, and every vertex pointing 4 times at vertex 7: vertex 7
    holds more than two parts' share of the edges at 8 parts, so a part
    after it is empty."""
    rng = np.random.default_rng(7)
    g = generate.rmat(9, 8, seed=3)
    src, dst = g.col_idx.astype(np.int64), g.dst_of_edges().astype(np.int64) % 300
    src = np.concatenate([src, np.tile(np.arange(g.nv), 4), np.full(300, 5)])
    dst = np.concatenate([dst, np.full(4 * g.nv, 7), np.arange(300)])
    w = rng.integers(-50, 100, len(src)).astype(np.int32) if weighted else None
    return from_edge_list(src, dst, g.nv, weights=w)


GRAPHS = {
    "rmat8": lambda: generate.rmat(8, 8, seed=11),
    "rmat10w": lambda: generate.rmat(10, 8, seed=12, weighted=True),
    "hub": lambda: _hub_graph(False),
    "hubw": lambda: _hub_graph(True),
}


def _ref(g: HostGraph):
    return ref_csc.HostGraph(nv=g.nv, ne=g.ne, row_ptr=g.row_ptr, col_idx=g.col_idx,
                             weights=g.weights)


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), what


def test_hub_graph_has_empty_parts():
    g = _hub_graph(False)
    sh = shards.build_pull_shards(g, 8)
    assert (sh.arrays.edge_mask.sum(axis=1) == 0).any()


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("parts", [1, 3, 8])
def test_fill_src_pos_pull_shards(name, parts):
    """build_pull_shards through fill_src_pos == its NumPy path == the
    reference's builder, every array."""
    g = GRAPHS[name]()
    got = shards.build_pull_shards(g, parts)
    with nio.numpy_path():
        npy = shards.build_pull_shards(g, parts)
    ref = ref_shards.build_pull_shards(_ref(g), parts)
    assert (got.host_io, npy.host_io) == ("native", "numpy")
    for field, a, b, r in zip(got.arrays._fields, got.arrays, npy.arrays, ref.arrays):
        _same(a, b, field)
        _same(a, r, field)


def test_fill_src_pos_binding():
    rng = np.random.default_rng(3)
    cuts = np.array([0, 10, 10, 37, 100], np.int64)
    srcs = rng.integers(0, 100, 5000).astype(np.int32)
    out = np.empty(len(srcs), np.int32)
    assert nio.fill_src_pos(srcs, cuts, 64, out)
    own = np.searchsorted(cuts, srcs, side="right") - 1
    _same(out, (own * 64 + srcs - cuts[own]).astype(np.int32))
    with pytest.raises(ValueError, match="beyond the last cut"):
        nio.fill_src_pos(np.array([100], np.int32), cuts, 64, np.empty(1, np.int32))


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("parts", [1, 3, 8])
def test_push_part_build(name, parts):
    """build_push_shards through push_part_build == its NumPy path == the
    reference's builder (the CSR arrays and the embedded pull layout)."""
    g = GRAPHS[name]()
    got = push_shards.build_push_shards(g, parts)
    with nio.numpy_path():
        npy = push_shards.build_push_shards(g, parts)
    ref = ref_push_shards.build_push_shards(_ref(g), parts)
    assert (got.host_io, npy.host_io) == ("native", "numpy")
    assert got.pspec == npy.pspec and got.pspec.u_pad == ref.pspec.u_pad
    for field, a, b, r in zip(got.parrays._fields, got.parrays, npy.parrays, ref.parrays):
        _same(a, b, field)
        _same(a, r, field)
    for a, r in zip(got.arrays, ref.arrays):
        _same(a, r)


def test_push_build_float_weights_take_numpy():
    """The native build casts weights from int32: float weights take the
    NumPy path (the reference's gate), with the same arrays."""
    g = generate.rmat(8, 8, seed=4)
    gf = HostGraph(g.nv, g.ne, g.row_ptr, g.col_idx,
                   np.linspace(0.5, 3.0, g.ne).astype(np.float32))
    got = push_shards.build_push_shards(gf, 2)
    ref = ref_push_shards.build_push_shards(_ref(gf), 2)
    assert got.host_io == "numpy"
    for a, r in zip(got.parrays, ref.parrays):
        _same(a, r)


def test_push_part_build_errors():
    counts = np.zeros(10, np.uint32)
    with pytest.raises(ValueError, match="inconsistent"):
        nio.push_part_build(np.array([3, 11], np.int32), np.array([0, 2], np.int64), None,
                            10, counts, np.empty(2, np.int32), None)
    with pytest.raises(ValueError, match="counts"):
        nio.push_part_build(np.array([3], np.int32), np.array([0, 1], np.int64), None,
                            10, np.zeros(9, np.uint32), np.empty(1, np.int32), None)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("v_blk,t_chunk", [(128, 128), (512, 512), (64, 256)])
def test_blockcsr_fill(name, v_blk, t_chunk):
    g = GRAPHS[name]()
    got = spmv.build_blockcsr(g, v_blk=v_blk, t_chunk=t_chunk)
    with nio.numpy_path():
        npy = spmv.build_blockcsr(g, v_blk=v_blk, t_chunk=t_chunk)
    ref = ref_spmv.build_blockcsr(_ref(g), v_blk=v_blk, t_chunk=t_chunk)
    assert (got.host_io, npy.host_io) == ("native", "numpy")
    for f in ("e_src_pos", "e_dst_rel", "e_weight", "chunk_block", "chunk_first"):
        a, b, r = getattr(got, f), getattr(npy, f), getattr(ref, f)
        if r is None:
            assert a is None and b is None
            continue
        _same(a, b, f)
        _same(a, r, f)


def test_blockcsr_fill_refuses_short_arrays():
    g = generate.rmat(8, 8, seed=1)
    bc = spmv.build_blockcsr(g, v_blk=128, t_chunk=128)
    chunk_start = np.flatnonzero(bc.chunk_first).astype(np.int64)
    with pytest.raises(ValueError, match="do not fit"):
        nio.blockcsr_fill(g.row_ptr, g.col_idx, None, 128, 128, chunk_start,
                          np.zeros(128, np.int32), np.zeros(128, np.int32), None)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_count_degrees(name):
    g = GRAPHS[name]()
    _same(nio.count_degrees(g.col_idx, g.nv), g.out_degrees())
    with pytest.raises(ValueError, match="out of range"):
        nio.count_degrees(np.array([g.nv], np.int32), g.nv)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_read_range_and_degree_scan(name, tmp_path):
    """Partial preads == the memory map == the reference's reader."""
    g = GRAPHS[name]()
    path = str(tmp_path / "g.lux")
    fmt.write_lux(path, g)
    assert nio.read_header(path) == (g.nv, g.ne)
    hdr = fmt.read_lux(path)
    for lo, hi in ((0, 0), (0, 1), (3, 200), (100, g.nv), (g.nv, g.nv)):
        got = fmt.read_lux_range(path, lo, hi, header=hdr)
        with nio.numpy_path():
            npy = fmt.read_lux_range(path, lo, hi, header=hdr)
        ref = ref_format.read_lux_range(path, lo, hi)
        for a, b, r in zip(got, npy, ref):
            if r is None:
                assert a is None and b is None
                continue
            _same(a, b)
            _same(a, r)
    _same(sharded_load.out_degrees_from_file(path, chunk_edges=999), g.out_degrees())
    _same(sharded_load.out_degrees_from_file(path), ref_sharded.out_degrees_from_file(path))


def test_read_errors(tmp_path):
    with pytest.raises(OSError):
        nio.read_header(str(tmp_path / "missing.lux"))
    g = generate.rmat(8, 8, seed=2)
    path = str(tmp_path / "g.lux")
    fmt.write_lux(path, g)
    with pytest.raises(OSError):  # no weight block
        nio.read_range(path, g.nv, g.ne, 0, 1, 0, 5, weighted=True)
    with pytest.raises(ValueError, match="outside"):
        nio.read_range(path, g.nv, g.ne, 0, g.nv + 1, 0, 5, weighted=False)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_write_from_edges_round_trip(name, tmp_path):
    """The native writer and the NumPy one write the same bytes, and both
    packages' readers read the graph back."""
    g = GRAPHS[name]()
    rng = np.random.default_rng(5)
    order = rng.permutation(g.ne)  # any input order; within a dst it is kept
    src, dst = g.col_idx[order], g.dst_of_edges()[order]
    w = None if g.weights is None else g.weights[order]
    a, b = str(tmp_path / "a.lux"), str(tmp_path / "b.lux")
    assert fmt.write_lux_edges(a, g.nv, src, dst, w) == "native"
    with nio.numpy_path():
        assert fmt.write_lux_edges(b, g.nv, src, dst, w) == "numpy"
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    want = from_edge_list(src, dst, g.nv, weights=w)
    for read in (fmt.read_lux, ref_format.read_lux):
        h = read(a)
        _same(h.row_ptr, want.row_ptr)
        _same(h.col_idx, want.col_idx)
        if w is None:
            assert h.weights is None
        else:
            _same(h.weights, want.weights)
    with pytest.raises(ValueError, match="out of uint32"):
        nio.write_from_edges(a, g.nv, np.array([-1]), np.array([0]))
    with pytest.raises(OSError):
        nio.write_from_edges(a, 4, np.array([5], np.uint32), np.array([0], np.uint32))


def _write_text(path, rows, comments=True):
    with open(path, "w") as f:
        if comments:
            f.write("# an edge list\n\n")
        for r in rows:
            f.write(" ".join(str(int(x)) for x in r) + "\n")
        if comments:
            f.write("   \n# the end\n")


@pytest.mark.parametrize("weighted", [False, True])
def test_parse_edge_text(weighted, tmp_path):
    """The native line parser == np.loadtxt, comments and blank lines
    skipped; an unweighted parse of a 3-column file reads columns 0-1."""
    rng = np.random.default_rng(9)
    rows = np.stack([rng.integers(0, 1000, 500), rng.integers(0, 1000, 500),
                     rng.integers(-9, 99, 500)], 1)
    path = str(tmp_path / "e.txt")
    _write_text(path, rows)
    got = fmt.read_edge_list_text(path, weighted=weighted)
    with nio.numpy_path():
        npy = fmt.read_edge_list_text(path, weighted=weighted)
    for a, b in zip(got[:2], npy[:2]):
        np.testing.assert_array_equal(a, b)
    if weighted:
        _same(got[2], npy[2])
    else:
        assert got[2] is None and npy[2] is None
    bad = str(tmp_path / "bad.txt")
    with open(bad, "w") as f:
        f.write("1 2\n3\n")
    with pytest.raises(OSError):
        nio.parse_edge_text(bad)


def test_converter_cli(tmp_path):
    """lux-convert, the --python path and write_lux write the same bytes."""
    g = generate.rmat(9, 8, seed=6, weighted=True)
    rows = np.stack([g.col_idx, g.dst_of_edges(), g.weights], 1)
    txt = str(tmp_path / "e.txt")
    _write_text(txt, rows, comments=False)
    want = str(tmp_path / "want.lux")
    fmt.write_lux(want, g)
    env = dict(os.environ, PYTHONPATH=REPO)
    outs = []
    for extra in ([], ["--python"]):
        out = str(tmp_path / f"g{len(outs)}.lux")
        subprocess.run([sys.executable, "-m", "lux_tpu_torch.tools.converter",
                        "-nv", str(g.nv), "-ne", str(g.ne), "-input", txt,
                        "-output", out, "-weighted"] + extra,
                       env=env, cwd=REPO, check=True, capture_output=True, timeout=300)
        outs.append(out)
    for out in outs:
        with open(out, "rb") as a, open(want, "rb") as b:
            assert a.read() == b.read()
    res = subprocess.run([str(nio.converter()), "-nv", str(g.nv), "-ne", str(g.ne + 1),
                          "-input", txt, "-output", str(tmp_path / "x.lux")],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 1 and "parsed" in res.stderr


def test_gen_graph_cli(tmp_path):
    out = str(tmp_path / "r.lux")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", "lux_tpu_torch.tools.gen_graph", "rmat",
                          "--scale", "9", "--ef", "4", "--weighted", "-o", out],
                         env=env, cwd=REPO, check=True, capture_output=True, text=True,
                         timeout=300)
    assert "host path native" in res.stdout
    g, h = generate.rmat(9, 4, seed=0, weighted=True), fmt.read_lux(out)
    for a, b in ((g.row_ptr, h.row_ptr), (g.col_idx, h.col_idx), (g.weights, h.weights)):
        np.testing.assert_array_equal(a, b)


def test_host_path_switch_and_spans(tmp_path):
    """host_path follows numpy_path; the builders' recorder spans name
    the path that ran."""
    import importlib
    import json

    recorder = importlib.import_module("lux_tpu_torch.obs.recorder")
    rec = recorder.Recorder(run_id="io", root=str(tmp_path / "obs"), enabled=True)
    old = recorder.install(rec)
    try:
        assert nio.host_path() == "native"
        g = generate.rmat(8, 8, seed=8)
        shards.build_pull_shards(g, 2)
        with nio.numpy_path():
            assert nio.host_path() == "numpy"
            with nio.numpy_path():
                assert nio.get_lib() is None
            push_shards.build_push_shards(g, 2)
        assert nio.host_path() == "native"
        spmv.build_blockcsr(g)
    finally:
        recorder.install(old)
        rec.close()
    events = [json.loads(x) for x in open(rec.log_path)]
    got = {(e["a"]["kind"], e["a"]["host_io"]) for e in events
           if e.get("n") == "graph.build" and "kind" in e.get("a", {})}
    assert {("pull", "native"), ("pull", "numpy"), ("push", "numpy"),
            ("blockcsr", "native")} <= got


def test_concurrent_builds_never_see_a_partial_file(tmp_path, monkeypatch):
    """Builders racing on one build directory: each writes a private
    temporary file and renames it into place, so every loader finds a
    whole library."""
    import ctypes

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    out = tmp_path / "liblux_io-test.so"
    errors = []

    def build():
        try:
            assert native.build_artifact((nio.SOURCE,), nio.LIB_FLAGS, out)
            nio._bind(ctypes.CDLL(str(out)))
        except Exception as e:  # noqa: BLE001 -- reported by the assert below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert sorted(p.name for p in tmp_path.iterdir()) == [out.name]


def test_sharded_load_native_equals_numpy(tmp_path):
    g = _hub_graph(True)
    path = str(tmp_path / "h.lux")
    fmt.write_lux(path, g)
    for subset in (None, [0, 5, 7]):
        got = sharded_load.load_pull_shards(path, 8, parts_subset=subset)
        with nio.numpy_path():
            npy = sharded_load.load_pull_shards(path, 8, parts_subset=subset)
        ref = ref_sharded.load_pull_shards(path, 8, parts_subset=subset)
        assert (got.host_io, npy.host_io) == ("native", "numpy")
        for field, a, b, r in zip(got.arrays._fields, got.arrays, npy.arrays, ref.arrays):
            _same(a, b, field)
            _same(a, np.asarray(r), field)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("parts", [1, 3, 8])
def test_bucket_split_binding(name, parts):
    """lux_bucket_split: the stable owner permutation and the counts of
    NumPy's argsort / bincount, bitwise."""
    from lux_tpu_torch.parallel import ring

    g = GRAPHS[name]()
    sh = shards.build_pull_shards(g, parts)
    for p in range(parts):
        lo, hi = int(g.row_ptr[sh.cuts[p]]), int(g.row_ptr[sh.cuts[p + 1]])
        srcs = g.col_idx[lo:hi]
        order, counts = nio.bucket_split(srcs, sh.cuts)
        with nio.numpy_path():
            want_order, want_counts = ring._owner_split(srcs.astype(np.int64), sh.cuts)
        np.testing.assert_array_equal(order, want_order)
        np.testing.assert_array_equal(counts, want_counts)
        assert order.dtype == np.int64 and counts.dtype == np.int64


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("parts", [2, 5])
@pytest.mark.parametrize("kind", ["ring", "scatter"])
def test_bucket_fill_binding(name, parts, kind):
    """lux_bucket_fill under the ring and reduce-scatter builders, full
    and subset: bitwise their NumPy paths (integer weights take the
    native fill)."""
    from lux_tpu_torch.parallel import ring, scatter

    g = GRAPHS[name]()
    build = ring.build_ring_shards if kind == "ring" else scatter.build_scatter_shards
    for subset in (None, [parts - 1]):
        native_sh = build(g, parts, parts_subset=subset)
        with nio.numpy_path():
            numpy_sh = build(g, parts, parts_subset=subset)
        assert (native_sh.host_io, numpy_sh.host_io) == ("native", "numpy")
        a = native_sh.rarrays if kind == "ring" else native_sh.sarrays
        b = numpy_sh.rarrays if kind == "ring" else numpy_sh.sarrays
        for field, x, y in zip(a._fields, a, b):
            np.testing.assert_array_equal(x, y, err_msg=field)


def test_bucket_bindings_refuse_bad_input():
    cuts = np.array([0, 4, 8], np.int64)
    with pytest.raises(ValueError, match="beyond the last cut"):
        nio.bucket_split(np.array([1, 9], np.int32), cuts)
    with pytest.raises(ValueError, match="out of uint32 range"):
        nio.bucket_split(np.array([-1], np.int64), cuts)
    B = 2
    src = np.zeros(2 * B, np.int32)
    dst = np.full(2 * B, 4, np.int32)
    hf = np.zeros(2 * B, np.uint8)
    w = np.zeros(2 * B, np.float32)
    # three edges from part 0's sources overflow a bucket of 2
    with pytest.raises(ValueError, match="overflow"):
        nio.bucket_fill(np.array([0, 1, 2], np.int32), np.array([0, 3], np.int64), None, cuts,
                        B, np.arange(2, dtype=np.int64), B, src, dst, hf, w)
    with pytest.raises(ValueError, match="contiguous"):
        nio.bucket_fill(np.array([0], np.int32), np.array([0, 1], np.int64), None, cuts, B,
                        np.arange(2, dtype=np.int64), B, src.astype(np.int64), dst, hf, w)
