"""lux_tpu_torch graph layer vs lux_tpu: byte-identical host arrays.

The port keeps its own numpy copy of the graph code (it imports nothing
of lux_tpu), so the same seed and scale must give the same bytes: RMAT
edge lists, pull shards (also for a ragged -ng), block-CSR layouts, and
.lux files either package writes and the other reads.
"""
import numpy as np
import pytest
import torch

from lux_tpu.graph import format as ref_format
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph import partition as ref_partition
from lux_tpu.graph import shards as ref_shards
from lux_tpu.ops import pallas_spmv as ref_spmv
from lux_tpu_torch.graph import csc, format, generate, partition, shards
from lux_tpu_torch.ops import spmv


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("scale,ef,seed,weighted", [
    (8, 8, 0, False), (8, 4, 3, True), (10, 6, 1, False)])
def test_rmat_byte_identical(scale, ef, seed, weighted):
    ref = ref_generate.rmat(scale, ef, seed=seed, weighted=weighted)
    got = generate.rmat(scale, ef, seed=seed, weighted=weighted)
    assert (got.nv, got.ne) == (ref.nv, ref.ne)
    _same(got.row_ptr, ref.row_ptr)
    _same(got.col_idx, ref.col_idx)
    if weighted:
        _same(got.weights, ref.weights)
    else:
        assert got.weights is None


@pytest.mark.parametrize("parts", [1, 2, 3, 5])
def test_edge_balanced_cuts_identical(parts):
    g = generate.rmat(9, 5, seed=2)
    _same(partition.edge_balanced_cuts(g.row_ptr, parts),
          ref_partition.edge_balanced_cuts(g.row_ptr, parts))


@pytest.mark.parametrize("scale,parts", [(8, 1), (8, 3), (9, 2), (9, 7)])
def test_pull_shards_byte_identical(scale, parts):
    rg = ref_generate.rmat(scale, 6, seed=4, weighted=True)
    g = generate.rmat(scale, 6, seed=4, weighted=True)
    ref = ref_shards.build_pull_shards(rg, parts)
    got = shards.build_pull_shards(g, parts)
    assert got.spec.__dict__ == ref.spec.__dict__
    _same(got.cuts, ref.cuts)
    assert got.arrays._fields == ref.arrays._fields
    for name in ref.arrays._fields:
        _same(getattr(got.arrays, name), getattr(ref.arrays, name))
    stacked = np.arange(parts * got.spec.nv_pad, dtype=np.float32).reshape(parts, -1)
    _same(got.scatter_to_global(stacked), ref.scatter_to_global(stacked))


@pytest.mark.parametrize("v_blk,t_chunk", [(128, 128), (512, 512), (256, 128)])
def test_blockcsr_byte_identical(v_blk, t_chunk):
    rg = ref_generate.rmat(9, 8, seed=5, weighted=True)
    g = generate.rmat(9, 8, seed=5, weighted=True)
    ref = ref_spmv.build_blockcsr(rg, v_blk=v_blk, t_chunk=t_chunk)
    got = spmv.build_blockcsr(g, v_blk=v_blk, t_chunk=t_chunk)
    for f in ("nv", "num_vblocks", "num_chunks", "v_blk", "t_chunk"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("e_src_pos", "e_dst_rel", "e_weight", "chunk_block", "chunk_first"):
        _same(getattr(got, f), getattr(ref, f))


def test_blockcsr_empty_blocks_and_hub():
    """Blocks with no edge get one all-padding chunk; a hub spans chunks."""
    src = np.arange(700) % 300
    dst = np.concatenate([np.full(500, 5), np.arange(200) + 600])
    g = csc.from_edge_list(src, dst, 1000)
    rg = ref_generate.from_edge_list(src, dst, 1000)
    got = spmv.build_blockcsr(g, v_blk=128, t_chunk=128)
    ref = ref_spmv.build_blockcsr(rg, v_blk=128, t_chunk=128)
    _same(got.e_dst_rel, ref.e_dst_rel)
    _same(got.chunk_block, ref.chunk_block)
    assert (got.e_dst_rel[got.chunk_block == 2] == 128).all()  # empty block
    assert (got.chunk_block == 0).sum() == 4  # 500-edge hub: 4 chunks


def test_lux_written_by_port_read_by_reference(tmp_path):
    g = generate.rmat(8, 4, seed=6, weighted=True)
    path = str(tmp_path / "g.lux")
    format.write_lux(path, g)
    back = ref_format.read_lux(path)
    _same(back.row_ptr, g.row_ptr)
    _same(back.col_idx, g.col_idx)
    _same(back.weights, g.weights)


@pytest.mark.parametrize("mmap", [True, False])
def test_lux_written_by_reference_read_by_port(tmp_path, mmap):
    rg = ref_generate.rmat(8, 4, seed=7)
    path = str(tmp_path / "g.lux")
    ref_format.write_lux(path, rg)
    g = format.read_lux(path, mmap=mmap)
    assert (g.nv, g.ne, g.weights) == (rg.nv, rg.ne, None)
    _same(g.row_ptr, rg.row_ptr)
    _same(np.asarray(g.col_idx), rg.col_idx)


def test_lux_trailing_degrees_are_ignored(tmp_path):
    """The original converter appends nv int32 degrees; both packages
    recognize the layout by size and read the same graph."""
    g = generate.rmat(7, 3, seed=8)
    path = str(tmp_path / "g.lux")
    format.write_lux(path, g)
    with open(path, "ab") as f:
        f.write(g.in_degrees().astype("<i4").tobytes())
    got, ref = format.read_lux(path), ref_format.read_lux(path)
    assert got.weights is None and ref.weights is None
    _same(np.asarray(got.col_idx), np.asarray(ref.col_idx))


def test_lux_bad_size_raises(tmp_path):
    g = generate.rmat(6, 2, seed=9)
    path = str(tmp_path / "g.lux")
    format.write_lux(path, g)
    with open(path, "ab") as f:
        f.write(b"\0" * 3)
    with pytest.raises(ValueError, match="cannot infer weights"):
        format.read_lux(path)


def test_to_device_keeps_dtypes():
    sh = shards.build_pull_shards(generate.rmat(7, 4, seed=10), 2)
    t = shards.to_device(sh.arrays, "cpu")
    assert t.src_pos.dtype == torch.int32 and t.row_ptr.dtype == torch.int32
    assert t.head_flag.dtype == torch.bool and t.weights.dtype == torch.float32
    np.testing.assert_array_equal(t.dst_local.numpy(), sh.arrays.dst_local)
    assert t.part(1).src_pos.shape == (sh.spec.e_pad,)


def test_hostgraph_rejects_bad_offsets():
    with pytest.raises(ValueError):
        csc.HostGraph(nv=2, ne=1, row_ptr=np.array([0, 1, 2]), col_idx=np.zeros(1, np.int32))
