"""Block-CSR SpMV: the port's plain version vs the reference Pallas kernel.

The reference kernel runs in Pallas interpret mode on the CPU, as its own
tests run it (tests/test_pallas_spmv.py), at v_blk = t_chunk = 128.
Tolerances: min/max and int32 are bitwise (order-insensitive combiners);
f32 sums rtol 1e-5 against the reference and against a float64 oracle
(both sides accumulate in f32, in different orders); bf16 values are the
same bits on both sides and both accumulate in f32, so rtol 1e-5 against
the reference too, and 2e-2 against the f64 oracle of the unrounded
values (bf16 quantization of each operand).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph import shards as ref_shards
from lux_tpu.ops import pallas_spmv as ref_spmv
from lux_tpu_torch import convert
from lux_tpu_torch.graph import csc, generate, shards
from lux_tpu_torch.ops import spmv

V_BLK = T_CHUNK = 128



def _corner_graph():
    """Ragged last block, a hub spanning several chunks, empty vertex
    blocks, and an all-padding tail block."""
    rng = np.random.default_rng(21)
    nv = 1000
    dst = np.concatenate([rng.integers(0, 200, 900), np.full(400, 150),
                          rng.integers(700, 760, 100)])
    src = rng.integers(0, nv, dst.shape[0])
    return csc.from_edge_list(src, dst, nv)


@pytest.fixture(scope="module")
def layout():
    g = _corner_graph()
    bc = spmv.build_blockcsr(g, v_blk=V_BLK, t_chunk=T_CHUNK)
    assert (bc.e_dst_rel[bc.chunk_block == bc.num_vblocks - 1] == V_BLK).all()
    return g, bc


def _oracle(g, state, op):
    fn = {"sum": np.add, "min": np.minimum, "max": np.maximum}[op]
    init = {"sum": 0, "min": np.inf, "max": -np.inf}[op]
    if state.dtype == np.int32:
        info = np.iinfo(np.int32)
        init = {"sum": 0, "min": info.max, "max": info.min}[op]
    out = np.full(g.nv, init, np.float64 if op == "sum" else state.dtype)
    fn.at(out, g.dst_of_edges(), state[g.col_idx])
    return out


def _run_both(bc, vals_np, op, compute_dtype="float32", vals_jax=None):
    ref = ref_spmv.spmv_blockcsr(
        jnp.asarray(vals_np) if vals_jax is None else vals_jax,
        jnp.asarray(bc.e_dst_rel), jnp.asarray(bc.chunk_block),
        jnp.asarray(bc.chunk_first), op=op, v_blk=bc.v_blk,
        num_vblocks=bc.num_vblocks, interpret=True, compute_dtype=compute_dtype)
    vals_t = (torch.from_numpy(vals_np) if vals_jax is None
              else convert.array_to_tensor(np.asarray(vals_jax), "cpu"))
    got = spmv.spmv_blockcsr(
        vals_t, torch.from_numpy(bc.e_dst_rel), torch.from_numpy(bc.chunk_block),
        torch.from_numpy(bc.chunk_first), op=op, v_blk=bc.v_blk,
        num_vblocks=bc.num_vblocks)
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_plain_matches_reference_f32(layout, op):
    g, bc = layout
    state = np.random.default_rng(22).random(g.nv).astype(np.float32) + 0.01
    ref, got = _run_both(bc, state[bc.e_src_pos], op)
    assert got.dtype == np.float32 and got.shape == (bc.num_vblocks * V_BLK,)
    want = _oracle(g, state, op)
    if op == "sum":
        np.testing.assert_allclose(got, ref, rtol=1e-5)
        np.testing.assert_allclose(got[: g.nv], want, rtol=1e-5)
        assert (got[g.nv:] == 0).all()
    else:
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got[: g.nv], want)


@pytest.mark.parametrize("op", ["min", "max"])
def test_plain_matches_reference_int32(layout, op):
    g, bc = layout
    rng = np.random.default_rng(23)
    state = rng.integers(-2**31, 2**31 - 1, g.nv, dtype=np.int64).astype(np.int32)
    ref, got = _run_both(bc, state[bc.e_src_pos], op)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[: g.nv], _oracle(g, state, op))


def test_plain_matches_reference_bf16_sum(layout):
    g, bc = layout
    state = np.random.default_rng(24).random(g.nv).astype(np.float32) + 0.01
    vals_bf16 = jnp.asarray(state[bc.e_src_pos]).astype(jnp.bfloat16)
    ref, got = _run_both(bc, None, "sum", "bfloat16", vals_jax=vals_bf16)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(got[: g.nv], _oracle(g, state, "sum"), rtol=2e-2)


def test_plain_matches_reference_one_hub():
    """One vertex holding every slot of 10 chunks (chunk_block and
    e_dst_rel all 0), the CUDA kernel's stress layout; the block's other
    vertices come out neutral."""
    C = 10
    vals = np.random.default_rng(30).random((C, T_CHUNK)).astype(np.float32) + 0.01
    zeros = np.zeros((C, T_CHUNK), np.int32)
    cb = np.zeros(C, np.int32)
    cf = np.zeros(C, np.int32)
    cf[0] = 1
    bc = spmv.BlockCSR(nv=V_BLK, num_vblocks=1, num_chunks=C, e_src_pos=zeros,
                       e_dst_rel=zeros, e_weight=None, chunk_block=cb, chunk_first=cf,
                       v_blk=V_BLK, t_chunk=T_CHUNK)
    ref, got = _run_both(bc, vals, "sum")
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(got[0], vals.astype(np.float64).sum(), rtol=1e-5)
    assert (got[1:] == 0).all()


def test_rmat_default_tiles_sum():
    """The main path's tiles (512 x 512) on an RMAT graph."""
    g = generate.rmat(10, 8, seed=25)
    bc = spmv.build_blockcsr(g)
    state = np.random.default_rng(26).random(g.nv).astype(np.float32)
    ref, got = _run_both(bc, state[bc.e_src_pos], "sum")
    np.testing.assert_allclose(got, ref, rtol=1e-5)


# --- the layout facts the CUDA kernel relies on -------------------------------
#
# csrc/spmv_blockcsr.cu reduces the flat (C * T) slot array as one
# sorted-key segmented reduce, cut into spans of 8,192 slots wherever they
# fall.  That is right only if build_blockcsr's layouts hold the three
# facts below, checked here on real layouts: an RMAT graph and the ragged
# graph of chip_smoke.py (a hub over several chunks, empty vertex blocks,
# an all-padding tail), at the main path's t_chunk, the tests' 128, and
# 40, which is not a multiple of a thread's 16 slots.


def _smoke_ragged_graph():
    """chip_smoke.ragged_graph, the same seed and shape."""
    rng = np.random.default_rng(5)
    nv = 5000
    dst = np.concatenate([rng.integers(0, 1500, 20000), np.full(3000, 2100),
                          rng.integers(4000, nv, 700)])
    src = rng.integers(0, nv, dst.shape[0])
    return csc.from_edge_list(src, dst, nv)


_LAYOUT_GRAPHS = {"rmat": lambda: generate.rmat(12, 8, seed=29), "ragged": _smoke_ragged_graph}


def _real_layout(graph, t_chunk):
    g = _LAYOUT_GRAPHS[graph]()
    return g, spmv.build_blockcsr(g, t_chunk=t_chunk)


@pytest.mark.parametrize("t_chunk", [128, 512, 40])
@pytest.mark.parametrize("graph", ["rmat", "ragged"])
def test_layout_flat_keys_never_decrease(graph, t_chunk):
    """Along the flat slot array the key chunk_block[slot // T] * v_blk +
    e_dst_rel never decreases once padding slots are set aside, and every
    edge has exactly one real slot."""
    g, bc = _real_layout(graph, t_chunk)
    d = bc.e_dst_rel.astype(np.int64)
    keys = (bc.chunk_block.astype(np.int64)[:, None] * bc.v_blk + d).reshape(-1)
    real = (d < bc.v_blk).reshape(-1)
    assert real.sum() == g.ne
    assert (d >= 0).all() and (d <= bc.v_blk).all()
    assert (np.diff(keys[real]) >= 0).all()
    assert (keys[real] < g.nv).all()


@pytest.mark.parametrize("t_chunk", [128, 512, 40])
@pytest.mark.parametrize("graph", ["rmat", "ragged"])
def test_layout_padding_only_at_block_tails(graph, t_chunk):
    """Within each vertex block's chunks, padding is a suffix that lies in
    the block's last chunk: fewer than t_chunk slots, or exactly one chunk
    for a block with no edge."""
    g, bc = _real_layout(graph, t_chunk)
    assert (np.diff(bc.chunk_block) >= 0).all()
    pad = bc.e_dst_rel == bc.v_blk
    starts = np.flatnonzero(bc.chunk_first)
    ends = np.append(starts[1:], bc.num_chunks)
    for lo, hi in zip(starts, ends):
        block_pad = pad[lo:hi].reshape(-1)
        n_real = int((~block_pad).sum())
        assert not block_pad[:n_real].any() and block_pad[n_real:].all()
        assert block_pad.size - n_real < t_chunk or (n_real == 0 and hi - lo == 1)


@pytest.mark.parametrize("t_chunk", [128, 512, 40])
@pytest.mark.parametrize("graph", ["rmat", "ragged"])
def test_layout_every_block_has_a_chunk(graph, t_chunk):
    """Every vertex block owns at least one chunk, contiguous and in order,
    and chunk_first marks the first of each."""
    g, bc = _real_layout(graph, t_chunk)
    assert bc.num_vblocks == -(-g.nv // bc.v_blk)
    blocks, first = np.unique(bc.chunk_block, return_index=True)
    np.testing.assert_array_equal(blocks, np.arange(bc.num_vblocks))
    np.testing.assert_array_equal(np.flatnonzero(bc.chunk_first), first)
    in_degree = np.bincount(g.dst_of_edges(), minlength=bc.num_vblocks * bc.v_blk)
    per_block = in_degree.reshape(bc.num_vblocks, bc.v_blk).sum(1)
    np.testing.assert_array_equal(np.bincount(bc.chunk_block, minlength=bc.num_vblocks),
                                  np.maximum(1, -(-per_block // t_chunk)))


def test_wrapper_rejects_bad_inputs(layout):
    _, bc = layout
    vals = torch.zeros(bc.e_dst_rel.shape, dtype=torch.float32)
    dst = torch.from_numpy(bc.e_dst_rel)
    cb, cf = torch.from_numpy(bc.chunk_block), torch.from_numpy(bc.chunk_first)
    with pytest.raises(TypeError):
        spmv.spmv_blockcsr(vals.to(torch.int32), dst, cb, cf, op="sum",
                           v_blk=V_BLK, num_vblocks=bc.num_vblocks)
    with pytest.raises(ValueError, match="same"):
        spmv.spmv_blockcsr(vals[:, :5], dst, cb, cf, v_blk=V_BLK,
                           num_vblocks=bc.num_vblocks)
    with pytest.raises(ValueError, match="num_vblocks"):
        spmv.spmv_blockcsr(vals, dst, cb, cf, v_blk=V_BLK)
    with pytest.raises(ValueError, match="op"):
        spmv.spmv_blockcsr(vals, dst, cb, cf, op="mean", v_blk=V_BLK,
                           num_vblocks=bc.num_vblocks)


def test_cpu_path_never_launches(layout):
    _, bc = layout
    before = spmv.spmv_blockcsr.launches
    spmv.spmv_blockcsr(torch.ones(bc.e_dst_rel.shape), torch.from_numpy(bc.e_dst_rel),
                       torch.from_numpy(bc.chunk_block), torch.from_numpy(bc.chunk_first),
                       v_blk=V_BLK, num_vblocks=bc.num_vblocks)
    assert spmv.spmv_blockcsr.launches == before


def test_convert_shards_round_trip():
    """The reference's layout, carried over, equals the port's own."""
    rg = ref_generate.rmat(8, 6, seed=27)
    ref = ref_shards.build_pull_shards(rg, 2)
    d = {k: np.asarray(v) for k, v in ref.arrays._asdict().items()}
    rbc = ref_spmv.build_blockcsr(rg, v_blk=V_BLK, t_chunk=T_CHUNK)
    for f in ("e_src_pos", "e_dst_rel", "e_weight", "chunk_block", "chunk_first"):
        d[f] = getattr(rbc, f)
    d["state"] = np.asarray(jnp.arange(6, dtype=jnp.bfloat16))
    out = convert.shards_from_numpy(d, device="cpu")
    own = shards.to_device(shards.build_pull_shards(generate.rmat(8, 6, seed=27), 2).arrays,
                           "cpu")
    for name in own._fields:
        assert torch.equal(getattr(out["arrays"], name), getattr(own, name)), name
    bc = spmv.build_blockcsr(generate.rmat(8, 6, seed=27), v_blk=V_BLK, t_chunk=T_CHUNK)
    assert torch.equal(out["e_dst_rel"], torch.from_numpy(bc.e_dst_rel))
    assert out["e_weight"] is None
    assert out["state"].dtype == torch.bfloat16
    assert out["state"].float().tolist() == [0, 1, 2, 3, 4, 5]
