"""The CUDA kernels of lux_tpu_torch against their plain versions, on the
card.  Every test here is marked gpu and skips without a CUDA device; on
the card run them with

    python -m pytest -m gpu tests/test_torch_cuda.py

This file imports neither jax nor lux_tpu, so it also runs where only
torch is installed.  Tolerances: gathers, min/max and int32 bitwise; f32
sums of positive values rtol 1e-5 (the kernels associate in another
order).
"""
import dataclasses

import numpy as np
import pytest
import torch

from lux_tpu_torch.graph import csc, shards
from lux_tpu_torch.models import pagerank as pr
from lux_tpu_torch.ops import expand, route, scan, segment, shuffle, spmv


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    return torch.device("cuda")


def _graph_layout(dst, nv, v_blk, t_chunk, seed):
    rng = np.random.default_rng(seed)
    g = csc.from_edge_list(rng.integers(0, nv, dst.shape[0]), dst, nv)
    return g.nv, spmv.build_blockcsr(g, v_blk=v_blk, t_chunk=t_chunk)


def _spmv_layout(name, v_blk):
    """(nv, BlockCSR, offset) of one case of the span kernel:
    corner: a ragged last block, a hub spanning several chunks, empty
      vertex blocks and an all-padding tail block;
    unaligned: the same, with values one element off a 16-byte boundary
      (offset 1: the kernel's scalar loads);
    hub: one vertex holding every slot of 70 chunks of 128 (chunk_block
      and e_dst_rel all 0: more than one span of 8,192 slots), and two
      vertex blocks that own no chunk;
    t_chunk_40: chunks of 40 slots, so a thread's 16 slots cross chunks
      and C * T is neither a multiple of 16 nor of the span;
    empty_blocks: 20 vertex blocks, edges into two of them only."""
    rng = np.random.default_rng(21)
    if name in ("corner", "unaligned"):
        dst = np.concatenate([rng.integers(0, 200, 900), np.full(400, 150),
                              rng.integers(700, 760, 100)])
        nv, bc = _graph_layout(dst, 1000, v_blk, 128, 21)
        return nv, bc, int(name == "unaligned")
    if name == "t_chunk_40":
        dst = np.concatenate([rng.integers(0, 1500, 20000), np.full(3000, 2100),
                              rng.integers(4000, 5000, 700)])
        return (*_graph_layout(dst, 5000, v_blk, 40, 22), 0)
    if name == "empty_blocks":
        nv = 20 * v_blk
        dst = np.concatenate([rng.integers(3 * v_blk, 4 * v_blk, 3000),
                              rng.integers(11 * v_blk, 12 * v_blk, 500)])
        return (*_graph_layout(dst, nv, v_blk, 128, 23), 0)
    assert name == "hub"
    C, T = 70, 128
    zeros = np.zeros((C, T), np.int32)
    first = np.zeros(C, np.int32)
    first[0] = 1
    bc = spmv.BlockCSR(nv=3 * v_blk, num_vblocks=3, num_chunks=C,
                       e_src_pos=rng.integers(0, 3 * v_blk, (C, T)).astype(np.int32),
                       e_dst_rel=zeros, e_weight=None, chunk_block=np.zeros(C, np.int32),
                       chunk_first=first, v_blk=v_blk, t_chunk=T)
    return bc.nv, bc, 0


def _spmv_sum_f64(vals, e_dst, cb, v_blk, num_vblocks):
    """The block-CSR sums in float64, the yardstick of the kernel's f32
    sums (the plain version's f32 index_add_ rounds in atomic order)."""
    n = num_vblocks * v_blk
    flat = torch.where(e_dst < v_blk, cb.long()[:, None] * v_blk + e_dst, n).reshape(-1)
    out = torch.zeros(n + 1, dtype=torch.float64, device=vals.device)
    return out.index_add_(0, flat, vals.reshape(-1).double())[:n]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["corner", "unaligned", "hub", "t_chunk_40",
                                    "empty_blocks"])
@pytest.mark.parametrize("v_blk", [128, 512])
@pytest.mark.parametrize("op,dtype", [("sum", torch.float32), ("sum", torch.bfloat16),
                                      ("min", torch.float32), ("max", torch.float32),
                                      ("min", torch.int32), ("max", torch.int32)])
def test_spmv_kernel_matches_plain(cuda, layout, v_blk, op, dtype):
    """min/max bitwise against the plain version; sums within rtol 1e-5 of
    float64 sums; two calls bitwise equal."""
    nv, bc, offset = _spmv_layout(layout, v_blk)
    rng = np.random.default_rng(28)
    if dtype == torch.int32:
        state = torch.from_numpy(rng.integers(-1000, 1000, nv).astype(np.int32))
    else:
        state = torch.from_numpy(rng.random(nv).astype(np.float32) + 0.01).to(dtype)
    g = state[torch.from_numpy(bc.e_src_pos).long()]
    buf = torch.empty(g.numel() + offset, dtype=dtype, device=cuda)
    vals = buf[offset:].view(g.shape)
    vals.copy_(g)
    args = (torch.from_numpy(bc.e_dst_rel).to(cuda), torch.from_numpy(bc.chunk_block).to(cuda),
            torch.from_numpy(bc.chunk_first).to(cuda))
    kw = dict(op=op, v_blk=bc.v_blk, num_vblocks=bc.num_vblocks)
    before = spmv.spmv_blockcsr.launches
    got = spmv.spmv_blockcsr(vals, *args, **kw)
    assert spmv.spmv_blockcsr.launches == before + 1
    if op == "sum":
        want = _spmv_sum_f64(vals, args[0], args[1], bc.v_blk, bc.num_vblocks)
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=0)
    else:
        assert torch.equal(got, spmv.spmv_blockcsr_plain(vals, *args, **kw))
    assert torch.equal(got, spmv.spmv_blockcsr(vals, *args, **kw))


def _scan_heads(kind, n, rng):
    """sparse: 1 % heads; none: no head at all; all: every element a head;
    one_segment: a head at 0 only, one segment across every tile."""
    if kind == "sparse":
        return rng.random(n) < 0.01
    head = np.full(n, kind == "all")
    if kind == "one_segment":
        head[0] = True
    return head


def _seg_scan_sum_f64(vals, head, k):
    """The segmented prefix sums of vals[:k] in float64 (a cumulative
    sum's differences back to each element's last head)."""
    v = vals[:k].double()
    cs = torch.cumsum(v, 0)
    idx = torch.arange(k, device=vals.device)
    last = torch.cummax(torch.where(head[:k], idx, -1), 0).values
    before = torch.where(last > 0, cs[(last - 1).clamp_min(0)], torch.zeros_like(cs))
    return cs - before


@pytest.mark.gpu
@pytest.mark.parametrize("heads", ["sparse", "none", "all", "one_segment"])
@pytest.mark.parametrize("op,dtype", [("sum", torch.float32), ("max", torch.float32),
                                      ("sum", torch.int32), ("min", torch.int32)])
@pytest.mark.parametrize("n", [1, 2047, 2049, 70001])
def test_scan_kernel_matches_plain(cuda, heads, op, dtype, n):
    """Under one 8,192-element tile and across tiles, at lengths that are
    not multiples of a thread's 16 elements.  min/max/int32 bitwise
    against the plain version; f32 sums within rtol 1e-5 of float64
    segmented sums; two calls bitwise equal."""
    rng = np.random.default_rng(38)
    head = torch.from_numpy(_scan_heads(heads, n, rng)).to(cuda)
    if dtype == torch.int32:
        vals = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64)
                                .astype(np.int32)).to(cuda)
    else:
        vals = torch.from_numpy(rng.random(n).astype(np.float32) + 0.01).to(cuda)
    end = torch.tensor([max(1, n - 5)], dtype=torch.int32, device=cuda)
    got = scan.mxscan_segmented(vals, head, op=op, valid_end=end)
    k = int(end.item())
    if op == "sum" and dtype == torch.float32:
        want = _seg_scan_sum_f64(vals, head, k)
        torch.testing.assert_close(got[:k].double(), want, rtol=1e-5, atol=0)
    else:
        want = scan.mxscan_segmented_plain(vals, head, op=op, valid_end=end)
        assert torch.equal(got[:k], want[:k])
    assert torch.equal(got, scan.mxscan_segmented(vals, head, op=op, valid_end=end))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
def test_scan_invalid_mask_on_card(cuda, offset):
    """NaN in the invalid slots never reaches a valid output.  offset 1
    puts every array one element off a 16-byte boundary (the kernel's
    scalar loads and stores)."""
    rng = np.random.default_rng(39)
    n = 20000
    vals = torch.from_numpy(rng.random(n + offset).astype(np.float32)).to(cuda)[offset:]
    invalid = torch.zeros(n + offset, dtype=torch.bool, device=cuda)[offset:]
    invalid[16000:] = True
    vals[16000:] = float("nan")
    head = torch.from_numpy(rng.random(n + offset) < 0.05).to(cuda)[offset:]
    got = scan.mxscan_segmented(vals, head, invalid, op="min")
    want = scan.mxscan_segmented_plain(vals, head, invalid, op="min")
    assert torch.equal(got[:16000], want[:16000])


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["pallas", "mxscan"])
def test_pagerank_on_card_matches_oracle(cuda, method):
    from lux_tpu_torch.graph import generate

    g = generate.rmat(12, 8, seed=3)
    if method == "pallas":
        got = pr.pagerank_pallas(g, 10, device=cuda)
    else:
        got = pr.pagerank(g, 10, method="mxscan", device=cuda)
    np.testing.assert_allclose(got, pr.pagerank_reference(g, 10), rtol=1e-5)


@pytest.mark.gpu
def test_segment_sum_mxscan_on_card(cuda):
    rp = torch.tensor([0, 3, 3, 7, 7], dtype=torch.int32, device=cuda)
    head = torch.zeros(8, dtype=torch.bool, device=cuda)
    head[[0, 3]] = True
    vals = torch.arange(8, dtype=torch.float32, device=cuda)
    got = segment.segment_sum_csc(vals, rp, head, method="mxscan")
    assert got.tolist() == [3.0, 0.0, 18.0, 0.0]


# --- the routed pull's kernels (ops/shuffle.py) ------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 2, 4, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("idx_dtype", [torch.uint8, torch.int32])
def test_lane_gather_kernel_matches_plain(cuda, rows, dtype, idx_dtype):
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.integers(-2**20, 2**20, (rows, 128)).astype(np.int32))
    x = x.to(dtype) if dtype != torch.int32 else x
    idx = torch.from_numpy(rng.integers(0, 128, (rows, 128)).astype(np.int32)).to(idx_dtype)
    before = shuffle.lane_gather.launches
    got = shuffle.lane_gather(x.to(cuda), idx.to(cuda))
    assert shuffle.lane_gather.launches == before + 1
    assert torch.equal(got.cpu(), shuffle.lane_gather_plain(x, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("length", [1, 1000, 70001])
def test_sublane_gather_kernel_matches_plain(cuda, d, length):
    rng = np.random.default_rng(d * length)
    x = torch.from_numpy(rng.random((d, length), dtype=np.float32))
    idx = torch.from_numpy(rng.integers(0, d, (d, length)).astype(np.uint8))
    got = shuffle.sublane_gather(x.to(cuda), idx.to(cuda))
    assert torch.equal(got.cpu(), shuffle.sublane_gather_plain(x, idx))


def _pf_route(n, seed, max_block):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    st, arrs = shuffle.freeze_plan(shuffle.plan_route(route.build_route(perm)))
    pst, parr = shuffle.pf_from_frozen(st, arrs, max_block=max_block)
    return perm, pst, tuple(expand._narrow_idx(a) for a in parr)


@pytest.mark.gpu
@pytest.mark.parametrize("n,max_block", [(1 << 14, 1 << 14), (1 << 15, 1 << 14),
                                         (1 << 15, 1024), (1 << 11, 128),
                                         (1 << 8, 1 << 14), (1 << 10, 1 << 14)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_pass_gather_kernel_matches_plain(cuda, n, max_block, dtype):
    """Every group of a pass-fused route (relayouts across rows included),
    then the whole replay against x[perm].  n = 2^8 and 2^10 give tiles of
    2 and 8 rows, whose CTAs run fewer threads than a row has lanes."""
    perm, pst, parr = _pf_route(n, 5, max_block)
    x = torch.from_numpy(np.random.default_rng(6).random(n, dtype=np.float32)).to(dtype)
    idx = expand.plan_to_device((pst, parr), cuda)[1]
    y, i = x.to(cuda), 0
    assert any(st.relayout is not None for g in pst.groups for st in g.steps) or n < 1 << 14
    for g in pst.groups:
        y = shuffle._relayout(y, g.view, g.perm_axes).reshape(g.kshape)
        k = len(g.steps)
        got = shuffle.fused_pass_gather(y, idx[i:i + k], g)
        assert torch.equal(got, shuffle.fused_pass_gather_plain(y, idx[i:i + k], g))
        y, i = got.reshape(-1), i + k
    out = shuffle.apply_route_frozen(x.to(cuda), pst, idx)
    assert torch.equal(out.cpu(), x[torch.from_numpy(perm)])


@pytest.mark.gpu
@pytest.mark.parametrize("tiles", [1, 3, 400])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("idx_dtype", [torch.uint8, torch.int32])
def test_fused_pass_gather_kernel_tile_counts(cuda, tiles, dtype, idx_dtype):
    """A group at the main block size (128 rows, relayouts included) over
    1, 3 and 400 tiles: 400 is more than three tiles for each of the
    H100's 132 SMs, so the last wave of CTAs is uneven.  Random in-row
    indices; bitwise against the plain version."""
    _, pst, _ = _pf_route(1 << 14, 5, 1 << 14)
    g = next(g for g in pst.groups if any(st.relayout is not None for st in g.steps))
    assert g.block_rows == 128
    rows = tiles * g.block_rows
    g = dataclasses.replace(g, kshape=(rows, 128))
    rng = np.random.default_rng(tiles)
    x = torch.from_numpy(rng.integers(-2**30, 2**30, (rows, 128)).astype(np.int32))
    x = x if dtype == torch.int32 else x.to(dtype)
    idx = [torch.from_numpy(rng.integers(0, 128, (rows, 128)).astype(np.int32))
           .to(idx_dtype).to(cuda) for _ in g.steps]
    before = shuffle.fused_pass_gather.launches
    got = shuffle.fused_pass_gather(x.to(cuda), idx, g)
    assert shuffle.fused_pass_gather.launches == before + 1
    assert torch.equal(got, shuffle.fused_pass_gather_plain(x.to(cuda), idx, g))


def _mx_plan(seed, nv=3000, ne=40000, hub=True):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, nv, ne)
    if hub:
        dst[: ne // 3] = 7  # one destination spanning many tiles
    g = csc.from_edge_list(rng.integers(0, nv, ne), dst, nv)
    sh = shards.build_pull_shards(g, 1)
    static, arrays = expand.plan_fused_shards(sh, "sum", mx=True)
    return sh, static, arrays


@pytest.mark.gpu
@pytest.mark.parametrize("op,dtype", [("sum", torch.float32), ("min", torch.float32),
                                      ("max", torch.float32), ("sum", torch.int32),
                                      ("min", torch.int32), ("max", torch.int32)])
def test_mxreduce_kernel_matches_plain(cuda, op, dtype):
    _, static, arrays = _mx_plan(8)
    mxg = dataclasses.replace(static.mx, op=op)
    r1a, ffa, r2a, _, _, _, _, mxa = expand.split_fused_arrays(static, [a[0] for a in arrays],
                                                               static.weighted)
    k = len(mxg.steps)
    rng = np.random.default_rng(9)
    n2 = static.n2
    if dtype == torch.int32:
        x = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n2, dtype=np.int64).astype(np.int32))
    else:
        x = torch.from_numpy(rng.random(n2, dtype=np.float32) + 0.01)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in mxa]
    y = shuffle._relayout(x.to(cuda), mxg.view, mxg.perm_axes).reshape(mxg.kshape)
    before = shuffle.mxreduce_pass_gather.launches
    got = shuffle.mxreduce_pass_gather(y, t[:k], t[k], t[k + 1], mxg)
    assert shuffle.mxreduce_pass_gather.launches == before + 1
    want = shuffle.mxreduce_pass_gather_plain(y, t[:k], t[k], t[k + 1], mxg)
    total = sum(c for _, c, _ in static.groups)
    if op == "sum" and dtype == torch.float32:
        torch.testing.assert_close(got[:total], want[:total], rtol=1e-5, atol=0)
    else:
        assert torch.equal(got[:total], want[:total])


_MX_V_BLK = 16


def _mx_split_case(case):
    """Tile blocks and a rank map on one edge of the mx kernel's split into
    chunks of 8,192 elements (8 tiles of 8 rows): flat keys never decrease
    along the layout, sentinels (rank v_blk) aside, as the planner
    guarantees.  Returns (tiles, tile_block, ranks (tiles * 1024,),
    num_blocks)."""
    rng = np.random.default_rng(len(case))
    v, tile = _MX_V_BLK, 1024
    tiles = {"single_tile": 1, "ragged": 45}.get(case, 64)
    tile_block = np.sort(rng.integers(0, 6, tiles))
    num_blocks = 6
    if case == "hub":
        tile_block = np.where(np.arange(tiles) < 40, 0, 1 + np.arange(tiles) // 50)
    elif case == "sentinel_chunk":
        tile_block = np.where(np.arange(tiles) < 8, 0, 1 + (np.arange(tiles) >= 40))
    elif case == "empty_block":
        tile_block = np.array([0] * 10 + [1] * 20 + [3] * 20 + [5] * 14)
        num_blocks = 7  # blocks 2, 4 and 6 own no tile; block 5 no real slot
    ranks = np.empty(tiles * tile, np.int64)
    for b in np.unique(tile_block):
        span = np.flatnonzero(np.repeat(tile_block, tile) == b)
        ranks[span] = np.sort(rng.integers(0, v, span.size))
    ranks[rng.random(ranks.size) < 0.1] = v
    if case == "hub":  # rank 3 of block 0 over positions 1000..35000: five chunks
        ranks[:40 * tile] = np.sort(rng.integers(0, v, 40 * tile))
        ranks[:1000] = np.minimum(ranks[:1000], 2)
        ranks[1000:35000] = 3
        ranks[35000:40 * tile] = np.maximum(ranks[35000:40 * tile], 4)
        ranks[1000:35000:13] = v
    elif case == "sentinel_chunk":  # block 1's rank 5 runs on past two empty chunks
        ranks[8 * tile:8 * tile + 500] = 5
        ranks[8 * tile + 500:24 * tile] = v
        ranks[24 * tile:24 * tile + 300] = 5
        ranks[24 * tile + 300:40 * tile] = np.maximum(ranks[24 * tile + 300:40 * tile], 6)
        ranks[8 * tile:8 * tile + 500][::7] = v
    elif case == "empty_block":
        ranks[50 * tile:] = v
    return tiles, tile_block.astype(np.int32), ranks, num_blocks


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["hub", "sentinel_chunk", "empty_block", "ragged",
                                  "single_tile"])
@pytest.mark.parametrize("idx_dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("op,dtype", [("sum", torch.float32), ("min", torch.float32),
                                      ("max", torch.float32), ("sum", torch.int32),
                                      ("min", torch.int32), ("max", torch.int32)])
def test_mxreduce_kernel_split_edges(cuda, case, idx_dtype, op, dtype):
    """The mx kernel's chunk-and-fold split on its edges: one rank whose
    run spans five chunks and crosses chunk boundaries mid-run (hub); a
    run that continues past two chunks of sentinel slots only; output
    blocks with no real slot (neutral out); 45 tiles, not a multiple of
    the chunk's 8; one tile.  Two steps, the second behind a cross-row
    relayout of the 1,024-element tile; the indices random."""
    tiles, tile_block, ranks, num_blocks = _mx_split_case(case)
    rows = tiles * 8
    steps = (shuffle.StaticStep(relayout=None),
             shuffle.StaticStep(relayout=((1, 8, 8, 16), (0, 2, 3, 1))))
    mxg = shuffle.StaticMXGroup(view=(rows * 128,), perm_axes=(), kshape=(rows, 128),
                                block_rows=8, steps=steps, v_blk=_MX_V_BLK,
                                num_blocks=num_blocks, op=op)
    rng = np.random.default_rng(31)
    if dtype == torch.int32:
        x = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (rows, 128), dtype=np.int64)
                             .astype(np.int32))
    else:
        x = torch.from_numpy(rng.random((rows, 128), dtype=np.float32) + 0.01)
    idx = [torch.from_numpy(rng.integers(0, 128, (rows, 128)).astype(np.int32))
           .to(idx_dtype).to(cuda) for _ in mxg.steps]
    dst_rel = torch.from_numpy(ranks.reshape(rows, 128).astype(np.int32)).to(idx_dtype).to(cuda)
    tb = torch.from_numpy(tile_block).to(cuda)
    x = x.to(cuda)
    before = shuffle.mxreduce_pass_gather.launches
    got = shuffle.mxreduce_pass_gather(x, idx, dst_rel, tb, mxg)
    assert shuffle.mxreduce_pass_gather.launches == before + 1
    want = shuffle.mxreduce_pass_gather_plain(x, idx, dst_rel, tb, mxg)
    if op == "sum" and dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["expand", "expand-pf", "fused", "fused-pf", "fused-mx"])
def test_routed_pagerank_on_card(cuda, mode):
    from lux_tpu_torch.apps import pagerank as app

    res = app.run(["--rmat-scale", "12", "--rmat-ef", "8", "-ni", "10", "--method", "mxscan",
                   "--route-gather", mode, "--device", "cuda", "-check"])
    assert res.rc == 0
    np.testing.assert_allclose(res.ranks, pr.pagerank_reference(res.graph, 10), rtol=1e-5)


# --- collaborative filtering: the 2-D block-CSR SpMV ---------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("v_blk", [128, 512])
@pytest.mark.parametrize("k", [1, 3, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
def test_spmv_2d_kernel_matches_plain(cuda, v_blk, k, dtype, aligned):
    """Every K and value type on the corner layout; ``aligned=False`` puts
    the values 4 bytes off a 16-byte boundary, so the scalar path runs."""
    _, bc, _ = _spmv_layout("corner", v_blk)
    shape = bc.e_dst_rel.shape + (k,)
    n = int(np.prod(shape))
    rng = np.random.default_rng(40 + k)
    flat = torch.from_numpy(rng.random(n + 2, dtype=np.float32) + 0.01).to(dtype).to(cuda)
    vals = (flat[:n] if aligned else flat[2:]).view(shape)
    args = (torch.from_numpy(bc.e_dst_rel).to(cuda), torch.from_numpy(bc.chunk_block).to(cuda),
            torch.from_numpy(bc.chunk_first).to(cuda))
    kw = dict(v_blk=bc.v_blk, num_vblocks=bc.num_vblocks)
    before = spmv.spmv_blockcsr_2d.launches
    got = spmv.spmv_blockcsr_2d(vals, *args, **kw)
    assert spmv.spmv_blockcsr_2d.launches == before + 1
    want = spmv.spmv_blockcsr_2d_plain(vals, *args, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("argv", [["--method", "pallas"], ["--method", "scatter"], [],
                                  ["--route-gather", "expand-pf"]])
def test_colfilter_on_card_matches_oracle(cuda, argv):
    """The CF app at RMAT 12 on the card against the f32 oracle, rtol 3e-5
    / atol 1e-7 (the reference's CF tolerance)."""
    from lux_tpu_torch.apps import colfilter as app
    from lux_tpu_torch.models import colfilter as cf

    res = app.run(["--rmat-scale", "12", "--rmat-ef", "8", "-ni", "10", "--device", "cuda",
                   "-check"] + argv)
    assert res.rc == 0
    np.testing.assert_allclose(res.state, cf.colfilter_reference(res.graph, 10),
                               rtol=3e-5, atol=1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("runner", ["pallas", "engine"])
def test_colfilter_library_on_card_moves_state(cuda, runner):
    """At gamma = 1e-3 the state moves, so the oracle check has teeth."""
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.models import colfilter as cf

    g = generate.bipartite_ratings(2048, 2048, 32768, seed=4)
    if runner == "pallas":
        got = cf.colfilter_pallas(g, 10, gamma=1e-3, device=cuda)
    else:
        got = cf.colfilter(g, 10, gamma=1e-3, device=cuda)
    want = cf.colfilter_reference(g, 10, gamma=1e-3)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=1e-7)
    assert cf.rmse(g, got) < cf.init_rmse(g)


# --- the push engine (engine/push.py): SSSP and connected components ---------


@pytest.mark.gpu
@pytest.mark.parametrize("app", ["sssp", "components"])
def test_push_apps_on_card_match_plain_scan(cuda, app):
    """SSSP (from the largest out-degree) and CC on the card under mxscan,
    scatter and the routed dense rounds (expand, expand-pf) are bitwise the
    plain scan run's, and the plain CPU run's: states, iterations and
    traversed edges.  Each kernel of the path launched."""
    from lux_tpu_torch.engine import push
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.graph.push_shards import build_push_shards
    from lux_tpu_torch.models import components as cc
    from lux_tpu_torch.models import sssp

    g = generate.rmat(14, 8, seed=3)
    sh = build_push_shards(g, 1)
    if app == "sssp":
        prog = sssp.SSSPProgram(nv=g.nv, start=int(np.argmax(g.out_degrees())))
    else:
        prog = cc.MaxLabelProgram()
    plan = expand.plan_expand_shards(sh.pull)
    want = push.run_push(prog, sh, method="scan", device=cuda)
    cpu = push.run_push(prog, sh, method="scan", device="cpu")
    np.testing.assert_array_equal(want[0].cpu().numpy(), cpu[0].numpy())
    assert want[1:] == cpu[1:]
    kernels = {"mxscan": scan.mxscan_segmented, "expand": shuffle.KERNELS["lane_gather"],
               "expand-pf": shuffle.KERNELS["fused_pass_gather"]}
    for label, method, route in (("mxscan", "mxscan", None), ("scatter", "scatter", None),
                                 ("expand", "mxscan", plan),
                                 ("expand-pf", "mxscan", expand.to_pf(plan))):
        for fn in kernels.values():
            fn.launches = 0
        got = push.run_push(prog, sh, method=method, route=route, device=cuda)
        np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
        assert got[1:] == want[1:], label
        if label in kernels:
            assert kernels[label].launches > 0, label


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["mxscan", "scatter"])
def test_spec_workloads_on_card_match_cpu(cuda, method):
    """k-core (direct and fused-mx) and triangles at scale 9 on the card
    equal the CPU runs: coreness, k_max and rounds bitwise; the triangle
    incidence bitwise (unit-weight sums below 2^24 are exact in f32).
    The triangles run carries its bitsets as int32 bit patterns through
    the card's gather and sum (PyTorch has no CUDA uint32 arithmetic)."""
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.program import workloads

    gs = workloads.symmetrize(generate.rmat(9, 8, seed=7))
    want = workloads.kcore(gs, method="scan", device="cpu")
    scan.mxscan_segmented.launches = 0
    got = workloads.kcore(gs, method=method, device=cuda)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert (scan.mxscan_segmented.launches > 0) == (method == "mxscan")
    plan = expand.plan_fused_shards(shards.build_pull_shards(gs, 1), "sum", pf=True, mx=True)
    shuffle.KERNELS["mxreduce_pass_gather"].launches = 0
    got = workloads.kcore(gs, method=method, route=plan, device=cuda)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert shuffle.KERNELS["mxreduce_pass_gather"].launches >= got[2]
    inc_cpu, stats_cpu = workloads.triangles(gs, method="scan", device="cpu")
    inc, stats = workloads.triangles(gs, method=method, device=cuda)
    np.testing.assert_array_equal(inc, inc_cpu)
    assert stats == stats_cpu


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["mxscan", "scatter"])
def test_long_run_engines_on_card_match_cpu(cuda, method):
    """The long and out-of-core engines on the card equal their CPU runs:
    delta-stepping (plain and expand-pf routed) and the adaptive
    repartitioning of SSSP bitwise in state, rounds and traversed edges;
    the streamed components bitwise and the streamed PageRank within
    rtol 1e-5 of the CPU run, through the pinned double buffer (several
    chunks a part), prefetch on and off bitwise equal (within rtol 1e-5
    for scatter's f32 sum, whose atomic adds are not deterministic)."""
    from lux_tpu_torch.engine import delta, pull, repartition, stream
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.graph.push_shards import build_push_shards
    from lux_tpu_torch.models import components as cc
    from lux_tpu_torch.models import sssp

    g = generate.rmat(14, 8, seed=3, weighted=True)
    sh = build_push_shards(g, 3)
    hub = int(np.argmax(g.out_degrees()))
    prog = sssp.WeightedSSSPProgram(nv=g.nv, start=hub)
    plan = expand.plan_expand_shards(sh.pull, pf=True)
    want = delta.run_push_delta(prog, sh, 8, method="scan", device="cpu")
    for route in (None, plan):
        got = delta.run_push_delta(prog, sh, 8, method=method, route=route, device=cuda)
        np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
        assert got[1:] == want[1:]
    bfs = sssp.SSSPProgram(nv=g.nv, start=0)
    want = repartition.run_push_adaptive(bfs, g, 4, chunk=2, threshold=1.01,
                                         method="scan", device="cpu")
    got = repartition.run_push_adaptive(bfs, g, 4, chunk=2, threshold=1.01,
                                        method=method, device=cuda)
    np.testing.assert_array_equal(got.state, want.state)
    assert (got.iters, got.edges, got.reparts) == (want.iters, want.edges, want.reparts)
    np.testing.assert_array_equal(got.shards.cuts, want.shards.cuts)
    pshards = shards.build_pull_shards(g, 2)
    ssh = stream.build_streamed_pull(pshards, 1 << 14, pin_memory=True)
    assert len(ssh.chunks[0]) >= 4 and ssh.packed.is_pinned()
    for prog, kw in ((cc.MaxLabelProgram(), {"active_fn": cc.active_count}),
                     (pr.PageRankProgram(nv=g.nv), {})):
        runs = {}
        for dev in ("cpu", cuda):
            s0 = pull.init_state(prog, shards.to_device(ssh.varrays, dev))
            for prefetch in (True, False):
                if kw:
                    out = stream.run_pull_until_streamed(prog, ssh, s0, 100, kw["active_fn"],
                                                         method=method, prefetch=prefetch)[0]
                else:
                    out = stream.run_pull_fixed_streamed(prog, ssh, s0, 5, method=method,
                                                         prefetch=prefetch)
                runs[str(dev), prefetch] = out.cpu()
        if kw or method == "mxscan":
            assert torch.equal(runs["cuda", True], runs["cuda", False])
        else:  # index_add_ on the card adds f32 in atomic order: not bitwise run to run
            np.testing.assert_allclose(runs["cuda", True].numpy(), runs["cuda", False].numpy(),
                                       rtol=1e-5, atol=1e-9)
        if kw:
            assert torch.equal(runs["cuda", True], runs["cpu", True])
        else:
            np.testing.assert_allclose(runs["cuda", True].numpy(), runs["cpu", True].numpy(),
                                       rtol=1e-5, atol=1e-9)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["auto", "scatter"])
@pytest.mark.parametrize("parts", [1, 2])
def test_batched_serving_on_card_matches_cpu(cuda, parts, method):
    """The batched query engines on the card equal their CPU runs: SSSP
    bitwise in distances, iterations, rounds and traversed edges (under
    auto, mxscan falls back to the plain scan on (E, Q) values), PPR
    within rtol 1e-5 (scatter adds f32 in atomic order on the card); a
    warm cache's engines share one copy of the arrays on the card, and a
    burst through the scheduler answers as the engine does."""
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.serve import batched
    from lux_tpu_torch.serve.scheduler import MicroBatchScheduler
    from lux_tpu_torch.serve.warm import WarmEngineCache

    g = generate.rmat(14, 8, seed=5)
    sh = shards.build_pull_shards(g, parts)
    srcs = np.argsort(g.out_degrees())[::-1][:8].astype(np.int32)
    for app in ("sssp", "ppr"):
        want = batched.BatchedEngine(sh, app, 8, method="scan", num_iters=6,
                                     device="cpu").run(srcs)
        eng = batched.BatchedEngine(sh, app, 8, method=method, num_iters=6, device=cuda)
        assert eng.method == ("mxscan" if method == "auto" else method)
        got = eng.warm().run(srcs)
        if app == "sssp":
            np.testing.assert_array_equal(got.state, want.state)
        else:
            np.testing.assert_allclose(got.state, want.state, rtol=1e-5, atol=0)
        assert got.iters == want.iters and got.traversed == want.traversed
        np.testing.assert_array_equal(got.rounds, want.rounds)
        cache = WarmEngineCache(sh, apps=(app,), q_buckets=(1, 8), method=method,
                                num_iters=6, device=cuda)
        cache.prewarm()
        ptrs = {e._arrays.src_pos.data_ptr() for e in cache._engines.values()}
        assert ptrs == {cache._device_arrays.src_pos.data_ptr()}
        sched = MicroBatchScheduler(cache, app=app, max_wait_ms=0.0).start()
        try:
            futs = [sched.submit(int(s)) for s in srcs]
            for i, f in enumerate(futs):
                out = f.result(timeout=120)
                if app == "sssp":
                    np.testing.assert_array_equal(out, want.state[i])
                else:
                    np.testing.assert_allclose(out, want.state[i], rtol=1e-5, atol=0)
        finally:
            sched.stop()


# --- dynamic graphs: the kernels under a mutation overlay's inputs -------------


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["random", "hub_block", "whole_tiles"])
@pytest.mark.parametrize("op,dtype", [("sum", torch.float32), ("min", torch.int32),
                                      ("max", torch.int32)])
def test_mxreduce_tombstoned_ranks(cuda, pattern, op, dtype):
    """The mx kernel with ranks tombstoned to the sentinel v_blk in the
    MIDDLE of tiles, as apply_fused(del_val=) writes them: 20 % of the
    slots at random, every slot of the hub block (block 0, five chunks),
    or eight whole tiles.  f32 sums within rtol 1e-5 of the same sums in
    float64, min/max int32 bitwise the plain version."""
    tiles, tile_block, ranks, num_blocks = _mx_split_case("hub")
    rng = np.random.default_rng(77)
    tile = 1024
    if pattern == "random":
        ranks[rng.random(ranks.size) < 0.2] = _MX_V_BLK
    elif pattern == "hub_block":
        ranks[np.repeat(tile_block, tile) == 0] = _MX_V_BLK
    else:
        ranks[3 * tile:11 * tile] = _MX_V_BLK
    rows = tiles * 8
    steps = (shuffle.StaticStep(relayout=None),
             shuffle.StaticStep(relayout=((1, 8, 8, 16), (0, 2, 3, 1))))
    mxg = shuffle.StaticMXGroup(view=(rows * 128,), perm_axes=(), kshape=(rows, 128),
                                block_rows=8, steps=steps, v_blk=_MX_V_BLK,
                                num_blocks=num_blocks, op=op)
    if dtype == torch.int32:
        x = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (rows, 128), dtype=np.int64)
                             .astype(np.int32)).to(cuda)
    else:
        x = torch.from_numpy(rng.random((rows, 128), dtype=np.float32) + 0.01).to(cuda)
    idx = [torch.from_numpy(rng.integers(0, 128, (rows, 128)).astype(np.uint8)).to(cuda)
           for _ in steps]
    dst_rel = torch.from_numpy(ranks.reshape(rows, 128).astype(np.uint8)).to(cuda)
    tb = torch.from_numpy(tile_block).to(cuda)
    got = shuffle.mxreduce_pass_gather(x, idx, dst_rel, tb, mxg)
    if op == "sum":
        y = shuffle._steps_plain(x, steps, idx).double()
        flat = (tb.long()[torch.arange(rows, device=cuda) // 8][:, None] * _MX_V_BLK
                + dst_rel.long())
        valid = dst_rel.long() < _MX_V_BLK
        want = torch.zeros(num_blocks * _MX_V_BLK, dtype=torch.float64, device=cuda)
        want.index_add_(0, flat[valid], y[valid])
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=0)
    else:
        assert torch.equal(got, shuffle.mxreduce_pass_gather_plain(x, idx, dst_rel, tb, mxg))
    if pattern == "hub_block":  # a block with no live slot comes out neutral
        neutral = spmv.reduce_neutral(op, got.dtype)
        assert bool((got[:_MX_V_BLK] == neutral).all())


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["fused-pf", "fused-mx"])
@pytest.mark.parametrize("reduce", ["sum", "max"])
def test_apply_fused_del_val_on_card(cuda, family, reduce):
    """apply_fused with a tombstone mask on the card against its plain
    twin (the same call on the CPU): max bitwise, f32 sums rtol 1e-5;
    the plan's own rank tiles are left as they were."""
    from lux_tpu_torch.graph import generate

    g = generate.rmat(12, 8, seed=3)
    sh = shards.build_pull_shards(g, 2)
    plan = (expand.plan_fused_shards(sh, reduce, mx=True) if family == "fused-mx"
            else expand.plan_fused_shards(sh, reduce, pf=True))
    rng = np.random.default_rng(5)
    dtype = np.float32 if reduce == "sum" else np.int32
    state = (rng.random(sh.spec.gathered_size).astype(np.float32) if reduce == "sum"
             else rng.integers(0, 1 << 20, sh.spec.gathered_size).astype(np.int32))
    for p in range(2):
        del_val = (rng.random(sh.spec.e_pad) < 0.1) & sh.arrays.edge_mask[p]
        outs = []
        for dev in ("cpu", cuda):
            st, arr = expand.plan_to_device(plan, dev)
            part = tuple(a[p] for a in arr)
            before = [a.clone() for a in part]
            outs.append(expand.apply_fused(torch.from_numpy(state).to(dev), st, part,
                                           del_val=torch.from_numpy(del_val).to(dev)).cpu())
            assert all(torch.equal(a, b) for a, b in zip(part, before))
        if reduce == "sum":
            torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-12)
        else:
            assert torch.equal(outs[1], outs[0])
        assert outs[0].dtype == torch.from_numpy(np.zeros(1, dtype)).dtype


@pytest.mark.gpu
@pytest.mark.parametrize("op,dtype", [("sum", torch.float32), ("min", torch.int32),
                                      ("max", torch.int32)])
def test_mxscan_on_neutral_masked_values(cuda, op, dtype):
    """The scan kernel on values a tombstone mask set to the reduce's
    neutral (mutate.overlay.mask_deleted), inside and across segments:
    int32 min/max bitwise, f32 sums rtol 1e-5 of the plain version."""
    from lux_tpu_torch.mutate import overlay as ovl

    rng = np.random.default_rng(8)
    n = 200_003
    head = rng.random(n) < 0.01
    head[0] = True
    head[50_000:120_000] = False  # one segment over several tiles
    vals = (torch.from_numpy(rng.random(n, dtype=np.float32) + 0.01) if dtype == torch.float32
            else torch.from_numpy(rng.integers(-1000, 1000, n).astype(np.int32)))
    dead = torch.from_numpy(rng.random(n) < 0.15)
    dead[60_000:90_000] = True
    masked = ovl.mask_deleted(vals, dead, op).to(cuda)
    h = torch.from_numpy(head).to(cuda)
    got = scan.mxscan_segmented(masked, h, op=op)
    want = scan.mxscan_segmented_plain(masked, h, op=op)
    if op == "sum":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_insert_fold_deterministic_on_card(cuda):
    """The float-sum insert fold with many duplicate destinations: ten
    runs on the card bitwise equal (no atomic-order dependence), within
    rtol 1e-5 of the float64 sums, and bitwise the CPU fold (the same
    rounds add in the same order)."""
    from lux_tpu_torch.mutate import overlay as ovl

    rng = np.random.default_rng(11)
    V, D = 4096, 8192
    dst = np.full((1, D), V, np.int32)
    live = 7000
    dst[0, :live] = rng.choice(np.arange(0, V, 97), live)  # 43 destinations
    src = rng.integers(0, 2 * V, (1, D)).astype(np.int32)
    oarr = ovl.OverlayArrays(np.zeros((1, 128), bool), src, dst, np.zeros((1, D), np.float32))
    full = rng.random(2 * V, dtype=np.float32)
    acc = rng.random(V, dtype=np.float32)
    outs = []
    for dev in (cuda,) * 10 + ("cpu",):
        oa = ovl.device_overlay(oarr, dev, V)[0]
        outs.append(ovl.delta_scatter(torch.from_numpy(acc).to(dev),
                                      torch.from_numpy(full).to(dev), oa,
                                      lambda s, w: s, "sum").cpu())
    assert all(torch.equal(o, outs[0]) for o in outs)
    want = acc.astype(np.float64)
    np.add.at(want, dst[0, :live], full[src[0, :live]].astype(np.float64))
    np.testing.assert_allclose(outs[0].numpy(), want, rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_refresh_on_card_matches_cpu(cuda):
    """Warm SSSP / CC refreshes on the card equal the CPU's bitwise, and
    the PageRank refresh lands within rtol 1e-5 of the CPU's fixpoint;
    two card refreshes from one prior are bitwise equal."""
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.models import components as comp
    from lux_tpu_torch.mutate import OP_DELETE, OP_INSERT, MutableGraph, refresh

    g = generate.rmat(13, 8, seed=6)
    rng = np.random.default_rng(6)
    mg = MutableGraph(g, num_parts=4)
    start = int(np.argmax(g.out_degrees()))
    dist = comp_dist = None
    from lux_tpu_torch.models import sssp as sssp_model

    dist = sssp_model.sssp(g, start=start, num_parts=4, device="cpu")
    comp_dist = comp.connected_components_push(g, num_parts=4, device="cpu")
    pr0, _ = refresh.converge_pagerank(mg.pull_shards, device="cpu")
    dele = rng.choice(g.ne, 300, replace=False)
    mg.apply(g.col_idx[dele], g.dst_of_edges()[dele], np.full(300, OP_DELETE, np.int8))
    mg.apply(rng.integers(0, g.nv, 300), rng.integers(0, g.nv, 300),
             np.full(300, OP_INSERT, np.int8))
    for dev in ("cpu", cuda):
        d, _ = refresh.refresh_sssp(mg, dist, start, device=dev)
        lab, _ = refresh.refresh_components(mg, comp_dist, device=dev)
        p, _ = refresh.refresh_pagerank(mg, pr0, device=dev)
        if dev == "cpu":
            want = (d, lab, p)
            continue
        np.testing.assert_array_equal(d, want[0])
        np.testing.assert_array_equal(lab, want[1])
        np.testing.assert_allclose(p.cpu().numpy(), want[2].numpy(), rtol=1e-5, atol=0)
        p2, _ = refresh.refresh_pagerank(mg, pr0, device=dev)
        assert torch.equal(p, p2)
