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
                                      ("min", torch.bfloat16), ("max", torch.bfloat16),
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


def _sorted_sum_case(name, rng):
    """(keys, num_segments) of one case of the sorted-key sum kernel:
    hub: one key over 3.5 spans of 8,192 slots, then singletons;
    ragged: random keys, empty segments, E not a multiple of 16 or of a span;
    interleaved: padding sentinels between the real keys;
    tail: a short array ending in padding; all_pad: only padding."""
    if name == "hub":
        keys = np.concatenate([np.full(28_700, 3), np.arange(4, 2_000)])
        return keys.astype(np.int32), 2_100
    if name == "ragged":
        return np.sort(rng.integers(0, 5_000, 70_001)).astype(np.int32), 6_000
    if name == "interleaved":
        keys = np.sort(rng.integers(0, 900, 20_000)).astype(np.int32)
        keys[rng.random(keys.size) < 0.2] = 900
        return keys, 900
    if name == "tail":
        return np.concatenate([np.sort(rng.integers(0, 40, 300)),
                               np.full(37, 40)]).astype(np.int32), 40
    assert name == "all_pad"
    return np.full(5_000, 17, np.int32), 17


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["hub", "ragged", "interleaved", "tail", "all_pad"])
@pytest.mark.parametrize("k", [1, 3, 20, 64, 300])
@pytest.mark.parametrize("offset", [0, 1])
def test_segment_sum_sorted_kernel(cuda, case, k, offset):
    """The sorted-key sum kernel: two launches bitwise equal, within rtol
    1e-5 of the same sums in float64, keys no slot holds 0; bf16 values
    through the scatter method within 2e-2 and bitwise across two runs.
    ``offset`` 1 starts values and keys one element off a 16-byte boundary
    (the (E,) kernel's scalar loads)."""
    rng = np.random.default_rng(len(case) * 1000 + k)
    keys, n = _sorted_sum_case(case, rng)
    shape = (keys.size,) if k == 1 else (keys.size, k)
    vals = rng.random(shape, dtype=np.float32) + 0.01
    kt = torch.from_numpy(np.concatenate([np.zeros(offset, np.int32), keys])).to(cuda)[offset:]
    vt = torch.from_numpy(np.concatenate([np.zeros((offset,) + shape[1:], np.float32),
                                          vals])).to(cuda)[offset:]
    before = segment.segment_sum_sorted.launches
    a = segment.segment_sum_sorted(vt, kt, n)
    b = segment.segment_sum_sorted(vt, kt, n)
    assert segment.segment_sum_sorted.launches == before + 2
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    want = np.zeros((n + 1,) + shape[1:])
    np.add.at(want, np.minimum(keys, n), vals.astype(np.float64))
    np.testing.assert_allclose(a.cpu().numpy(), want[:n], rtol=1e-5, atol=0)
    vb = vt.to(torch.bfloat16)
    ab = segment._scatter(vb, kt, n, "sum")
    assert ab.dtype == torch.bfloat16
    assert torch.equal(ab.view(torch.int16), segment._scatter(vb, kt, n, "sum").view(torch.int16))
    wb = np.zeros((n + 1,) + shape[1:])
    np.add.at(wb, np.minimum(keys, n), vb.float().cpu().numpy().astype(np.float64))
    np.testing.assert_allclose(ab.float().cpu().numpy(), wb[:n], rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_segment_sum_sorted_edges(cuda):
    """No slot, no segment, and a wrong dtype: the empty sums are 0, a CUDA
    float64 sum raises (no silent fallback), integer sums keep index_add_."""
    empty = segment.segment_sum_sorted(torch.zeros((0, 4), device=cuda),
                                       torch.zeros(0, dtype=torch.int32, device=cuda), 5)
    assert empty.shape == (5, 4) and not bool(empty.any())
    assert segment.segment_sum_sorted(torch.ones(3, device=cuda),
                                      torch.zeros(3, dtype=torch.int32, device=cuda),
                                      0).shape == (0,)
    with pytest.raises(TypeError, match="float32"):
        segment.segment_sum_sorted(torch.ones(3, dtype=torch.float64, device=cuda),
                                   torch.zeros(3, dtype=torch.int32, device=cuda), 2)
    before = segment.segment_sum_sorted.launches
    ints = segment._scatter(torch.arange(6, dtype=torch.int32, device=cuda),
                            torch.tensor([0, 0, 1, 1, 1, 2], dtype=torch.int32, device=cuda),
                            2, "sum")
    assert ints.tolist() == [1, 9] and segment.segment_sum_sorted.launches == before


# --- the routed pull's kernels (ops/shuffle.py) ------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 2, 4, 1000, 4096, 16384, 131072])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("idx_dtype", [torch.uint8, torch.int32])
def test_lane_gather_kernel_matches_plain(cuda, rows, dtype, idx_dtype):
    """Bitwise the plain version at every tile size the kernel picks (32
    rows down to 1) and a ragged last tile (1000 rows)."""
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.integers(-2**20, 2**20, (rows, 128)).astype(np.int32))
    x = x.to(dtype) if dtype != torch.int32 else x
    idx = torch.from_numpy(rng.integers(0, 128, (rows, 128)).astype(np.int32)).to(idx_dtype)
    before = shuffle.lane_gather.launches
    got = shuffle.lane_gather(x.to(cuda), idx.to(cuda))
    assert shuffle.lane_gather.launches == before + 1
    assert torch.equal(got.cpu(), shuffle.lane_gather_plain(x, idx))


@pytest.mark.gpu
def test_lane_gather_refuses_misaligned_views(cuda):
    """The kernel's bulk copies start on 16-byte boundaries: a view one
    element off raises, a view a whole row off runs."""
    x = torch.arange(5 * 128, dtype=torch.float32, device=cuda)
    idx = torch.randint(0, 128, (4, 128), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        shuffle.lane_gather(x[1:1 + 4 * 128].view(4, 128), idx)
    view = x[128:].view(4, 128)
    assert torch.equal(shuffle.lane_gather(view, idx), shuffle.lane_gather_plain(view, idx))


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
                                      ("min", torch.int32), ("max", torch.int32),
                                      ("sum", torch.bfloat16), ("min", torch.bfloat16),
                                      ("max", torch.bfloat16)])
def test_mxreduce_kernel_matches_plain(cuda, op, dtype):
    """Sums of f32 and of bf16 values (f32 totals) within rtol 1e-5 of the
    plain version; min/max and int32 bitwise, bf16 min/max in bf16."""
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
        x = torch.from_numpy(rng.random(n2, dtype=np.float32) + 0.01).to(dtype)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in mxa]
    y = shuffle._relayout(x.to(cuda), mxg.view, mxg.perm_axes).reshape(mxg.kshape)
    before = shuffle.mxreduce_pass_gather.launches
    got = shuffle.mxreduce_pass_gather(y, t[:k], t[k], t[k + 1], mxg)
    assert shuffle.mxreduce_pass_gather.launches == before + 1
    want = shuffle.mxreduce_pass_gather_plain(y, t[:k], t[k], t[k + 1], mxg)
    total = sum(c for _, c, _ in static.groups)
    assert got.dtype == want.dtype
    if op == "sum" and dtype.is_floating_point:
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
                                      ("min", torch.int32), ("max", torch.int32),
                                      ("sum", torch.bfloat16), ("min", torch.bfloat16)])
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
        x = torch.from_numpy(rng.random((rows, 128), dtype=np.float32) + 0.01).to(dtype)
    idx = [torch.from_numpy(rng.integers(0, 128, (rows, 128)).astype(np.int32))
           .to(idx_dtype).to(cuda) for _ in mxg.steps]
    dst_rel = torch.from_numpy(ranks.reshape(rows, 128).astype(np.int32)).to(idx_dtype).to(cuda)
    tb = torch.from_numpy(tile_block).to(cuda)
    x = x.to(cuda)
    before = shuffle.mxreduce_pass_gather.launches
    got = shuffle.mxreduce_pass_gather(x, idx, dst_rel, tb, mxg)
    assert shuffle.mxreduce_pass_gather.launches == before + 1
    want = shuffle.mxreduce_pass_gather_plain(x, idx, dst_rel, tb, mxg)
    if op == "sum" and dtype.is_floating_point:
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
    chunks a part), prefetch on and off bitwise equal (scatter's f32 sum
    included: the sorted-key kernel's order is fixed)."""
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
        assert torch.equal(runs["cuda", True], runs["cuda", False])
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
    within rtol 1e-5 (f32 sums in another order than the CPU's); a
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


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 8, 64])
@pytest.mark.parametrize("method", ["auto", "scatter"])
def test_batched_serving_peak_within_the_estimate_on_card(cuda, method, q):
    """serve/driver's memory estimate (utils/preflight.estimate_batched)
    is at or above the card's peak of a served batch: the engine's own
    device arrays and a whole run to convergence, for SSSP and PPR."""
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.serve.batched import BatchedEngine
    from lux_tpu_torch.utils import preflight

    g = generate.rmat(14, 16, seed=0)
    sh = shards.build_pull_shards(g, 1)
    for app in ("sssp", "ppr"):
        torch.cuda.synchronize(cuda)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        eng = BatchedEngine(sh, app, q, method=method, num_iters=5, device=cuda)
        res = eng.run(np.arange(q, dtype=np.int32) * 7 % g.nv)
        torch.cuda.synchronize(cuda)
        peak = torch.cuda.max_memory_allocated(cuda) - base
        est = preflight.estimate_batched(sh.spec, q, eng.method)
        assert res.state.shape == (q, g.nv)
        assert peak <= est.total_bytes, (app, eng.method, peak, est.total_bytes)
        del eng, res


# --- the serving fleet and pods on the card ------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["auto", "scatter"])
def test_fleet_on_card_matches_cpu(cuda, method, tmp_path):
    """A 2-replica fleet with its engines on the card (threads here; the
    smoke runs CUDA worker processes): SSSP answers bitwise the CPU
    engine's, PPR within rtol 1e-5; each heartbeat reports the card's
    peak bytes; a republish of another snapshot sheds nothing and then
    answers that snapshot's engine, bitwise."""
    from lux_tpu_torch.graph import format as fmt
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.serve.batched import BatchedEngine
    from lux_tpu_torch.serve.fleet.bench import start_fleet

    g = generate.rmat(12, 8, seed=6)
    sh = shards.build_pull_shards(g, 1)
    srcs = [int(s) for s in np.argsort(g.out_degrees())[::-1][:8]]
    fleet = start_fleet(2, shards=sh, mode="thread", buckets=(1, 8), device="cuda",
                        apps=("sssp", "ppr"), method=method)
    ctl = fleet.controller
    try:
        for app in ("sssp", "ppr"):
            want = BatchedEngine(sh, app, 8, method="scan", device="cpu").run(srcs)
            futs = [ctl.submit(s, app=app) for s in srcs]
            for i, f in enumerate(futs):
                got = f.result(timeout=120)
                if app == "sssp":
                    np.testing.assert_array_equal(got, want.state[i])
                else:
                    np.testing.assert_allclose(got, want.state[i], rtol=1e-5, atol=0)
        for w in fleet.thread_workers:
            hb = w.heartbeat()
            assert hb["device"].startswith("cuda") and hb["peak_bytes"] > 0
        g2 = generate.rmat(12, 8, seed=7)
        snap = str(tmp_path / "g2.lux")
        fmt.write_lux(snap, g2)
        rep = ctl.republish(snap, graph_id="g2")
        assert rep["generations"] == {"w0": 1, "w1": 1}
        want2 = BatchedEngine(shards.build_pull_shards(g2, 1), "sssp", 8, method="scan",
                              device="cpu").run(srcs)
        for i, s in enumerate(srcs):
            np.testing.assert_array_equal(ctl.submit(s).result(timeout=120), want2.state[i])
        assert ctl.stats()["shed"] == 0 and ctl.stats()["errors"] == 0
    finally:
        fleet.close()


@pytest.mark.gpu
@pytest.mark.parametrize("app", ["sssp", "components", "pagerank"])
def test_pod_on_card_matches_single_process(cuda, app, tmp_path):
    """A 2-member pod with its parts on the card is bitwise the
    single-process 8-part run on the card under auto (mxscan), and every
    iteration launches the scan kernel."""
    from lux_tpu_torch.engine import pull
    from lux_tpu_torch.graph import format as fmt
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.models.components import MaxLabelProgram
    from lux_tpu_torch.models.pagerank import PageRankProgram
    from lux_tpu_torch.models.sssp import SSSPProgram
    from lux_tpu_torch.program.spec import active_changed
    from lux_tpu_torch.serve.fleet.pod import PodWorker, run_pull_pod

    g = generate.rmat(12, 8, seed=3)
    snap = str(tmp_path / "g.lux")
    fmt.write_lux(snap, g)
    sh = shards.build_pull_shards(g, 8)
    arr = shards.to_device(sh.arrays, cuda)
    start = int(np.argmax(g.out_degrees()))
    prog = {"sssp": SSSPProgram(nv=g.nv, start=start), "components": MaxLabelProgram(),
            "pagerank": PageRankProgram(nv=g.nv)}[app]
    s0 = pull.init_state(prog, arr)
    if app == "pagerank":
        want, iters = pull.run_pull_fixed(prog, sh.spec, arr, s0, 10), 10
    else:
        want, iters = pull.run_pull_until(prog, sh.spec, arr, s0, 10_000, active_changed)
    before = scan.mxscan_segmented.launches
    ws = [PodWorker(f"p{i}", device="cuda").start() for i in range(2)]
    res = run_pull_pod([(w.host, w.port) for w in ws], snap, 8, app=app, start=start,
                       num_iters=10)
    assert res["iters"] == int(iters)
    np.testing.assert_array_equal(res["state"], want.cpu().numpy())
    assert {w["method"] for w in res["workers"].values()} == {"mxscan"}
    assert scan.mxscan_segmented.launches - before >= 8 * int(iters)
    # each member's reply counts the launches since its pod_build (the two
    # in-process members share the counters, so each sees at least its own)
    for w in res["workers"].values():
        assert w["launches"]["mxscan_segmented"] >= (w["hi"] - w["lo"]) * int(iters)


# --- live serving and the autopilot on the card --------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["fused-pf", "none"])
def test_live_fleet_on_card_matches_cpu(cuda, route):
    """A 2-replica live fleet with its engines and standing refreshes on
    the card (threads here; the smoke runs CUDA worker processes): after
    churn and a refresh, standing SSSP and components bitwise a CPU
    replica's and each other's, PageRank bitwise across the replicas and
    within rtol 1e-5 of the CPU's; bounded reads bitwise the merged
    graph's BFS; the standing rounds launched the scan kernel."""
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.models.sssp import bfs_reference
    from lux_tpu_torch.serve.live.bench import churn_batch
    from lux_tpu_torch.serve.live.controller import start_live_fleet
    from lux_tpu_torch.serve.live.replica import LiveReplica

    g = generate.rmat(12, 8, seed=6)
    standing = (("sssp", int(np.argmax(g.out_degrees()))), ("components", None),
                ("pagerank", None))
    fleet = start_live_fleet(2, g, parts=1, cap=4096, standing=standing, device="cuda",
                             route_family=route)
    ctl = fleet.controller
    rng = np.random.default_rng(0)
    before = scan.mxscan_segmented.launches
    try:
        for _ in range(3):
            s, d, o = churn_batch(ctl.journal.log, rng, 256)
            gen = ctl.admit_writes(s, d, o)["generation"]
        ctl.refresh_fleet()
        merged = ctl.journal.log.merged_graph()
        for src in (0, 5, 9):
            f = ctl.submit(src, min_generation=gen)
            np.testing.assert_array_equal(f.result(timeout=120), bfs_reference(merged, src))
        solo = LiveReplica(g, shards.build_pull_shards(g, 1), cap=4096, standing=standing,
                           device="cpu", route_family="none")
        for gg, arr in ctl.journal.batches_since(0):
            solo.apply_batch(arr, gg)
        solo.refresh()
        for app in ("sssp", "components", "pagerank"):
            a, b = (ctl.read_standing(app, worker=w)["state"] for w in ("w0", "w1"))
            np.testing.assert_array_equal(a, b)
            want = solo.standing(app)["state"]
            if app == "pagerank":
                np.testing.assert_allclose(a, want, rtol=1e-5, atol=0)
            else:
                np.testing.assert_array_equal(a, want)
        assert scan.mxscan_segmented.launches > before
    finally:
        fleet.close()


@pytest.mark.gpu
def test_autopilot_on_card(cuda):
    """The soaks with their replicas on the card: autopilot_soak (scale-up,
    election, overflow compaction) and chaos_soak at seed 0."""
    from lux_tpu_torch.fault.chaos import autopilot_soak, chaos_soak

    rep = autopilot_soak(0, device="cuda")
    assert rep["scale_ups"] >= 1 and rep["elections"] == 1 and rep["compactions"] >= 1
    rep = chaos_soak(0, device="cuda")
    assert rep["writes"] >= 1 and rep["faults_injected"] > 0


# --- the gather relayouts and the native host builds on the card ---------------


def _relayout_shards(layout, parts=2, scale=12):
    from lux_tpu_torch.graph import generate

    g = generate.rmat(scale, 8, seed=41)
    return g, shards.build_pull_shards(g, parts, sort_segments="sorted" in layout,
                                       compact_gather="compact" in layout)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["sorted", "compact", "sorted+compact"])
@pytest.mark.parametrize("op,dtype", [("sum", torch.float32), ("min", torch.int32),
                                      ("max", torch.int32)])
def test_relayout_scan_kernel_matches_plain(cuda, layout, op, dtype):
    """mxscan_segmented over each relayout's gathered values: int32
    min/max bitwise the plain version, f32 sums within rtol 1e-5 of
    float64; the compact gather bitwise the direct one on every real
    slot."""
    from lux_tpu_torch.engine import pull

    _, sh = _relayout_shards(layout)
    arrays = shards.to_device(sh.arrays, cuda)
    rng = np.random.default_rng(42)
    n = sh.spec.gathered_size
    full = (torch.from_numpy(rng.integers(-10**6, 10**6, n).astype(np.int32))
            if dtype == torch.int32 else torch.from_numpy(rng.random(n, dtype=np.float32) + 0.01))
    full = full.to(cuda)
    for p in range(sh.spec.num_parts):
        a = arrays.part(p)
        vals = pull.gather_sources(a, full).contiguous()
        m = a.edge_mask  # padding slots read the mirror's slot 0 instead
        assert torch.equal(vals[m], full.index_select(0, a.src_pos)[m])
        end = a.row_ptr[-1:]
        before = scan.mxscan_segmented.launches
        got = scan.mxscan_segmented(vals, a.head_flag, op=op, valid_end=end)
        assert scan.mxscan_segmented.launches == before + 1
        k = int(end)
        if op == "sum":
            want = _seg_scan_sum_f64(vals, a.head_flag, k)
            torch.testing.assert_close(got[:k].double(), want, rtol=1e-5, atol=0)
        else:
            plain = scan.mxscan_segmented_plain(vals, a.head_flag, op=op, valid_end=end)
            assert torch.equal(got[:k], plain[:k])


@pytest.mark.gpu
@pytest.mark.parametrize("app,extra", [("pagerank", ["-ni", "10", "--method", "mxscan"]),
                                       ("sssp", ["--method", "mxscan"]),
                                       ("components", ["--method", "mxscan"])])
def test_compact_gather_bitwise_direct_on_card(cuda, app, extra):
    """The apps on the card: --compact-gather bitwise the default layout,
    --sort-segments --compact-gather bitwise --sort-segments, and the
    build line names the native host path."""
    import importlib

    run = importlib.import_module(f"lux_tpu_torch.apps.{app}").run
    base = ["--rmat-scale", "12", "--rmat-ef", "8", "-ng", "2", "--device", "cuda",
            "-check"] + extra
    out = {}
    for layout in ([], ["--compact-gather"], ["--sort-segments"],
                   ["--sort-segments", "--compact-gather"]):
        res = run(base + layout)
        assert res.rc == 0
        out[tuple(layout)] = res.ranks if app == "pagerank" else res.state
    assert np.array_equal(out[("--compact-gather",)], out[()])
    assert np.array_equal(out[("--sort-segments", "--compact-gather")],
                          out[("--sort-segments",)])
    if app != "pagerank":  # min/max relaxation is order-free
        assert np.array_equal(out[("--sort-segments",)], out[()])
    else:
        g = res.graph
        np.testing.assert_allclose(out[("--sort-segments",)], pr.pagerank_reference(g, 10),
                                   rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("op,dtype", [("sum", torch.float32), ("min", torch.int32)])
def test_native_blockcsr_spmv_matches_plain(cuda, op, dtype):
    """spmv_blockcsr on a block-CSR filled by the native host library
    (bitwise the NumPy fill) against its plain version."""
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.native import io as native_io

    g = generate.rmat(13, 8, seed=43, weighted=True)
    bc = spmv.build_blockcsr(g)
    with native_io.numpy_path():
        npy = spmv.build_blockcsr(g)
    assert bc.host_io == "native" and npy.host_io == "numpy"
    for f in ("e_src_pos", "e_dst_rel", "e_weight", "chunk_block", "chunk_first"):
        assert np.array_equal(getattr(bc, f), getattr(npy, f)), f
    rng = np.random.default_rng(44)
    state = (torch.from_numpy(rng.integers(-1000, 1000, g.nv).astype(np.int32))
             if dtype == torch.int32 else torch.from_numpy(rng.random(g.nv, dtype=np.float32)
                                                           + 0.01))
    vals = state.to(cuda)[torch.from_numpy(bc.e_src_pos).to(cuda).long()].contiguous()
    args = (torch.from_numpy(bc.e_dst_rel).to(cuda), torch.from_numpy(bc.chunk_block).to(cuda),
            torch.from_numpy(bc.chunk_first).to(cuda))
    kw = dict(op=op, v_blk=bc.v_blk, num_vblocks=bc.num_vblocks)
    got = spmv.spmv_blockcsr(vals, *args, **kw)
    if op == "sum":
        want = _spmv_sum_f64(vals, args[0], args[1], bc.v_blk, bc.num_vblocks)
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=0)
    else:
        assert torch.equal(got, spmv.spmv_blockcsr_plain(vals, *args, **kw))


@pytest.mark.gpu
def test_sorted_routed_kernels_match_plain(cuda):
    """Plans over the sorted src_pos: the expand-pf replay (lane_gather,
    fused_pass_gather) bitwise the direct gather on every real slot; the
    app's --sort-segments --route-gather fused-pf within rtol 1e-5 of
    float64."""
    from lux_tpu_torch.apps import pagerank as app

    g, sh = _relayout_shards("sorted", parts=1, scale=13)
    st, arrs = expand.plan_to_device(expand.plan_expand_shards(sh, pf=True), cuda)
    part = tuple(a[0] for a in arrs)
    full = torch.from_numpy(np.random.default_rng(45).random(sh.spec.gathered_size,
                                                             dtype=np.float32)).to(cuda)
    lane0, fused0 = shuffle.lane_gather.launches, shuffle.fused_pass_gather.launches
    got = expand.apply_expand(full, st, part)
    assert shuffle.lane_gather.launches > lane0 and shuffle.fused_pass_gather.launches > fused0
    m = torch.from_numpy(sh.arrays.edge_mask[0]).to(cuda)
    want = full.index_select(0, torch.from_numpy(sh.arrays.src_pos[0]).to(cuda))
    assert torch.equal(got[m], want[m])
    res = app.run(["--rmat-scale", "13", "--rmat-ef", "8", "-ni", "10", "--sort-segments",
                   "--route-gather", "fused-pf", "--device", "cuda", "-check"])
    assert res.rc == 0 and res.route_gather == "fused-pf"
    np.testing.assert_allclose(res.ranks, pr.pagerank_reference(res.graph, 10), rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", ["sparse", "none", "one_segment"])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("n", [2047, 70001])
def test_scan_kernel_bf16_matches_plain(cuda, heads, op, n):
    """bf16 values: min/max bitwise against the plain version (f32 widening,
    one rounding); sums, carried in f32 through the tiles, the carries and
    the rescanning carry pass and rounded once, within rtol 2e-2 / atol
    2e-2 of float64 segmented sums.  The launch counter rises."""
    rng = np.random.default_rng(39)
    head = torch.from_numpy(_scan_heads(heads, n, rng)).to(cuda)
    vals = torch.from_numpy(rng.random(n).astype(np.float32) + 0.01).to(torch.bfloat16).to(cuda)
    end = torch.tensor([n - 5], dtype=torch.int32, device=cuda)
    before = scan.mxscan_segmented.launches
    got = scan.mxscan_segmented(vals, head, op=op, valid_end=end)
    assert scan.mxscan_segmented.launches == before + 1 and got.dtype == torch.bfloat16
    k = n - 5
    if op == "sum":
        want = _seg_scan_sum_f64(vals.float(), head, k)
        torch.testing.assert_close(got[:k].double(), want, rtol=2e-2, atol=2e-2)
    else:
        want = scan.mxscan_segmented_plain(vals, head, op=op, valid_end=end)
        assert torch.equal(got[:k], want[:k])
    assert torch.equal(got, scan.mxscan_segmented(vals, head, op=op, valid_end=end))


def _weighted_mx_case(scale, reduce):
    from lux_tpu_torch.graph import generate

    g = generate.rmat(scale, 8, seed=3, weighted=True)
    sh = shards.build_pull_shards(g, 1)
    return g, sh, expand.plan_fused_shards(sh, reduce, mx=True)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_apply_fused_mx_bf16_state_on_card(cuda, op):
    """bf16 state through apply_fused on a fused-mx plan: the card's totals
    against the CPU's (sums f32 within rtol 1e-5, min/max bf16 bitwise); the
    mx kernel launches."""
    _, sh, plan = _weighted_mx_case(11, op)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(sh.spec.gathered_size)
                         .astype(np.float32)).to(torch.bfloat16)
    part = tuple(torch.from_numpy(np.ascontiguousarray(a[0])) for a in plan[1])
    want = expand.apply_fused(x, plan[0], part)
    before = shuffle.mxreduce_pass_gather.launches
    got = expand.apply_fused(x.to(cuda), plan[0], tuple(a.to(cuda) for a in part))
    assert shuffle.mxreduce_pass_gather.launches == before + 1
    assert got.dtype == want.dtype == (torch.float32 if op == "sum" else torch.bfloat16)
    if op == "sum":
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_weighted_sssp_pull_until_fused_mx_on_card(cuda):
    """Weighted SSSP through run_pull_until on a "min" fused-mx plan: the
    card bitwise the CPU and the push engine's --weighted run, the mx kernel
    launched every iteration."""
    from lux_tpu_torch.apps import sssp as sssp_app
    from lux_tpu_torch.engine import pull
    from lux_tpu_torch.program import library, spec

    g, sh, plan = _weighted_mx_case(12, "min")
    hub = int(np.argmax(g.out_degrees()))
    prog = spec.bind(library.SSSP_WEIGHTED, inf=1 << 30, start=hub)

    def run(dev):
        arr = shards.to_device(sh.arrays, dev)
        return pull.run_pull_until(prog, sh.spec, arr, pull.init_state(prog, arr), 1000,
                                   spec.active_changed, route=plan)

    before = shuffle.mxreduce_pass_gather.launches
    got, iters = run(cuda)
    assert shuffle.mxreduce_pass_gather.launches - before == iters > 2
    want, want_iters = run("cpu")
    assert iters == want_iters and torch.equal(got.cpu(), want)
    push = sssp_app.run(["--weighted", "-start", str(hub), "--device", "cuda"], graph=g)
    assert push.rc == 0
    np.testing.assert_array_equal(sh.scatter_to_global(got.cpu().numpy()), push.state)


def _pallas_single_process(g, parts: int, iters: int, dev):
    """The distributed block-CSR PageRank's per-part steps in one process
    (every part's state gathered by concatenation, not a collective): the
    single-process twin the ranks must equal bit for bit."""
    from lux_tpu_torch.parallel import pallas_dist as pd

    pp = pd.build_pallas_parts(g, parts)
    prog = pr.PageRankProgram(nv=g.nv)
    state = pd.init_state_pallas(prog, pp).to(dev)
    a = [shards_part(pp.arrays, p, dev) for p in range(parts)]
    for _ in range(iters):
        full = state.reshape(-1)
        new = []
        for p in range(parts):
            vals = prog.edge_value(full.index_select(0, a[p]["e_src"]).view(a[p]["shape"]),
                                   a[p]["e_w"])
            acc = spmv.spmv_blockcsr(vals.contiguous(), a[p]["e_dst"], a[p]["cb"], a[p]["cf"],
                                     op="sum", v_blk=pp.v_blk,
                                     num_vblocks=pp.num_vblocks)[: pp.spec.nv_pad]
            new.append(prog.apply(state[p], acc, a[p]["view"]))
        state = torch.stack(new)
    return pp.scatter_to_global(state.cpu().numpy())


def shards_part(arr, p: int, dev) -> dict:
    from lux_tpu_torch.parallel.ring import _RingView

    t = {f: torch.from_numpy(np.ascontiguousarray(getattr(arr, f)[p])).to(dev)
         for f in arr._fields}
    return {"e_src": t["e_src_pos"].reshape(-1), "shape": t["e_dst_rel"].shape,
            "e_dst": t["e_dst_rel"], "e_w": t["e_weight"], "cb": t["chunk_block"],
            "cf": t["chunk_first"],
            "view": _RingView(t["global_vid"], t["degree"], t["vtx_mask"])}


@pytest.mark.gpu
def test_dist_ranks_sharing_the_card(cuda):
    """Two gloo ranks on the one card (collectives staged through pinned
    host buffers): allgather + mxscan PageRank at 4 parts bitwise the
    single-process card run, and the block-CSR PageRank at one part a
    rank bitwise its single-process twin; each rank launched its kernel
    every iteration."""
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.parallel import spawn

    spec = ("rmat", 12, 8, 7)
    cases = {"allgather": {"graph": spec, "prog": "pagerank", "parts": 4,
                           "exchange": "allgather", "iters": 6, "method": "mxscan"},
             "pallas": {"graph": spec, "prog": "pagerank", "parts": 2, "exchange": "pallas",
                        "iters": 6}}
    res = spawn.run_ranks(2, "torch_dist_jobs:run_cases", (cases,), num_parts=2,
                          device="cuda", backend="gloo", deadline_s=300,
                          env={"LUX_DIST_BACKEND": "gloo"})
    assert all(r["backend"] == "gloo" and r["device"].startswith("cuda") for r in res)
    for r in res:
        assert r["launches"]["mxscan_segmented"] >= 6 * 2
        assert r["launches"]["spmv_blockcsr"] >= 6
    g = generate.rmat(12, 8, seed=7)
    single = pr.pagerank(g, 6, num_parts=4, method="mxscan", device="cuda")
    np.testing.assert_array_equal(res[0]["result"]["allgather"], single)
    np.testing.assert_array_equal(res[0]["result"]["pallas"],
                                  _pallas_single_process(g, 2, 6, cuda))
    np.testing.assert_allclose(res[0]["result"]["pallas"], pr.pagerank_reference(g, 6),
                               rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("app,op", [("sssp", "min"), ("wsssp", "min"), ("cc", "max")])
@pytest.mark.parametrize("mid_run", [False, True])
def test_spmv_int32_minmax_on_push_pallas_part(cuda, app, op, mid_run):
    """Kernel 1 in int32 min / max on a rank's part of the block-CSR push
    (parallel/pallas_dist.build_push_pallas_shards at 2 parts): the dense
    round's relaxed slot values, from the initial state (SSSP: everything
    at inf but the source) or a random one, bitwise the plain version."""
    import torch_push_dist_jobs as jobs
    from lux_tpu_torch.parallel import pallas_dist as pd

    g = jobs.graph(("rmat", 12, 8, 7, app == "wsssp"))
    prog = jobs.program(app, g)
    sh = pd.build_push_pallas_shards(g, 2)
    view = [torch.from_numpy(np.ascontiguousarray(getattr(sh.pl, f))).to(cuda)
            for f in ("global_vid", "degree", "vtx_mask")]
    state = torch.stack([prog.init_state(view[0][p], view[1][p], view[2][p])
                         for p in range(2)])
    if mid_run:
        rng = np.random.default_rng(5)
        state = torch.from_numpy(rng.integers(-1, g.nv, state.shape).astype(np.int32)).to(cuda)
    full = state.reshape(-1)
    for p in range(2):
        t = {f: torch.from_numpy(np.ascontiguousarray(getattr(sh.pl, f)[p])).to(cuda)
             for f in ("e_src_pos", "e_dst_rel", "e_weight", "chunk_block", "chunk_first")}
        vals = prog.relax(full.index_select(0, t["e_src_pos"].reshape(-1))
                          .view(t["e_dst_rel"].shape), t["e_weight"]).contiguous()
        assert vals.dtype == torch.int32
        args = (vals, t["e_dst_rel"], t["chunk_block"], t["chunk_first"])
        got = spmv.spmv_blockcsr(*args, op=op, v_blk=sh.v_blk, num_vblocks=sh.num_vblocks)
        want = spmv.spmv_blockcsr_plain(*args, op, sh.v_blk, sh.num_vblocks)
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_push_dist_nccl_one_rank_matches_run_push(cuda):
    """One NCCL rank holding 4 parts: run_push_dist (bulk and tree) and the
    pallas push at one part, bitwise the single-process card run in
    state, iterations and edges; mxscan and the spmv kernel launched in
    the rank."""
    import torch_push_dist_jobs as jobs
    from lux_tpu_torch.engine import push
    from lux_tpu_torch.graph.push_shards import build_push_shards
    from lux_tpu_torch.parallel import spawn

    spec = ("rmat", 12, 8, 7)
    cases = {"bulk": {"graph": spec, "prog": "sssp", "parts": 4, "engine": "dist",
                      "method": "mxscan"},
             "tree": {"graph": spec, "prog": "cc", "parts": 4, "engine": "dist",
                      "method": "mxscan", "merge": "tree"},
             "pallas": {"graph": spec, "prog": "sssp", "parts": 1, "engine": "pallas"}}
    res = spawn.run_ranks(1, "torch_push_dist_jobs:run_all", (cases, []), num_parts=1,
                          device="cuda", backend="nccl", deadline_s=300,
                          env={"LUX_DIST_BACKEND": "nccl"})
    assert res[0]["backend"] == "nccl"
    assert res[0]["launches"]["mxscan_segmented"] > 0
    assert res[0]["launches"]["spmv_blockcsr"] > 0
    g = jobs.graph(spec)
    for name, case in cases.items():
        prog = jobs.program(case["prog"], g)
        sh = build_push_shards(g, case["parts"])
        st, it, e = push.run_push(prog, sh, method="mxscan", device="cuda")
        got = res[0]["result"]["cases"][name]
        np.testing.assert_array_equal(got[0], sh.scatter_to_global(st.cpu().numpy()))
        assert (got[1], got[2]) == (it, e)
