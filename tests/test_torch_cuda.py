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


def _corner_layout(v_blk):
    """Ragged last block, a hub spanning several chunks, empty vertex
    blocks, and an all-padding tail block."""
    rng = np.random.default_rng(21)
    nv = 1000
    dst = np.concatenate([rng.integers(0, 200, 900), np.full(400, 150),
                          rng.integers(700, 760, 100)])
    g = csc.from_edge_list(rng.integers(0, nv, dst.shape[0]), dst, nv)
    return g, spmv.build_blockcsr(g, v_blk=v_blk, t_chunk=128)


@pytest.mark.gpu
@pytest.mark.parametrize("v_blk", [128, 512])
@pytest.mark.parametrize("op,dtype", [("sum", torch.float32), ("sum", torch.bfloat16),
                                      ("min", torch.float32), ("max", torch.float32),
                                      ("min", torch.int32), ("max", torch.int32)])
def test_spmv_kernel_matches_plain(cuda, v_blk, op, dtype):
    g, bc = _corner_layout(v_blk)
    rng = np.random.default_rng(28)
    if dtype == torch.int32:
        state = torch.from_numpy(rng.integers(-1000, 1000, g.nv).astype(np.int32))
    else:
        state = torch.from_numpy(rng.random(g.nv).astype(np.float32) + 0.01).to(dtype)
    vals = state[torch.from_numpy(bc.e_src_pos).long()].to(cuda)
    args = (torch.from_numpy(bc.e_dst_rel).to(cuda), torch.from_numpy(bc.chunk_block).to(cuda),
            torch.from_numpy(bc.chunk_first).to(cuda))
    kw = dict(op=op, v_blk=bc.v_blk, num_vblocks=bc.num_vblocks)
    before = spmv.spmv_blockcsr.launches
    got = spmv.spmv_blockcsr(vals, *args, **kw)
    want = spmv.spmv_blockcsr_plain(vals, *args, **kw)
    assert spmv.spmv_blockcsr.launches == before + 1
    if op == "sum":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("op,dtype", [("sum", torch.float32), ("max", torch.float32),
                                      ("sum", torch.int32), ("min", torch.int32)])
@pytest.mark.parametrize("n", [1, 2047, 2049, 70001])
def test_scan_kernel_matches_plain(cuda, op, dtype, n):
    """Across the kernel's 2048-element tile boundaries."""
    rng = np.random.default_rng(38)
    head = torch.from_numpy(rng.random(n) < 0.01).to(cuda)
    if dtype == torch.int32:
        vals = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64)
                                .astype(np.int32)).to(cuda)
    else:
        vals = torch.from_numpy(rng.random(n).astype(np.float32) + 0.01).to(cuda)
    end = torch.tensor([max(1, n - 5)], dtype=torch.int32, device=cuda)
    got = scan.mxscan_segmented(vals, head, op=op, valid_end=end)
    want = scan.mxscan_segmented_plain(vals, head, op=op, valid_end=end)
    k = int(end.item())
    if op == "sum" and dtype == torch.float32:
        torch.testing.assert_close(got[:k], want[:k], rtol=1e-5, atol=0)
    else:
        assert torch.equal(got[:k], want[:k])


@pytest.mark.gpu
def test_scan_invalid_mask_on_card(cuda):
    rng = np.random.default_rng(39)
    n = 5000
    vals = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
    invalid = torch.zeros(n, dtype=torch.bool, device=cuda)
    invalid[4000:] = True
    vals[4000:] = float("nan")
    head = torch.from_numpy(rng.random(n) < 0.05).to(cuda)
    got = scan.mxscan_segmented(vals, head, invalid, op="min")
    want = scan.mxscan_segmented_plain(vals, head, invalid, op="min")
    assert torch.equal(got[:4000], want[:4000])


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
                                         (1 << 15, 1024), (1 << 11, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_pass_gather_kernel_matches_plain(cuda, n, max_block, dtype):
    """Every group of a pass-fused route (relayouts across rows included),
    then the whole replay against x[perm]."""
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


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["expand", "expand-pf", "fused", "fused-pf", "fused-mx"])
def test_routed_pagerank_on_card(cuda, mode):
    from lux_tpu_torch.apps import pagerank as app

    res = app.run(["--rmat-scale", "12", "--rmat-ef", "8", "-ni", "10", "--method", "mxscan",
                   "--route-gather", mode, "--device", "cuda", "-check"])
    assert res.rc == 0
    np.testing.assert_allclose(res.ranks, pr.pagerank_reference(res.graph, 10), rtol=1e-5)
