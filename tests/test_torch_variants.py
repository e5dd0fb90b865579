"""The bf16 and weighted-edge forms of the scan, mx and spmv kernels:
lux_tpu_torch against lux_tpu, on the CPU.

The reference's Pallas kernels run in interpret mode, as its own suite
runs them; the port's wrappers run their plain versions on CPU tensors.
Tolerances (the reference's own contract): min/max and int32 bitwise;
bf16 sums within rtol 2e-2 / atol 2e-2 of float64 sums (one rounding to
bf16 at the storage precision); f32 sums, the mx form's totals of bf16
values included, within rtol 1e-5.  The weighted mx form keeps its
weights in the mx group's entry layout (ops/expand.mx_weights_to_entry):
sent through the plain chain they are the reference's final-layout
weights, bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lux_tpu.engine import pull as ref_pull
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph import shards as ref_shards
from lux_tpu.ops import expand as ref_expand
from lux_tpu.ops import pallas_spmv as ref_spmv
from lux_tpu.ops import segment as ref_segment
from lux_tpu.program import library as ref_library
from lux_tpu.program import spec as ref_spec
from lux_tpu_torch.apps import sssp as sssp_app
from lux_tpu_torch.engine import pull
from lux_tpu_torch.graph import csc, generate, shards
from lux_tpu_torch.ops import expand, scan, segment, spmv
from lux_tpu_torch.program import library, spec

BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    monkeypatch.setenv("LUX_PF_MAX_BLOCK", str(1 << 14))
    for k in ("LUX_ROUTE_MODE", "LUX_REDUCE_MODE", "LUX_ROUTE_IDX8"):
        monkeypatch.delenv(k, raising=False)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _np32(t) -> np.ndarray:
    """A bf16 tensor or jax array as its exact f32 widening."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


# ---------------------------------------------------------------------------
# the scan: segment_*_csc(method="mxscan") on bf16
# ---------------------------------------------------------------------------


def _csc(widths, pad):
    """row_ptr, head_flag, dst_local and e_pad of CSC segments of the
    given widths followed by ``pad`` padding slots (dst_local == V)."""
    rp = np.concatenate([[0], np.cumsum(widths)]).astype(np.int32)
    ne = int(rp[-1])
    e_pad = ne + pad
    head = np.zeros(e_pad, bool)
    head[rp[:-1][np.diff(rp) > 0]] = True
    dst = np.full(e_pad, len(widths), np.int32)
    dst[:ne] = np.repeat(np.arange(len(widths)), widths)
    return rp, head, dst, e_pad


#: a hub of 9,000 slots (longer than the kernel's 8,192-element tile),
#: empty rows, and short segments on both sides
_WIDTHS = [5, 0, 9000, 1, 33, 0, 700, 7]


def _bf16_vals(e_pad, seed, inf_at=3):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(e_pad).astype(np.float32)
    v[inf_at] = np.inf  # the sssp shape: an Inf sentinel among the values
    return v


def _seg_f64(widths, vals, op):
    out, pos = [], 0
    for w in widths:
        seg = vals[pos:pos + w].astype(np.float64)
        pos += w
        if w == 0:
            out.append(0.0 if op == "sum" else (np.inf if op == "min" else -np.inf))
        else:
            out.append({"sum": np.sum, "min": np.min, "max": np.max}[op](seg))
    return np.asarray(out)


@pytest.mark.parametrize("op", ["min", "max"])
def test_segment_minmax_mxscan_bf16_bitwise(op):
    rp, head, dst, e_pad = _csc(_WIDTHS, pad=13)
    v = _bf16_vals(e_pad, 1)
    fn = segment.segment_min_csc if op == "min" else segment.segment_max_csc
    rfn = ref_segment.segment_min_csc if op == "min" else ref_segment.segment_max_csc
    got = fn(_bf16(v), _t(rp), _t(head), _t(dst), method="mxscan")
    want = rfn(jnp.asarray(v).astype(jnp.bfloat16), jnp.asarray(rp), jnp.asarray(head),
               jnp.asarray(dst), method="mxscan")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np32(got), _np32(want))
    np.testing.assert_array_equal(_np32(got), _seg_f64(_WIDTHS, _np32(_bf16(v)), op))


def test_segment_sum_mxscan_bf16_within_tolerance():
    rp, head, dst, e_pad = _csc(_WIDTHS, pad=13)
    v = _bf16_vals(e_pad, 2, inf_at=e_pad - 1)  # the Inf in the padding: neutralized
    vb = _bf16(v)
    got = segment.segment_sum_csc(vb, _t(rp), _t(head), _t(dst), method="mxscan")
    want = ref_segment.segment_sum_csc(jnp.asarray(v).astype(jnp.bfloat16), jnp.asarray(rp),
                                       jnp.asarray(head), jnp.asarray(dst), method="mxscan")
    assert got.dtype == torch.bfloat16
    oracle = _seg_f64(_WIDTHS, _np32(vb), "sum")
    np.testing.assert_allclose(_np32(got), oracle, **BF16_TOL)
    np.testing.assert_allclose(_np32(got), _np32(want), **BF16_TOL)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_mxscan_plain_bf16_rounds_once(op):
    """The plain twin widens, scans in f32 and rounds once: on one segment
    across two tiles its sums are the f32 prefix sums rounded, where the
    bf16 ladder would round at every level."""
    n = 9000
    rng = np.random.default_rng(3)
    vb = _bf16(rng.random(n) + 0.5)
    head = torch.zeros(n, dtype=torch.bool)
    head[0] = True
    got = scan.mxscan_segmented(vb, head, op=op)
    assert got.dtype == torch.bfloat16
    want = scan.segmented_scan(vb.float(), head, scan.COMBINERS[op]).to(torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_segment_reduce_by_ends_mxscan_bf16(op):
    """The bucketed callers' form (no row_ptr; the dst_local sentinel is the
    padding mask) passes bf16 to the scan too: min/max bitwise the
    reference's, sums within rtol 2e-2 of them and of float64."""
    rp, head, dst, e_pad = _csc(_WIDTHS, pad=13)
    head[int(rp[-1]):] = True  # a padding slot opens a run of its own, as in a bucket
    v = _bf16_vals(e_pad, 4, inf_at=e_pad - 2)
    nseg = len(_WIDTHS)
    got = segment.segment_reduce_by_ends(_bf16(v), _t(head), _t(dst), nseg, op, method="mxscan")
    want = ref_segment.segment_reduce_by_ends(jnp.asarray(v).astype(jnp.bfloat16),
                                              jnp.asarray(head), jnp.asarray(dst), nseg, op,
                                              method="mxscan")
    assert got.dtype == torch.bfloat16
    if op == "sum":
        np.testing.assert_allclose(_np32(got), _np32(want), **BF16_TOL)
        np.testing.assert_allclose(_np32(got), _seg_f64(_WIDTHS, _np32(_bf16(v)), op),
                                   **BF16_TOL)
    else:
        np.testing.assert_array_equal(_np32(got), _np32(want))


# ---------------------------------------------------------------------------
# the spmv: spmv_blockcsr min/max on bf16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["min", "max"])
def test_spmv_blockcsr_bf16_minmax_bitwise(op):
    rng = np.random.default_rng(5)
    nv = 900
    dst = np.concatenate([rng.integers(0, 200, 700), np.full(300, 150),
                          rng.integers(600, 700, 80)])
    g = csc.from_edge_list(rng.integers(0, nv, dst.shape[0]), dst, nv)
    bc = spmv.build_blockcsr(g, v_blk=128, t_chunk=128)
    state = rng.standard_normal(nv).astype(np.float32)
    state[7] = np.inf if op == "min" else -np.inf
    vals = _bf16(state)[_t(bc.e_src_pos).long()]
    got = spmv.spmv_blockcsr(vals, _t(bc.e_dst_rel), _t(bc.chunk_block), _t(bc.chunk_first),
                             op=op, v_blk=bc.v_blk, num_vblocks=bc.num_vblocks)
    want = ref_spmv.spmv_blockcsr(
        jnp.asarray(state).astype(jnp.bfloat16)[jnp.asarray(bc.e_src_pos)],
        jnp.asarray(bc.e_dst_rel), jnp.asarray(bc.chunk_block), jnp.asarray(bc.chunk_first),
        op=op, v_blk=bc.v_blk, num_vblocks=bc.num_vblocks, interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np32(got), _np32(want))


# ---------------------------------------------------------------------------
# the mx form: apply_fused on bf16 state, and weighted
# ---------------------------------------------------------------------------


def _fused_case(seed, m=1500, nseg=61, ss=900, e_pad=1536):
    rng = np.random.default_rng(seed)
    p = np.ones(nseg)
    p[0] = nseg  # a hub destination
    dst = np.repeat(np.arange(nseg), rng.multinomial(m, p / p.sum()))
    sp = np.zeros(e_pad, np.int32)
    dl = np.full(e_pad, nseg, np.int32)
    sp[:m], dl[:m] = rng.integers(0, ss, m), dst
    return sp, dl, m, nseg, ss


def _apply_both(plan, rplan, x, bf16=False, del_val=None, edge=None):
    """The port's apply_fused and the reference's on the same part inputs;
    ``edge`` = (the port's edge function, the reference's) of a weighted
    program."""
    xp, xr = _t(x), jnp.asarray(x)
    if bf16:
        xp, xr = xp.to(torch.bfloat16), xr.astype(jnp.bfloat16)
    kw = {} if edge is None else {"weighted": True}
    got = expand.apply_fused(xp, plan[0], tuple(_t(a) for a in plan[1]),
                             edge_value=None if edge is None else edge[0],
                             del_val=None if del_val is None else _t(del_val), **kw)
    want = ref_expand.apply_fused(xr, rplan[0], tuple(jnp.asarray(a) for a in rplan[1]),
                                  edge_value=None if edge is None else edge[1],
                                  del_val=None if del_val is None else jnp.asarray(del_val),
                                  interpret=True, **kw)
    return got, want


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_apply_fused_mx_bf16_state(op):
    sp, dl, m, nseg, ss = _fused_case(7)
    plan = expand.plan_fused(sp, dl, m, ss, 128, op, mx=True)
    rplan = ref_expand.plan_fused(sp, dl, m, ss, 128, op, mx=True)
    x = np.random.default_rng(8).standard_normal(ss).astype(np.float32)
    got, want = _apply_both(plan, rplan, x, bf16=True)
    if op == "sum":
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        vals = np.asarray(_np32(_bf16(x)), np.float64)[sp[:m]]
        oracle = np.zeros(nseg)
        np.add.at(oracle, dl[:m], vals)
        np.testing.assert_allclose(got.numpy()[:nseg], oracle, **BF16_TOL)
    else:
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np32(got), _np32(want))


def _weights(m, e_pad, seed, eighths: bool):
    """Per-edge f32 weights: multiples of 1/8 (products with the state
    round like any f32 product) or the integers 1..100 (SSSP's costs)."""
    rng = np.random.default_rng(seed)
    w = np.zeros(e_pad, np.float32)
    w[:m] = rng.integers(1, 64, m) / 8.0 if eighths else rng.integers(1, 101, m)
    return w


@pytest.mark.parametrize("tombstones", [False, True])
@pytest.mark.parametrize("op", ["sum", "min"])
def test_apply_fused_mx_weighted(op, tombstones):
    """``v * w`` summed (rtol 1e-5) and ``src + i32(w)`` min (bitwise), with
    and without tombstoned edges, against the reference's in-kernel edge
    function; the plan's entry-layout weights sent through the steps are
    the reference's, bitwise."""
    sp, dl, m, nseg, ss = _fused_case(11)
    w = _weights(m, len(sp), 12, eighths=op == "sum")
    plan = expand.plan_fused(sp, dl, m, ss, 128, op, weights=w, mx=True)
    rplan = ref_expand.plan_fused(sp, dl, m, ss, 128, op, weights=w, mx=True)
    slot = expand.mx_weights_slot(plan[0])
    k = len(plan[0].mx.steps)
    back = expand.mx_weights_to_final(plan[0].mx, plan[1][slot - 3 - k:slot - 3], plan[1][slot])
    assert back.tobytes() == np.asarray(rplan[1][slot]).tobytes()
    rng = np.random.default_rng(13)
    if op == "sum":
        x = (rng.random(ss) + 0.01).astype(np.float32)
        edge = (lambda s, ww: s * ww, lambda s, ww: s * ww)
    else:
        x = rng.integers(0, 1 << 20, ss).astype(np.int32)
        x[5] = 1 << 30  # an unreached source
        edge = (lambda s, ww: s + ww.to(torch.int32), lambda s, ww: s + ww.astype(jnp.int32))
    d = np.zeros(len(sp), bool)
    if tombstones:
        d[rng.choice(m, m // 7, replace=False)] = True
    got, want = _apply_both(plan, rplan, x, del_val=d if tombstones else None, edge=edge)
    keep = ~d[:m]
    vals = np.asarray(x, np.float64)[sp[:m]]
    if op == "sum":
        oracle = np.zeros(nseg)
        np.add.at(oracle, dl[:m][keep], (vals * w[:m])[keep])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
        np.testing.assert_allclose(got.numpy()[:nseg], oracle, rtol=1e-5)
    else:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        oracle = np.full(nseg, np.iinfo(np.int32).max, np.int64)
        np.minimum.at(oracle, dl[:m][keep], (vals + w[:m])[keep].astype(np.int64))
        np.testing.assert_array_equal(got.numpy()[:nseg], oracle)


# ---------------------------------------------------------------------------
# the path: weighted SSSP through run_pull_until on a fused-mx plan
# ---------------------------------------------------------------------------


def test_weighted_sssp_pull_until_fused_mx():
    g = generate.rmat(10, 4, seed=17, weighted=True)
    rg = ref_generate.rmat(10, 4, seed=17, weighted=True)
    hub = int(np.argmax(g.out_degrees()))
    inf = 1 << 30
    sh = shards.build_pull_shards(g, 1)
    arrays = shards.to_device(sh.arrays, "cpu")
    prog = spec.bind(library.SSSP_WEIGHTED, inf=inf, start=hub)
    plan = expand.plan_fused_shards(sh, "min", mx=True)
    got, iters = pull.run_pull_until(prog, sh.spec, arrays, pull.init_state(prog, arrays),
                                     200, spec.active_changed, route=plan)
    rsh = ref_shards.build_pull_shards(rg, 1)
    rprog = ref_spec.bind(ref_library.SSSP_WEIGHTED, inf=inf, start=hub)
    rplan = ref_expand.plan_fused_shards(rsh, "min", mx=True)
    want, riters = ref_pull.run_pull_until(rprog, rsh.spec, rsh.arrays,
                                           ref_pull.init_state(rprog, rsh.arrays), 200,
                                           ref_spec.active_changed, method="scan", route=rplan)
    assert iters == int(riters) and iters > 2
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    push = sssp_app.run(["--weighted", "-start", str(hub), "--device", "cpu"], graph=g)
    assert push.rc == 0
    np.testing.assert_array_equal(sh.scatter_to_global(got.numpy()), push.state)


def test_reference_weighted_mx_plan_converts_to_entry_layout():
    """convert.route_plan_from_numpy moves a reference mx plan's final-layout
    weights to the entry layout: weighted SSSP on the converted plan is
    bitwise the run on the port's own plan, whose arrays it equals."""
    from lux_tpu_torch import convert

    g = generate.rmat(8, 6, seed=19, weighted=True)
    rg = ref_generate.rmat(8, 6, seed=19, weighted=True)
    sh = shards.build_pull_shards(g, 2)
    rplan = ref_expand.plan_fused_shards(ref_shards.build_pull_shards(rg, 2), "min", mx=True)
    st, ts = convert.route_plan_from_numpy(rplan[0], rplan[1], device="cpu")
    mine = expand.plan_fused_shards(sh, "min", mx=True)
    assert all(np.array_equal(t.numpy(), a) for t, a in zip(ts, mine[1]))
    arrays = shards.to_device(sh.arrays, "cpu")
    prog = spec.bind(library.SSSP_WEIGHTED, inf=1 << 30, start=int(np.argmax(g.out_degrees())))
    s0 = pull.init_state(prog, arrays)
    a, ia = pull.run_pull_until(prog, sh.spec, arrays, s0, 200, spec.active_changed,
                                route=(st, ts))
    b, ib = pull.run_pull_until(prog, sh.spec, arrays, s0, 200, spec.active_changed,
                                route=mine)
    assert ia == ib and torch.equal(a, b)


def test_mx_cache_entries_of_the_old_format_are_rebuilt(tmp_path, monkeypatch):
    """MX_FORMAT salts the fused-mx keys: an entry written under format 1
    (final-layout weights) is never read as the entry layout."""
    sh = shards.build_pull_shards(generate.rmat(7, 4, seed=2, weighted=True), 1)
    cache = str(tmp_path / "plans")
    monkeypatch.setattr(expand, "MX_FORMAT", 1)
    expand.plan_fused_shards_cached(sh, "min", cache_dir=cache, mx=True)
    assert expand.has_cached_fused_plan(sh, "min", cache_dir=cache, mx=True)
    monkeypatch.setattr(expand, "MX_FORMAT", 2)
    assert expand.has_cached_fused_plan(sh, "min", cache_dir=cache, mx=True) is None
