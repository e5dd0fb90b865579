"""Segmented scan and segment reductions: the port vs the reference.

The reference's mxscan kernel runs in Pallas interpret mode on the CPU
(its default off-TPU, as in tests/test_mxscan.py); the reference segment
methods run as jitted XLA on the CPU.  Tolerances: min/max and int32 sums
are bitwise (order-insensitive combiners, int32 wraps the same way);
f32 sums rtol 1e-5 against the reference and a float64 oracle (positive
values, different association).  ``cumsum``/``mxsum`` take a global
prefix, so their f32 differences carry an absolute error of a few ulps
of the total prefix, stated as atol.  Invalid slots' scan outputs are
unspecified in both packages and are not compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph import shards as ref_shards
from lux_tpu.ops import pallas_scan as ref_scan
from lux_tpu.ops import segment as ref_segment
from lux_tpu_torch.ops import scan, segment

N = 3000  # not a multiple of any tile: a ragged tail



def _geometry(kind, rng):
    head = np.zeros(N, bool)
    if kind == "mixed":  # single-element and longer segments
        head = rng.random(N) < 0.3
        head[0] = True
    elif kind == "one_segment":  # one segment spanning the whole array
        head[0] = True
    elif kind == "no_head_first":  # the first slots belong to no head
        head[500::37] = True
    invalid = np.zeros(N, bool)
    invalid[2600:] = True  # padding tail
    return head, invalid


def _values(dtype, rng, invalid):
    if dtype == np.int32:
        vals = rng.integers(-2**31, 2**31 - 1, N, dtype=np.int64).astype(np.int32)
    else:
        vals = (rng.random(N) + 0.01).astype(np.float32)
        vals[invalid] = np.where(np.arange(invalid.sum()) % 2, np.nan, np.inf)
    return vals


def _oracle(vals, head, invalid, op):
    fn = {"sum": np.add, "min": np.minimum, "max": np.maximum}[op]
    v = vals.astype(np.float64) if vals.dtype == np.float32 and op == "sum" else vals
    out = np.empty_like(v)
    for i in range(N):
        out[i] = v[i] if (i == 0 or head[i]) else fn(out[i - 1], v[i])
    return out


@pytest.mark.parametrize("kind", ["mixed", "one_segment", "no_head_first"])
@pytest.mark.parametrize("op,dtype", [("sum", np.float32), ("min", np.float32),
                                      ("max", np.float32), ("sum", np.int32),
                                      ("min", np.int32), ("max", np.int32)])
def test_plain_mxscan_matches_reference(kind, op, dtype):
    rng = np.random.default_rng(31)
    head, invalid = _geometry(kind, rng)
    vals = _values(dtype, rng, invalid)
    ref = np.asarray(ref_scan.mxscan_segmented(
        jnp.asarray(vals), jnp.asarray(head), jnp.asarray(invalid), op=op))
    got = scan.mxscan_segmented(torch.from_numpy(vals), torch.from_numpy(head),
                                torch.from_numpy(invalid), op=op).numpy()
    assert got.dtype == vals.dtype
    ok = ~invalid
    if op == "sum" and dtype == np.float32:
        np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-5)
        want = _oracle(np.where(invalid, 0, vals).astype(np.float32), head, invalid, op)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5)
    else:
        np.testing.assert_array_equal(got[ok], ref[ok])


def test_valid_end_equals_invalid_mask():
    rng = np.random.default_rng(32)
    head, invalid = _geometry("mixed", rng)
    vals = torch.from_numpy(_values(np.float32, rng, invalid))
    a = scan.mxscan_segmented(vals, torch.from_numpy(head), torch.from_numpy(invalid))
    b = scan.mxscan_segmented(vals, torch.from_numpy(head),
                              valid_end=torch.tensor([2600], dtype=torch.int32))
    assert torch.equal(a[:2600], b[:2600])


def test_mxscan_rejects_what_it_does_not_take():
    """bf16 is taken now (the reference's kernel, interpret mode, gives the
    same min/max bits and sums at rtol 2e-2); float16, (E, K) values, a
    misshaped head_flag and an unknown op are refused."""
    rng = np.random.default_rng(34)
    head, invalid = _geometry("mixed", rng)
    vals = rng.standard_normal(N).astype(np.float32)
    vb = torch.from_numpy(vals).to(torch.bfloat16)
    for op in ("sum", "min", "max"):
        got = scan.mxscan_segmented(vb, torch.from_numpy(head), torch.from_numpy(invalid), op=op)
        want = ref_scan.mxscan_segmented(jnp.asarray(vals).astype(jnp.bfloat16),
                                         jnp.asarray(head), jnp.asarray(invalid), op=op)
        assert got.dtype == torch.bfloat16
        ok = ~invalid
        g32, w32 = got.float().numpy()[ok], np.asarray(want.astype(jnp.float32))[ok]
        if op == "sum":
            np.testing.assert_allclose(g32, w32, rtol=2e-2, atol=2e-2)
        else:
            np.testing.assert_array_equal(g32, w32)
    h = torch.zeros(8, dtype=torch.bool)
    with pytest.raises(TypeError, match="bfloat16"):
        scan.mxscan_segmented(torch.zeros(8, dtype=torch.float16), h)
    with pytest.raises(ValueError, match="1-D"):
        scan.mxscan_segmented(torch.zeros(8, 2), h)
    with pytest.raises(ValueError, match="head_flag"):
        scan.mxscan_segmented(torch.zeros(8), h[:4])
    with pytest.raises(ValueError, match="op"):
        scan.mxscan_segmented(torch.zeros(8), h, op="prod")
    assert scan.mxscan_segmented(torch.zeros(0), h[:0]).shape == (0,)


@pytest.fixture(scope="module")
def part():
    """One part of a ragged 2-part RMAT layout (empty rows included), with
    numpy arrays for the reference and tensors for the port."""
    g = ref_generate.rmat(9, 4, seed=33)
    sh = ref_shards.build_pull_shards(g, 2)
    p = {k: np.asarray(v)[1] for k, v in sh.arrays._asdict().items()}
    assert (np.diff(p["row_ptr"]) == 0).any()
    return p


def _vals(p, dtype, rng, k=None):
    e = p["src_pos"].shape[0]
    shape = (e,) if k is None else (e, k)
    if dtype == np.int32:
        return rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int64).astype(np.int32)
    return (rng.random(shape) + 0.01).astype(np.float32)


def _both(fn_name, p, vals, method):
    ref = jax.jit(getattr(ref_segment, fn_name), static_argnames="method")(
        jnp.asarray(vals), jnp.asarray(p["row_ptr"]), jnp.asarray(p["head_flag"]),
        jnp.asarray(p["dst_local"]), method=method)
    got = getattr(segment, fn_name)(
        torch.from_numpy(vals), torch.from_numpy(p["row_ptr"]),
        torch.from_numpy(p["head_flag"]), torch.from_numpy(p["dst_local"]),
        method=method)
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("method", ["scan", "mxscan", "scatter", "cumsum", "mxsum"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_sum_csc_matches_reference(part, method, dtype):
    vals = _vals(part, dtype, np.random.default_rng(34))
    ref, got = _both("segment_sum_csc", part, vals, method)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if dtype == np.int32:
        np.testing.assert_array_equal(got, ref)
    elif method in ("cumsum", "mxsum"):
        atol = 8 * np.finfo(np.float32).eps * float(vals.sum())
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("fn_name", ["segment_min_csc", "segment_max_csc"])
@pytest.mark.parametrize("method", ["scan", "mxscan", "scatter"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_minmax_csc_bitwise(part, fn_name, method, dtype):
    vals = _vals(part, dtype, np.random.default_rng(35))
    ref, got = _both(fn_name, part, vals, method)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("method", ["scan", "mxscan"])
def test_segment_sum_csc_k_dim(part, method):
    """(E, K) values: mxscan downgrades to scan, bitwise."""
    vals = _vals(part, np.float32, np.random.default_rng(36), k=3)
    ref, got = _both("segment_sum_csc", part, vals, method)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    _, scan_got = _both("segment_sum_csc", part, vals, "scan")
    np.testing.assert_array_equal(got, scan_got)


@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
@pytest.mark.parametrize("method", ["scan", "scatter", "mxscan", "cumsum"])
def test_segment_reduce_by_ends_matches_reference(part, reduce, method):
    vals = _vals(part, np.float32, np.random.default_rng(37))
    v = part["row_ptr"].shape[0] - 1
    by_ends = jax.jit(ref_segment.segment_reduce_by_ends,
                      static_argnames=("num_segments", "reduce", "method"))
    ref = np.asarray(by_ends(
        jnp.asarray(vals), jnp.asarray(part["head_flag"]), jnp.asarray(part["dst_local"]),
        num_segments=v, reduce=reduce, method=method))
    got = segment.segment_reduce_by_ends(
        torch.from_numpy(vals), torch.from_numpy(part["head_flag"]),
        torch.from_numpy(part["dst_local"]), v, reduce=reduce, method=method).numpy()
    if reduce == "sum":
        np.testing.assert_allclose(got, ref, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, ref)


def test_unknown_method_raises(part):
    vals = torch.zeros(part["src_pos"].shape[0])
    with pytest.raises(ValueError, match="unknown method"):
        segment.segment_sum_csc(vals, torch.from_numpy(part["row_ptr"]),
                                torch.from_numpy(part["head_flag"]), method="nope")
    with pytest.raises(ValueError, match="sum-only"):
        segment.segment_min_csc(vals, torch.from_numpy(part["row_ptr"]),
                                torch.from_numpy(part["head_flag"]), method="cumsum")
