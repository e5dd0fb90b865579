"""Spec evaluation: the port's torch builtins vs the reference's jax ones.

The same spec text, on the same numpy inputs, must give the same bits in
both packages: every operation here is a single IEEE f32 (or integer)
operation with the same operand types on both sides, so the comparison
is bitwise (bf16 states compare through an exact f32 widening).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lux_tpu.models import pagerank as ref_pr
from lux_tpu.program import library as ref_library
from lux_tpu.program import spec as ref_spec
from lux_tpu_torch.models import pagerank as pr
from lux_tpu_torch.program import expr, library, spec

NV = 777


def _inputs(seed):
    rng = np.random.default_rng(seed)
    vid = np.arange(1024, dtype=np.int32)
    vid[NV:] = NV - 1
    degree = rng.integers(0, 9, 1024).astype(np.int32)
    mask = np.arange(1024) < NV
    return vid, degree, mask


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _assert_bitwise(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _arrays(vid, degree, mask, torch_side):
    conv = torch.from_numpy if torch_side else jnp.asarray
    return types.SimpleNamespace(global_vid=conv(vid), degree=conv(degree),
                                 vtx_mask=conv(mask))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["pagerank", "ppr"])
def test_pagerank_family_bitwise(which, dtype):
    vid, degree, mask = _inputs(41)
    if which == "pagerank":
        ref_prog = ref_pr.PageRankProgram(nv=NV, dtype=dtype)
        prog = pr.PageRankProgram(nv=NV, dtype=dtype)
    else:
        ref_prog = ref_pr.PPRProgram(nv=NV, dtype=dtype, seed=5)
        prog = pr.PPRProgram(nv=NV, dtype=dtype, seed=5)
    ra, ta = _arrays(vid, degree, mask, False), _arrays(vid, degree, mask, True)
    s_ref = ref_prog.init_state(ra.global_vid, ra.degree, ra.vtx_mask)
    s_got = prog.init_state(ta.global_vid, ta.degree, ta.vtx_mask)
    _assert_bitwise(s_got, s_ref)
    e_ref = ref_prog.edge_value(s_ref, jnp.zeros(1024, jnp.float32))
    e_got = prog.edge_value(s_got, torch.zeros(1024))
    _assert_bitwise(e_got, e_ref)
    acc = np.random.default_rng(42).random(1024).astype(np.float32) * 1e-3
    a_ref = ref_prog.apply(s_ref, jnp.asarray(acc), ra)
    a_got = prog.apply(s_got, torch.from_numpy(acc), ta)
    _assert_bitwise(a_got, a_ref)


def test_apply_rank_update_bitwise():
    acc = np.random.default_rng(43).random(2048).astype(np.float32) * 1e-2
    degree = np.random.default_rng(44).integers(0, 5, 2048).astype(np.int32)
    want = ref_pr.apply_rank_update(jnp.asarray(acc), jnp.asarray(degree), 1500)
    got = pr.apply_rank_update(torch.from_numpy(acc), torch.from_numpy(degree), 1500)
    _assert_bitwise(got, want)


@pytest.mark.parametrize("name,params", [
    ("sssp", {"inf": NV, "start": 3}),
    ("components", {}),
    ("bfs", {"nv": NV, "sources": (0, 9)}),
])
def test_integer_specs_bitwise(name, params):
    vid, degree, mask = _inputs(45)
    ref_prog = ref_spec.bind(ref_library.REGISTRY[name], **params)
    prog = spec.bind(library.REGISTRY[name], **params)
    ra, ta = _arrays(vid, degree, mask, False), _arrays(vid, degree, mask, True)
    s_ref = ref_prog.init_state(ra.global_vid, ra.degree, ra.vtx_mask)
    s_got = prog.init_state(ta.global_vid, ta.degree, ta.vtx_mask)
    _assert_bitwise(s_got, s_ref)
    acc = np.random.default_rng(46).integers(-5, NV, 1024).astype(np.int32)
    _assert_bitwise(prog.apply(s_got, torch.from_numpy(acc), ta),
                    ref_prog.apply(s_ref, jnp.asarray(acc), ra))
    _assert_bitwise(prog.edge_value(s_got, torch.zeros(1024)),
                    ref_prog.edge_value(s_ref, jnp.zeros(1024)))


def test_registry_is_the_reference_registry():
    assert set(library.REGISTRY) == set(ref_library.REGISTRY)
    for name, s in library.REGISTRY.items():
        r = ref_library.REGISTRY[name]
        assert (s.reduce, s.init, s.edge, s.apply, s.frontier, s.convergence) == \
            (r.reduce, r.init, r.edge, r.apply, r.frontier, r.convergence), name


@pytest.mark.parametrize("src", [
    "x.dtype", "import os", "x[0]", "lambda: 1", "(lambda a: a)(1)",
    "where(a, b, c, d=1)", "1 < x < 2", "[x]"])
def test_outside_the_language_rejected(src):
    with pytest.raises(expr.SpecSyntaxError):
        expr.check(src)


def test_scalar_tensor_mixing_gives_tensors():
    x = torch.arange(4, dtype=torch.int32)
    out = expr.run("f32(0.5) * x", {"x": x})
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    both = expr.run("where(x > 1, i32(7), i32(-1))", {"x": x})
    assert both.dtype == torch.int32 and both.tolist() == [-1, -1, 7, 7]
    assert expr.run("maximum(1.0, f32(x))", {"x": x}).tolist() == [1, 1, 2, 3]
    assert expr.run("arange(3)", {"x": x}).dtype == torch.int32
    # scalar-only arithmetic rounds in f32, like the reference
    assert expr.run("f32(0.1) * f32(3.0)", {}) == np.float32(0.1) * np.float32(3.0)


def test_unknown_name_and_function_raise():
    with pytest.raises(expr.SpecSyntaxError, match="unknown name"):
        expr.run("y + 1", {"x": 1})
    with pytest.raises(expr.SpecSyntaxError, match="unknown function"):
        expr.run("frob(x)", {"x": 1})
    with pytest.raises(expr.SpecSyntaxError, match="unknown function"):
        expr.run("__import__('os')", {})
