"""The restricted expression language vertex-program specs are written in.

Counterpart of ``lux_tpu.program.expr``; the parser and the vocabulary
are the same, the builtins evaluate with torch.  A spec field is a short
straight-line program in Python SYNTAX: ``name = expression`` bindings
followed by one final expression, compiled through :mod:`ast` against a
CLOSED vocabulary.  Names resolve to the lowering environment (engine
tensors plus program parameters), calls resolve to the builtin table
below, and every other construct is rejected at definition time.  There
is no ``eval``/``exec`` of user text.

Scalars: ``f32(x)``/``i32(x)``/``u32(x)`` of a Python scalar give the
numpy scalar of that type (so scalar-only arithmetic rounds as the
reference does), and a numpy scalar meeting a tensor — in an operator or
a builtin — becomes a 0-d tensor of its own dtype on the tensor's device,
so mixed expressions always return tensors with the reference's dtype.

uint32: PyTorch's CUDA build has no arithmetic, bitwise, shift or
``where`` kernel for ``torch.uint32`` (only copies, casts, comparisons
for equality and gathers).  So an operation whose tensor operands are
all uint32 runs on their int64 widening and narrows back modulo 2^32:
the same bits as uint32 arithmetic, on either device.  ``popcount``
counts 32-bit words with five SWAR steps on their int32 bit pattern.

Vocabulary (beyond ``+ - * / // % ** << >> & | ^ ~ -x`` and single
comparisons): where, maximum, minimum, abs, sqrt, f32, i32, u32,
cast(x, dtype_name), lane(x), row(x), arange(n) (int32), onehot(x, n),
fullk(ref, n, v), rowsum, sum_lanes, popcount, isin(x, tuple),
dot_lanes(a, b, mode).
"""
from __future__ import annotations

import ast
import functools
import operator
from typing import Any, Callable, Dict

import numpy as np
import torch


class SpecSyntaxError(ValueError):
    """A spec expression used a construct outside the language."""


_TORCH_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "int32": torch.int32, "uint32": torch.uint32,
    "bool": torch.bool,
}


def _is_scalar(x) -> bool:
    return isinstance(x, (bool, int, float, np.bool_, np.number))


def _torch_dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    name = dt if isinstance(dt, str) else np.dtype(dt).name
    if name not in _TORCH_DTYPES:
        raise SpecSyntaxError(f"dtype {name!r} is not in the language")
    return _TORCH_DTYPES[name]


def _device_of(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def _scalar_tensor(x, dev) -> torch.Tensor:
    """A 0-d tensor of ``x`` on ``dev``: numpy scalars keep their dtype.
    ``torch.full`` fills on the device, so no blocking host-to-device
    copy (and no stream synchronization) happens per evaluation."""
    if isinstance(x, np.generic):
        return torch.full((), x.item(), dtype=_torch_dtype(x.dtype), device=dev)
    return torch.full((), x, device=dev)


def _lift(args):
    """numpy scalars -> 0-d tensors of their dtype, when a tensor is
    among ``args`` (Python scalars are left to torch's own promotion)."""
    dev = _device_of(args)
    if dev is None:
        return args
    return [_scalar_tensor(a, dev) if isinstance(a, np.generic) else a
            for a in args]


_U32_MASK = 0xFFFFFFFF


def _u32_call(fn, args):
    """``fn(*args)`` with uint32 tensors widened to int64; when every
    tensor operand was uint32, an int64 result narrows back to uint32
    (modulo 2^32, as uint32 arithmetic wraps).  Other calls pass
    through."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors or not any(t.dtype == torch.uint32 for t in tensors):
        return fn(*args)
    wide = [a.to(torch.int64) if isinstance(a, torch.Tensor)
            and a.dtype == torch.uint32 else a for a in args]
    out = fn(*wide)
    if all(t.dtype == torch.uint32 for t in tensors) and out.dtype == torch.int64:
        return (out & _U32_MASK).to(torch.uint32)
    return out


def _tensor_op(fn):
    """Wrap a binary/ternary op so numpy scalars meet tensors as 0-d
    tensors; scalar-only calls stay numpy; uint32 operands widen."""
    def call(*args):
        return _u32_call(fn, _lift(args))
    return call


def _cast(x, dt):
    """Dtype cast: scalars through the numpy scalar type, tensors through
    ``.to`` (a same-dtype cast is a no-op)."""
    if _is_scalar(x):
        if _torch_dtype(dt) == torch.bfloat16:  # numpy has no bfloat16
            return torch.tensor(x, dtype=torch.bfloat16)
        return np.dtype(dt).type(x)
    return x.to(_torch_dtype(dt))


def _sqrt(x):
    # scalar constants stay float64 Python-side
    if _is_scalar(x):
        return float(np.sqrt(x))
    return torch.sqrt(x)


def _as_tensor(x, like):
    return x if isinstance(x, torch.Tensor) else _scalar_tensor(x, _device_of(like))


def _where(c, a, b):
    a, b = _lift([c, a, b])[1:]
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        # both branches scalar: keep their numpy dtype (i32 stays int32)
        a, b = _as_tensor(a, [c]), _as_tensor(b, [c])
    return _u32_call(lambda x, y: torch.where(c, x, y), [a, b])


def _maximum(a, b):
    a, b = _lift([a, b])
    return _u32_call(torch.maximum, [_as_tensor(a, [b]), _as_tensor(b, [a])])


def _minimum(a, b):
    a, b = _lift([a, b])
    return _u32_call(torch.minimum, [_as_tensor(a, [b]), _as_tensor(b, [a])])


def _isin(x, vals):
    if not isinstance(vals, (tuple, list)):
        raise SpecSyntaxError(
            f"isin() needs a tuple parameter, got {type(vals).__name__}")
    out = x == vals[0]
    for v in vals[1:]:
        out = out | (x == v)
    return out


def _popcount(x):
    """Set bits of each 32-bit word (int32 or uint32), in ``x.dtype``.
    Five SWAR steps on the int32 bit pattern; an int32 right shift
    sign-extends, so every shifted term is masked before it is used."""
    if x.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"popcount counts 32-bit words, got {x.dtype}")
    v = x.view(torch.int32)
    y = v - ((v >> 1) & 0x55555555)
    t = (y >> 2) & 0x33333333
    y &= 0x33333333
    y += t
    del t
    y += y >> 4
    y &= 0x0F0F0F0F
    y *= 0x01010101
    y >>= 24
    y &= 0x3F
    return y if x.dtype == torch.int32 else y.to(torch.uint32)


def dot_lanes(a, b, mode):
    """The per-edge K-dim dot product (collaborative filtering's error-dot,
    models/colfilter.err_dot): "vpu" sums the elementwise product over the
    last axis, "mxu" contracts it as a (rows, K) @ (K, 1) matmul, which on
    the card is full f32 (``torch.backends.cuda.matmul.allow_tf32`` stays
    False, PyTorch's default)."""
    prod = a * b
    if mode == "mxu":
        ones = torch.ones((prod.shape[-1], 1), dtype=torch.float32, device=prod.device)
        return torch.matmul(prod, ones)[..., 0]
    if mode != "vpu":
        raise ValueError(f"dot_lanes mode must be 'vpu' or 'mxu', got {mode!r}")
    return prod.sum(-1)


def _fullk(ref, n, v):
    return torch.full((ref.shape[0], int(n)), float(v), dtype=torch.float32,
                      device=ref.device)


def _onehot(x, n):
    iota = torch.arange(n, dtype=torch.int32, device=x.device)
    return (iota[None, :] == x[..., None]).to(torch.float32)


def _builtins(device=None) -> Dict[str, Callable]:
    """The call vocabulary, as a fresh dict so callers cannot mutate it.
    ``device`` is where ``arange`` puts its tensor (the env's device)."""
    return {
        "where": _where,
        "maximum": _maximum,
        "minimum": _minimum,
        "abs": torch.abs,
        "sqrt": _sqrt,
        "f32": functools.partial(_cast, dt="float32"),
        "i32": functools.partial(_cast, dt="int32"),
        "u32": functools.partial(_cast, dt="uint32"),
        "cast": _cast,
        "lane": lambda x: x[..., None],
        "row": lambda x: x[None, :],
        "arange": lambda n: torch.arange(n, dtype=torch.int32, device=device),
        "onehot": _onehot,
        "fullk": _fullk,
        "rowsum": lambda x: x.sum(-1, keepdim=True),
        "sum_lanes": lambda x: x.sum(-1),
        "popcount": _popcount,
        "isin": _isin,
        "dot_lanes": dot_lanes,
    }


def _lnot(x):
    if _is_scalar(x):
        return np.logical_not(x)
    return _u32_call(operator.invert, [x])


_BINOPS = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod,
    ast.Pow: operator.pow,
    ast.LShift: operator.lshift,
    ast.RShift: operator.rshift,
    ast.BitAnd: operator.and_,
    ast.BitOr: operator.or_,
    ast.BitXor: operator.xor,
}

_CMPOPS = {
    ast.Eq: operator.eq,
    ast.NotEq: operator.ne,
    ast.Lt: operator.lt,
    ast.LtE: operator.le,
    ast.Gt: operator.gt,
    ast.GtE: operator.ge,
}

_UNOPS = {
    ast.USub: operator.neg,
    ast.Invert: _lnot,
}


def _err(src: str, node: ast.AST, msg: str) -> SpecSyntaxError:
    line = src.splitlines()[node.lineno - 1] if hasattr(node, "lineno") else src
    return SpecSyntaxError(f"{msg} (in spec expression: {line.strip()!r})")


def _compile_expr(node: ast.expr, src: str) -> Callable[[dict], Any]:
    """Recursively lower one expression node to an env -> value closure."""
    if isinstance(node, ast.Constant):
        if isinstance(node.value, (bool, int, float, str)):
            v = node.value
            return lambda env: v
        raise _err(src, node, f"constant {node.value!r} is not allowed")
    if isinstance(node, ast.Name):
        name = node.id
        marker = object()

        def load(env, name=name, marker=marker):
            v = env.get(name, marker)
            if v is marker:
                raise SpecSyntaxError(
                    f"unknown name {name!r}; available here: "
                    + ", ".join(sorted(k for k in env if not k.startswith("_"))))
            return v

        return load
    if isinstance(node, ast.BinOp):
        op = _BINOPS.get(type(node.op))
        if op is None:
            raise _err(src, node, f"operator {type(node.op).__name__} "
                                  "is not in the language")
        op = _tensor_op(op)
        lf = _compile_expr(node.left, src)
        rf = _compile_expr(node.right, src)
        return lambda env: op(lf(env), rf(env))
    if isinstance(node, ast.UnaryOp):
        op = _UNOPS.get(type(node.op))
        if op is None:
            raise _err(src, node, f"unary {type(node.op).__name__} "
                                  "is not in the language")
        vf = _compile_expr(node.operand, src)
        return lambda env: op(vf(env))
    if isinstance(node, ast.Compare):
        if len(node.ops) != 1:
            raise _err(src, node, "chained comparisons are not allowed")
        op = _CMPOPS.get(type(node.ops[0]))
        if op is None:
            raise _err(src, node, f"comparison {type(node.ops[0]).__name__} "
                                  "is not in the language")
        op = _tensor_op(op)
        lf = _compile_expr(node.left, src)
        rf = _compile_expr(node.comparators[0], src)
        return lambda env: op(lf(env), rf(env))
    if isinstance(node, ast.Call):
        if node.keywords:
            raise _err(src, node, "keyword arguments are not allowed")
        if not isinstance(node.func, ast.Name):
            raise _err(src, node, "only builtin-name calls are allowed")
        fname = node.func.id
        argfs = [_compile_expr(a, src) for a in node.args]

        def call(env, fname=fname, argfs=argfs):
            fn = env["_builtins"].get(fname)
            if fn is None:
                raise SpecSyntaxError(
                    f"unknown function {fname!r}; builtins: "
                    + ", ".join(sorted(env["_builtins"])))
            return fn(*[f(env) for f in argfs])

        return call
    if isinstance(node, ast.Tuple):
        elfs = [_compile_expr(e, src) for e in node.elts]
        return lambda env: tuple(f(env) for f in elfs)
    raise _err(src, node, f"{type(node).__name__} is not in the language")


@functools.lru_cache(maxsize=1024)
def compile_source(src: str):
    """Compile a spec field to ``run(env) -> value``.  ``src`` is a
    sequence of single-name assignments ending in one expression.  Raises
    :class:`SpecSyntaxError` for anything outside the language, at
    spec-definition time."""
    try:
        tree = ast.parse(src, mode="exec")
    except SyntaxError as e:
        raise SpecSyntaxError(f"spec expression does not parse: {e}") from None
    if not tree.body:
        raise SpecSyntaxError("empty spec expression")
    steps = []
    for stmt in tree.body[:-1]:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1 \
                or not isinstance(stmt.targets[0], ast.Name):
            raise _err(src, stmt,
                       "only 'name = expression' bindings may precede the "
                       "final expression")
        steps.append((stmt.targets[0].id, _compile_expr(stmt.value, src)))
    last = tree.body[-1]
    if not isinstance(last, ast.Expr):
        raise _err(src, last, "a spec must END in a bare expression "
                              "(its value is the result)")
    final = _compile_expr(last.value, src)

    def run(env: dict):
        scope = dict(env)
        scope["_builtins"] = _builtins(_device_of(env.values()))
        for name, fn in steps:
            scope[name] = fn(scope)
        return final(scope)

    return run


def run(src: str, env: dict):
    """Evaluate a spec field against ``env`` (parameters + tensors)."""
    return compile_source(src)(env)


def check(src: str) -> None:
    """Parse-validate a spec field (definition-time gate)."""
    compile_source(src)
