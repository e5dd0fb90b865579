"""Device replay of a routed permutation (ops/route.py) with hand-written
gather kernels.

Counterpart of ``lux_tpu.ops.pallas_shuffle``.  Each Benes pass gathers
along one digit; the four kernels of the replay, each a CUDA C++ kernel
for sm_90a under ``csrc/`` with its plain PyTorch version beside it:

  * :func:`lane_gather` — a LANE pass: gather along a 128 digit, batched
    over rows: ``out[r, c] = x[r, idx[r, c]]`` on (R, 128);
  * :func:`sublane_gather` — a SUBLANE pass: gather along a digit d <= 8,
    batched over columns: ``out[s, l] = x[idx[s, l], l]`` on (d, L);
  * :func:`fused_pass_gather` — 2-3 consecutive passes chained on one
    tile held in shared memory (the pass-fused replay, ``routed-pf``);
  * :func:`mxreduce_pass_gather` — the route's final pass group chained
    with the segmented reduction by destination rank (``fused-mx``).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  Each wrapper counts its launches in
``<wrapper>.launches``.

The digit being gathered must sit in the right position of the physical
layout, so the host-side planner (``plan_route``, numpy, a copy of the
reference's) threads ONE transpose per pass: it tracks the running digit
order, transposes the DATA directly from the previous pass's layout into
this pass's, and pre-arranges every index array into its kernel layout
at build time (indices are digit-local values — relayouts move their
positions, never their values).  The transposes are torch copies
(``reshape``/``permute``) outside the kernels, as the reference leaves
them to XLA.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import threading

import numpy as np
import torch

from lux_tpu_torch.ops import cuda_build
from lux_tpu_torch.ops import route as route_mod
from lux_tpu_torch.ops.spmv import reduce_neutral
from lux_tpu_torch.utils.config import env_int

LANE = 128

#: most gather steps one fused or mx kernel chains, and most axes of one
#: in-tile relayout (csrc/lux_shuffle.cuh kMaxSteps / kMaxDims)
MAX_STEPS = 4
MAX_DIMS = 8
#: the mx kernel's chunk, the unit of its grid: whole tiles one CTA of
#: 512 threads reduces, 16 elements a thread; so also the largest mx
#: reduce tile (csrc/mxreduce_pass_gather.cu)
MX_MAX_TILE_ELEMS = 8192
#: bytes of the mx kernel's summary of one chunk (two int32 keys, an int32
#: run count, two 4-byte partial values)
MX_PART_BYTES = 20

_GATHER_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
_INDEX_DTYPES = (torch.uint8, torch.int32)
_MX_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_MX_OPS = {"sum": 0, "min": 1, "max": 2}


# ---------------------------------------------------------------------------
# shared wrapper plumbing
# ---------------------------------------------------------------------------

_bound: dict[str, ctypes.CDLL] = {}
#: guards _bound and _DESC_CACHE: planner threads and the caller may reach them at once
_LOCK = threading.Lock()

_VP, _CI, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "lane_gather": ("lux_lane_gather", [_VP, _CI, _VP, _CI, _CLL, _VP, _VP]),
    "sublane_gather": ("lux_sublane_gather",
                       [_VP, _CI, _VP, _CI, _CI, _CLL, _VP, _VP]),
    "fused_pass_gather": ("lux_fused_pass_gather",
                          [_VP, _CI, _VP, _CI, _VP, _CLL, _CI, _VP, _VP]),
    "mxreduce_pass_gather": ("lux_mxreduce_pass_gather",
                             [_VP, _CI, _VP, _CI, _VP, _VP, _CI, _VP, _CLL,
                              _CI, _CI, _CI, _CI, _VP, _VP, _CLL, _VP]),
}


def _fn(name: str):
    """The bound C entry point of kernel ``name`` (built on first use)."""
    with _LOCK:
        lib = _bound.get(name)
        if lib is None:
            lib = cuda_build.load(name)
            sym, argtypes = _ARGTYPES[name]
            getattr(lib, sym).argtypes = argtypes
            getattr(lib, sym).restype = ctypes.c_int
            _bound[name] = lib
    return getattr(lib, _ARGTYPES[name][0])


def _same_device(name: str, *tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name} inputs span devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    return dev


def _launch(name: str, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        rc = _fn(name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _check_aligned(name: str, *tensors) -> None:
    """The chained kernels move 16 bytes a load and a store: every array
    must start on a 16-byte boundary (a fresh tensor does; a view at an
    offset may not)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned arrays; one starts "
                             f"at byte {t.data_ptr() % 16} of 16")


def _check_gather(name: str, x: torch.Tensor, idx: torch.Tensor):
    if x.dtype not in _GATHER_DTYPES:
        raise TypeError(f"{name} moves float32, bfloat16 or int32 values, "
                        f"got {x.dtype}")
    if idx.dtype not in _INDEX_DTYPES:
        raise TypeError(f"{name} takes uint8 or int32 indices, got {idx.dtype}")
    if idx.shape != x.shape:
        raise ValueError(f"{name}: idx shape {tuple(idx.shape)} != x shape "
                         f"{tuple(x.shape)}")
    dev = _same_device(name, x, idx)
    if dev.type == "cuda" and not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name} needs contiguous inputs")
    return dev


# ---------------------------------------------------------------------------
# the single-pass kernels
# ---------------------------------------------------------------------------


def lane_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`lane_gather`."""
    return torch.gather(x, 1, idx.long())


def lane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(R, 128) per-row lane shuffle: ``out[r, c] = x[r, idx[r, c]]``.
    ``idx`` is uint8 or int32 with values in [0, 128) — promised, not
    checked on the card (the planners assert it, ops/expand._narrow_idx).
    Any R >= 1.  CPU tensors run the plain version; CUDA tensors launch
    ``csrc/lane_gather.cu``."""
    if x.dim() != 2 or x.shape[1] != LANE:
        raise ValueError(f"lane_gather takes (R, {LANE}), got {tuple(x.shape)}")
    dev = _check_gather("lane_gather", x, idx)
    if dev.type == "cpu":
        return lane_gather_plain(x, idx)
    out = torch.empty_like(x)
    if x.shape[0]:
        _launch("lane_gather", dev, x.data_ptr(), x.element_size(),
                idx.data_ptr(), idx.element_size(), x.shape[0], out.data_ptr())
        lane_gather.launches += 1
    return out


lane_gather.launches = 0


def sublane_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`sublane_gather`."""
    return torch.gather(x, 0, idx.long())


def sublane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(d, L) per-column sublane shuffle, d <= 8:
    ``out[s, l] = x[idx[s, l], l]``; index values in [0, d), promised.
    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/sublane_gather.cu``."""
    if x.dim() != 2 or not 1 <= x.shape[0] <= 8:
        raise ValueError(f"sublane_gather takes (d <= 8, L), got {tuple(x.shape)}")
    dev = _check_gather("sublane_gather", x, idx)
    if dev.type == "cpu":
        return sublane_gather_plain(x, idx)
    out = torch.empty_like(x)
    if x.shape[1]:
        _launch("sublane_gather", dev, x.data_ptr(), x.element_size(),
                idx.data_ptr(), idx.element_size(), x.shape[0], x.shape[1],
                out.data_ptr())
        sublane_gather.launches += 1
    return out


sublane_gather.launches = 0


# ---------------------------------------------------------------------------
# host planning (numpy; the reference's planners)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DevicePass:
    """One planned pass: transpose the flat data from the previous
    layout via ``perm_axes`` (on the mixed-radix ``view`` of the
    PREVIOUS layout), then run ``kind`` with the pre-arranged ``idx``."""

    kind: str  # "lane" | "sublane"
    view: tuple[int, ...]  # reshape of the incoming flat array
    perm_axes: tuple[int, ...]  # np.transpose axes, () if identity
    kshape: tuple[int, ...]  # 2-D kernel operand shape
    idx: np.ndarray  # int32, kshape


@dataclasses.dataclass
class RoutePlan:
    n: int
    dims: tuple[int, ...]
    passes: list[DevicePass]
    final_view: tuple[int, ...]
    final_perm: tuple[int, ...]  # restore row-major digit order at the end


def plan_route(route: route_mod.Route) -> RoutePlan:
    """Compile a host Route into transposed-once-per-pass device form."""
    dims = route.dims
    k = len(dims)
    order = list(range(k))  # current digit order, outer->inner
    passes: list[DevicePass] = []
    for p in route.passes:
        g = p.axis
        d = dims[g]
        if d == LANE or (route.n >= LANE and d <= LANE and LANE % d == 0):
            # a small digit (d < 128, d | 128) ALSO rides the lane
            # kernel: with the digit innermost, each 128-lane row holds
            # 128/d whole digit-blocks, and the gather stays block-local
            # via the static fixup lane = (lane//d)*d + idx.  This
            # avoids the sublane kernel's narrow-minor-dim layouts
            # ((2, n/2) measured ~10x slower than lane passes on v5e).
            # Digits that do NOT divide 128 (caller-supplied dims —
            # build_route accepts any factorization) would make the
            # fixup gather across block boundaries under
            # promise_in_bounds: they fall through to the sublane
            # kernel, whose own d <= 8 assert fails loudly instead.
            assert d <= LANE and LANE % d == 0, d
            new_order = [a for a in order if a != g] + [g]
            kshape = (route.n // LANE, LANE)
            kind = "lane"
        else:
            new_order = [g] + [a for a in order if a != g]
            kshape = (d, route.n // d)
            kind = "sublane"
        view = tuple(dims[a] for a in order)
        perm_axes = tuple(order.index(a) for a in new_order)
        if perm_axes == tuple(range(k)):
            perm_axes = ()
        # index array: canonical row-major -> this pass's layout
        idx = np.ascontiguousarray(
            np.transpose(p.idx, new_order).reshape(kshape), np.int32
        )
        if kind == "lane" and d < LANE:
            idx = ((np.arange(LANE, dtype=np.int32)[None, :] // d) * d
                   + idx)
        passes.append(DevicePass(kind=kind, view=view,
                                 perm_axes=perm_axes, kshape=kshape,
                                 idx=idx))
        order = new_order
    final_view = tuple(dims[a] for a in order)
    final_perm = tuple(order.index(a) for a in range(k))
    if final_perm == tuple(range(k)):
        final_perm = ()
    return RoutePlan(n=route.n, dims=dims, passes=passes,
                     final_view=final_view, final_perm=final_perm)


@dataclasses.dataclass(frozen=True)
class StaticPass:
    """Hashable half of a DevicePass (everything but the index data)."""

    kind: str
    view: tuple[int, ...]
    perm_axes: tuple[int, ...]
    kshape: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class StaticRoute:
    """Hashable route descriptor: the static half of a frozen plan (the
    per-pass index arrays travel beside it as tensors; engine
    integration: ops/expand.py)."""

    n: int
    dims: tuple[int, ...]
    passes: tuple[StaticPass, ...]
    final_view: tuple[int, ...]
    final_perm: tuple[int, ...]


def freeze_plan(plan: RoutePlan):
    """Split a RoutePlan into (StaticRoute, tuple-of-index-arrays)."""
    static = StaticRoute(
        n=plan.n,
        dims=tuple(plan.dims),
        passes=tuple(
            StaticPass(kind=p.kind, view=tuple(p.view),
                       perm_axes=tuple(p.perm_axes),
                       kshape=tuple(p.kshape))
            for p in plan.passes
        ),
        final_view=tuple(plan.final_view),
        final_perm=tuple(plan.final_perm),
    )
    return static, tuple(p.idx for p in plan.passes)


@dataclasses.dataclass(frozen=True)
class StaticStep:
    """One in-kernel gather step of a fused pass group: an optional
    cross-row in-tile relayout (static reshape/transpose/reshape of the
    tile held in shared memory) followed by a 128-lane row gather whose
    index tile holds full in-row lanes."""

    relayout: tuple | None  # ((view...), (perm...)) over the tile, or None


@dataclasses.dataclass(frozen=True)
class StaticGroup:
    """Static half of one fused pass group (hashable)."""

    view: tuple[int, ...]       # reshape of the incoming flat array
    perm_axes: tuple[int, ...]  # entry transpose (torch), () if identity
    kshape: tuple[int, ...]     # 2-D kernel operand shape (R, 128)
    block_rows: int             # tile rows (multiple of the block's)
    steps: tuple[StaticStep, ...]


@dataclasses.dataclass(frozen=True)
class StaticRoutePF:
    """Hashable pass-fused route descriptor — drop-in for StaticRoute
    wherever a frozen route is replayed (apply_route_frozen dispatches
    on the type); index arrays travel beside it exactly like the
    unfused plan's."""

    n: int
    dims: tuple[int, ...]
    groups: tuple[StaticGroup, ...]
    final_view: tuple[int, ...]
    final_perm: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class StaticMXGroup:
    """Static half of an MXREDUCE final group (hashable): the route's
    last 1-3 Benes passes chained in ONE kernel with the segmented
    reduction — the kernel gathers like a fused pass group, then
    reduces each tile by its plan-time rank map into the
    (num_blocks * v_blk,) totals.  The full group-space array is READ
    once and never written back: the separate masked group-reduce sweep
    of the plain fused replay is gone.

    Precision contract: float sums accumulate in f32 and come out f32;
    min/max and integer ops preserve their dtype bitwise.  (The name
    is the reference's: on the TPU the float sum is an MXU one-hot
    contraction.)"""

    view: tuple[int, ...]       # reshape of the incoming flat array
    perm_axes: tuple[int, ...]  # entry transpose (torch), () if identity
    kshape: tuple[int, ...]     # 2-D kernel operand shape (R, 128)
    block_rows: int             # reduce-tile rows (covers whole blocks)
    steps: tuple[StaticStep, ...]
    v_blk: int                  # totals ranks per output block
    num_blocks: int             # output blocks (>= 1)
    op: str                     # "sum" | "min" | "max"


def route_num_arrays(static) -> int:
    """Index-array count of a frozen route (unfused: one per pass;
    pass-fused: one per in-group gather step) — the ONE place array
    layout arithmetic for both forms lives."""
    if isinstance(static, StaticRoutePF):
        return sum(len(g.steps) for g in static.groups)
    return len(static.passes)


def route_num_hbm_passes(static) -> int:
    """Full-array device-memory read+write sweeps of a frozen route's
    replay: kernels launched (unfused: per pass; fused: per group).
    Entry transposes between groups/passes are additional torch copies
    in both forms and are excluded here."""
    if isinstance(static, StaticRoutePF):
        return len(static.groups)
    return len(static.passes)


#: shared memory one CTA of sm_90 may use (the H100's 227 KB), the
#: default tile budget of the fused kernels
SMEM_BYTES = 232448


def _pf_defaults(max_block=None, max_group=None, smem_bytes=None):
    """Pass-fusion knobs with env defaults: LUX_PF_MAX_BLOCK (elements a
    group's digit block may span; 2^14 by default, so two f32 tile
    buffers of one block take 128 KB), LUX_PF_MAX_GROUP (passes per
    kernel), LUX_PF_SMEM_BYTES (the fused kernel's shared-memory budget
    per CTA, at most the card's 232,448 B).  The knobs shape the PLAN;
    they are baked into the frozen static, never read at replay time.
    (The reference sizes the same plans for 8 MB of TPU VMEM with
    LUX_PF_VMEM_MB and a 2^17 block.)"""
    if max_block is None:
        max_block = env_int("LUX_PF_MAX_BLOCK", 1 << 14, minimum=LANE)
    if max_group is None:
        max_group = env_int("LUX_PF_MAX_GROUP", 3, minimum=1)
    if smem_bytes is None:
        smem_bytes = env_int("LUX_PF_SMEM_BYTES", SMEM_BYTES,
                             minimum=2 * 4 * LANE, maximum=SMEM_BYTES)
    return max_block, max_group, smem_bytes


def _pf_block_rows(R: int, rpb: int, smem_bytes: int) -> int:
    """Tile rows for one fused kernel: the largest power of two whose
    two ping-pong buffers (4-byte elements, the widest the kernel
    moves; index tiles stream from device memory) fit the shared-memory
    budget, clamped to the whole array.  A tile can never shrink below
    ONE block unit (rpb rows) — if that already blows the budget the
    knobs are inconsistent (LUX_PF_MAX_BLOCK too big for
    LUX_PF_SMEM_BYTES), and the right failure is HERE at plan time, not
    a refused launch on the card."""
    per_elem = 2 * 4
    rows = max(smem_bytes // (LANE * per_elem), 1)
    if rpb > rows:
        raise ValueError(
            f"pass-fusion block of {rpb * LANE} elements needs "
            f"{rpb * LANE * per_elem} B of shared memory, over the "
            f"{smem_bytes} B budget — lower LUX_PF_MAX_BLOCK or raise "
            "LUX_PF_SMEM_BYTES")
    tb = 1
    while tb * 2 <= rows:
        tb *= 2
    return max(rpb, min(tb, R))


def _block_relayout(dims, gorder, new_gorder):
    """Positional source map of an in-tile digit relayout: for each
    position p in the NEW block layout, src[p] is the position of that
    element in the OLD layout.  Returns (src (B,), row_local) — the
    relayout is identical for every block, so one B-element map covers
    the whole array."""
    shape = tuple(dims[a] for a in gorder)
    b = 1
    for s in shape:
        b *= s
    ids = np.arange(b, dtype=np.int64).reshape(shape)
    perm = tuple(gorder.index(a) for a in new_gorder)
    src = np.ascontiguousarray(np.transpose(ids, perm)).ravel()
    if b <= LANE:
        return src, True  # sub-row blocks can never cross rows
    row_local = bool((src // LANE == np.arange(b, dtype=np.int64)
                      // LANE).all())
    return src, row_local


def _compose_rowlocal(row_idx: np.ndarray, src: np.ndarray,
                      b: int) -> np.ndarray:
    """Fold a row-local relayout into the next pass's in-row gather:
    combined[r, c] = old-layout lane of the element the gather wants at
    (r, c).  ``src`` is the block map from _block_relayout; ``b`` the
    block size."""
    t = row_idx
    if b >= LANE:
        rpb = b // LANE
        rows = (np.arange(t.shape[0], dtype=np.int64)[:, None] % rpb) * LANE
        return src[rows + t] % LANE
    return (t // b) * b + src[t % b]


def _pf_plan(n: int, dims, canon, group_sizes, smem_bytes: int,
             mx=None):
    """Lower canonical Benes pass indices into the pass-fused frozen
    form.  ``canon``: per-pass full-size index arrays in canonical
    mixed-radix shape (Route.passes[j].idx), values in [0, dims[axis]).
    Returns (StaticRoutePF, tuple of (R, 128) int32 index arrays, one
    per gather step).

    ``mx`` (a dict with keys v_blk/num_blocks/op/tile_rows) turns the
    LAST group into an MXREDUCE group: its passes chain in the same
    kernel as the segmented one-hot reduction (mxreduce_pass_gather),
    the final canonical-order restore transpose is SKIPPED (the
    reduction consumes the final PHYSICAL layout directly — callers
    pre-compose their target permutation with ``mx_physical_order`` so
    that layout IS the desired one), and the return grows to
    (StaticRoutePF[prefix groups, identity final], prefix arrays,
    StaticMXGroup, mx step arrays)."""
    k = len(dims)
    for d in dims:
        if d > LANE or LANE % d:
            raise ValueError(
                "pass fusion requires lane-eligible digits (d <= 128, "
                f"d | 128); got dims={tuple(dims)}")
    if n < LANE:
        raise ValueError(f"pass fusion requires n >= {LANE}, got {n}")
    axes = route_mod.benes_axes(k)
    assert len(canon) == len(axes), (len(canon), len(axes))
    assert sum(group_sizes) == len(axes), (group_sizes, axes)
    R = n // LANE
    order = list(range(k))
    groups: list[StaticGroup] = []
    arrays: list[np.ndarray] = []
    mx_group = None
    mx_arrays: list[np.ndarray] = []
    j = 0
    for gi, glen in enumerate(group_sizes):
        is_mx = mx is not None and gi == len(group_sizes) - 1
        gaxes = list(axes[j:j + glen])
        gcanon = canon[j:j + glen]
        sset: list[int] = []
        for a in gaxes:
            if a not in sset:
                sset.append(a)
        B = 1
        for a in sset:
            B *= dims[a]
        rpb = max(B // LANE, 1)
        if is_mx:
            # the reduce tile: small (the rank-block alignment padding
            # of the mx layout is a multiple of its span), covering
            # whole suffix blocks so the chained gathers stay tile-local
            tb = max(rpb, min(int(mx["tile_rows"]), R))
            assert tb % rpb == 0 and R % tb == 0, (tb, rpb, R)
        else:
            tb = _pf_block_rows(R, rpb, smem_bytes)
        rest = [a for a in order if a not in sset]
        # entry layout: rest axes (current relative order) outermost,
        # group axes innermost with the first gathered axis in lane
        # position — all in-group movement is then block-local
        gorder = [a for a in order if a in sset and a != gaxes[0]]
        gorder.append(gaxes[0])
        new_order = rest + gorder
        view = tuple(dims[a] for a in order)
        perm_axes = tuple(order.index(a) for a in new_order)
        if perm_axes == tuple(range(k)):
            perm_axes = ()
        steps: list[StaticStep] = []
        g_arrays: list[np.ndarray] = []
        for step_i, (g, idx_canon) in enumerate(zip(gaxes, gcanon)):
            d = dims[g]
            relayout = None
            src = None
            if step_i and gorder[-1] != g:
                new_gorder = [a for a in gorder if a != g] + [g]
                src, row_local = _block_relayout(dims, gorder, new_gorder)
                if not row_local:
                    ub = tb * LANE // B
                    rview = (ub,) + tuple(dims[a] for a in gorder)
                    rperm = (0,) + tuple(gorder.index(a) + 1
                                         for a in new_gorder)
                    relayout = (rview, rperm)
                    src = None
                gorder = new_gorder
            full_order = rest + gorder
            idx_full = np.ascontiguousarray(
                np.transpose(np.asarray(idx_canon, np.int64), full_order)
            ).reshape(R, LANE)
            base = (np.arange(LANE, dtype=np.int64)[None, :] // d) * d
            row_idx = base + idx_full
            if src is not None:
                row_idx = _compose_rowlocal(row_idx, src, B)
            assert row_idx.min() >= 0 and row_idx.max() < LANE, (
                row_idx.min(), row_idx.max())
            steps.append(StaticStep(relayout=relayout))
            g_arrays.append(np.ascontiguousarray(row_idx, np.int32))
        if is_mx:
            mx_group = StaticMXGroup(
                view=view, perm_axes=perm_axes, kshape=(R, LANE),
                block_rows=tb, steps=tuple(steps),
                v_blk=int(mx["v_blk"]), num_blocks=int(mx["num_blocks"]),
                op=str(mx["op"]))
            mx_arrays = g_arrays
        else:
            groups.append(StaticGroup(view=view, perm_axes=perm_axes,
                                      kshape=(R, LANE), block_rows=tb,
                                      steps=tuple(steps)))
            arrays.extend(g_arrays)
        order = rest + gorder
        j += glen
    if mx is not None:
        # the reduction consumes the final physical layout in place —
        # no restore transpose; the layout the caller's rank map was
        # built against must be exactly the one the threading produced
        assert order == _pf_final_order(dims, group_sizes), (
            order, group_sizes)
        return (StaticRoutePF(n=n, dims=tuple(dims),
                              groups=tuple(groups),
                              final_view=(n,), final_perm=()),
                tuple(arrays), mx_group, tuple(mx_arrays))
    final_view = tuple(dims[a] for a in order)
    final_perm = tuple(order.index(a) for a in range(k))
    if final_perm == tuple(range(k)):
        final_perm = ()
    return (StaticRoutePF(n=n, dims=tuple(dims), groups=tuple(groups),
                          final_view=final_view, final_perm=final_perm),
            tuple(arrays))


def plan_route_pf(route: route_mod.Route, group_sizes=None, max_block=None,
                  max_group=None, smem_bytes=None):
    """Compile a host Route into the pass-fused frozen form directly.
    ``group_sizes`` overrides the planner (tests force specific group
    widths through it)."""
    max_block, max_group, smem_bytes = _pf_defaults(max_block, max_group,
                                                    smem_bytes)
    if group_sizes is None:
        group_sizes = route_mod.plan_fusion_groups(route.dims, max_block,
                                                   max_group)
    canon = [np.asarray(p.idx) for p in route.passes]
    return _pf_plan(route.n, route.dims, canon, group_sizes, smem_bytes)


def _frozen_canonical(static: StaticRoute, arrays):
    """Reconstruct the canonical per-pass index arrays from a frozen
    unfused plan by inverting plan_route's per-pass arrangement (the
    layout threading is deterministic, so the inversion is exact).  The
    passes must be a full Benes sequence of lane passes — the only form
    the expand planners produce for n >= 128."""
    dims = static.dims
    k = len(dims)
    if len(static.passes) != 2 * k - 1:
        raise ValueError(
            f"pass fusion expects a full Benes pass list (2k-1), got "
            f"{len(static.passes)} passes for {k} digits")
    axes = route_mod.benes_axes(k)
    order = list(range(k))
    canon = []
    for p, arr, g in zip(static.passes, arrays, axes):
        if p.kind != "lane":
            raise ValueError("pass fusion covers lane-kernel routes only")
        d = dims[g]
        new_order = [a for a in order if a != g] + [g]
        idx = np.asarray(arr, np.int64).reshape(p.kshape)
        if d < LANE:
            idx = idx - (np.arange(LANE, dtype=np.int64)[None, :] // d) * d
        shaped = idx.reshape(tuple(dims[a] for a in new_order))
        inv = tuple(np.argsort(np.asarray(new_order)))
        canon.append(np.ascontiguousarray(
            np.transpose(shaped, inv)).astype(np.int32))
        order = new_order
    return canon


def pf_from_frozen(static: StaticRoute, arrays, group_sizes=None,
                   max_block=None, max_group=None, smem_bytes=None):
    """Transform a frozen UNFUSED route plan into the pass-fused form —
    pure NumPy rearrangement, no Euler recoloring, so a cached unfused
    plan upgrades in seconds instead of minutes.  Replay is bitwise
    identical to the unfused replay of the same plan (the fused kernels
    move the same bits through the same per-pass permutations)."""
    max_block, max_group, smem_bytes = _pf_defaults(max_block, max_group,
                                                    smem_bytes)
    if group_sizes is None:
        group_sizes = route_mod.plan_fusion_groups(static.dims, max_block,
                                                   max_group)
    canon = _frozen_canonical(static, arrays)
    return _pf_plan(static.n, static.dims, canon, group_sizes, smem_bytes)


# ---------------------------------------------------------------------------
# mxreduce: the segmented reduction fused into the final pass group
# ---------------------------------------------------------------------------
#
# The plain fused replay (apply_fused) ends with: the last r2 kernel
# writes the full group-space array back to device memory, then a
# separate masked group-reduce sweep READS it all again.  mxreduce
# deletes both: the final group's kernel keeps each tile on chip after
# its chained gathers and reduces it by destination RANK, writing only
# the small totals vector.  The host-side planner (ops/expand) lays the
# group space out so that (a) ranks are monotone along the final
# PHYSICAL layout (the route's target permutation is pre-composed with
# mx_physical_order, so no restore transpose is ever needed) and (b)
# every reduce tile maps into exactly ONE v_blk-rank output block
# (rank-block starts are tile-span aligned), so the tiles of one output
# block are contiguous and one CTA can own the block.


def _mx_defaults(mx_max_block=None, tile_rows=None, v_blk=None):
    """mxreduce knobs with env defaults: LUX_MX_MAX_BLOCK (largest
    suffix-group digit block the reduce kernel may chain — also bounds
    the rank-block alignment padding), LUX_MX_TILE_ROWS (reduce-tile
    rows, at most 64: the kernel holds tiles of up to 8192 elements in
    shared memory), LUX_MX_VBLK (totals ranks per output block;
    multiple of 8, <= 248 so the u8 rank tiles keep a distinct
    sentinel).  Like the pf knobs they shape the PLAN and are never
    read at replay."""
    if mx_max_block is None:
        mx_max_block = env_int("LUX_MX_MAX_BLOCK", 1024, minimum=LANE)
    if tile_rows is None:
        tile_rows = env_int("LUX_MX_TILE_ROWS", 8, minimum=1,
                            maximum=MX_MAX_TILE_ELEMS // LANE)
    if v_blk is None:
        v_blk = env_int("LUX_MX_VBLK", 128, minimum=8, maximum=248)
    if v_blk % 8:
        raise ValueError(f"LUX_MX_VBLK must be a multiple of 8 (the "
                         f"reference's output alignment), got {v_blk}")
    for name, v in (("LUX_MX_MAX_BLOCK", mx_max_block),
                    ("LUX_MX_TILE_ROWS", tile_rows)):
        if v & (v - 1):
            raise ValueError(f"{name} must be a power of two (tile and "
                             f"block geometry divide each other), got {v}")
    if mx_max_block > tile_rows * LANE:
        raise ValueError(
            f"LUX_MX_MAX_BLOCK ({mx_max_block}) exceeds the reduce tile "
            f"(LUX_MX_TILE_ROWS*128 = {tile_rows * LANE}): the suffix "
            "group's blocks must fit one tile")
    return mx_max_block, tile_rows, v_blk


def _pf_final_order(dims, group_sizes) -> list[int]:
    """The digit-axis order of the array's FINAL physical layout after
    all fused groups, BEFORE the restore transpose — a dry run of
    _pf_plan's order threading (asserted against the real plan there,
    so the two can never drift).  Needed ahead of route construction:
    the mxreduce planner pre-composes its target permutation with this
    layout (mx_physical_order)."""
    k = len(dims)
    axes = route_mod.benes_axes(k)
    assert sum(group_sizes) == len(axes), (group_sizes, axes)
    order = list(range(k))
    j = 0
    for glen in group_sizes:
        gaxes = list(axes[j:j + glen])
        sset: list[int] = []
        for a in gaxes:
            if a not in sset:
                sset.append(a)
        rest = [a for a in order if a not in sset]
        gorder = [a for a in order if a in sset and a != gaxes[0]]
        gorder.append(gaxes[0])
        for step_i, g in enumerate(gaxes):
            if step_i and gorder[-1] != g:
                gorder = [a for a in gorder if a != g] + [g]
        order = rest + gorder
        j += glen
    return order


def mx_physical_order(n: int, dims, group_sizes) -> np.ndarray:
    """sigma: the canonical flat slot living at each FINAL physical
    position of a pass-fused replay that skips the restore transpose.
    A caller that wants physical position p to end up holding
    ``x[desired[p]]`` routes the permutation ``routed`` where
    ``routed[sigma] = desired`` — the Benes machinery then lands the
    desired layout directly and the mxreduce kernel consumes it with
    plan-time rank tiles, no transpose."""
    order = _pf_final_order(dims, group_sizes)
    ids = np.arange(n, dtype=np.int64).reshape(tuple(dims))
    return np.ascontiguousarray(np.transpose(ids, order)).reshape(-1)


def plan_route_pf_mx(route: route_mod.Route, v_blk: int, num_blocks: int, op: str,
                     group_sizes, tile_rows: int, max_block=None,
                     max_group=None, smem_bytes=None):
    """Compile a host Route into the MXREDUCE pass-fused form: the
    prefix groups replay as ordinary fused kernels (identity final —
    no restore), the suffix group becomes the StaticMXGroup consumed by
    ``mxreduce_pass_gather``.  ``group_sizes`` MUST come from
    route.plan_mx_fusion_groups for the same dims, and the route's
    target permutation must have been pre-composed with
    ``mx_physical_order(n, dims, group_sizes)``.

    Returns (StaticRoutePF, prefix arrays, StaticMXGroup, mx step
    arrays)."""
    max_block, max_group, smem_bytes = _pf_defaults(max_block, max_group,
                                                    smem_bytes)
    canon = [np.asarray(p.idx) for p in route.passes]
    return _pf_plan(route.n, route.dims, canon, group_sizes, smem_bytes,
                    mx={"v_blk": v_blk, "num_blocks": num_blocks,
                        "op": op, "tile_rows": tile_rows})



# ---------------------------------------------------------------------------
# replays (torch): transposes between passes/groups, kernels in between
# ---------------------------------------------------------------------------


def _relayout(y: torch.Tensor, static_view, perm) -> torch.Tensor:
    """``y.reshape(view).permute(perm)`` as a contiguous flat copy."""
    y = y.reshape(static_view)
    if perm:
        y = y.permute(perm)
    return y.contiguous().reshape(-1)


def apply_route_frozen(x: torch.Tensor, static, idx_dev) -> torch.Tensor:
    """Replay a frozen route on ``x`` (n,): returns ``x[perm]``.  A
    pass-fused static (StaticRoutePF) replays through the fused kernel
    (apply_route_frozen_pf)."""
    if isinstance(static, StaticRoutePF):
        return apply_route_frozen_pf(x, static, idx_dev)
    y = x
    for p, idx in zip(static.passes, idx_dev):
        y = _relayout(y, p.view, p.perm_axes).reshape(p.kshape)
        if p.kind == "lane":
            y = lane_gather(y, idx)
        else:
            y = sublane_gather(y, idx)
        y = y.reshape(-1)
    return _relayout(y, static.final_view, static.final_perm)


def apply_route_frozen_pf(x: torch.Tensor, static: StaticRoutePF,
                          idx_dev) -> torch.Tensor:
    """apply_route_frozen for the pass-fused form: one kernel per GROUP,
    entry transposes between groups only."""
    y = x
    i = 0
    for g in static.groups:
        y = _relayout(y, g.view, g.perm_axes).reshape(g.kshape)
        n_steps = len(g.steps)
        y = fused_pass_gather(y, tuple(idx_dev[i:i + n_steps]), group=g)
        i += n_steps
        y = y.reshape(-1)
    return _relayout(y, static.final_view, static.final_perm)


# ---------------------------------------------------------------------------
# the chained kernels
# ---------------------------------------------------------------------------


def _steps_plain(y: torch.Tensor, steps, idx) -> torch.Tensor:
    """The step loop of a fused or mx group on the whole (R, 128) array:
    each step's relayout is the same on every tile (its leading axis
    keeps tiles and blocks in place), then a row gather."""
    r = y.shape[0]
    for st, ix in zip(steps, idx):
        if st.relayout is not None:
            rview, rperm = st.relayout
            y = (y.reshape((-1,) + tuple(rview[1:])).permute(rperm)
                 .reshape(r, LANE))
        y = torch.gather(y, 1, ix.long())
    return y


def _relayout_desc(steps) -> np.ndarray:
    """The int32 step table the chained kernels read: n_steps, then per
    step (has_relayout, ndim, then per output axis (shift, mask,
    src_shift)).  An output position q of a relayout reads the old
    position sum_i ((q >> shift_i) & mask_i) << src_shift_i."""
    out = [len(steps)]
    for st in steps:
        if st.relayout is None:
            out += [0, 0]
            continue
        rview, rperm = st.relayout
        tshape = [rview[a] for a in rperm]
        if len(tshape) > MAX_DIMS:
            raise ValueError(f"relayout over {len(tshape)} axes; the kernels "
                             f"take at most {MAX_DIMS}")
        in_stride = [math.prod(rview[j + 1:]) for j in range(len(rview))]
        out += [1, len(tshape)]
        for i, d in enumerate(tshape):
            out_stride = math.prod(tshape[i + 1:])
            out += [int(out_stride).bit_length() - 1, d - 1,
                    int(in_stride[rperm[i]]).bit_length() - 1]
    return np.asarray(out, np.int32)


_DESC_CACHE: dict = {}


def _desc_of(steps) -> np.ndarray:
    with _LOCK:
        d = _DESC_CACHE.get(steps)
        if d is None:
            d = _DESC_CACHE[steps] = _relayout_desc(steps)
        return d


def _check_chain(name, x, idx, steps, block_rows, kshape):
    if x.dim() != 2 or x.shape[1] != LANE or tuple(kshape) != tuple(x.shape):
        raise ValueError(f"{name}: x {tuple(x.shape)} is not the group's "
                         f"{tuple(kshape)}")
    if len(idx) != len(steps):
        raise ValueError(f"{name}: {len(idx)} index tiles for "
                         f"{len(steps)} steps")
    if len(steps) > MAX_STEPS:
        raise ValueError(f"{name} chains at most {MAX_STEPS} steps, got "
                         f"{len(steps)} (lower LUX_PF_MAX_GROUP)")
    if x.shape[0] % block_rows:
        raise ValueError(f"{name}: {x.shape[0]} rows are not a multiple of "
                         f"the tile's {block_rows}")
    if len({ix.dtype for ix in idx}) > 1:
        raise TypeError(f"{name}: index tiles of one group share a dtype")
    for ix in idx:
        _check_gather(name, x, ix)
    return _same_device(name, x, *idx)


def _ptr_array(tensors):
    """The device pointers of the step index tiles, as the host array of
    MAX_STEPS pointers the C entry points take."""
    return (ctypes.c_void_p * MAX_STEPS)(*[t.data_ptr() for t in tensors])


def fused_pass_gather_plain(x: torch.Tensor, idx, group: StaticGroup):
    """Plain PyTorch version of :func:`fused_pass_gather`."""
    return _steps_plain(x, group.steps, idx)


def fused_pass_gather(x: torch.Tensor, idx, group: StaticGroup) -> torch.Tensor:
    """Run ONE fused pass group: x (R, 128) -> out (R, 128), the group's
    steps (optional in-tile relayout, then a row gather) chained on
    tiles of ``group.block_rows`` rows.  ``idx``: one (R, 128) index
    tile per step (uint8 or int32, values < 128).  CPU tensors run the
    plain version; CUDA tensors launch ``csrc/fused_pass_gather.cu``."""
    idx = tuple(idx)
    dev = _check_chain("fused_pass_gather", x, idx, group.steps,
                       group.block_rows, group.kshape)
    if dev.type == "cpu":
        return fused_pass_gather_plain(x, idx, group)
    out = torch.empty_like(x)
    _check_aligned("fused_pass_gather", x, out, *idx)
    desc = _desc_of(group.steps)
    _launch("fused_pass_gather", dev, x.data_ptr(), x.element_size(),
            _ptr_array(idx), idx[0].element_size(), desc.ctypes.data,
            x.shape[0], group.block_rows, out.data_ptr())
    fused_pass_gather.launches += 1
    return out


fused_pass_gather.launches = 0


def mx_num_chunks(rows: int, block_rows: int) -> int:
    """Chunks of the mx kernel's grid over (rows, 128) in tiles of
    ``block_rows`` rows: MX_MAX_TILE_ELEMS elements of whole tiles each,
    the last one short when the tiles do not fill it.  The wrapper
    allocates MX_PART_BYTES of summary for each."""
    tile = block_rows * LANE
    if block_rows < 1 or rows % block_rows or tile > MX_MAX_TILE_ELEMS:
        raise ValueError(f"mxreduce_pass_gather: {rows} rows in tiles of "
                         f"{block_rows} rows; a tile divides the rows and "
                         f"holds at most {MX_MAX_TILE_ELEMS} elements")
    per_chunk = MX_MAX_TILE_ELEMS // tile
    return -(-(rows // block_rows) // per_chunk)


def mx_out_dtype(op: str, dtype: torch.dtype) -> torch.dtype:
    """Float sums come out float32; min/max and integer ops keep the
    dtype."""
    return torch.float32 if op == "sum" and dtype.is_floating_point else dtype


def mxreduce_pass_gather_plain(x: torch.Tensor, idx, dst_rel: torch.Tensor,
                               tile_block: torch.Tensor,
                               group: StaticMXGroup) -> torch.Tensor:
    """Plain PyTorch version of :func:`mxreduce_pass_gather`: the step
    loop, then a masked reduce over flat ranks (tile's block * v_blk +
    rank; the sentinel rank v_blk contributes nothing)."""
    y = _steps_plain(x, group.steps, idx)
    v_blk = group.v_blk
    ranks = dst_rel.long()
    tile = torch.arange(y.shape[0], device=y.device) // group.block_rows
    flat = tile_block.long()[tile][:, None] * v_blk + ranks
    valid = ranks < v_blk
    out_dtype = mx_out_dtype(group.op, y.dtype)
    out = torch.full((group.num_blocks * v_blk,),
                     reduce_neutral(group.op, out_dtype), dtype=out_dtype,
                     device=y.device)
    vals = y[valid].to(out_dtype)
    if group.op == "sum":
        return out.index_add_(0, flat[valid], vals)
    return out.scatter_reduce_(0, flat[valid], vals,
                               "amin" if group.op == "min" else "amax")


def mxreduce_pass_gather(x: torch.Tensor, idx, dst_rel: torch.Tensor,
                         tile_block: torch.Tensor,
                         group: StaticMXGroup) -> torch.Tensor:
    """Run the MXREDUCE final group: x (R, 128) in the group's entry
    layout -> totals (num_blocks * v_blk,).

    ``idx``: per-step gather index tiles ((R, 128), values < 128, uint8
    or int32).  ``dst_rel``: (R, 128) plan-time rank map of the FINAL
    layout (values < v_blk; v_blk = the padding sentinel; uint8 or
    int32).  ``tile_block``: (R / block_rows,) int32 output block of
    each tile, nondecreasing (the planner's rank-block alignment).  The
    program's edge function is applied to ``x`` by the caller
    (apply_fused): the gathers only permute, so that is the same values.
    Float sums (bf16 included) accumulate and come out in float32; min/max
    and int32 ops keep the dtype, bitwise.  CPU tensors run the plain
    version; CUDA tensors launch ``csrc/mxreduce_pass_gather.cu``."""
    idx = tuple(idx)
    if x.dtype not in _MX_KIND:
        raise TypeError(f"mxreduce_pass_gather takes float32, bfloat16 or int32, "
                        f"got {x.dtype}")
    if group.op not in _MX_OPS:
        raise ValueError(f"mx op must be sum|min|max, got {group.op!r}")
    dev = _check_chain("mxreduce_pass_gather", x, idx, group.steps,
                       group.block_rows, group.kshape)
    num_tiles = x.shape[0] // group.block_rows
    if dst_rel.shape != x.shape or dst_rel.dtype != idx[0].dtype:
        raise ValueError("dst_rel must have x's shape and the index tiles' "
                         "dtype (uint8 or int32)")
    if tile_block.shape != (num_tiles,) or tile_block.dtype != torch.int32:
        raise ValueError(f"tile_block must be int32 of shape ({num_tiles},)")
    _same_device("mxreduce_pass_gather", x, dst_rel, tile_block)
    if dev.type == "cpu":
        return mxreduce_pass_gather_plain(x, idx, dst_rel, tile_block, group)
    if group.block_rows * LANE > MX_MAX_TILE_ELEMS:
        raise ValueError(f"mx tile of {group.block_rows * LANE} elements; the "
                         f"kernel holds at most {MX_MAX_TILE_ELEMS}")
    if not (dst_rel.is_contiguous() and tile_block.is_contiguous()):
        raise ValueError("mxreduce_pass_gather needs contiguous inputs")
    # the kernel fills every total with the neutral value itself (its
    # first launch), so keys no real slot touches come out neutral
    out = torch.empty(group.num_blocks * group.v_blk,
                      dtype=mx_out_dtype(group.op, x.dtype), device=dev)
    scratch = torch.empty(MX_PART_BYTES * mx_num_chunks(x.shape[0], group.block_rows),
                          dtype=torch.uint8, device=dev)
    _check_aligned("mxreduce_pass_gather", x, dst_rel, out, scratch, *idx)
    desc = _desc_of(group.steps)
    _launch("mxreduce_pass_gather", dev, x.data_ptr(), _MX_KIND[x.dtype],
            _ptr_array(idx), idx[0].element_size(),
            desc.ctypes.data, dst_rel.data_ptr(), dst_rel.element_size(),
            tile_block.data_ptr(), x.shape[0], group.block_rows, group.v_blk,
            group.num_blocks, _MX_OPS[group.op], out.data_ptr(),
            scratch.data_ptr(), scratch.numel())
    mxreduce_pass_gather.launches += 1
    return out


mxreduce_pass_gather.launches = 0


#: every kernel wrapper of this module, by kernel name
KERNELS = {
    "lane_gather": lane_gather,
    "sublane_gather": sublane_gather,
    "fused_pass_gather": fused_pass_gather,
    "mxreduce_pass_gather": mxreduce_pass_gather,
}
