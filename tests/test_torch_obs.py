"""The flight recorder of lux_tpu_torch (obs/) against lux_tpu.obs, on the CPU.

The recorder, dtrace and slo modules are the reference's stdlib copies:
the same calls give the same events, ids, sampling decisions and SLO
verdicts in both packages, and the reference's ``tools/luxview.py`` reads
the port's log.  The telemetry ring is a device tensor in the port: its
rows equal the reference's ``ring_rows`` (PageRank's f32 residual within
rtol 1e-5 of the curve's scale — the two packages' states differ in their
last ulps — and of a float64 recomputation of the port's own iterates;
push SSSP bitwise), and every result with the ring is bitwise the result
without.  The kernel
attribution (obs/xprof) is held on chrome-trace fixtures written here,
with kernel names as torch.profiler exports them from the card.
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lux_tpu.engine import pull as ref_pull
from lux_tpu.engine import push as ref_push
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph.push_shards import build_push_shards as ref_build_push
from lux_tpu.graph.shards import build_pull_shards as ref_build_pull
from lux_tpu.models import components as ref_cc
from lux_tpu.models import pagerank as ref_pr
from lux_tpu.models import sssp as ref_sssp
from lux_tpu.obs import dtrace as ref_dtrace
from lux_tpu.obs import ring as ref_ring
from lux_tpu.obs import slo as ref_slo
from lux_tpu_torch.engine import pull, push
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.push_shards import build_push_shards
from lux_tpu_torch.graph.shards import build_pull_shards, to_device
from lux_tpu_torch.models import components as cc
from lux_tpu_torch.models import pagerank as pr
from lux_tpu_torch.models import sssp
from lux_tpu_torch.obs import dtrace, ring, slo, xprof
from lux_tpu_torch.utils import profiling

# the packages' __init__ re-export the accessor FUNCTION ``recorder``
# under the submodule's name: load the modules themselves
recorder = importlib.import_module("lux_tpu_torch.obs.recorder")
ref_recorder = importlib.import_module("lux_tpu.obs.recorder")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _luxview():
    spec = importlib.util.spec_from_file_location(
        "luxview_for_port", os.path.join(REPO, "tools", "luxview.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _drive(mod, root, run_id):
    """One scripted sequence of spans and points through a package's
    Recorder; returns the closed recorder."""
    rec = mod.Recorder(run_id=run_id, root=str(root), enabled=True)
    with rec.span("plan.build", tag="expand", part=0) as sp:
        with rec.span("plan.load", tag="expand-pf", part=1):
            rec.point("serve.cache", app="sssp", q=8, warm=True)
        sp.set(bytes=123)
    try:
        with rec.span("mutate.apply", rows=3):
            raise KeyError("x")
    except KeyError:
        pass
    rec.point("telemetry.ring", kind="push", n=2, rows=[[0.0, 1.0], [1.0, 2.0]])
    rec.emit_span("serve.request", 1.0, 2.5, attrs={"trace": "t1"}, end_attrs={"ok": 1})
    rec.close()
    return rec


def _shape(path):
    """The events of a log with timestamps, pids and span ids abstracted:
    spans by begin order, parents by that order."""
    evs = [json.loads(line) for line in open(path)]
    order, out = {}, []
    for e in evs:
        if e["e"] == "m":
            out.append(("m", e["run"], e["argv"][:0]))
        elif e["e"] == "b":
            order[e["s"]] = len(order)
            out.append(("b", e["n"], order.get(e["p"]), e.get("a")))
        elif e["e"] == "e":
            out.append(("e", order[e["s"]], e["ok"], e.get("a")))
        else:
            out.append(("p", e["n"], e.get("a")))
    return out


def test_recorder_events_match_the_reference(tmp_path):
    mine = _drive(recorder, tmp_path / "port", "runA")
    ref = _drive(ref_recorder, tmp_path / "ref", "runA")
    assert _shape(mine.log_path) == _shape(ref.log_path)
    assert mine.totals().keys() == ref.totals().keys()
    assert {k: v[0] for k, v in mine.totals().items()} == \
        {k: v[0] for k, v in ref.totals().items()}
    # the directory contract: 0o700, this uid
    st = os.stat(os.path.dirname(mine.log_path))
    assert st.st_mode & 0o777 == 0o700 and st.st_uid == os.getuid()


def test_luxview_reads_the_ports_log(tmp_path):
    rec = _drive(recorder, tmp_path, "runB")
    lv = _luxview()
    metas, spans, points, bad = lv.load_events([rec.log_path])
    assert bad == 0 and len(metas) == 1
    assert sorted(s["name"] for s in spans.values()) == sorted(
        ["plan.build", "plan.load", "mutate.apply", "serve.request"])
    assert [p["name"] for p in points] == ["serve.cache", "telemetry.ring"]
    report = lv.render(metas, spans, points, bad, "runB")
    assert "plan.build" in report and "telemetry" in report


def test_recorder_env_and_begin_on_disk(tmp_path, monkeypatch):
    """LUX_OBS_DIR / LUX_OBS_RUN_ID name the log; a begin event is on
    disk while its span is still open; LUX_OBS=0 keeps the totals only."""
    monkeypatch.setenv("LUX_OBS_DIR", str(tmp_path / "root"))
    monkeypatch.setenv("LUX_OBS_RUN_ID", "run-env")
    rec = recorder.Recorder()
    with rec.span("plan.build"):
        lines = open(rec.log_path).read().splitlines()
        assert json.loads(lines[-1])["e"] == "b"
    assert rec.log_path.startswith(str(tmp_path / "root" / "run-env"))
    rec.close()
    monkeypatch.setenv("LUX_OBS", "0")
    off = recorder.Recorder(root=str(tmp_path / "off"))
    with off.span("x"):
        pass
    assert off.total_count("x") == 1 and off.log_path is None


def test_dtrace_ids_and_sampling_match_the_reference(monkeypatch):
    keys = [f"req-{i}" for i in range(300)] + ["w:17", "w:18"]
    for rate in ("1.0", "0.25", "0.0"):
        monkeypatch.setenv("LUX_DTRACE_SAMPLE", rate)
        for k in keys:
            a, b = dtrace.mint(k), ref_dtrace.mint(k)
            assert (a.trace_id, a.span_id, a.flags) == (b.trace_id, b.span_id, b.flags)
            ia, ib = dtrace.incident(k), ref_dtrace.incident(k)
            assert (ia.trace_id, ia.span_id, ia.flags) == (ib.trace_id, ib.span_id, ib.flags)
    ctx = dtrace.mint("req-1").child()
    back = ref_dtrace.TraceContext.from_wire(ctx.to_wire())
    assert back.attrs() == ctx.attrs()
    monkeypatch.setenv("LUX_DTRACE", "0")
    assert dtrace.mint("req-1") is None and ref_dtrace.mint("req-1") is None


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_slo_verdicts_match_the_reference():
    specs = ('[{"name": "avail", "kind": "availability", "objective": 0.99, '
             '"windows": [[10, 2.0], [40, 1.0]]}, '
             '{"name": "p99", "kind": "latency", "objective": 0.9, "threshold_ms": 50, '
             '"windows": [[10, 2.0], [40, 1.0]]}, '
             '{"name": "fresh", "kind": "staleness", "objective": 0.95}, '
             '{"name": "ack", "kind": "write_latency", "objective": 0.9, '
             '"threshold_ms": 100}]')
    engines = []
    for mod in (slo, ref_slo):
        clock = _Clock()
        engines.append((mod.SLOEngine(mod.specs_from_json(specs), clock=clock), clock))
    rng = np.random.default_rng(7)
    for i in range(2000):
        lat = float(rng.exponential(0.03))
        ok = bool(rng.random() > 0.02)
        stale = bool(rng.random() < 0.03)
        wlat = float(rng.exponential(0.05))
        for eng, clock in engines:
            clock.t = i * 0.05
            eng.observe_query(lat, ok=ok, stale=stale, trace_id=f"t{i}")
            if i % 3 == 0:
                eng.observe_write(wlat, ok=ok, trace_id=f"w{i}")
        if i % 250 == 0:
            (a, _), (b, _) = engines
            assert a.status() == b.status()
    (a, _), (b, _) = engines
    assert a.verdicts() == b.verdicts()
    assert a.status() == b.status()
    assert a.prom_lines() == b.prom_lines()
    assert [s.to_dict() for s in slo.default_fleet_slos()] == \
        [s.to_dict() for s in ref_slo.default_fleet_slos()]


# ---------------------------------------------------------------------------
# the telemetry ring
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pull_pair():
    g, rg = generate.rmat(8, 8, seed=17), ref_generate.rmat(8, 8, seed=17)
    return build_pull_shards(g, 2), ref_build_pull(rg, 2)


def test_ring_pull_fixed_rows_and_bitwise_noop(pull_pair):
    sh, rsh = pull_pair
    arrays = to_device(sh.arrays, "cpu")
    prog = pr.PageRankProgram(nv=sh.spec.nv)
    s0 = pull.init_state(prog, arrays)
    plain = pull.run_pull_fixed(prog, sh.spec, arrays, s0, 6, method="scan")
    out, rg = pull.run_pull_fixed(prog, sh.spec, arrays, s0, 6, method="scan",
                                  telemetry=ring.new_ring("pull_fixed"))
    assert torch.equal(out, plain)
    rows, n = ring.ring_rows(rg)
    assert n == 6 and rows.shape == (6, 2)
    # the reference's ring over the same graph
    rdev = jax.tree.map(jnp.asarray, rsh.arrays)
    rprog = ref_pr.PageRankProgram(nv=rsh.spec.nv)
    rs0 = ref_pull.init_state(rprog, rdev)
    _, rrg = ref_pull.run_pull_fixed(rprog, rsh.spec, rdev, rs0, 6, method="scan",
                                     telemetry=ref_ring.new_ring("pull_fixed"))
    rrows, rn = ref_ring.ring_rows(rrg)
    assert rn == n
    np.testing.assert_array_equal(rows[:, 0], rrows[:, 0])
    # the two packages' f32 states differ in their last ulps (their sums
    # associate differently), so a late residual — a sum of last-ulp
    # changes — is held at rtol 1e-5 of the curve's scale
    np.testing.assert_allclose(rows[:, 1], rrows[:, 1], rtol=1e-5, atol=1e-5 * rrows[0, 1])
    # and exactly what the ring claims: the L1 residual of the port's own
    # iterates, recomputed in float64 on the host
    st, want = s0, []
    for _ in range(6):
        nxt = pull.run_pull_fixed(prog, sh.spec, arrays, st, 1, method="scan")
        want.append(np.abs(nxt.double().numpy() - st.double().numpy()).sum())
        st = nxt
    np.testing.assert_allclose(rows[:, 1], want, rtol=1e-5)
    # donation: the state is written in place, the ring the same
    s1 = s0.clone()
    out_d, rg_d = pull.run_pull_fixed(prog, sh.spec, arrays, s1, 6, method="scan",
                                      donate=True, telemetry=ring.new_ring("pull_fixed"))
    assert torch.equal(out_d, plain)
    assert np.array_equal(ring.ring_rows(rg_d)[0], rows)


def test_ring_pull_until_rows_and_bitwise_noop(pull_pair):
    sh, rsh = pull_pair
    arrays = to_device(sh.arrays, "cpu")
    prog = cc.MaxLabelProgram()
    s0 = pull.init_state(prog, arrays)

    def active(old, new):
        return (old != new).reshape(old.shape[0], -1).sum(dim=1, dtype=torch.int32)

    plain, it = pull.run_pull_until(prog, sh.spec, arrays, s0, 100, active, method="scan")
    out, it2, rg = pull.run_pull_until(prog, sh.spec, arrays, s0, 100, active,
                                       method="scan", telemetry=ring.new_ring("pull_until"))
    assert torch.equal(out, plain) and it == it2
    rows, n = ring.ring_rows(rg)
    rdev = jax.tree.map(jnp.asarray, rsh.arrays)
    rprog = ref_cc.MaxLabelProgram()
    rs0 = ref_pull.init_state(rprog, rdev)
    rout, rit, rrg = ref_pull.run_pull_until(
        rprog, rsh.spec, rdev, rs0, 100,
        lambda o, nw: jnp.sum(o != nw, axis=tuple(range(1, o.ndim))), method="scan",
        telemetry=ref_ring.new_ring("pull_until"))
    rrows, rn = ref_ring.ring_rows(rrg)
    assert (n, it) == (rn, int(rit))
    np.testing.assert_array_equal(rows, rrows)
    np.testing.assert_array_equal(out.numpy(), np.asarray(rout))


@pytest.mark.parametrize("parts", [1, 2])
def test_ring_push_rows_bitwise(parts):
    g, rg = generate.rmat(9, 8, seed=31), ref_generate.rmat(9, 8, seed=31)
    sh, rsh = build_push_shards(g, parts), ref_build_push(rg, parts)
    start = int(np.argmax(g.out_degrees()))
    prog = sssp.SSSPProgram(nv=g.nv, start=start)
    plain = push.run_push(prog, sh, method="scan", device="cpu")
    st, it, edges, rgn = push.run_push(prog, sh, method="scan", device="cpu",
                                       telemetry=ring.new_ring("push"))
    assert torch.equal(st, plain[0]) and (it, edges) == plain[1:]
    rows, n = ring.ring_rows(rgn)
    assert n == it
    rprog = ref_sssp.SSSPProgram(nv=g.nv, start=start)
    rst, rit, _redges, rring = ref_push.run_push(rprog, rsh, method="scatter",
                                                 telemetry=ref_ring.new_ring("push"))
    rrows, rn = ref_ring.ring_rows(rring)
    assert (n, it) == (rn, int(rit))
    np.testing.assert_array_equal(rows, rrows)
    np.testing.assert_array_equal(st.numpy(), np.asarray(rst))
    # the columns: iteration, frontier, traversed edges, direction
    assert rows[:, 0].tolist() == list(range(n))
    assert rows[:, 2].astype(np.int64).sum() == edges


def test_ring_wraparound_keeps_the_tail():
    rg = ring.new_ring("pull_fixed", cap=4)
    for i in range(10):
        rg = ring.ring_push(rg, i, torch.tensor(float(i * i)))
    rows, n = ring.ring_rows(rg)
    assert n == 10
    np.testing.assert_array_equal(rows[:, 0], [6, 7, 8, 9])
    np.testing.assert_array_equal(rows[:, 1], [36, 49, 64, 81])
    assert ring.SCHEMAS == ref_ring.SCHEMAS and ring.DEFAULT_CAP == ref_ring.DEFAULT_CAP


def test_emit_ring_writes_the_telemetry_point(tmp_path):
    rec = recorder.Recorder(run_id="ring", root=str(tmp_path), enabled=True)
    rg = ring.ring_push(ring.new_ring("push", cap=8), 0, 5, 40, 1)
    ring.emit_ring("push", rg, rec=rec, app="sssp")
    rec.close()
    pts = [json.loads(x) for x in open(rec.log_path) if '"telemetry.ring"' in x]
    assert pts[0]["a"] == {"kind": "push", "cols": ["it", "frontier", "edges_lo", "dense"],
                           "n": 1, "rows": [[0.0, 5.0, 40.0, 1.0]], "app": "sssp"}


# ---------------------------------------------------------------------------
# kernel attribution (obs/xprof, utils/profiling)
# ---------------------------------------------------------------------------

#: kernel names as torch.profiler's chrome trace gives them on the card
#: (demangled; the port's own are template instances)
CARD_NAMES = {
    "void spmv_span_kernel<float, 0>(float const*, int const*, int const*, int, "
    "int, Summary*)": "spmv",
    "void spmv_blockcsr_2d_kernel<float>(float const*, int const*, int, int)": "spmv",
    "void scan_tiles<float, 0>(float const*, bool const*, long long, float*)": "scan",
    "void apply_carries<int, 1>(int*, long long)": "scan",
    "void fused_pass_kernel<float>(float*, unsigned char const*, int)": "routed-pf",
    "void mx_chunk_kernel<float, 0>(float const*, int const*, int)": "routed-pf",
    "void lane_gather_kernel<float, unsigned char>(float const*, unsigned char const*, "
    "float*, int)": "route",
    "void runs_fold_kernel<float, 0>(Summary const*, int, float*)": "runs",
    "void at::native::(anonymous namespace)::indexSelectLargeIndex<float, long, unsigned "
    "int, 2, 2, -2, true>(at::cuda::detail::TensorInfo<float, unsigned int>, "
    "at::cuda::detail::TensorInfo<float const, unsigned int>, "
    "at::cuda::detail::TensorInfo<long const, unsigned int>, int, int, unsigned int, "
    "unsigned int, long)": "gather",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::(anonymous "
    "namespace)::OpaqueType<4u>, unsigned int, 1, 128, 1>(at::native::(anonymous "
    "namespace)::OpaqueType<4u>*, at::native::(anonymous namespace)::CatArrInputTensor"
    "Metadata<at::native::(anonymous namespace)::OpaqueType<4u>, unsigned int, 128, 1>, "
    "at::native::(anonymous namespace)::TensorSizeStride<unsigned int, 4u>, int, "
    "unsigned int)": "cat",
    "void at::native::(anonymous namespace)::indexFuncLargeIndex<float, long, unsigned "
    "int, 1, 1, -2, true, at::native::(anonymous namespace)::ReduceAdd>(...)": "scatter",
    "void at::native::_scatter_gather_elementwise_kernel<128, 8, "
    "at::native::_cuda_scatter_gather_internal_kernel<true, int>::operator()(...)": "scatter",
    "void at::native::_scatter_gather_elementwise_kernel<128, 8, "
    "at::native::_cuda_scatter_gather_internal_kernel<false, float>::operator()<"
    "at::native::TensorAssign>(at::TensorIterator&, long, long, long, "
    "at::native::TensorAssign const&)::{lambda(int)#1}>(int, "
    "at::native::_cuda_scatter_gather_internal_kernel<false, float>::operator()<"
    "at::native::TensorAssign>(...)::{lambda(int)#1})": "gather",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
    "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::"
    "operator()() const::{lambda()#7}::operator()() const::{lambda(float)#1}>(...)": "copy",
    "Memcpy DtoD (Device -> Device)": "copy",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::func_wrapper_t<float, at::native::sum_functor<float, float, float>::"
    "operator()(at::TensorIterator&)::{lambda(float, float)#1}>, unsigned int, float, "
    "4, 4> >(...)": "other",
}


def test_classify_card_names():
    for name, cls in CARD_NAMES.items():
        assert xprof.classify(name) == cls, name


def _write_trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "deviceProperties": []}, f)


def test_kernel_table_and_class_summary(tmp_path):
    span = "void spmv_span_kernel<float, 0>(float const*, int const*, int const*, int, int)"
    gather = "void at::native::indexSelectLargeIndex<float, long>(...)"
    evs = [{"ph": "X", "cat": "kernel", "name": span, "dur": 60.0, "pid": 0, "tid": 7}
           for _ in range(20)]
    evs += [{"ph": "X", "cat": "kernel", "name": gather, "dur": 130.0, "pid": 0, "tid": 7}
            for _ in range(10)]
    evs += [{"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)",
             "dur": 30.0, "pid": 0, "tid": 7}]
    # host events and the GPU-side annotation ranges do not count as device time
    evs += [{"ph": "X", "cat": "cpu_op", "name": "aten::index_select", "dur": 900.0,
             "pid": 4242, "tid": 1},
            {"ph": "X", "cat": "gpu_user_annotation", "name": "iteration", "dur": 5000.0,
             "pid": 0, "tid": 7},
            {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "python3"}}]
    _write_trace(tmp_path / "old.trace.json", [{"ph": "X", "cat": "kernel", "name": "stale",
                                                "dur": 1.0}])
    os.utime(tmp_path / "old.trace.json", (1, 1))
    _write_trace(tmp_path / "new.trace.json", evs)
    meta = {}
    rows = xprof.kernel_table(str(tmp_path), meta=meta)
    assert not meta.get("host_only")
    assert [(r["name"], r["class"], r["calls"]) for r in rows] == [
        (gather, "gather", 10), (span, "spmv", 20),
        ("Memcpy DtoD (Device -> Device)", "copy", 1)]
    assert rows[0]["total_ms"] == pytest.approx(1.3) and rows[1]["total_ms"] == pytest.approx(1.2)
    assert xprof.class_summary(rows) == pytest.approx({"spmv": 1.2, "gather": 1.3, "copy": 0.03})
    assert sum(r["frac"] for r in rows) == pytest.approx(1.0, abs=1e-3)
    # a file over the size cap is named, not parsed
    skipped = []
    os.environ["LUX_OBS_XPROF_MAX_MB"] = "1"
    try:
        _write_trace(tmp_path / "new.trace.json", evs * 2000)
        assert xprof.kernel_table(str(tmp_path), skipped=skipped) == []
        assert skipped and skipped[0].endswith("new.trace.json")
    finally:
        del os.environ["LUX_OBS_XPROF_MAX_MB"]


def test_profiling_trace_on_the_cpu_lands_in_the_event_log(tmp_path):
    rec = recorder.Recorder(run_id="prof", root=str(tmp_path / "obs"), enabled=True)
    old = recorder.install(rec)
    try:
        with profiling.trace(str(tmp_path / "prof"), device="cpu"):
            with profiling.annotate("window"):
                x = torch.arange(4096.0)
                torch.cat([x, x]).index_select(0, torch.arange(100)).sum()
    finally:
        recorder.install(old)
        rec.close()
    assert len(list((tmp_path / "prof").glob("*.trace.json"))) == 1
    evs = [json.loads(x) for x in open(rec.log_path)]
    assert any(e["e"] == "b" and e["n"] == "xprof.trace" for e in evs)
    pt = [e for e in evs if e["e"] == "p" and e["n"] == "xprof.kernels"][0]["a"]
    assert pt["host_only"] is True  # no card: host wall time, labelled so
    names = {r["name"]: r["class"] for r in pt["rows"]}
    assert names["aten::cat"] == "cat" and names["aten::index_select"] == "gather"
    assert pt["total_ms"] > 0 and pt["calls"] >= len(pt["rows"])
