"""The memory preflight of lux_tpu_torch (utils/preflight, apps/common):
each estimate against the exact ``nbytes`` of the arrays the port builds,
the warning against the device memory, and the estimate every app prints
before its set-up.  CPU only: the byte counts are the same on the card."""
import pytest
import torch

from lux_tpu_torch.apps import colfilter, common, components, pagerank
from lux_tpu_torch.apps import run as run_app
from lux_tpu_torch.apps import sssp
from lux_tpu_torch.engine import pull, push
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph import push_shards as ps
from lux_tpu_torch.graph.push_shards import build_push_shards
from lux_tpu_torch.graph.shards import build_pull_shards, to_device
from lux_tpu_torch.models import colfilter as cf_model
from lux_tpu_torch.models import pagerank as pr_model
from lux_tpu_torch.models import sssp as sssp_model
from lux_tpu_torch.models.pagerank import PageRankProgram
from lux_tpu_torch.ops import expand, spmv
from lux_tpu_torch.program import library
from lux_tpu_torch.program import workloads as wl
from lux_tpu_torch.program.spec import bind
from lux_tpu_torch.utils import preflight
from lux_tpu_torch.utils.config import parse_args


def _nbytes(tensors) -> int:
    return int(sum(t.nbytes for t in tensors))


@pytest.fixture(scope="module")
def graph():
    return generate.rmat(9, 8, seed=13, weighted=True)


@pytest.mark.parametrize("parts", [1, 3])
def test_estimate_pull_is_the_ports_arrays(graph, parts):
    sh = build_pull_shards(graph, parts)
    arrays = to_device(sh.arrays, "cpu")
    prog = PageRankProgram(nv=graph.nv)
    state = pull.init_state(prog, arrays)
    est = preflight.scale_residency(preflight.estimate_pull(sh.spec), parts)
    assert est.shard_bytes == _nbytes(arrays)
    assert est.state_bytes == 2 * state.nbytes
    full = state.reshape(sh.spec.gathered_size)
    src, dst = pull.pull_gather_part(arrays.part(0), full, state[0], False)
    assert dst is None and est.gathered_bytes == src.nbytes
    assert est.total_bytes == est.shard_bytes + est.state_bytes + est.gathered_bytes
    # scatter's int64 destination index, one part at a time
    est_s = preflight.estimate_pull(sh.spec, method="scatter")
    assert est_s.gathered_bytes - src.nbytes == arrays.dst_local[0].long().nbytes


def test_estimate_pull_wide_and_destination_reads(graph):
    """CF's (V, K) state and its destination read; bf16 state."""
    sh = build_pull_shards(graph, 1)
    arrays = to_device(sh.arrays, "cpu")
    for dtype, nbytes in (("float32", 4), ("bfloat16", 2)):
        prog = cf_model.CFProgram(dtype=dtype, err_dot="vpu")
        state = pull.init_state(prog, arrays)
        est = preflight.estimate_pull(sh.spec, cf_model.K, nbytes, dst_state=True)
        assert est.state_bytes == 2 * state.nbytes
        src, dst = pull.pull_gather_part(arrays.part(0), state[0], state[0], True)
        assert est.gathered_bytes == src.nbytes + dst.nbytes


def test_estimate_push_is_the_ports_arrays(graph):
    sh = build_push_shards(graph, 1)
    prog = sssp_model.SSSPProgram(nv=graph.nv, start=0)
    arrays, parrays, carry = push.push_init(prog, sh, "cpu")
    est = preflight.estimate_push(sh.spec, sh.pspec)
    assert est.shard_bytes == _nbytes(arrays) + _nbytes(parrays)
    p = parrays.part(0)
    plan = push._push_prep(sh.pspec, sh.spec, parrays, carry)
    walk = push._sparse_walk(prog, sh.pspec, p, sh.spec.nv_pad, plan.q_vids, plan.q_vals,
                             plan.rows[0], plan.incl[0], sh.pspec.e_sp)
    old_and_new = 2 * (carry.state.nbytes + carry.q_vid.nbytes + carry.q_val.nbytes)
    assert est.state_bytes == old_and_new + _nbytes(walk)
    assert walk[2].dtype == torch.int64  # searchsorted's queue entry
    full = carry.state.reshape(sh.spec.gathered_size)
    src, _ = pull.pull_gather_part(arrays.part(0), full, carry.state[0], False)
    assert est.gathered_bytes == src.nbytes
    assert isinstance(sh.parrays, ps.PushArrays)


@pytest.mark.parametrize("wide", [False, True])
def test_estimate_pallas_pull_is_the_runners_arrays(graph, wide):
    """The block-CSR runners' device arrays: PageRank's slot indices,
    chunk tables and degrees; CF's slot weights and destination rows
    instead of degrees, and a second (C, T, K) gather."""
    bc = spmv.build_blockcsr(graph)
    nvp = bc.num_vblocks * bc.v_blk
    k = cf_model.K if wide else 1
    est = common.estimate_blockcsr(bc, k)
    runner = cf_model.make_pallas_runner if wide else pr_model.make_pallas_runner
    _, state0 = runner(graph, device="cpu", bc=bc)
    assert est.state_bytes == 2 * state0.nbytes
    layout = bc.e_src_pos.nbytes + bc.e_dst_rel.nbytes + bc.chunk_block.nbytes \
        + bc.chunk_first.nbytes
    if wide:
        layout += bc.e_weight.nbytes + bc.e_dst_rel.nbytes  # + each slot's row
    else:
        layout += 4 * nvp  # int32 degrees
    assert est.shard_bytes == layout
    vals = state0.index_select(0, torch.from_numpy(bc.e_src_pos).reshape(-1).long())
    assert est.gathered_bytes == vals.nbytes * (2 if wide else 1)


@pytest.mark.parametrize("mode", ["expand", "expand-pf", "fused", "fused-pf", "fused-mx"])
def test_routed_plan_bytes(graph, mode):
    """The exact count is the built plan's arrays on the device; the
    analytic one, from the geometry before planning, holds the expand
    families to 1 % and over-counts the fused ones by at most 25 %
    (the fill-forward and group sizes depend on the graph)."""
    sh = build_pull_shards(graph, 1)
    if mode.startswith("fused"):
        plan = expand.plan_fused_shards(sh, "sum", pf=mode != "fused",
                                        mx=mode == "fused-mx")
    else:
        plan = expand.plan_expand_shards(sh, pf=mode == "expand-pf")
    on_dev = expand.plan_to_device(plan, "cpu")
    exact = preflight.routed_plan_bytes(on_dev)
    assert exact == _nbytes(on_dev[1]) == preflight.routed_plan_bytes(plan)
    est = preflight.estimate_pull(sh.spec)
    assert preflight.add_routed(est, plan).shard_bytes == est.shard_bytes + exact
    analytic = preflight.routed_plan_bytes_analytic(sh.spec, mode)
    if mode.startswith("expand"):
        assert abs(analytic - exact) <= 0.01 * exact
    else:
        assert exact <= analytic <= 1.25 * exact


def test_routed_plan_bytes_wide(graph):
    sh = build_pull_shards(graph, 1)
    plan = expand.plan_cf_route_shards(sh)
    exact = preflight.routed_plan_bytes(plan)
    analytic = preflight.routed_plan_bytes_analytic(sh.spec, "expand", wide=True)
    assert abs(analytic - exact) <= 0.01 * exact


def _push_state_bytes(sh, prog, carry, parrays, blocks: int) -> int:
    """One part's ``blocks`` state copies, its queues old and new, and the
    sparse walk's buffer, from the port's own tensors."""
    plan = push._push_prep(sh.pspec, sh.spec, parrays, carry)
    walk = push._sparse_walk(prog, sh.pspec, parrays.part(0), sh.spec.nv_pad, plan.q_vids,
                             plan.q_vals, plan.rows[0], plan.incl[0], sh.pspec.e_sp)
    queues = carry.q_vid[0].nbytes + carry.q_val[0].nbytes
    return blocks * carry.state[0].nbytes + 2 * queues + _nbytes(walk), plan


def _exchanged(carry, plan) -> int:
    """The gathered (P, 2, f_cap) queue block and its flattened vids and
    values (one device holds every part's queues: the gathered layout)."""
    pair = torch.stack([carry.q_vid, carry.q_val.view(torch.int32)], 1)
    return pair.nbytes + plan.q_vids.nbytes + plan.q_vals.nbytes


def test_estimate_push_ring_is_the_ports_arrays(graph):
    """One resident part of the ring push: its buckets, frontier CSR and
    vertex view (the graph bytes equal the reference's estimate on the
    same specs), four state blocks with the queues and the sparse walk,
    and the exchanged queues."""
    from lux_tpu.graph import generate as ref_generate
    from lux_tpu.parallel import ring as ref_ring
    from lux_tpu.utils import preflight as ref_preflight
    from lux_tpu_torch.parallel import ring

    sh = ring.build_push_ring_shards(graph, 2)
    prog = sssp_model.SSSPProgram(nv=graph.nv, start=0)
    arrays, parrays, carry = push.push_init(prog, sh.push, "cpu")
    est = preflight.estimate_push_ring(sh.spec, sh.pspec, sh.e_bucket_pad)
    one = [torch.from_numpy(a[0]) for a in sh.rarrays] + list(parrays.part(0)) + [
        arrays.global_vid[0], arrays.degree[0], arrays.vtx_mask[0]]
    assert est.shard_bytes == _nbytes(one)
    state, plan = _push_state_bytes(sh, prog, carry, parrays, 4)
    assert est.state_bytes == state
    assert est.gathered_bytes == _exchanged(carry, plan)
    rsh = ref_ring.build_push_ring_shards(ref_generate.rmat(9, 8, seed=13, weighted=True), 2)
    assert est.shard_bytes == ref_preflight.estimate_push_ring(
        rsh.spec, rsh.pspec, rsh.e_bucket_pad).shard_bytes


def test_estimate_push_pallas_is_the_ports_arrays(graph):
    """The one part of a rank of the block-CSR push: its chunks, frontier
    CSR and vertex view (the reference's graph bytes on the same specs),
    two state blocks with the queues and the walk, and the gathered state,
    the (C, T) slot values and the exchanged queues."""
    from lux_tpu.graph import generate as ref_generate
    from lux_tpu.parallel import pallas_dist as ref_pd
    from lux_tpu.utils import preflight as ref_preflight
    from lux_tpu_torch.parallel import pallas_dist

    sh = pallas_dist.build_push_pallas_shards(graph, 2, v_blk=128, t_chunk=128)
    prog = sssp_model.WeightedSSSPProgram(nv=graph.nv, start=0)
    arrays, parrays, carry = push.push_init(prog, sh.push, "cpu")
    C = sh.pl.e_src_pos.shape[1]
    est = preflight.estimate_push_pallas(sh.spec, sh.pspec, C, sh.t_chunk)
    chunks = [torch.from_numpy(getattr(sh.pl, f)[0]) for f in
              ("e_src_pos", "e_dst_rel", "e_weight", "chunk_block", "chunk_first")]
    view = [arrays.global_vid[0], arrays.degree[0], arrays.vtx_mask[0]]
    assert est.shard_bytes == _nbytes(chunks + list(parrays.part(0)) + view)
    state, plan = _push_state_bytes(sh, prog, carry, parrays, 2)
    assert est.state_bytes == state
    full = carry.state.reshape(-1)
    vals = full.index_select(0, chunks[0].reshape(-1))
    assert est.gathered_bytes == full.nbytes + vals.nbytes + _exchanged(carry, plan)
    rsh = ref_pd.build_push_pallas_shards(ref_generate.rmat(9, 8, seed=13, weighted=True), 2,
                                          v_blk=128, t_chunk=128)
    assert est.shard_bytes == ref_preflight.estimate_push_pallas(
        rsh.spec, rsh.pspec, rsh.pl.e_src_pos.shape[1], rsh.t_chunk).shard_bytes


def test_check_fits(capsys):
    est = preflight.MemoryEstimate(1 << 30, 1 << 29, 1 << 28, (1 << 30) + (3 << 28))
    assert preflight.check_fits(est, hbm_bytes=2 << 30)
    assert capsys.readouterr().out == ""
    assert not preflight.check_fits(est, hbm_bytes=1 << 30)
    assert "WARNING: estimated 1.75 GiB exceeds device memory 1.00 GiB" in \
        capsys.readouterr().out
    assert preflight.check_fits(est, device="cpu")
    assert "memory check skipped" in capsys.readouterr().out
    assert preflight.device_memory_bytes("cpu") is None
    assert "per-device memory estimate: graph 1.000 GiB + state 0.500 GiB" in str(est)


def test_estimate_exchange_counts_every_part_and_the_plan(graph):
    sh = build_pull_shards(graph, 2)
    cfg = parse_args(["--device", "cpu", "--route-gather", "fused-mx"])
    est = common.estimate_exchange(sh, cfg)
    base = preflight.scale_residency(preflight.estimate_pull(sh.spec), 2)
    extra = 2 * preflight.routed_plan_bytes_analytic(sh.spec, "fused-mx")
    assert est.total_bytes == base.total_bytes + extra
    cfg = parse_args(["--device", "cpu", "--dtype", "bfloat16"])
    assert common.estimate_exchange(build_pull_shards(graph, 1), cfg).state_bytes == \
        2 * build_pull_shards(graph, 1).spec.nv_pad * 2


def test_kcore_and_triangle_estimates_are_their_arrays():
    """The generic driver's estimates: k-core's int32 flags; triangles'
    (V, words) bitsets and phase 2's two per-edge gathers."""
    gs = wl.symmetrize(generate.rmat(8, 6, seed=3))
    sh = build_pull_shards(gs, 1)
    arrays = to_device(sh.arrays, "cpu")
    cfg = parse_args(["--device", "cpu"], program=True)
    prog = bind(library.KCORE, kk=1)
    state = pull.init_state(prog, arrays)
    est = common.estimate_exchange(sh, cfg)
    assert est.state_bytes == 2 * state.nbytes
    words = (gs.nv + 31) // 32
    phase1 = wl.BitPatterns(bind(library.TRI_NEIGHBORS, w=words, width=words))
    bits = pull.init_state(phase1, arrays)
    est = common.estimate_exchange(sh, cfg, state_width=words, dst_state=True)
    assert est.state_bytes == 2 * bits.nbytes
    load, _, _ = pull.compile_pull_phases(bind(library.TRI_COUNT), sh.spec, "scan")
    src, dst = load(arrays, bits)[0]
    assert est.gathered_bytes == src.nbytes + dst.nbytes


@pytest.mark.parametrize("main, argv", [
    (pagerank.main, ["-ni", "2"]),
    (pagerank.main, ["-ni", "2", "--method", "pallas"]),
    (pagerank.main, ["-ni", "2", "--route-gather", "expand"]),
    (colfilter.main, ["-ni", "2"]),
    (colfilter.main, ["-ni", "2", "--method", "pallas"]),
    (sssp.main, []),
    (components.main, ["--route-gather", "expand"]),
    (run_app.main, ["kcore"]),
    (run_app.main, ["labelprop", "-ni", "2"]),
])
def test_apps_print_the_estimate_before_set_up(main, argv, capsys):
    lead = argv[:1] if main is run_app.main else []
    rest = argv[1:] if main is run_app.main else argv
    assert main(lead + ["--rmat-scale", "7", "--rmat-ef", "4", "--device", "cpu"] + rest) == 0
    out = capsys.readouterr().out
    assert out.index("per-device memory estimate") < out.index("ELAPSED TIME")
    assert "memory check skipped" in out


def _batched_peak(sh, arrays, app, method, q):
    """(peak bytes of one batched iteration on the CPU: the arrays, the
    state and the most the iteration held at once, from the profiler's
    allocation record; the gather and edge values; the new state)."""
    import json as _json
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from lux_tpu_torch.serve import batched

    prog = batched.make_program(app, sh.spec.nv)
    queries = torch.arange(q, dtype=torch.int32) % sh.spec.nv
    state = batched.batched_init(prog, arrays, queries)
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        new = batched.batched_iteration(prog, sh.spec, method, arrays, state, queries)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/mem.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            mem = [e["args"] for e in _json.load(f)["traceEvents"]
                   if e.get("name") == "[memory]"]
    base = mem[0]["Total Allocated"] - mem[0]["Bytes"]
    peak = max(m["Total Allocated"] for m in mem) - base
    full = state.reshape((sh.spec.gathered_size,) + tuple(state.shape[2:]))
    src = full.index_select(0, arrays.part(0).src_pos)
    vals = prog.edge_value(src, arrays.part(0).weights)
    return _nbytes(arrays) + state.nbytes + peak, src, vals, state, new


@pytest.mark.parametrize("q", [1, 8, 64])
@pytest.mark.parametrize("method", ["auto", "scatter"])
def test_estimate_batched_is_the_iterations_arrays(graph, method, q):
    """serve/driver's estimate: its terms are the nbytes of what one
    batched iteration allocates (the (E, Q) gather and edge values, the
    scan ladder's copy and temporary, scatter's output and index), and
    the whole is at or above the iteration's measured peak and no more
    than the new state's bytes (plus the ladder's last two rows) over
    it, for SSSP, whose relax copies its values."""
    from lux_tpu_torch.serve.batched import resolve_method

    sh = build_pull_shards(graph, 1)
    arrays = to_device(sh.arrays, "cpu")
    resolved = resolve_method(method, "sssp", graph.nv, torch.device("cpu"))
    est = preflight.estimate_batched(sh.spec, q, resolved)
    peak, src, vals, state, new = _batched_peak(sh, arrays, "sssp", resolved, q)
    E, V = sh.spec.e_pad, sh.spec.nv_pad
    assert est.shard_bytes == _nbytes(arrays)
    assert est.state_bytes == state.nbytes + new.nbytes
    if resolved == "scatter":
        idx = arrays.dst_local[0].long()
        out = torch.empty((V + 1, q), dtype=vals.dtype)
        want = max(src.nbytes + vals.nbytes, vals.nbytes + out.nbytes + 2 * idx.nbytes)
    else:
        ladder, tmp = vals.clone(), vals[1:].clone()
        want = max(vals.nbytes + ladder.nbytes + tmp.nbytes + q * 4 + E,
                   2 * vals.nbytes + 3 * state.nbytes)
    assert est.gathered_bytes == want
    assert peak <= est.total_bytes <= peak + new.nbytes + 2 * q * 4
    # PPR's f32 relax reads the gather in place: the estimate still holds
    ppr_peak = _batched_peak(sh, arrays, "ppr", resolved, q)[0]
    assert ppr_peak <= est.total_bytes


def test_serve_driver_prints_the_batched_estimate(capsys):
    from lux_tpu_torch.apps import sssp as sssp_app

    res = sssp_app.run(["--rmat-scale", "8", "--serve", "--serve-queries", "8",
                        "--serve-buckets", "1,8", "--device", "cpu"])
    g = generate.rmat(8, 8, seed=0)
    sh = build_pull_shards(g, 1)
    est = preflight.estimate_batched(sh.spec, 8, res.method)
    assert res.estimate_bytes == est.total_bytes
    assert str(est) in capsys.readouterr().out
