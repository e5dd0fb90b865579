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
