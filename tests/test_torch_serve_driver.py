"""The --serve driver of lux_tpu_torch (serve/driver.py, serve/benchmarks.py
and the apps' --serve branch) vs lux_tpu's, on the CPU: both apps'
`--serve --device cpu -check` exit 0 and print a JSON line whose keys are
the reference's minus ``run_id``; the refusals, the source draw and the
check are the reference's; LUX_SERVE_PROM writes the Prometheus text."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lux_tpu.apps import pagerank as ref_pr_app
from lux_tpu.apps import sssp as ref_sssp_app
from lux_tpu.graph import csc as ref_csc
from lux_tpu.serve import benchmarks as ref_benchmarks
from lux_tpu_torch.apps import components as cc_app
from lux_tpu_torch.apps import pagerank as pr_app
from lux_tpu_torch.apps import sssp as sssp_app
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.shards import build_pull_shards
from lux_tpu_torch.serve import benchmarks, driver
from lux_tpu_torch.utils.config import parse_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--rmat-scale", "9", "--rmat-ef", "8"]
CPU = ["--device", "cpu"]


def _metric_line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith('{"metric"')][-1])


def _keys(d: dict, prefix: str = "") -> set:
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_serve_cli_exits_0_with_the_reference_keys(app, capsys):
    """The module entry (a subprocess that never imports jax) exits 0
    under -check; its JSON line carries the reference's keys but run_id."""
    argv = SMALL + ["--serve", "--serve-queries", "16", "-check"]
    if app == "pagerank":
        argv += ["-ni", "5"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-m", f"lux_tpu_torch.apps.{app}"] + argv + CPU,
                          capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    mine = _metric_line(proc.stdout)
    name = "sssp" if app == "sssp" else "ppr"
    assert f"[PASS] {name} serve check: 0 violations" in proc.stdout
    assert "per-device memory estimate:" in proc.stdout.split('{"metric"')[0]
    ref_main = ref_sssp_app.main if app == "sssp" else ref_pr_app.main
    assert ref_main(argv) == 0
    ref = _metric_line(capsys.readouterr().out)
    assert _keys(mine) == _keys(ref) - {"run_id"}
    assert mine["metric"] == ref["metric"] == f"{name}_serve"
    for k in ("completed", "timeouts", "rejected", "batches", "batch_occupancy",
              "warm_batch_ratio", "queries", "traversed_edges"):
        assert mine[k] == ref[k], k
    assert mine["engine_cache"]["warm_hit_ratio"] == 1.0


def test_serve_answers_and_result(capsys):
    res = sssp_app.run(SMALL + CPU + ["--serve", "--serve-sources", "3,9",
                                      "--serve-buckets", "2", "-check"])
    assert res.rc == 0 and res.summary["completed"] == 2
    assert res.method == "scan" and res.peak_bytes is None and res.estimate_bytes > 0
    np.testing.assert_array_equal(res.sources, [3, 9])
    g = generate.rmat(9, 8, seed=0)
    from lux_tpu_torch.models.sssp import sssp

    for s, a in zip(res.sources, res.answers):
        np.testing.assert_array_equal(a, sssp(g, start=int(s), device="cpu"))
    assert sssp_app.main(SMALL + CPU + ["--serve", "--serve-queries", "3",
                                        "--serve-buckets", "4"]) == 0
    assert '"batch_occupancy": 0.75' in capsys.readouterr().out


def test_serve_backpressure_loop_serves_every_request(capsys):
    """A burst larger than the admission bound: the driver pumps and
    retries, and every request is answered."""
    assert pr_app.main(SMALL + CPU + ["-ni", "3", "--serve", "--serve-queries", "9",
                                      "--serve-buckets", "2", "--serve-max-queue", "2",
                                      "-check"]) == 0
    stats = _metric_line(capsys.readouterr().out)
    assert stats["completed"] == 9 and stats["rejected"] > 0


def test_serve_refusals_match_reference():
    cases = [(["--serve", "--weighted"], "does not combine"),
             (["--serve", "--method", "pallas"], "does not combine"),
             (["--serve", "--route-gather", "expand"], "does not combine"),
             (["--serve", "--ckpt-dir", "d", "--ckpt-every", "2"], "does not combine"),
             (["--serve", "-verbose"], "does not combine"),
             (["--serve", "--repartition-every", "2"], "does not combine"),
             (["--serve", "--serve-sources", "1,x"], "bad vertex list"),
             (["--serve", "--serve-sources", "999999"], "must be in"),
             (["--serve", "--serve-buckets", "0,4"], "buckets must be"),
             (["--serve", "--serve-queries", "0"], "must be >= 1")]
    for extra, msg in cases:
        for main in (sssp_app.main, ref_sssp_app.main):
            with pytest.raises(SystemExit, match=msg):
                main(SMALL + extra + (CPU if main is sssp_app.main else []))
    for extra in (["--stream-hbm-gib", "0.1"], ["--dtype", "bfloat16"]):
        for main in (pr_app.main, ref_pr_app.main):
            with pytest.raises(SystemExit):
                main(SMALL + ["--serve"] + extra + (CPU if main is pr_app.main else []))
    with pytest.raises(SystemExit):  # components takes no --serve
        cc_app.main(SMALL + CPU + ["--serve"])


def test_serve_flags_parse():
    cfg = parse_args(SMALL + ["--serve", "--serve-queries", "7", "--serve-sources", "1,2",
                              "--serve-buckets", "8,1", "--serve-wait-ms", "1.5",
                              "--serve-timeout-ms", "20", "--serve-max-queue", "9"],
                     serve=True)
    assert (cfg.serve, cfg.serve_queries, cfg.serve_sources, cfg.serve_buckets) == \
        (True, 7, "1,2", "8,1")
    assert (cfg.serve_wait_ms, cfg.serve_timeout_ms, cfg.serve_max_queue) == (1.5, 20.0, 9)
    assert driver.parse_buckets("8,1,8") == (1, 8)
    assert not parse_args(SMALL).serve


def test_serve_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (sssp_app.main, pr_app.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(SMALL + ["--serve", "--device", "cuda"])


def test_pick_sources_is_the_reference_draw():
    g = generate.rmat(8, 4, seed=6)
    rg = ref_csc.HostGraph(g.nv, g.ne, g.row_ptr.copy(), g.col_idx.copy())
    for n, seed in ((8, 1), (3, 0), (1000, 2)):
        got = benchmarks.pick_sources(g, n, seed=seed)
        np.testing.assert_array_equal(got, ref_benchmarks.pick_sources(rg, n, seed=seed))
        assert len(got) == n and (g.out_degrees()[got] > 0).all()


def test_check_binds_answers_to_their_requests():
    g = generate.rmat(8, 4, seed=6)
    cfg = parse_args(["-ni", "4"], serve=True)
    srcs = benchmarks.pick_sources(g, 3, seed=0)
    from lux_tpu_torch.models import pagerank, sssp

    good = [sssp.bfs_reference(g, int(s)) for s in srcs]
    assert driver._check_answers("sssp", g, cfg, srcs, good) == 0
    assert driver._check_answers("sssp", g, cfg, srcs, good[::-1]) >= 2
    ranks = [pagerank.ppr_reference(g, int(s), 4) for s in srcs]
    assert driver._check_answers("ppr", g, cfg, srcs, ranks) == 0
    assert driver._check_answers("ppr", g, cfg, srcs, ranks[::-1]) > 0


def test_prometheus_artifact(tmp_path, monkeypatch, capsys):
    path = tmp_path / "serve.prom"
    monkeypatch.setenv("LUX_SERVE_PROM", str(path))
    assert sssp_app.main(SMALL + CPU + ["--serve", "--serve-queries", "4",
                                        "--serve-buckets", "4"]) == 0
    text = path.read_text()
    assert "lux_serve_requests_completed_total 4" in text
    assert "lux_serve_warm_hit_ratio 1.0" in text and "# {" not in text
    monkeypatch.setenv("LUX_SERVE_PROM", str(tmp_path / "no" / "dir" / "x.prom"))
    assert sssp_app.main(SMALL + CPU + ["--serve", "--serve-queries", "2",
                                        "--serve-buckets", "2"]) == 0
    assert "NOT written" in capsys.readouterr().err


@pytest.mark.parametrize("app", ["sssp", "ppr"])
def test_measure_serving_fields(app):
    g = generate.rmat(9, 6, seed=8)
    res = benchmarks.measure_serving(g, build_pull_shards(g, 1), app=app, q=4, num_seq=2,
                                     batched_reps=1, device="cpu")
    for k in ("qps_batched", "qps_q1_sequential", "batched_vs_q1", "latency_ms",
              "traversed_edges", "scheduler", "method", "warm_trace_s", "batch_ms"):
        assert k in res, k
    assert res["platform"] == "cpu" and res["method"] == "scan"
    assert res["qps_batched"] > 0 and res["qps_q1_sequential"] > 0
    assert res["scheduler"]["completed"] == 4 and res["scheduler"]["timeouts"] == 0
    assert json.dumps(res)
