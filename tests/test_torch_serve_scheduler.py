"""serve/scheduler and serve/metrics in lux_tpu_torch vs lux_tpu, on the
CPU.  The policy cases mirror tests/test_serve_scheduler.py: coalescing,
deadlines, backpressure and cold degradation, driven by an injected
clock (no sleeps, no wall-clock waits) and a fake engine cache.  Then the
port and the reference scheduler replay one script side by side (same
dispatches, same metrics), the metrics' Prometheus text and reservoir
are compared line for line, and a real burst through the port's warm
engines answers what the reference's engine answers."""
import numpy as np
import pytest

from lux_tpu.graph import csc as ref_csc
from lux_tpu.graph.shards import build_pull_shards as ref_build_pull
from lux_tpu.serve import batched as ref_batched
from lux_tpu.serve import metrics as ref_metrics
from lux_tpu.serve import scheduler as ref_scheduler
from lux_tpu.utils import timing as ref_timing
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.shards import build_pull_shards
from lux_tpu_torch.serve import metrics as metrics_mod
from lux_tpu_torch.serve.metrics import ServeMetrics
from lux_tpu_torch.serve.scheduler import (MicroBatchScheduler, RejectedError,
                                           ServeTimeoutError)
from lux_tpu_torch.serve.warm import WarmEngineCache
from lux_tpu_torch.utils import timing


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeResult:
    def __init__(self, queries):
        self.queries = list(queries)
        self.iters = 3
        self.rounds = np.full(len(queries), 3, np.int32)
        self.traversed = [100] * len(queries)

    def query_state(self, i):
        return np.asarray([self.queries[i]])  # echo the query back


class FakeEngine:
    def __init__(self, q, fail=False, clock=None):
        self.q = q
        self.fail = fail
        self.clock = clock
        self.calls = []

    def run(self, queries):
        assert len(queries) == self.q
        if self.fail:
            raise RuntimeError("engine exploded")
        self.calls.append(list(queries))
        if self.clock is not None:
            self.clock.t += 0.002  # a batch takes 2 ms of the fake clock
        return FakeResult(queries)


class FakeCache:
    """warm_buckets/get shim around FakeEngines."""

    def __init__(self, warm=(4,), fail=False, clock=None):
        self._warm = tuple(sorted(warm))
        self.engines = {}
        self.fail = fail
        self.clock = clock
        self.cold_traces = 0
        self.warm_hits = 0

    def warm_buckets(self, app):
        return self._warm

    def current_overlay(self):  # the reference's scheduler asks for it
        return None

    def get(self, app, q):
        eng = self.engines.setdefault(q, FakeEngine(q, fail=self.fail, clock=self.clock))
        warm = q in self._warm
        if warm:
            self.warm_hits += 1
        else:
            self.cold_traces += 1
        return eng, warm

    def stats(self):
        return {"warm_hits": self.warm_hits, "cold_traces": self.cold_traces}


def make(warm=(4,), **kw):
    clock = FakeClock()
    cache = FakeCache(warm=warm, fail=kw.pop("fail", False))
    sched = MicroBatchScheduler(cache, app="sssp", clock=clock, metrics=ServeMetrics(),
                                **kw)
    return sched, cache, clock


def test_coalesces_within_wait_window():
    sched, cache, clock = make(warm=(4,), max_wait_ms=10.0)
    futs = [sched.submit(i) for i in range(3)]
    assert sched.step() == 0  # window not elapsed, bucket not full
    assert not futs[0].done()
    clock.t = 0.011  # past max_wait_ms
    assert sched.step() == 3
    # one batch in the smallest covering bucket, padded with the first query
    assert cache.engines[4].calls == [[0, 1, 2, 0]]
    assert [f.result(timeout=0)[0] for f in futs] == [0, 1, 2]
    b = sched.metrics.batches[0]
    assert (b.q, b.real, b.warm) == (4, 3, True)


def test_injected_now_overrides_the_clock():
    sched, cache, clock = make(warm=(4,), max_wait_ms=10.0)
    sched.submit(5)
    assert sched.step(now=0.005) == 0
    assert sched.step(now=0.010) == 1
    assert cache.engines[4].calls == [[5, 5, 5, 5]]
    assert clock.t == 0.0


def test_full_bucket_dispatches_without_waiting():
    sched, cache, clock = make(warm=(2, 4), max_wait_ms=1e6)
    for i in range(4):
        sched.submit(i)
    assert sched.step() == 4
    assert cache.engines[4].calls == [[0, 1, 2, 3]]


def test_overflow_drains_in_bucket_sized_batches():
    sched, cache, clock = make(warm=(4,), max_wait_ms=0.0)
    futs = [sched.submit(i) for i in range(6)]
    assert sched.step() == 4
    assert sched.pending() == 2
    assert sched.step() == 2
    assert cache.engines[4].calls == [[0, 1, 2, 3], [4, 5, 4, 4]]
    assert all(f.done() for f in futs)


def test_deadline_expiry_returns_timeout_not_hang():
    sched, cache, clock = make(warm=(4,), max_wait_ms=1e6)
    fut = sched.submit(7, timeout_ms=5.0)
    clock.t = 0.006
    assert sched.step() == 1  # resolved AS a timeout
    with pytest.raises(ServeTimeoutError):
        fut.result(timeout=0)
    assert sched.metrics.timeouts == 1
    assert cache.engines == {}


def test_result_wall_guard_never_hangs():
    sched, _, _ = make()
    fut = sched.submit(1)
    with pytest.raises(ServeTimeoutError):
        fut.result(timeout=0)  # nobody is pumping: the guard fires at once


def test_tight_deadline_forces_early_dispatch():
    sched, cache, clock = make(warm=(4,), max_wait_ms=1000.0)
    fut = sched.submit(3, timeout_ms=50.0)
    assert sched.step() == 1  # waiting 1 s would blow the 50 ms deadline
    assert fut.result(timeout=0)[0] == 3


def test_bounded_queue_rejects_with_retry_after():
    sched, _, clock = make(warm=(4,), max_queue=2, max_wait_ms=1e6)
    sched.submit(0)
    sched.submit(1)
    with pytest.raises(RejectedError) as e:
        sched.submit(2)
    assert e.value.retry_after_ms > 0
    assert sched.metrics.rejected == 1
    assert sched.pending() == 2


def test_cold_shape_degrades_to_q1():
    sched, cache, clock = make(warm=(), max_wait_ms=0.0)
    futs = [sched.submit(i) for i in range(3)]
    for _ in range(3):
        assert sched.step() == 1
    assert cache.engines[1].calls == [[0], [1], [2]]
    assert cache.cold_traces == 3
    assert [f.result(timeout=0)[0] for f in futs] == [0, 1, 2]
    assert sched.metrics.summary()["warm_batch_ratio"] == 0.0


def test_engine_failure_resolves_requests_with_error():
    sched, cache, clock = make(warm=(2,), max_wait_ms=0.0, fail=True)
    fut = sched.submit(5)
    sched.step()
    with pytest.raises(RuntimeError, match="engine exploded"):
        fut.result(timeout=0)


def test_metrics_summary_shape():
    sched, cache, clock = make(warm=(4,), max_wait_ms=0.0)
    for i in range(4):
        sched.submit(i)
    sched.step()
    s = sched.metrics.summary(elapsed_s=1.0, cache_stats=cache.stats())
    assert s["completed"] == 4 and s["qps"] == 4.0
    assert s["batch_occupancy"] == 1.0
    assert set(s["latency_ms"]) == {"p50", "p95", "p99"}
    assert s["engine_cache"]["warm_hits"] == 1


def _script(mod_sched, mod_metrics, warm):
    """One scripted service life: submits, expiries, rejections and
    dispatches on a fake clock whose batches take 2 ms.  Returns the
    engine calls, the futures' outcomes and the metrics."""
    clock = FakeClock()
    cache = FakeCache(warm=warm, clock=clock)
    metrics = mod_metrics.ServeMetrics()
    sched = mod_sched.MicroBatchScheduler(cache, app="sssp", max_wait_ms=3.0,
                                          max_queue=6, clock=clock, metrics=metrics)
    sched.snapshot_every_s = 0  # the reference's flight-recorder cadence: off
    outcomes, futs = [], []
    for step in range(40):
        clock.t = step * 1e-3
        for k in range(step % 3):
            try:
                futs.append(sched.submit(step * 10 + k,
                                         timeout_ms=4.0 if step % 5 == 0 else None))
            except Exception as e:  # noqa: BLE001
                outcomes.append(("rejected", type(e).__name__, round(e.retry_after_ms, 6)))
        sched.step()
    sched.step(now=1.0)
    for f in futs:
        try:
            outcomes.append(("ok", int(f.result(timeout=0)[0]), f.rounds,
                             f.traversed_edges))
        except Exception as e:  # noqa: BLE001
            outcomes.append(("error", type(e).__name__))
    calls = {q: e.calls for q, e in cache.engines.items()}
    return calls, outcomes, metrics


@pytest.mark.parametrize("warm", [(), (2,), (1, 4)])
def test_scheduler_replays_the_reference_policy(warm):
    got = _script(__import__("lux_tpu_torch.serve.scheduler", fromlist=["x"]),
                  metrics_mod, warm)
    want = _script(ref_scheduler, ref_metrics, warm)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2].summary(elapsed_s=0.04) == want[2].summary(elapsed_s=0.04)
    assert got[2].counters() == want[2].counters()
    assert got[2].dump(elapsed_s=0.04, cache_stats={"warm_hits": 3, "cold_traces": 1},
                       replica="w0", exemplars=False) == \
        want[2].dump(elapsed_s=0.04, cache_stats={"warm_hits": 3, "cold_traces": 1},
                     replica="w0", exemplars=False)


def test_latency_histogram_reservoir_matches_reference():
    mine, ref = timing.LatencyHistogram(max_samples=64), ref_timing.LatencyHistogram(
        max_samples=64)
    rng = np.random.default_rng(5)
    for x in rng.exponential(0.01, 1000):
        mine.record(x)
        ref.record(x)
    assert len(mine) == len(ref) == 1000
    assert mine.samples == ref.samples
    assert mine.summary_ms() == ref.summary_ms()
    vals = rng.random(37)
    assert timing.percentiles(vals, (1, 50, 90, 99, 100)) == \
        ref_timing.percentiles(vals, (1, 50, 90, 99, 100))
    assert timing.percentiles([]) == {}


def test_metrics_prometheus_text_and_scrape():
    m = ServeMetrics()
    assert m.summary() == ref_metrics.ServeMetrics().summary()
    m.record_batch(q=4, real=3, warm=True, service_s=0.01)
    m.record_done(latency_s=0.02, wait_s=0.005, traversed=10, trace="abc")
    m.record_eviction()
    m.sample_queue_depth(3)
    text = m.scrape(queue_depth=2, cache_stats={"warm_hits": 1, "cold_traces": 1,
                                                "warm_hit_ratio": 0.5},
                    extra_gauges=(("lux_x", 7, "a gauge"),))
    assert 'lux_serve_request_latency_seconds_bucket{le="0.025"} 1' in text
    assert "lux_serve_queue_depth 2" in text and "lux_x 7" in text
    assert "lux_serve_warm_hit_ratio 0.5" in text and "lux_serve_qps " in text
    assert "trace_id" not in text  # exemplars come with obs
    assert m.exemplars() == {}
    assert m.emit_snapshot() is None
    assert m.counters()["evictions"] == 1


def test_threaded_loop_end_to_end():
    """Background-thread mode with the real clock (a tiny window)."""
    cache = FakeCache(warm=(4,))
    sched = MicroBatchScheduler(cache, app="sssp", max_wait_ms=2.0,
                                metrics=ServeMetrics()).start()
    try:
        futs = [sched.submit(i) for i in range(3)]
        assert [f.result(timeout=5.0)[0] for f in futs] == [0, 1, 2]
    finally:
        sched.stop()


@pytest.mark.parametrize("app", ["sssp", "ppr"])
def test_real_burst_answers_like_the_reference_engine(app):
    """A burst through the port's scheduler and warm engines (one thread
    pumping on the CPU) answers each request as the reference's
    BatchedEngine does: SSSP bitwise, PPR within rtol 1e-5."""
    g = generate.rmat(8, 8, seed=17)
    rg = ref_csc.HostGraph(g.nv, g.ne, g.row_ptr.copy(), g.col_idx.copy())
    cache = WarmEngineCache(build_pull_shards(g, 2), apps=(app,), q_buckets=(1, 4),
                            num_iters=5, device="cpu")
    cache.prewarm()
    clock = FakeClock()
    sched = MicroBatchScheduler(cache, app=app, max_wait_ms=1.0, clock=clock)
    srcs = [3, 9, 27, 81, 5, 6]
    futs = [sched.submit(s) for s in srcs]
    assert sched.step() == 4
    clock.t = 0.002
    assert sched.step() == 2
    want = ref_batched.BatchedEngine(ref_build_pull(rg, 2), app, 6, method="scan",
                                     num_iters=5).run(np.asarray(srcs, np.int32))
    for i, f in enumerate(futs):
        if app == "sssp":
            np.testing.assert_array_equal(f.result(timeout=0), np.asarray(want.state[i]))
        else:
            np.testing.assert_allclose(f.result(timeout=0), np.asarray(want.state[i]),
                                       rtol=1e-5, atol=0)
        assert f.rounds == int(want.rounds[i])
        assert f.traversed_edges == want.traversed[i]
    s = sched.metrics.summary()
    assert (s["completed"], s["batches"], s["batch_occupancy"]) == (6, 2, 0.75)
    assert cache.stats()["warm_hits"] == 2


def test_concurrent_submitters_lose_no_request():
    """Stress: more submitting threads than cores against the background
    pump, with a short switch interval; every request is answered once,
    with its own query, and the counters add up."""
    import os
    import sys
    import threading

    cache = FakeCache(warm=(1, 4, 8))
    metrics = ServeMetrics()
    sched = MicroBatchScheduler(cache, app="sssp", max_wait_ms=0.5, max_queue=10_000,
                                metrics=metrics)
    n_threads, per = 2 * (os.cpu_count() or 4), 40
    results = {}
    lock = threading.Lock()

    def client(t):
        futs = [(t * per + i, sched.submit(t * per + i)) for i in range(per)]
        got = {q: int(f.result(timeout=30)[0]) for q, f in futs}
        with lock:
            results.update(got)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    sched.start()
    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
        sched.stop()
    n = n_threads * per
    assert results == {q: q for q in range(n)}
    s = metrics.summary()
    assert s["completed"] == n and s["timeouts"] == 0 and s["rejected"] == 0
    assert s["batches"] == sum(len(e.calls) for e in cache.engines.values())
    served = sorted(q for e in cache.engines.values() for c in e.calls for q in set(c))
    assert served == list(range(n))
