"""The port's obs stack (``repro_torch.obs``) on the CPU: the launcher-free
tests of ``tests/test_obs.py`` run against the port's tracer, metrics,
logging and report CLI, then the two packages against each other: the same
histogram buckets and quantiles on seeded values, byte-identical trace
files for the same records, and each package's ``report.analyze`` reading
the other's dumps to the same result.  (The traced distributed run is in
``tests/test_torch_launcher.py``.)
"""
from __future__ import annotations

import json
import threading

import numpy as np
import pytest

from repro.obs import metrics as jax_metrics
from repro.obs import report as jax_report
from repro.obs import trace as jax_trace
from repro_torch.obs import log as obs_log
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import report as obs_report
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import Tracer


@pytest.fixture(autouse=True)
def _reset_tracer():
    """Every test starts and ends with the no-op singleton installed."""
    obs_trace.disable()
    jax_trace.disable()
    yield
    obs_trace.disable()
    jax_trace.disable()


# ---------------------------------------------------------------------------
# Tracer mechanics
# ---------------------------------------------------------------------------


def test_spans_are_complete_and_ordered():
    tr = Tracer(capacity=128)
    for i in range(5):
        t0 = tr.t()
        tr.rec(obs_trace.CHUNK_READ, t0, a=i)
    recs, tids, dropped = tr.records()
    assert len(recs) == 5 and dropped == 0
    assert (recs["t1"] >= recs["t0"]).all(), "a span must not end before it begins"
    assert (np.diff(recs["t0"]) >= 0).all(), "export must be sorted by t0"
    assert recs["a"].tolist() == [0, 1, 2, 3, 4]
    assert all(t == threading.current_thread().name for t in tids)


def test_span_context_manager_and_instant():
    tr = Tracer(capacity=16)
    with tr.span(obs_trace.PEER_FETCH, a=3):
        pass
    tr.instant(obs_trace.PEER_RETRY, a=3, b=1)
    recs, _, _ = tr.records()
    assert len(recs) == 2
    fetch = recs[recs["kind"] == obs_trace.PEER_FETCH][0]
    retry = recs[recs["kind"] == obs_trace.PEER_RETRY][0]
    assert fetch["t1"] >= fetch["t0"]
    assert retry["t0"] == retry["t1"], "an instant is a zero-width span"


def test_step_stamp_rides_every_record():
    tr = Tracer(capacity=16)
    tr.set_step(7)
    tr.instant(obs_trace.SERVE_SHED)
    tr.set_step(8)
    tr.instant(obs_trace.SERVE_SHED)
    recs, _, _ = tr.records()
    assert recs["step"].tolist() == [7, 8]


def test_ring_wraparound_keeps_newest_and_counts_drops():
    tr = Tracer(capacity=8)
    for i in range(20):
        t0 = tr.t()
        tr.rec(obs_trace.STEP, t0, a=i)
    recs, _, dropped = tr.records()
    assert len(recs) == 8, "a full ring holds exactly capacity rows"
    assert dropped == 12, "overwritten rows must be accounted"
    assert recs["a"].tolist() == list(range(12, 20)), (
        "wraparound must keep the newest records in order"
    )


def test_per_thread_rings_merge_sorted():
    tr = Tracer(capacity=64)

    def worker():
        for _ in range(10):
            tr.instant(obs_trace.PREFETCH_QWAIT)

    threads = [threading.Thread(target=worker, name=f"w{i}") for i in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    tr.instant(obs_trace.STEP)
    recs, tids, dropped = tr.records()
    assert len(recs) == 31 and dropped == 0
    assert (np.diff(recs["t0"]) >= 0).all()
    assert {t for t in tids} >= {"w0", "w1", "w2"}


def test_kind_interning_is_stable():
    assert obs_trace.kind_id("chunk.read") == obs_trace.CHUNK_READ
    kid = obs_trace.kind_id("fault.crash:3")
    assert obs_trace.kind_id("fault.crash:3") == kid
    assert obs_trace.kind_name(kid) == "fault.crash:3"


# ---------------------------------------------------------------------------
# Export schemas
# ---------------------------------------------------------------------------


def _traced_dump(tmp_path, n=6):
    tr = Tracer(capacity=32)
    tr.set_step(2)
    for i in range(n):
        t0 = tr.t()
        tr.rec(obs_trace.CHUNK_READ, t0, a=i, b=i * 100)
    return tr.dump(str(tmp_path), rank=1)


def test_jsonl_export_schema(tmp_path):
    out = _traced_dump(tmp_path)
    lines = [
        json.loads(s) for s in open(out["jsonl"]) if s.strip()
    ]
    meta, records = lines[0], lines[1:]
    assert meta["meta"] and meta["rank"] == 1 and meta["clock"] == "perf_counter"
    assert meta["records"] == len(records) == 6
    assert meta["dropped"] == 0
    for r in records:
        assert set(r) == {"name", "ts", "dur", "step", "a", "b", "tid"}
        assert r["name"] == "chunk.read" and r["dur"] >= 0 and r["step"] == 2


def test_chrome_export_schema(tmp_path):
    out = _traced_dump(tmp_path)
    doc = json.load(open(out["chrome"]))
    events = doc["traceEvents"]
    assert len(events) == 6
    for ev in events:
        assert ev["ph"] == "X", "complete events only"
        assert ev["pid"] == 1, "pid is the rank"
        assert ev["dur"] >= 0 and isinstance(ev["ts"], float)
        assert set(ev["args"]) == {"step", "a", "b"}
    assert doc["otherData"]["rank"] == 1


# ---------------------------------------------------------------------------
# Disabled tracer: the no-op contract
# ---------------------------------------------------------------------------


def test_null_tracer_records_nothing():
    tr = obs_trace.get()
    assert not tr.enabled
    assert tr.t() == 0.0, "disabled timestamping must not touch the clock"
    tr.rec(obs_trace.STEP, 0.0)
    tr.instant(obs_trace.STEP)
    tr.set_step(5)
    with tr.span(obs_trace.STEP):
        pass
    live = obs_trace.enable(capacity=8)
    recs, _, _ = live.records()
    assert len(recs) == 0, "the null tracer must have dropped everything"


def test_enable_disable_roundtrip():
    assert obs_trace.disable() is None, "no live tracer yet"
    live = obs_trace.enable(capacity=8)
    assert obs_trace.get() is live
    live.instant(obs_trace.STEP)
    back = obs_trace.disable()
    assert back is live
    assert not obs_trace.get().enabled


# ---------------------------------------------------------------------------
# Metrics: deterministic histograms + registry folding
# ---------------------------------------------------------------------------


def test_bucket_index_is_log2_and_clamped():
    assert obs_metrics.bucket_index(0) == 0
    assert obs_metrics.bucket_index(-3.0) == 0
    assert obs_metrics.bucket_index(1) == 1      # [1, 2) us
    assert obs_metrics.bucket_index(2) == 2      # [2, 4) us
    assert obs_metrics.bucket_index(3) == 2
    assert obs_metrics.bucket_index(1024) == 11
    assert obs_metrics.bucket_index(2**80) == obs_metrics.NBUCKETS - 1


def test_histogram_quantiles_are_order_invariant():
    values = [3, 900, 17, 120000, 64, 64, 5000, 2, 31, 7]
    a, b = obs_metrics.Histogram(), obs_metrics.Histogram()
    for v in values:
        a.record(v)
    for v in reversed(values):
        b.record(v)
    for q in (0.5, 0.95, 0.99):
        assert a.quantile_us(q) == b.quantile_us(q)
    # 5th smallest of the 10 values is 31 -> bucket [16, 32) -> upper bound
    assert a.quantile_us(0.5) == 32.0


def test_histogram_merge_is_exact():
    xs, ys = [10, 200, 3000], [7, 7, 450000]
    h1, h2, ref = (obs_metrics.Histogram() for _ in range(3))
    for v in xs:
        h1.record(v)
    for v in ys:
        h2.record(v)
    for v in xs + ys:
        ref.record(v)
    merged = obs_metrics.merge_histograms([h1.bucket_dict(), h2.bucket_dict()])
    assert merged.count == ref.count
    assert merged.counts == ref.counts
    for q in (0.5, 0.95, 0.99):
        assert merged.quantile_us(q) == ref.quantile_us(q)


def test_empty_histogram_quantile_is_zero():
    h = obs_metrics.Histogram()
    assert h.quantile_us(0.5) == 0.0
    assert h.bucket_dict() == {}


def test_registry_fold_never_mutates_source():
    reg = obs_metrics.MetricsRegistry()
    legacy = {"numPFS": 12, "misses": 3, "ratio": 0.25,
              "nested": {"x": 1}, "name": "solar"}
    before = dict(legacy)
    reg.fold("loader", legacy)
    assert legacy == before, "folding must read, never rewrite"
    snap = reg.snapshot()
    assert snap["counters"]["loader.numPFS"] == 12
    assert snap["counters"]["loader.misses"] == 3
    assert snap["gauges"]["loader.ratio"] == 0.25
    assert "loader.nested" not in snap["counters"]
    assert "loader.name" not in snap["counters"]


def test_latency_summary_keys():
    s, f = obs_metrics.Histogram(), obs_metrics.Histogram()
    s.record(1500)
    f.record(300)
    out = obs_metrics.latency_summary(s, f)
    assert set(out) == {
        "step_ms_p50", "step_ms_p95", "step_ms_p99", "step_count",
        "fetch_ms_p50", "fetch_ms_p95", "fetch_ms_p99", "fetch_count",
    }
    assert out["step_count"] == 1 and out["fetch_count"] == 1
    assert out["step_ms_p50"] == 2.048  # bucket [1024, 2048) us -> upper bound


# ---------------------------------------------------------------------------
# Logging satellite
# ---------------------------------------------------------------------------


def test_log_configure_levels_and_rank_tag(capsys):
    import io

    buf = io.StringIO()
    obs_log.configure(1, rank=3, stream=buf)
    lg = obs_log.get_logger("test.mod")
    lg.info("hello %d", 42)
    lg.debug("invisible at -v")
    out = buf.getvalue()
    assert "[info r3 test.mod] hello 42" in out
    assert "invisible" not in out
    obs_log.configure(0, stream=io.StringIO())  # restore default level


def test_verbosity_args_roundtrip():
    import argparse

    ap = argparse.ArgumentParser()
    obs_log.add_verbosity_args(ap)
    assert obs_log.verbosity_from(ap.parse_args([])) == 0
    assert obs_log.verbosity_from(ap.parse_args(["-v"])) == 1
    assert obs_log.verbosity_from(ap.parse_args(["-vv"])) == 2
    assert obs_log.verbosity_from(ap.parse_args(["-q"])) == -1


# ---------------------------------------------------------------------------
# Report: analyze/check over synthetic + real dumps
# ---------------------------------------------------------------------------


def _synthetic_rank_dump(tmp_path, rank=0, steps=4):
    """A hand-built minimal trace a single rank's loop would produce."""
    tr = Tracer(capacity=256)
    now = 0.0
    for s in range(steps):
        tr.set_step(s)
        t0 = now
        tr.rec(obs_trace.BARRIER_WAIT, t0, t0 + 0.002, a=s)
        tr.rec(obs_trace.CHUNK_READ, t0 + 0.002, t0 + 0.003, a=8)
        tr.rec(obs_trace.STEP_PEER, t0 + 0.003, t0 + 0.004)
        tr.rec(obs_trace.STEP_EXECUTE, t0 + 0.004, t0 + 0.009)
        tr.rec(obs_trace.STEP, t0, t0 + 0.011)
        now += 0.011
    tr.dump(str(tmp_path), rank=rank)


def test_report_analyze_attribution(tmp_path):
    _synthetic_rank_dump(tmp_path, rank=0, steps=4)
    rep = obs_report.analyze(str(tmp_path))
    r0 = rep["ranks"]["0"]
    assert r0["steps"] == 4
    assert r0["step_ms_total"] == pytest.approx(44.0, abs=0.01)
    assert r0["stage_ms_per_step"]["barrier"] == pytest.approx(2.0, abs=0.01)
    assert r0["stage_ms_per_step"]["execute"] == pytest.approx(5.0, abs=0.01)
    assert r0["detail_ms_total"]["disk_pfs"] == pytest.approx(4.0, abs=0.01)
    assert rep["cluster"]["barrier_ms_per_step"] == pytest.approx(2.0, abs=0.01)
    # 2 + 1 + 5 of 11 ms accounted by the tiling sections
    assert rep["cluster"]["coverage"] == pytest.approx(8.0 / 11.0, abs=0.01)


def test_report_check_flags_problems(tmp_path):
    # empty dir
    assert obs_report.check(str(tmp_path))
    _synthetic_rank_dump(tmp_path, rank=0)
    # healthy single-rank dump passes at a coverage bar it meets
    assert obs_report.check(str(tmp_path), min_coverage=0.5) == []
    # and fails when the bar is above what the spans account for
    fails = obs_report.check(str(tmp_path), min_coverage=0.99)
    assert any("coverage" in f for f in fails)


def test_report_check_catches_missing_chunk_reads(tmp_path):
    tr = Tracer(capacity=16)
    tr.rec(obs_trace.STEP, 0.0, 0.01)
    tr.dump(str(tmp_path), rank=0)
    fails = obs_report.check(str(tmp_path), min_coverage=0.0)
    assert any("chunk.read" in f for f in fails)


def test_report_main_check_cli(tmp_path, capsys):
    _synthetic_rank_dump(tmp_path, rank=0)
    rc = obs_report.main([str(tmp_path), "--check", "--min-coverage", "0.5"])
    assert rc == 0
    assert "trace OK" in capsys.readouterr().out
    rc = obs_report.main([str(tmp_path), "--check", "--min-coverage", "0.99"])
    assert rc == 1


# ---------------------------------------------------------------------------
# The two packages against each other
# ---------------------------------------------------------------------------


def test_kind_table_matches_the_jax_package():
    """The same well-known kinds in the same registration order: records
    carry the same kind ids in both packages."""
    names = obs_trace.kind_names()
    want = jax_trace.kind_names()
    assert names[:20] == want[:20]
    for attr in ("CHUNK_READ", "PEER_FETCH", "SERVE_SHED", "BARRIER_WAIT", "STEP",
                 "STEP_PRIME", "STEP_PEER", "STEP_EXECUTE", "HB_SEND",
                 "TRAIN_COMPUTE", "FAULT"):
        assert getattr(obs_trace, attr) == getattr(jax_trace, attr), attr


def _seeded_values(seed, n=2000):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.lognormal(6.0, 2.5, n), rng.uniform(0, 3, 50),
                           [0.0, -1.0, 2.0 ** 70]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_buckets_and_quantiles_match_the_jax_package(seed):
    values = _seeded_values(seed)
    port, ref = obs_metrics.Histogram(), jax_metrics.Histogram()
    for v in values.tolist():
        assert obs_metrics.bucket_index(v) == jax_metrics.bucket_index(v)
        port.record(v)
        ref.record(v)
    assert obs_metrics.NBUCKETS == jax_metrics.NBUCKETS
    for i in range(obs_metrics.NBUCKETS):
        assert obs_metrics.bucket_upper_us(i) == jax_metrics.bucket_upper_us(i)
    assert port.counts == ref.counts and port.count == ref.count
    for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert port.quantile_us(q) == ref.quantile_us(q)
    assert port.bucket_dict() == ref.bucket_dict()
    half = len(values) // 2
    parts = [obs_metrics.Histogram(), obs_metrics.Histogram()]
    for i, v in enumerate(values.tolist()):
        parts[i >= half].record(v)
    dicts = [h.bucket_dict() for h in parts]
    merged = obs_metrics.merge_histograms(dicts)
    assert merged.counts == jax_metrics.merge_histograms(dicts).counts == ref.counts
    assert obs_metrics.latency_summary(port, merged) == \
        jax_metrics.latency_summary(ref, jax_metrics.merge_histograms(dicts))


def test_registry_snapshot_matches_the_jax_package():
    summary = {"numPFS": 12, "misses": 3, "ratio": 0.25, "nested": {"x": 1},
               "name": "solar", "flag": True}
    port, ref = obs_metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    for reg in (port, ref):
        reg.fold("loader", summary)
        reg.fold("ladder", {"retries": 4, "breaker_opens": 0})
    assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())


def _same_records(tracers, rng_seed=5):
    """Record one seeded sequence of spans into each tracer, from this
    thread and from a named worker thread."""
    rng = np.random.default_rng(rng_seed)
    kinds = ["chunk.read", "peer.fetch", "barrier.wait", "step", "serve.shed",
             "fault.crash:3"]
    rows = [(kinds[int(rng.integers(len(kinds)))], float(t0), float(t0 + d),
             int(rng.integers(-1, 40)), int(rng.integers(0, 1 << 40)),
             int(rng.integers(-5, 5)))
            for t0, d in zip(np.cumsum(rng.uniform(0, 1e-3, 64)) + 1234.5,
                             rng.uniform(0, 5e-4, 64))]

    def record(part):
        for tr, mod in tracers:
            for name, t0, t1, step, a, b in part:
                tr.set_step(step)
                tr.rec(mod.kind_id(name), t0, t1, a=a, b=b)

    record(rows[:40])
    worker = threading.Thread(target=record, args=(rows[40:],), name="io-worker")
    worker.start()
    worker.join()


def test_trace_dumps_are_byte_identical_to_the_jax_package(tmp_path):
    port, ref = Tracer(capacity=48), jax_trace.Tracer(capacity=48)
    _same_records([(port, obs_trace), (ref, jax_trace)])
    out = port.dump(str(tmp_path / "port"), rank=3)
    want = ref.dump(str(tmp_path / "jax"), rank=3)
    assert out["records"] == want["records"] == 40 + 24
    assert out["dropped"] == want["dropped"] == 0
    for key in ("jsonl", "chrome"):
        with open(out[key], "rb") as f, open(want[key], "rb") as g:
            assert f.read() == g.read(), key


def test_trace_dumps_match_after_the_ring_wraps(tmp_path):
    port, ref = Tracer(capacity=16), jax_trace.Tracer(capacity=16)
    _same_records([(port, obs_trace), (ref, jax_trace)], rng_seed=6)
    out = port.dump(str(tmp_path / "port"), rank=0)
    want = ref.dump(str(tmp_path / "jax"), rank=0)
    assert out["dropped"] == want["dropped"] == (40 - 16) + (24 - 16)
    for key in ("jsonl", "chrome"):
        with open(out[key], "rb") as f, open(want[key], "rb") as g:
            assert f.read() == g.read(), key


def _rank_dumps(tmp_path, tracer_cls, trace_mod, ranks=2, steps=5):
    """A two-rank loop's spans, seeded, dumped by one package."""
    rng = np.random.default_rng(7)
    for rank in range(ranks):
        tr = tracer_cls(capacity=512)
        now = 10.0 * rank
        for s in range(steps):
            tr.set_step(s)
            d = rng.uniform(1e-4, 2e-3, 6)
            t = now
            tr.rec(trace_mod.BARRIER_WAIT, t, t + d[0], a=s)
            tr.rec(trace_mod.STEP_PRIME, t + d[0], t + d[0] + d[1])
            tr.rec(trace_mod.CHUNK_READ, t + d[0], t + d[0] + d[2], a=16)
            tr.rec(trace_mod.PEER_FETCH, t + d[0] + d[1], t + d[0] + d[1] + d[3], a=1 - rank)
            tr.rec(trace_mod.STEP_PEER, t + d[0] + d[1], t + d[0] + d[1] + d[3])
            tr.rec(trace_mod.STEP_EXECUTE, t + d[0] + d[1] + d[3],
                   t + d[0] + d[1] + d[3] + d[4])
            end = t + d[0] + d[1] + d[3] + d[4] + d[5]
            tr.rec(trace_mod.HB_SEND, end - d[5], end)
            tr.rec(trace_mod.STEP, t, end)
            now = end
        tr.dump(str(tmp_path), rank=rank)


def test_each_report_reads_the_other_packages_traces(tmp_path):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    _rank_dumps(port_dir, Tracer, obs_trace)
    _rank_dumps(jax_dir, jax_trace.Tracer, jax_trace)
    want = jax_report.analyze(str(jax_dir))
    assert want["num_ranks"] == 2 and want["cluster"]["coverage"] == pytest.approx(1.0)
    # the port's report on JAX traces, and the JAX report on port traces
    assert obs_report.analyze(str(jax_dir)) == want
    assert jax_report.analyze(str(port_dir)) == obs_report.analyze(str(port_dir)) == \
        dict(want, trace_dir=str(port_dir))
    assert obs_report.check(str(jax_dir)) == jax_report.check(str(port_dir)) == []
    assert obs_report.load_traces(str(jax_dir)).keys() == \
        jax_report.load_traces(str(port_dir)).keys()


def test_report_cli_prints_what_the_jax_cli_prints(tmp_path, capsys):
    _rank_dumps(tmp_path, Tracer, obs_trace)
    for flags in ([], ["--json"], ["--check"]):
        rc = obs_report.main([str(tmp_path)] + flags)
        got = capsys.readouterr().out
        assert rc == jax_report.main([str(tmp_path)] + flags) == 0
        assert got == capsys.readouterr().out, flags
