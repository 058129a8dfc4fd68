"""The port's multi-process launcher (``repro_torch.runtime.launcher``) on
the CPU, against the JAX package.

Mirrors the launcher-bound tests of ``tests/test_runtime.py``,
``tests/test_window_protocol.py`` (2 and 4 ranks at depths 0 and 2),
``tests/test_faults.py``, ``tests/test_datatier.py`` and
``tests/test_obs.py``.  In each, the port's ranks run the port's loader
over the same store and spec as the JAX reference: their digests must equal
both the JAX package's ``in_process_digests`` and the port's own, and under
crashes, re-slicing, degrade mode, false suspects and rejoins the XOR
aggregate must equal both packages' ``in_process_aggregate``.  A run's
``summary()`` is held to the JAX ``DistributedReport.summary()`` of the
same rank results.

Every spawning test carries the ``dist`` marker.  The ranks import no
torch (``tests/test_torch_imports.py``); stores are 1024 x 8 f32, as in
the JAX tests.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from repro.core.scheduler import SolarConfig as JaxSolarConfig
from repro.data import LoaderSpec as JaxLoaderSpec
from repro.obs import report as jax_report
from repro.runtime import launcher as jax_launcher
from repro.serve.datatier import DataTierClient as JaxDataTierClient
from repro_torch.core.scheduler import SolarConfig
from repro_torch.data import DatasetSpec, LoaderSpec, build_store, create_store
from repro_torch.obs import report as obs_report
from repro_torch.runtime import (
    Fault,
    FaultPlan,
    LauncherConfigError,
    in_process_aggregate,
    in_process_digests,
    run_distributed,
)
from repro_torch.runtime.launcher import _Coordinator
from repro_torch.serve.datatier import (
    DataTierClient,
    PlanServiceClient,
    ServeTierConfig,
    TenantConfig,
)

SRC = Path(__file__).resolve().parents[1] / "src"


def _specs(tmp_path, nodes, *, depth=0, num_samples=1024, local_batch=16,
           buffer=256, epochs=3, peer=True, name=None):
    """The port's path-based spec and the JAX package's, over one store."""
    path = str(tmp_path / (name or f"dist_{nodes}"))
    if not os.path.exists(path):
        create_store(path, "binary", spec=DatasetSpec(num_samples, (8,), "<f4"),
                     fill="arange").close()
    kw = dict(loader="solar", backend="binary", path=path, num_nodes=nodes,
              local_batch=local_batch, num_epochs=epochs, buffer_size=buffer,
              collect_data=True, peer_fetch=peer, transport="socket",
              prefetch_depth=depth)
    solar = dict(num_nodes=nodes, local_batch=local_batch, buffer_size=buffer,
                 seed=0, capacity_factor=1.0, enable_peer=True)
    return (LoaderSpec(solar=SolarConfig(**solar) if peer else None, **kw),
            JaxLoaderSpec(solar=JaxSolarConfig(**solar) if peer else None, **kw))


def _reference_digests(spec, jspec):
    ref = in_process_digests(spec)
    assert ref == jax_launcher.in_process_digests(jspec)
    return ref


def _reference_aggregate(spec, jspec):
    ref = in_process_aggregate(spec)
    assert ref == jax_launcher.in_process_aggregate(jspec)
    return ref


def _jax_summary(report):
    """The JAX ``DistributedReport.summary()`` of the same rank results."""
    ranks = [jax_launcher.RankResult(**dataclasses.asdict(r)) for r in report.ranks]
    fields = {f.name: getattr(report, f.name)
              for f in dataclasses.fields(report) if f.name != "ranks"}
    return jax_launcher.DistributedReport(ranks=ranks, **fields).summary()


def _check_summary(report):
    summ = report.summary()
    assert summ == _jax_summary(report)
    return summ


# ---------------------------------------------------------------------------
# test_runtime.py: digest parity, deaths, plan by hash, recovery
# ---------------------------------------------------------------------------


@pytest.mark.dist
@pytest.mark.parametrize("nodes", [2, 4])
def test_launcher_digests_match_in_process_run(tmp_path, nodes):
    spec, jspec = _specs(tmp_path, nodes)
    report = run_distributed(spec, timeout_s=240.0)
    assert report.ok, f"dead ranks: {report.dead}"
    assert report.digests() == _reference_digests(spec, jspec)
    assert sum(r.peer_fallbacks for r in report.ranks) == 0
    assert sum(r.stale_refusals for r in report.ranks) == 0
    assert sum(r.peer_served for r in report.ranks) > 0
    summ = _check_summary(report)
    assert summ["peer_served"] == sum(summ["served_by_source"].values()) > 0
    assert [r["status"] for r in summ["ranks"]] == ["ok"] * nodes


@pytest.mark.dist
def test_launcher_survives_peer_death_mid_run(tmp_path):
    spec, jspec = _specs(tmp_path, 4, epochs=2)
    report = run_distributed(spec, timeout_s=240.0, die_at_step={2: 5})
    assert report.dead == [2]
    assert [r.status for r in report.ranks] == ["ok", "ok", "dead", "ok"]
    ref = _reference_digests(spec, jspec)
    steps = {r.steps for r in report.ranks if r.status == "ok"}
    assert len(steps) == 1 and steps.pop() > 5
    for r in report.ranks:
        if r.status == "ok":
            assert r.digest == ref[r.rank], f"rank {r.rank} corrupted"
    assert _check_summary(report)["dead_ranks"] == [2]


@pytest.mark.dist
def test_launcher_distributes_plan_by_hash(tmp_path, monkeypatch):
    from repro_torch.data import plan as plan_fn

    spec, _ = _specs(tmp_path, 2, epochs=1, num_samples=256, buffer=64)
    schedule = plan_fn(spec)
    # lie about the digest in the parent only: the ranks recompute it from
    # the artifact and must refuse to execute
    monkeypatch.setattr(type(schedule), "artifact_digest", lambda self: "0" * 64)
    report = run_distributed(spec, schedule=schedule, timeout_s=120.0)
    assert report.dead == [0, 1]
    assert not report.ok


def test_launcher_rejects_invalid_configuration():
    spec = LoaderSpec(loader="solar", backend="binary", path="/nonexistent", num_nodes=2,
                      local_batch=4, num_epochs=1, buffer_size=16, transport="socket")
    with pytest.raises(LauncherConfigError, match="barrier_timeout_s"):
        run_distributed(spec, barrier_timeout_s=0.0)
    with pytest.raises(LauncherConfigError, match="barrier_timeout_s"):
        run_distributed(spec, barrier_timeout_s=-5.0)
    with pytest.raises(LauncherConfigError, match="suspect_timeout_s"):
        run_distributed(spec, suspect_timeout_s=0)
    with pytest.raises(LauncherConfigError, match="recovery"):
        run_distributed(spec, recovery="pray")
    with pytest.raises(ValueError, match="path-based"):
        run_distributed(spec.replace(store=object()))


def test_coordinator_pending_detail_names_silent_ranks():
    coord = _Coordinator(3, barrier_timeout_s=5.0).start()
    try:
        detail = coord.pending_detail()
        assert sorted(detail) == [0, 1, 2]
        assert all(age is None for age in detail.values())
    finally:
        coord.close()


@pytest.mark.dist
def test_launcher_reslices_dead_ranks_plan_onto_survivors(tmp_path):
    spec, jspec = _specs(tmp_path, 4, epochs=2)
    report = run_distributed(spec, timeout_s=240.0, die_at_step={2: 5}, recovery="reslice")
    assert report.dead == [2]
    assert report.resliced_samples > 0, "nobody adopted the orphaned plan"
    assert report.resliced_nodes == 1
    assert report.aggregate_digest() == _reference_aggregate(spec, jspec)
    ref = _reference_digests(spec, jspec)
    for r in report.ranks:
        if r.status == "ok":
            assert r.digest == ref[r.rank]
    adopters = [r for r in report.ranks if r.adopted_nodes]
    assert len(adopters) == 1 and adopters[0].adopted_nodes == [2]
    summ = _check_summary(report)
    assert summ["resliced_samples"] == report.resliced_samples
    assert summ["recovery"] == "reslice"


@pytest.mark.dist
def test_launcher_degrade_mode_keeps_legacy_behavior(tmp_path):
    spec, jspec = _specs(tmp_path, 4, epochs=2)
    report = run_distributed(spec, timeout_s=240.0, die_at_step={2: 5}, recovery="degrade")
    assert report.dead == [2]
    assert report.resliced_samples == 0
    assert all(not r.adopted_nodes for r in report.ranks)
    ref = _reference_digests(spec, jspec)
    for r in report.ranks:
        if r.status == "ok":
            assert r.digest == ref[r.rank]
    assert _check_summary(report)["recovery"] == "degrade"


@pytest.mark.dist
def test_launcher_readmits_false_suspect_without_divergence(tmp_path):
    spec, jspec = _specs(tmp_path, 2, epochs=2)
    faults = FaultPlan(seed=0, faults=(Fault("hb_loss", 1, step=4, delay_s=1.0),))
    report = run_distributed(spec, timeout_s=240.0, faults=faults,
                             heartbeat_interval_s=0.1, suspect_timeout_s=0.3,
                             probe_grace_s=10.0)
    assert report.ok, f"a stall must not kill the rank: {report.dead}"
    assert report.false_suspects >= 1, "the stall was never suspected"
    assert report.resliced_samples == 0, "re-admission must not re-slice"
    assert report.rejoins == 0
    assert report.digests() == _reference_digests(spec, jspec)
    assert report.aggregate_digest() == _reference_aggregate(spec, jspec)
    assert report.ranks[1].faults_fired.get("hb_loss:4") == 1, report.ranks[1].faults_fired
    _check_summary(report)


@pytest.mark.dist
def test_launcher_restarted_rank_rejoins_and_reclaims_its_slice(tmp_path):
    """The restarted rank re-registers while the survivors hold their next
    release for it, so it always resumes on a boundary the run has not
    passed yet: it runs steps, an interim adopter covered the gap, and the
    aggregate is exactly once."""
    spec, jspec = _specs(tmp_path, 4, epochs=2)
    report = run_distributed(spec, timeout_s=240.0, die_at_step={1: 3}, restart_ranks={1})
    assert report.rejoins == 1
    r1 = report.ranks[1]
    assert r1.status == "ok" and r1.rejoined
    assert 0 < r1.steps, "the rejoiner never executed a step"
    assert report.resliced_samples > 0, "someone must cover the gap between death and rejoin"
    assert report.aggregate_digest() == _reference_aggregate(spec, jspec)
    _check_summary(report)


@pytest.mark.dist
def test_launcher_survives_mixed_chaos_with_digest_parity(tmp_path):
    spec, jspec = _specs(tmp_path, 4, epochs=2)
    faults = FaultPlan.compile(11, 4, num_steps=8, corrupt=2, truncate=1, resets=2, slow=2)
    report = run_distributed(spec, timeout_s=240.0, faults=faults)
    assert report.ok, f"flaky faults must never kill ranks: {report.dead}"
    assert report.digests() == _reference_digests(spec, jspec)
    assert report.aggregate_digest() == _reference_aggregate(spec, jspec)
    summ = _check_summary(report)
    assert summ["retries"] > 0, "injected faults never exercised the ladder"
    assert any(r.faults_fired for r in report.ranks), "the armed plan never fired"


# ---------------------------------------------------------------------------
# test_window_protocol.py and test_faults.py: the epoch-window protocol
# ---------------------------------------------------------------------------


@pytest.mark.dist
@pytest.mark.parametrize("nodes", [2, 4])
@pytest.mark.parametrize("depth", [0, 2])
def test_depth_invariant_digest_parity(tmp_path, nodes, depth):
    spec, jspec = _specs(tmp_path, nodes, depth=depth, epochs=2, name=f"win_{nodes}")
    report = run_distributed(spec, timeout_s=240.0)
    assert report.ok, f"dead ranks: {report.dead}"
    # the depth-0 references of both packages
    assert report.digests() == _reference_digests(spec.replace(prefetch_depth=0),
                                                  jspec.replace(prefetch_depth=0))
    assert sum(r.peer_fallbacks for r in report.ranks) == 0
    assert sum(r.stale_refusals for r in report.ranks) == 0
    assert sum(r.peer_served for r in report.ranks) > 0
    summ = _check_summary(report)
    assert summ["max_observed_skew"] <= depth + 1
    cursors = set()
    for row in summ["ranks"]:
        assert row["window_steps"] == depth + 1
        cursors |= {win * (depth + 1) + off for win, off in row["window_cursors"].values()}
    assert len(cursors) == 1, cursors


@pytest.mark.dist
def test_windowed_run_reslices_on_window_boundaries(tmp_path):
    spec, jspec = _specs(tmp_path, 4, depth=2, epochs=2, name="win_4")
    report = run_distributed(spec, timeout_s=240.0, die_at_step={2: 5})
    assert report.dead == [2]
    assert report.aggregate_digest() == _reference_aggregate(spec, jspec)
    boundaries = [b for r in report.ranks for b in r.adoption_boundaries]
    assert boundaries, "someone must have adopted the dead rank's slice"
    assert all(b % 3 == 0 for b in boundaries), boundaries
    ref = _reference_digests(spec, jspec)
    for r in report.ranks:
        if r.status == "ok":
            assert r.digest == ref[r.rank], f"rank {r.rank} corrupted"


@pytest.mark.dist
@pytest.mark.parametrize("seed", [3, 11])
def test_windowed_chaos_adopts_on_boundaries_and_keeps_aggregate(tmp_path, seed):
    plan = FaultPlan.compile(seed, 4, crashes=1, resets=2, slow=1, spare_rank=0)
    spec, jspec = _specs(tmp_path, 4, depth=4, epochs=2, name="chaos")
    report = run_distributed(spec, timeout_s=240.0, faults=plan)
    assert report.aggregate_digest() == _reference_aggregate(spec, jspec)
    boundaries = [b for r in report.ranks for b in r.adoption_boundaries]
    if report.dead:
        assert boundaries, "a death must hand its slice to a survivor"
    assert all(b % 5 == 0 for b in boundaries), boundaries
    ref = _reference_digests(spec, jspec)
    for r in report.ranks:
        if r.status == "ok" and not r.rejoined:
            assert r.digest == ref[r.rank], f"rank {r.rank} corrupted"


# ---------------------------------------------------------------------------
# test_datatier.py: tenants under a live run
# ---------------------------------------------------------------------------


@pytest.mark.dist
def test_live_run_with_tenant_storm_keeps_digest_parity(tmp_path):
    """Two tenants replay seeded Zipf traces against a live 2-rank run: the
    port's client as tenant 1, the JAX package's as tenant 2.  Digests stay
    bit-identical to the references, with zero stale refusals, and both
    tenants are served (buffer or peer hits)."""
    spec, jspec = _specs(tmp_path, 2, depth=1, epochs=2, name="dist_store")
    tier_cfg = ServeTierConfig(tenants=(TenantConfig(1, "alpha"), TenantConfig(2, "beta")))
    done = threading.Event()
    stats: dict[int, dict] = {}
    threads: list[threading.Thread] = []

    def tenant_main(tenant, token, client_cls, info):
        rng = np.random.default_rng(tenant)
        zipf = 1.0 / np.arange(1, 1025, dtype=np.float64) ** 1.1
        zipf /= zipf.sum()
        perm = rng.permutation(1024)
        c = client_cls(info["endpoints"], tenant=tenant, token=token,
                       shed_wait_s=0.02, max_shed_retries=1)
        try:
            while not done.is_set():
                c.read(perm[rng.choice(1024, size=8, p=zipf)])
        finally:
            stats[tenant] = c.stats()
            c.close()

    def on_ready(info):
        assert info["plan_service"] is not None
        fetched = PlanServiceClient(info["plan_service"]).fetch(
            info["plan_digest"], dest_dir=str(tmp_path))
        assert fetched.artifact_digest() == info["plan_digest"]
        for tenant, token, cls in ((1, "alpha", DataTierClient),
                                   (2, "beta", JaxDataTierClient)):
            t = threading.Thread(target=tenant_main, args=(tenant, token, cls, info),
                                 daemon=True)
            t.start()
            threads.append(t)

    report = run_distributed(spec, timeout_s=240.0, serve_tier=tier_cfg,
                             on_tier_ready=on_ready)
    done.set()
    for t in threads:
        t.join(timeout=15.0)
    assert report.ok, f"dead ranks: {report.dead}"
    assert report.digests() == _reference_digests(spec, jspec)
    summ = _check_summary(report)
    assert summ["stale_refusals"] == 0
    assert sum(r.peer_fallbacks for r in report.ranks) == 0
    assert summ["tenant_hits"] + summ["tenant_peer_reads"] > 0
    assert len(threads) == 2
    assert all(stats[t]["rows_served"] > 0 for t in (1, 2)), stats
    per = {tid for r in report.ranks for tid in r.tenants["per_tenant"]}
    assert per == {"1", "2"}


@pytest.mark.dist
def test_zero_tenant_tier_run_matches_plain_run(tmp_path):
    spec, jspec = _specs(tmp_path, 2, num_samples=512, buffer=128, epochs=1, name="zt_store")
    tier_cfg = ServeTierConfig(tenants=(TenantConfig(1, "idle"),), plan_service=False)
    report = run_distributed(spec, timeout_s=240.0, serve_tier=tier_cfg)
    assert report.ok
    assert report.digests() == _reference_digests(spec, jspec)
    summ = _check_summary(report)
    for k in ("tenant_hits", "tenant_peer_reads", "tenant_pfs_fallbacks", "tenant_sheds"):
        assert summ[k] == 0, (k, summ[k])


@pytest.mark.dist
def test_rate_limited_tenant_storm_from_its_own_process_is_shed(tmp_path):
    """The layout of ``chip_smoke.py``'s ``dist_tier_serve`` at a small size:
    the tier held by 4 ranks, tenant 1 (unlimited) reading a batch from the
    parent while tenant 2 (4 rows/s, burst 4) storms from a
    ``repro_torch.serve.tenant_load`` process.  Tenant 2 is shed, tenant 1
    never; the rows equal the store's; the loader does not see the storm."""
    spec, jspec = _specs(tmp_path, 4, depth=1, epochs=6, name="storm_store")
    tier_cfg = ServeTierConfig(tenants=(
        TenantConfig(1, "replica"), TenantConfig(2, "batch", rate=4.0, burst=4.0)))
    ready = threading.Event()
    info = {}

    def on_ready(i):
        info.update(i)
        ready.set()

    runner = threading.Thread(target=lambda: info.update(report=run_distributed(
        spec, timeout_s=240.0, serve_tier=tier_cfg, on_tier_ready=on_ready)))
    runner.start()
    try:
        assert ready.wait(120.0), "the tier never came up"
        endpoints = ",".join(f"{n}={h}:{p}" for n, (h, p) in sorted(info["endpoints"].items()))
        storm = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.serve.tenant_load", "--endpoints", endpoints,
             "--tenant", "2", "--token", "batch", "--num-samples", "1024"],
            env=dict(os.environ, PYTHONPATH=str(SRC)), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True)
        try:
            assert json.loads(storm.stdout.readline()) == {"ready": True}
            ids = np.arange(40, 56)
            store = build_store(spec)
            try:
                want = store.read_scattered(ids)
            finally:
                store.close()
            with DataTierClient(info["endpoints"], tenant=1, token="replica") as client:
                for _ in range(3):
                    rows, ok = client.read(ids)
                    assert ok.all()
                    np.testing.assert_array_equal(rows, want)
            assert runner.is_alive(), "the run ended before the storm did"
        finally:
            storm_stats = json.loads(storm.communicate(timeout=60.0)[0].splitlines()[-1])
    finally:
        runner.join(timeout=240.0)
    report = info["report"]
    assert storm.returncode == 0 and storm_stats["reads"] > 0
    assert report.ok and report.digests() == _reference_digests(spec, jspec)
    summ = _check_summary(report)
    assert summ["stale_refusals"] == 0 and summ["peer_fallbacks"] == 0
    sheds = {t: sum(r.tenants["per_tenant"].get(t, {}).get("sheds", 0) for r in report.ranks)
             for t in ("1", "2")}
    assert sheds["1"] == 0 and sheds["2"] > 0, sheds
    assert storm_stats["sheds"] > 0


# ---------------------------------------------------------------------------
# test_obs.py: a traced run
# ---------------------------------------------------------------------------


@pytest.mark.dist
def test_traced_run_digest_parity_and_valid_trace(tmp_path):
    """A traced 2-rank run trains the same bytes as the references, dumps
    traces that both packages' ``report --check`` pass and analyze alike,
    and carries latency quantiles and a metrics snapshot on every rank."""
    spec, jspec = _specs(tmp_path, 2, num_samples=512, local_batch=8, buffer=64,
                         depth=2, epochs=2, name="tokens")
    trace_dir = str(tmp_path / "traces")
    metrics_out = str(tmp_path / "metrics.json")
    traced = run_distributed(spec, timeout_s=120.0, trace_dir=trace_dir,
                             metrics_out=metrics_out)
    assert traced.ok and traced.digests() == _reference_digests(spec, jspec)
    assert obs_report.check(trace_dir) == jax_report.check(trace_dir) == []
    rep = obs_report.analyze(trace_dir)
    assert rep == jax_report.analyze(trace_dir)
    assert rep["num_ranks"] == 2
    assert rep["cluster"]["coverage"] >= 0.9
    assert rep["cluster"]["barrier_ms_per_step"] > 0
    for r in traced.ranks:
        assert r.latency["step_count"] == r.steps
        assert r.latency["step_ms_p50"] > 0
        assert r.metrics["counters"], "metrics snapshot missing"
    summ = _check_summary(traced)
    assert summ["latency"]["step_count"] == sum(r.steps for r in traced.ranks)
    m = json.load(open(metrics_out))
    assert m["telemetry"], "no telemetry rows rode the heartbeat path"
    assert {"t", "rank", "steps"} <= set(m["telemetry"][0])
    assert m["summary"]["latency"] == summ["latency"]


# ---------------------------------------------------------------------------
# The CLI under an injected crash
# ---------------------------------------------------------------------------


@pytest.mark.dist
def test_distributed_cli_verifies_an_injected_crash(tmp_path):
    """``python -m repro_torch.launch.train distributed --faults ... --verify``
    exits 0 when a rank dies and is re-sliced, with aggregate parity."""
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "distributed", "--nodes", "2",
         "--peer-fetch", "--num-samples", "1024", "--local-batch", "16", "--buffer", "256",
         "--epochs", "2", "--faults", "seed=2,crash=1,reset=1,spare=0", "--verify",
         "--data", str(tmp_path / "tokens.bin"), "-q"],
        env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True, text=True,
        timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout)
    assert out["verify"]["aggregate_parity"] is True
    assert out["dead_ranks"] and out["resliced_samples"] > 0
