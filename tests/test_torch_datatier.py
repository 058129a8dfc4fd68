"""The port's multi-tenant data tier (``repro_torch.serve.datatier``) against
the JAX package's.

Mirrors the tests of ``tests/test_datatier.py`` that need no multi-process
launcher: the tenant frames, the deterministic token bucket, tenant
service against a live server (bit-exact reads, loud auth refusal,
geometry negotiation, sheds that never charge the breaker, strict trainer
priority, the breaker ladder on a dead node), the residency index, the plan
service, ``rows_to_prompts`` and config validation.  It adds the
cross-package checks: a port client against a JAX tier and a JAX client
against a port tier read bit-equal rows and see the same sheds and
refusals; ``rows_to_prompts`` maps rows to the JAX package's prompts; and
``ServeEngine.generate_from_tier`` at ``reduced()`` in f32 gives the JAX
engine's tokens and served mask, for qwen2-0.5b and hymba-1.5b, from
weights carried across by ``convert.params_from_jax``.

Every socket binds port 0, every client carries a timeout, and every tier
is closed in a ``finally`` or its context manager.
"""
import socket
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - depends on the environment
    HAVE_HYPOTHESIS = False

import repro.serve.datatier as jtier
from repro.configs import get_config as jax_config
from repro.data.backends import open_store as jopen_store
from repro.models import lm as jlm
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data import DatasetSpec, LoaderSpec, create_store
from repro_torch.data.backends import open_store
from repro_torch.data.peer import Breaker, RetryPolicy
from repro_torch.launch import serve
from repro_torch.runtime import wire
from repro_torch.runtime.server import INTERNAL_TENANT, TokenBucket
from repro_torch.serve.datatier import (
    DataTierClient,
    PlanService,
    PlanServiceClient,
    ResidencyIndex,
    ServeTierConfig,
    StandaloneTier,
    TenantConfig,
    TierAuthError,
    TierError,
    rows_to_prompts,
)
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(1)

TIMEOUT_S = 5.0


# ---------------------------------------------------------------------------
# Wire: tenant frames
# ---------------------------------------------------------------------------


def _pipe():
    a, b = socket.socketpair()
    a.settimeout(2.0)
    b.settimeout(2.0)
    return a, b


def test_read_roundtrip():
    a, b = _pipe()
    try:
        ids = np.asarray([3, 1, 4, 1, 5], np.int64)
        wire.send_frame(a, wire.MSG_READ, wire.pack_read(7, ids))
        msg_type, payload = wire.recv_frame(b)
        assert msg_type == wire.MSG_READ
        tenant, forward, got = wire.unpack_read(payload)
        assert (tenant, forward) == (7, True)
        assert np.array_equal(got, ids)
        t2, f2, g2 = wire.unpack_read(
            wire.pack_read(INTERNAL_TENANT, ids[:2], forward=False)
        )
        assert (t2, f2) == (INTERNAL_TENANT, False)
        assert np.array_equal(g2, ids[:2])
    finally:
        a.close()
        b.close()


def test_shed_roundtrip():
    a, b = _pipe()
    try:
        wire.send_frame(a, wire.MSG_SHED, wire.pack_shed(0.25, "rate_limited"))
        msg_type, payload = wire.recv_frame(b)
        assert msg_type == wire.MSG_SHED
        retry, reason = wire.unpack_shed(payload)
        assert retry == 0.25 and reason == "rate_limited"
    finally:
        a.close()
        b.close()


def test_tenant_frames_are_distinct_known_types():
    new = {wire.MSG_ATTACH, wire.MSG_ATTACH_OK, wire.MSG_READ, wire.MSG_SHED}
    legacy = {
        wire.MSG_HELLO, wire.MSG_HELLO_OK, wire.MSG_FETCH, wire.MSG_FETCHW,
        wire.MSG_ROWS, wire.MSG_ERROR, wire.MSG_CTRL,
    }
    assert len(new) == 4 and not (new & legacy)
    assert new <= wire._KNOWN_TYPES


def test_legacy_frames_and_version_are_unchanged():
    ids = np.asarray([9, 2], np.int64)
    assert wire.pack_fetch(4, ids) == (
        wire._FETCH.pack(4, 2) + ids.astype("<i8").tobytes()
    )
    w, s, got = wire.unpack_fetchw(wire.pack_fetchw(1, 5, ids))
    assert (w, s) == (1, 5) and np.array_equal(got, ids)
    assert wire.WIRE_VERSION == 1


def test_read_payload_validation():
    with pytest.raises(wire.ProtocolError, match="READ"):
        wire.unpack_read(b"\x00" * 4)
    good = wire.pack_read(1, np.asarray([7, 8], np.int64))
    with pytest.raises(wire.ProtocolError, match="READ"):
        wire.unpack_read(good[:-4])
    bad_flag = bytearray(good)
    bad_flag[8] = 9  # forward byte out of {0, 1}
    with pytest.raises(wire.ProtocolError):
        wire.unpack_read(bytes(bad_flag))


def test_shed_payload_validation():
    with pytest.raises(ValueError):
        wire.pack_shed(-1.0, "no")
    with pytest.raises(ValueError):
        wire.pack_shed(float("nan"), "no")
    retry, _ = wire.unpack_shed(wire.pack_shed(1e9, "busy"))
    assert retry == wire.MAX_RETRY_AFTER_S
    with pytest.raises(wire.ProtocolError):
        wire.unpack_shed(wire.pack_json({"reason": "missing retry"}))
    with pytest.raises(wire.ProtocolError):
        wire.unpack_shed(wire.pack_json({"retry_after_s": -3.0}))


def _corruption_check(seed: int) -> None:
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 2**40, size=int(rng.integers(1, 16)))
    payload = wire.pack_read(int(rng.integers(0, 100)), ids)
    header = wire._HEADER.pack(
        wire.MAGIC, wire.WIRE_VERSION, wire.MSG_READ, len(payload)
    )
    frame = header + payload + wire._frame_digest(header, payload)

    a, b = _pipe()
    try:
        corrupt = bytearray(frame)
        pos = int(rng.integers(0, len(corrupt)))
        corrupt[pos] ^= 0xFF
        a.sendall(bytes(corrupt))
        a.close()
        with pytest.raises(wire.WireError):
            wire.recv_frame(b)
    finally:
        b.close()

    a, b = _pipe()
    try:
        cut = int(rng.integers(1, len(frame)))
        a.sendall(frame[:cut])
        a.close()
        with pytest.raises(wire.TruncatedFrame):
            wire.recv_frame(b)
    finally:
        b.close()


if HAVE_HYPOTHESIS:

    @settings(max_examples=15, deadline=None)
    @given(seed=st.integers(min_value=0, max_value=2**31 - 1))
    def test_tenant_frame_corruption_property(seed):
        _corruption_check(seed)

else:

    @pytest.mark.parametrize("seed", range(8))
    def test_tenant_frame_corruption_property(seed):
        _corruption_check(seed)


# ---------------------------------------------------------------------------
# Admission: deterministic token bucket
# ---------------------------------------------------------------------------


def test_token_bucket_is_a_pure_function_of_its_clock():
    b = TokenBucket(rate=10.0, burst=20.0)
    assert b.admit(20, now=0.0) == 0.0
    wait = b.admit(5, now=0.0)
    assert wait == pytest.approx(0.5)
    assert b.admit(5, now=1.0) == 0.0
    assert b.admit(5, now=1.0) == 0.0
    assert b.admit(1, now=1.0) == pytest.approx(0.1)
    assert b.admit(20, now=100.0) == 0.0
    assert b.admit(20, now=50.0) > 0.0
    assert TokenBucket(rate=None).admit(10**9, now=0.0) == 0.0
    with pytest.raises(ValueError):
        TokenBucket(rate=0.0)


def test_token_bucket_follows_the_jax_bucket_on_a_seeded_call_sequence():
    rng = np.random.default_rng(8)
    b, jb = TokenBucket(rate=64.0, burst=16.0), jtier.TokenBucket(rate=64.0, burst=16.0)
    now = 0.0
    for _ in range(500):
        now += float(rng.exponential(0.02)) * (1 if rng.random() < 0.9 else -1)
        n = int(rng.integers(1, 12))
        assert b.admit(n, now) == jb.admit(n, now)
        assert b.tokens == jb.tokens


def _store(tmp_path, tag, num_samples=128, shape=(8,), fill="arange"):
    path = str(tmp_path / f"store_{tag}")
    create_store(
        path, "binary", spec=DatasetSpec(num_samples, shape, "<f4"), fill=fill,
    ).close()
    return path


def test_rate_limit_determinism_under_seeded_concurrent_clients(tmp_path):
    store = open_store(_store(tmp_path, "rl", num_samples=64, shape=(4,)), "binary")
    burst = 24
    cfg = ServeTierConfig(
        tenants=(TenantConfig(1, "tok", rate=1.0, burst=float(burst)),),
    )
    try:
        with StandaloneTier(store, cfg, clock=lambda: 0.0) as tier:
            served = []
            sheds = []

            def client_main(seed: int) -> None:
                rng = np.random.default_rng(seed)
                c = DataTierClient(
                    {0: tier.endpoint}, tenant=1, token="tok",
                    shed_wait_s=0.001, max_shed_retries=0, timeout_s=TIMEOUT_S,
                )
                try:
                    for _ in range(8):
                        ids = rng.integers(0, 64, size=4)
                        _, ok = c.read(ids)
                        served.append(int(ok.sum()))
                finally:
                    sheds.append(c.stats()["sheds"])
                    c.close()

            threads = [
                threading.Thread(target=client_main, args=(s,))
                for s in range(3)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60.0)
            stats = tier.stats()
        assert sum(served) == burst
        assert stats["tenant_hits"] == burst
        assert stats["tenant_sheds"] == sum(sheds) == (96 - burst) // 4
    finally:
        store.close()


# ---------------------------------------------------------------------------
# Tenant service against a live server
# ---------------------------------------------------------------------------


def _tier(tmp_path, tag, tenants, **kw):
    store = open_store(_store(tmp_path, tag), "binary")
    return store, StandaloneTier(store, ServeTierConfig(tenants=tenants), **kw)


def test_tenant_reads_are_bit_exact_and_geometry_negotiates(tmp_path):
    store, tier = _tier(tmp_path, "exact", (TenantConfig(1, "a"),))
    try:
        ref = store.read_scattered(np.arange(128))
        c = DataTierClient({0: tier.endpoint}, tenant=1, token="a",
                           timeout_s=TIMEOUT_S)
        ids = np.asarray([0, 5, 127, 64, 5], np.int64)
        rows, ok = c.read(ids)
        assert ok.all()
        np.testing.assert_array_equal(rows, ref[ids])
        assert c.sample_shape == (8,) and c.dtype == np.dtype("<f4")
        c.close()
        c2 = DataTierClient(
            {0: tier.endpoint}, tenant=1, token="a",
            sample_shape=(8,), dtype="<f4", timeout_s=TIMEOUT_S,
        )
        _, ok2 = c2.read(np.asarray([3]))
        assert ok2.all()
        c2.close()
        bad = DataTierClient(
            {0: tier.endpoint}, tenant=1, token="a",
            sample_shape=(16,), dtype="<f4", timeout_s=TIMEOUT_S,
        )
        with pytest.raises(TierAuthError):
            bad.read(np.asarray([1]))
        bad.close()
    finally:
        tier.close()
        store.close()


def test_auth_refusals_are_loud(tmp_path):
    store, tier = _tier(tmp_path, "auth", (TenantConfig(1, "secret"),))
    try:
        for tenant, token in ((1, "wrong"), (2, "secret")):
            c = DataTierClient({0: tier.endpoint}, tenant=tenant, token=token,
                               timeout_s=TIMEOUT_S)
            with pytest.raises(TierAuthError):
                c.read(np.asarray([1]))
            c.close()
        conn = socket.create_connection(tier.endpoint, timeout=2.0)
        conn.settimeout(2.0)
        try:
            wire.send_frame(
                conn, wire.MSG_READ, wire.pack_read(1, np.asarray([1]))
            )
            msg_type, payload = wire.recv_frame(conn)
            assert msg_type == wire.MSG_ERROR
            assert b"ATTACH" in payload
        finally:
            conn.close()
    finally:
        tier.close()
        store.close()


def test_shed_is_honored_and_never_charges_the_breaker(tmp_path):
    store, tier = _tier(
        tmp_path, "shed", (TenantConfig(1, "t", rate=1.0, burst=4.0),),
        clock=lambda: 0.0,
    )
    try:
        c = DataTierClient(
            {0: tier.endpoint}, tenant=1, token="t",
            shed_wait_s=0.005, max_shed_retries=1, timeout_s=TIMEOUT_S,
        )
        _, ok = c.read(np.arange(4))
        assert ok.all()
        for _ in range(5):
            _, ok = c.read(np.arange(4))
            assert not ok.any()
        s = c.stats()
        assert s["sheds"] >= 5 and s["shed_give_ups"] == 5
        assert s["breaker_opens"] == 0 and s["breaker_skips"] == 0
        assert s["retries"] == 0
        assert tier.stats()["tenant_sheds"] >= 5
        _, ok = c.read(np.arange(4))
        assert not ok.any()
        c.close()
    finally:
        tier.close()
        store.close()


def test_dead_node_climbs_the_breaker_ladder():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    c = DataTierClient(
        {0: ("127.0.0.1", port)}, tenant=1, token="t",
        sample_shape=(4,), dtype="<f4", timeout_s=TIMEOUT_S,
        retry=RetryPolicy(
            max_attempts=2, backoff_base_s=0.001, breaker_threshold=2,
            breaker_cooldown_s=60.0,
        ),
    )
    try:
        for _ in range(4):
            _, ok = c.read(np.asarray([1, 2]))
            assert not ok.any()
        s = c.stats()
        assert s["retries"] >= 2
        assert s["breaker_opens"] == 1
        assert s["breaker_skips"] == 2
        assert isinstance(c._breakers[0], Breaker)
    finally:
        c.close()


def test_read_storm_cannot_slow_the_trainer_past_the_yield_bound(tmp_path):
    from repro_torch.data import SocketTransport

    store, tier = _tier(tmp_path, "prio", (TenantConfig(1, "t"),))
    server = tier.server
    try:
        transport = SocketTransport(
            {0: (server.host, server.port)}, timeout_s=2.0,
            sample_shape=(8,), dtype="<f4",
            retry=RetryPolicy(max_attempts=1, backoff_base_s=0.001),
        )
        stop = threading.Event()

        def storm(seed: int) -> None:
            rng = np.random.default_rng(seed)
            c = DataTierClient({0: tier.endpoint}, tenant=1, token="t",
                               timeout_s=TIMEOUT_S)
            try:
                while not stop.is_set():
                    c.read(rng.integers(0, 128, size=8))
            finally:
                c.close()

        threads = [
            threading.Thread(target=storm, args=(s,), daemon=True)
            for s in range(4)
        ]
        for t in threads:
            t.start()
        try:
            transport.at_step(0)
            latencies = []
            for _ in range(50):
                t0 = time.perf_counter()
                rows, ok = transport.fetch(0, np.asarray([1, 2, 3], np.int64))
                latencies.append(time.perf_counter() - t0)
                assert ok.all()
            latencies.sort()
            assert latencies[len(latencies) // 2] < 0.2, latencies[-5:]
            assert server.stale_refusals == 0
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5.0)
            transport.close()
    finally:
        tier.close()
        store.close()


def test_tenant_read_waits_for_inflight_trainer_mutation(tmp_path):
    store, tier = _tier(tmp_path, "yield", (TenantConfig(1, "t"),))
    server = tier.server
    try:
        release = threading.Event()
        entered = threading.Event()

        def hold_mutation() -> None:
            with server.mutating(1):
                entered.set()
                release.wait(timeout=5.0)

        holder = threading.Thread(target=hold_mutation, daemon=True)
        holder.start()
        assert entered.wait(timeout=2.0)
        c = DataTierClient({0: tier.endpoint}, tenant=1, token="t",
                           timeout_s=TIMEOUT_S)
        t0 = time.perf_counter()
        timer = threading.Timer(0.05, release.set)
        timer.start()
        try:
            _, ok = c.read(np.asarray([1, 2]))
        finally:
            timer.join()
            holder.join(timeout=5.0)
            c.close()
        assert ok.all()
        assert time.perf_counter() - t0 >= 0.04
    finally:
        tier.close()
        store.close()


# ---------------------------------------------------------------------------
# Residency index
# ---------------------------------------------------------------------------


def _fake_schedule(steps):
    sps = [
        types.SimpleNamespace(nodes=[
            types.SimpleNamespace(
                node=n,
                admissions=np.asarray(a, np.int64),
                evictions=np.asarray(e, np.int64),
            )
            for n, a, e in sp
        ])
        for sp in steps
    ]
    return types.SimpleNamespace(
        epochs=[types.SimpleNamespace(steps=sps)]
    )


def test_residency_index_replays_deltas_in_order():
    sched = _fake_schedule([
        [(0, [1, 2], []), (1, [3], [])],
        [(0, [4], [1]), (1, [], [3])],
        [(1, [1], [])],
    ])
    idx = ResidencyIndex(sched)
    assert idx.locate(np.asarray([1, 3])).tolist() == [-1, -1]
    idx.advance_to(1)
    assert idx.locate(np.asarray([1, 2, 3, 9])).tolist() == [0, 0, 1, -1]
    idx.advance_to(3)
    assert idx.locate(np.asarray([1, 2, 3, 4])).tolist() == [1, 0, -1, 0]
    idx.advance_to(0)
    idx.advance_to(3)
    assert idx.applied == 3
    sched2 = _fake_schedule([
        [(0, [5], [])],
        [(1, [5], [])],
        [(0, [], [5])],
    ])
    idx2 = ResidencyIndex(sched2)
    idx2.advance_to(3)
    assert idx2.locate(np.asarray([5])).tolist() == [1]


def test_residency_index_matches_the_jax_index_over_a_real_schedule(tmp_path):
    """Replaying a real SOLAR plan's deltas, step by step, gives the owner
    map the JAX package gives over its own plan of the same spec."""
    import repro.data as rdata
    from repro_torch.data.pipeline import plan as plan_fn

    path = _store(tmp_path, "res", num_samples=256)
    geo = dict(loader="solar", backend="binary", path=path, num_nodes=3,
               local_batch=8, num_epochs=2, buffer_size=48)
    sched = plan_fn(LoaderSpec(**geo))
    jsched = rdata.plan(rdata.LoaderSpec(**geo))
    idx, jidx = ResidencyIndex(sched), jtier.ResidencyIndex(jsched)
    ids = np.arange(256)
    for step in range(0, sched.num_steps + 1, 3):
        idx.advance_to(step)
        jidx.advance_to(step)
        assert idx.locate(ids).tolist() == jidx.locate(ids).tolist()
    assert (idx.locate(ids) >= 0).any()


# ---------------------------------------------------------------------------
# Plan service
# ---------------------------------------------------------------------------


def test_plan_service_serves_schedules_by_content_hash(tmp_path):
    from repro_torch.core.planners import PlanCache
    from repro_torch.data.pipeline import plan as plan_fn

    path = _store(tmp_path, "ps", num_samples=256)
    spec = LoaderSpec(
        loader="solar", backend="binary", path=path, num_nodes=2,
        local_batch=8, num_epochs=1, buffer_size=64,
    )
    schedule = plan_fn(spec)
    digest = schedule.artifact_digest()

    cache = PlanCache(str(tmp_path / "ps_cache"))
    with PlanService(cache).start() as svc:
        assert svc.publish(schedule) == digest
        client = PlanServiceClient((svc.host, svc.port), timeout_s=TIMEOUT_S)
        fetched = client.fetch(digest, dest_dir=str(tmp_path))
        assert fetched.artifact_digest() == digest
        assert fetched.num_steps == schedule.num_steps
        with pytest.raises(TierError, match="no artifact"):
            client.fetch("0" * 64, dest_dir=str(tmp_path))
        # the JAX package's client fetches and verifies the port's artifact
        (tmp_path / "j").mkdir()
        jfetched = jtier.PlanServiceClient((svc.host, svc.port),
                                           timeout_s=TIMEOUT_S).fetch(
            digest, dest_dir=str(tmp_path / "j"))
        assert jfetched.artifact_digest() == digest

    with PlanService(cache).start() as svc2:
        again = PlanServiceClient((svc2.host, svc2.port),
                                  timeout_s=TIMEOUT_S).fetch(
            digest, dest_dir=str(tmp_path))
        assert again.artifact_digest() == digest


# ---------------------------------------------------------------------------
# Row -> prompt mapping
# ---------------------------------------------------------------------------


def test_rows_to_prompts_is_deterministic_and_in_vocab():
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((5, 8)).astype("<f4")
    a = rows_to_prompts(rows, 16, 50_000)
    b = rows_to_prompts(rows.copy(), 16, 50_000)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (5, 16) and a.dtype == np.int32
    assert (a >= 0).all() and (a < 50_000).all()
    assert not np.array_equal(a[0], a[1])
    const = rows_to_prompts(np.zeros((1, 8), "<f4"), 16, 50_000)
    assert len(np.unique(const)) > 1


@pytest.mark.parametrize("shape,dtype,prompt_len,vocab", [
    ((4, 8), "<f4", 16, 50_000),
    ((3, 8, 8, 1), "<f4", 512, 151_936),
    ((2, 5), "<f8", 7, 256),
    ((4, 3), "<i2", 40, 32_001),
    ((1, 4096), "<f4", 1536, 32_001),
])
def test_rows_to_prompts_matches_the_jax_package(shape, dtype, prompt_len, vocab):
    rng = np.random.default_rng(sum(shape) + prompt_len)
    rows = (rng.standard_normal(shape) * 1000).astype(dtype)
    got = rows_to_prompts(rows, prompt_len, vocab)
    want = jtier.rows_to_prompts(rows, prompt_len, vocab)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# Config validation
# ---------------------------------------------------------------------------


def test_serve_tier_config_validation():
    with pytest.raises(TierError, match="at least one tenant"):
        ServeTierConfig(tenants=()).validate()
    with pytest.raises(TierError, match="reserved"):
        ServeTierConfig(
            tenants=(TenantConfig(INTERNAL_TENANT, "x"),)
        ).validate()
    with pytest.raises(TierError, match="duplicate"):
        ServeTierConfig(
            tenants=(TenantConfig(1, "x"), TenantConfig(1, "y"))
        ).validate()
    with pytest.raises(TierError, match="queue_depth"):
        ServeTierConfig(
            tenants=(TenantConfig(1, "x"),), queue_depth=0
        ).validate()


# ---------------------------------------------------------------------------
# Cross-package: port clients against JAX tiers and the other way round
# ---------------------------------------------------------------------------

_TIER_PKGS = {
    "torch": (StandaloneTier, ServeTierConfig, TenantConfig, open_store),
    "jax": (jtier.StandaloneTier, jtier.ServeTierConfig, jtier.TenantConfig,
            jopen_store),
}
_CLIENT_PKGS = {
    "torch": (DataTierClient, TierAuthError),
    "jax": (jtier.DataTierClient, jtier.TierAuthError),
}


@pytest.mark.parametrize("tier_pkg,client_pkg", [("jax", "torch"), ("torch", "jax")])
def test_clients_and_tiers_interoperate(tmp_path, tier_pkg, client_pkg):
    """Bit-equal rows (resident hits and PFS fallbacks), the same sheds
    under a frozen clock, and the same loud auth refusal, across the package
    boundary."""
    Tier, Config, Tenant, opener = _TIER_PKGS[tier_pkg]
    Client, AuthError = _CLIENT_PKGS[client_pkg]
    path = _store(tmp_path, "x", num_samples=96, shape=(4, 3), fill="random")
    store = opener(path, "binary")
    cfg = Config(tenants=(Tenant(1, "a"), Tenant(2, "b", rate=1.0, burst=6.0)))
    try:
        with Tier(store, cfg, resident_ids=np.arange(48), clock=lambda: 0.0) as tier:
            ref = store.read_scattered(np.arange(96))
            ids = np.asarray([47, 48, 0, 95, 47], np.int64)
            c = Client({0: tier.endpoint}, tenant=1, token="a", timeout_s=TIMEOUT_S)
            rows, ok = c.read(ids)
            c.close()
            assert ok.all() and c.sample_shape == (4, 3)
            assert rows.tobytes() == ref[ids].tobytes()
            limited = Client({0: tier.endpoint}, tenant=2, token="b",
                             timeout_s=TIMEOUT_S, shed_wait_s=0.001,
                             max_shed_retries=0)
            served = [int(limited.read(np.arange(4))[1].sum()) for _ in range(3)]
            assert served == [4, 0, 0]
            assert limited.stats()["sheds"] == 2
            assert limited.stats()["breaker_opens"] == 0
            limited.close()
            bad = Client({0: tier.endpoint}, tenant=1, token="wrong",
                         timeout_s=TIMEOUT_S)
            with pytest.raises(AuthError):
                bad.read(np.asarray([1]))
            bad.close()
            stats = tier.stats()
        assert stats["per_tenant"]["1"] == {"hits": 3, "peer_reads": 0,
                                            "pfs_fallbacks": 2, "sheds": 0}
        assert stats["per_tenant"]["2"]["sheds"] == 2
    finally:
        store.close()


@pytest.mark.parametrize("peer_pkg", ["torch", "jax"])
def test_rank_tier_routes_misses_to_the_owning_peer_then_the_pfs(tmp_path, peer_pkg):
    """``wire_rank_tier`` on a port server: a read it misses locally goes to
    the sibling the residency index names (an internal proxy read, to a port
    or a JAX server), and what no node holds goes to the PFS, all bit-exact
    and attributed per tenant."""
    from repro.data.loaders import _DataMirror as JMirror
    from repro.runtime.server import BufferServer as JServer
    from repro_torch.data.loaders import _DataMirror
    from repro_torch.runtime.server import BufferServer
    from repro_torch.serve.datatier import wire_rank_tier

    store = open_store(_store(tmp_path, "rank", num_samples=64, fill="random"), "binary")
    ref = store.read_scattered(np.arange(64))
    sched = _fake_schedule([[(0, [1, 2], []), (1, [5, 6, 7], [])]])
    Server, Mirror = (BufferServer, _DataMirror) if peer_pkg == "torch" else \
        (JServer, JMirror)
    m0 = _DataMirror(8, (8,), np.dtype("<f4"))
    m0.admit([1, 2], ref[[1, 2]])
    m1 = Mirror(8, (8,), np.dtype("<f4"))
    m1.admit(np.asarray([5, 6, 7]), ref[[5, 6, 7]])
    s0 = BufferServer(0, (8,), "<f4").start()
    s1 = Server(1, (8,), "<f4").start()
    s0.attach(lambda node: m0 if node == 0 else None)
    s1.attach(lambda node: m1 if node == 1 else None)
    s1.enable_tenant_serving([], internal_token="cluster")  # proxy reads only
    cfg = ServeTierConfig(tenants=(TenantConfig(1, "t"),))
    tier = wire_rank_tier(server=s0, schedule=sched, store=store,
                          endpoints={1: (s1.host, s1.port)}, config=cfg,
                          cluster_token="cluster")
    c = DataTierClient({0: (s0.host, s0.port)}, tenant=1, token="t",
                       timeout_s=TIMEOUT_S)
    try:
        tier.at_step(1)
        ids = np.asarray([2, 6, 40, 7, 1], np.int64)
        rows, ok = c.read(ids)
        assert ok.all() and rows.tobytes() == ref[ids].tobytes()
        assert tier.stats()["per_tenant"]["1"] == {
            "hits": 2, "peer_reads": 2, "pfs_fallbacks": 1, "sheds": 0}
        # a stale route (the sibling evicted it) falls through to the PFS
        m1.evict(np.asarray([6]))
        rows, ok = c.read(np.asarray([6]))
        assert ok.all() and rows.tobytes() == ref[[6]].tobytes()
        assert tier.stats()["tenant_pfs_fallbacks"] == 2
    finally:
        c.close()
        tier.close()
        s0.close()
        s1.close()
        store.close()


# ---------------------------------------------------------------------------
# Tier-fed serving: generate_from_tier against the JAX engine
# ---------------------------------------------------------------------------

GEN = 6
PROMPT = 40  # past hymba's reduced window of 32: the ring cache wraps


def _noisy_weights(jcfg, seed=1):
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype), tree)


@pytest.fixture(scope="module")
def serving_tier(tmp_path_factory):
    """A port tier over 64 random (8,) f32 rows, ids 0-31 resident (the
    rest read through its PFS fallback), and a dead second endpoint: ids
    a client routes there (odd ids) come back unserved."""
    d = tmp_path_factory.mktemp("serve_tier")
    path = str(d / "rows")
    create_store(path, "binary", spec=DatasetSpec(64, (8,), "<f4"),
                 fill="random", seed=6).close()
    store = open_store(path, "binary")
    tier = StandaloneTier(store, ServeTierConfig(tenants=(TenantConfig(1, "s"),)),
                          resident_ids=np.arange(32))
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead = probe.getsockname()
    probe.close()
    yield store, {0: tier.endpoint, 1: dead}
    tier.close()
    store.close()


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "hymba-1.5b"])
def test_generate_from_tier_matches_the_jax_engine(serving_tier, arch):
    import repro.data.peer as jpeer

    store, endpoints = serving_tier
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    tree = _noisy_weights(jcfg)
    ids = np.asarray([2, 9, 40, 16], np.int64)  # 9 -> dead node, 40 -> PFS
    eng = ServeEngine(cfg, params_from_jax(tree, "cpu"), max_len=PROMPT + GEN + 1,
                      attn_impl="pallas", ssm_impl="pallas", norm_impl="pallas",
                      device="cpu")
    jeng = JaxEngine(jcfg, jax.tree.map(jnp.asarray, tree),
                     max_len=PROMPT + GEN + 1, attn_impl="pallas")
    c = DataTierClient(endpoints, tenant=1, token="s", timeout_s=TIMEOUT_S,
                       retry=RetryPolicy(max_attempts=1, backoff_base_s=0.001))
    jc = jtier.DataTierClient(endpoints, tenant=1, token="s", timeout_s=TIMEOUT_S,
                              retry=jpeer.RetryPolicy(max_attempts=1,
                                                      backoff_base_s=0.001))
    try:
        out, served = eng.generate_from_tier(c, ids, GEN, prompt_len=PROMPT)
        want, jserved = jeng.generate_from_tier(jc, ids, GEN, prompt_len=PROMPT)
    finally:
        c.close()
        jc.close()
    assert served.tolist() == jserved.tolist() == [True, False, True, True]
    assert out.shape == (3, GEN) and out.dtype == np.int32
    np.testing.assert_array_equal(out, np.asarray(want))
    # the same tokens as generate on the store's rows mapped to prompts
    rows = store.read_scattered(ids[served])
    np.testing.assert_array_equal(
        eng.generate(rows_to_prompts(rows, PROMPT, cfg.vocab_size), GEN), out)


def test_partial_read_returns_a_mask_where_the_jax_client_raises(tmp_path):
    """A server with no PFS fallback answers a partial ROWS frame.  The
    port's client returns the rows it got and a False mask for the rest, as
    its contract says; the JAX package's client indexes the compact rows
    with the mask and raises (ROADMAP.md Queue 3, a departure)."""
    store = open_store(_store(tmp_path, "partial", num_samples=16), "binary")
    cfg = ServeTierConfig(tenants=(TenantConfig(1, "p"),))
    try:
        with StandaloneTier(store, cfg, resident_ids=np.arange(8),
                            pfs_fallback=False) as tier:
            ids = np.asarray([3, 12, 7], np.int64)
            c = DataTierClient({0: tier.endpoint}, tenant=1, token="p",
                               timeout_s=TIMEOUT_S)
            jc = jtier.DataTierClient({0: tier.endpoint}, tenant=1, token="p",
                                      timeout_s=TIMEOUT_S)
            try:
                rows, ok = c.read(ids)
                with pytest.raises(IndexError):
                    jc.read(ids)
            finally:
                c.close()
                jc.close()
        assert ok.tolist() == [True, False, True]
        assert rows[ok].tobytes() == store.read_scattered(ids[ok]).tobytes()
        assert c.stats()["rows_unserved"] == 1
    finally:
        store.close()


def test_generate_from_tier_raises_when_nothing_is_served(serving_tier):
    _, endpoints = serving_tier
    cfg = get_config("qwen2-0.5b").reduced()
    from repro_torch.models import lm

    eng = ServeEngine(cfg, lm.init_lm(cfg, seed=0, device="cpu"), max_len=24,
                      device="cpu")
    c = DataTierClient({1: endpoints[1]}, tenant=1, token="s", timeout_s=TIMEOUT_S,
                       sample_shape=(8,), dtype="<f4",
                       retry=RetryPolicy(max_attempts=1, backoff_base_s=0.001))
    try:
        with pytest.raises(RuntimeError, match="served none"):
            eng.generate_from_tier(c, np.asarray([41, 51]), 2, prompt_len=8)
    finally:
        c.close()


def test_launch_serve_reads_prompts_from_the_tier(tmp_path, capsys):
    """The serving CLI with ``--data-tier`` on the CPU: it attaches as the
    tenant, reads ``--batch`` ids from ``--first-id`` across the resident
    edge, prints what the tier served, and generates what the engine
    generates from those rows."""
    from repro_torch.models import lm

    path = _store(tmp_path, "cli", num_samples=64, fill="random")
    store = open_store(path, "binary")
    cfg = ServeTierConfig(tenants=(TenantConfig(1, "cli-token"),))
    try:
        with StandaloneTier(store, cfg, resident_ids=np.arange(32)) as tier:
            host, port = tier.endpoint
            args = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
                    "--batch", "4", "--prompt-len", "12", "--gen", "5",
                    "--data-tier", f"{host}:{port}", "--tenant", "1",
                    "--token", "cli-token", "--first-id", "30"]
            serve.main(args)
            stats = tier.stats()
            with pytest.raises(SystemExit):
                serve.main(["--arch", "whisper-medium", "--reduced", "--device",
                            "cpu", "--data-tier", f"{host}:{port}"])
        out = capsys.readouterr().out
        assert "tier served 4/4 samples" in out
        assert stats["tenant_hits"] == 2 and stats["tenant_pfs_fallbacks"] == 2
        mcfg = get_config("qwen2-0.5b").reduced()
        eng = ServeEngine(mcfg, lm.init_lm(mcfg, seed=0, device="cpu"),
                          max_len=12 + 5 + 1, device="cpu")
        prompts = rows_to_prompts(store.read_scattered(np.arange(30, 34)), 12,
                                  mcfg.vocab_size)
        first = eng.generate(prompts, 5)[0].tolist()
        assert f"first sequence: {first}" in out
    finally:
        store.close()
