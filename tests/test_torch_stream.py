"""The port's streaming ingestion (``repro_torch.stream``, the executor's
stream mode, the prefetch probe and ``launch.train stream``) on the CPU,
against the JAX package.

Three parts:

* the 15 tests of ``tests/test_stream.py`` against the port (admission,
  sealed manifests, spec validation, ``extend``, overlap against
  stop-the-world, the drain, prefetch depths, the empty rank slice, the
  distributed digest parity and the concurrent plan-cache writers);
* parity with the JAX package, bit for bit, on inputs made from numpy
  seeds: admission priorities and admitted sets, ``synthetic_row`` bytes,
  window plans, ``run_stream``'s digests at prefetch depths 0 and 2,
  ``StreamSpec.validate()``'s errors, ``make_planner``'s refusal,
  ``run_stream_distributed``'s per-rank digests, and the CLI's summaries;
* the slice as a whole: reduced hymba-1.5b (2 layers, f32, the JAX init
  carried across by ``convert.lm_params_from_jax``) trains on the sealed
  windows of one pre-fed trace through ``run_stream``'s ``on_batch`` in
  both packages.  The per-step loss agrees within 1e-5 relative (the
  tolerance of ``tests/test_torch_lm_train.py``: the same f32 operations
  summed in other orders) and the token counts exactly.

Every spawning test carries the ``dist`` marker.
"""
from __future__ import annotations

import hashlib
import json
import os
import random
import subprocess
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro import stream as jstream
from repro.configs import get_config as jax_config
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.runtime import launcher as jlauncher
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data import (
    DatasetSpec,
    LoaderSpec,
    PlanCache,
    create_store,
    execute,
    make_planner,
    plan,
)
from repro_torch.launch import train as ttrain
from repro_torch.models import lm
from repro_torch.optim import adamw as tadamw
from repro_torch.stream import (
    IngestSession,
    StreamSpec,
    WindowPlanner,
    admission_priority,
    run_producers,
    run_stream,
    synthetic_row,
)
from repro_torch.train import step as tstep

# Files run in parallel worker processes: one intra-op thread keeps torch's
# thread pool from starving timing-sensitive tests in the other workers.
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _mem_store(tmp_path, n=512, width=8, tag="s", pkg=None):
    return (pkg.create_store if pkg else create_store)(
        str(tmp_path / f"stream_{tag}"), "memory",
        spec=(pkg.DatasetSpec if pkg else DatasetSpec)(n, (width,), "<f4"),
        fill="zeros",
    )


def _feed(session, trace, threads=1, seed=0, pkg=None):
    (pkg.run_producers if pkg else run_producers)(
        session, trace, threads=threads, data_seed=seed)


def _stream_spec(store=None, *, nodes=2, local_batch=4, buffer=64,
                 window_steps=4, watermark=0, max_windows=4, pkg=None, **stream_kw):
    spec_cls = pkg.LoaderSpec if pkg else LoaderSpec
    stream_cls = pkg.StreamSpec if pkg else StreamSpec
    return spec_cls(
        loader="stream", store=store, num_nodes=nodes,
        local_batch=local_batch, buffer_size=buffer, seed=0,
        collect_data=True,
        stream=stream_cls(
            window_steps=window_steps, watermark=watermark,
            max_windows=max_windows, **stream_kw,
        ),
    )


# The JAX package's stream names and its data names in one namespace, as
# the helpers above take them.
JAX = types.SimpleNamespace(
    create_store=jdata.create_store, DatasetSpec=jdata.DatasetSpec,
    LoaderSpec=jdata.LoaderSpec, StreamSpec=jstream.StreamSpec,
    run_producers=jstream.run_producers)


# ---------------------------------------------------------------------------
# Seeded admission: deterministic in (seed, trace), interleaving-independent
# ---------------------------------------------------------------------------


def test_admitted_set_deterministic_in_seed_and_trace(tmp_path):
    """Same (seed, arrival trace) -> identical admitted multiset, even when
    the trace arrives in a different order; a different seed retains a
    different subset."""
    trace = list(range(400))
    shuffled = list(trace)
    random.Random(7).shuffle(shuffled)
    sealed = {}
    for tag, (seed, order) in {
        "a": (3, trace), "b": (3, shuffled), "c": (11, trace),
    }.items():
        with _mem_store(tmp_path, tag=tag) as st:
            sess = IngestSession(
                st, seed=seed, admission="reservoir", reservoir_size=64,
                max_pending=len(trace),
            )
            _feed(sess, order)
            sealed[tag] = sess.seal(min_fresh=0).ids
    np.testing.assert_array_equal(sealed["a"], sealed["b"])
    assert not np.array_equal(sealed["a"], sealed["c"])


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_admitted_set_independent_of_producer_interleaving(tmp_path, threads):
    """Producer thread count (and therefore put() interleaving) never
    changes the admitted set or the bytes an admitted id carries."""
    n, reservoir = 512, 96
    with _mem_store(tmp_path, n=n, tag=f"t{threads}") as st:
        sess = IngestSession(
            st, seed=5, admission="reservoir", reservoir_size=reservoir,
            max_pending=n,
        )
        _feed(sess, range(n), threads=threads, seed=9)
        m = sess.seal(min_fresh=0)
        rows = st.read_ranges([(i, i + 1) for i in m.ids])
    expected = np.asarray(
        sorted(range(n), key=lambda i: (admission_priority(5, i), i))[:reservoir],
        np.int64,
    )
    np.testing.assert_array_equal(m.ids, np.sort(expected))
    for sid, row in zip(m.ids, rows):
        np.testing.assert_array_equal(
            row[0], synthetic_row(sid, st.sample_shape, st.dtype, 9))


def test_latest_policy_retains_freshest_ids(tmp_path):
    with _mem_store(tmp_path, tag="latest") as st:
        sess = IngestSession(
            st, seed=0, admission="latest", reservoir_size=32, max_pending=512)
        _feed(sess, range(300))
        m = sess.seal(min_fresh=0)
    np.testing.assert_array_equal(m.ids, np.arange(268, 300))
    assert sess.stats["evicted"] == 268


def test_sealed_ids_are_immutable(tmp_path):
    """A sealed id is visible to readers through its manifest: a re-put is
    refused and the stored row keeps its original bytes."""
    with _mem_store(tmp_path, tag="sealed") as st:
        sess = IngestSession(st, seed=0, admission="all")
        first = np.full(st.sample_shape, 1.5, "<f4")
        assert sess.put(3, first)
        sess.seal(min_fresh=0)
        assert not sess.put(3, np.full(st.sample_shape, -9.0, "<f4"))
        assert sess.stats["rejected_sealed"] == 1
        np.testing.assert_array_equal(st.read_ranges([(3, 4)])[0][0], first)


def test_put_rejects_ids_outside_the_store(tmp_path):
    from repro_torch.stream import IngestError

    with _mem_store(tmp_path, n=16, tag="oob") as st:
        sess = IngestSession(st, admission="all")
        with pytest.raises(IngestError):
            sess.put(16, np.zeros(st.sample_shape, "<f4"))
        with pytest.raises(ValueError):
            IngestSession(st, admission="bogus")


# ---------------------------------------------------------------------------
# Spec validation + planner registry
# ---------------------------------------------------------------------------


def test_stream_spec_validation(tmp_path):
    with _mem_store(tmp_path, tag="val") as st:
        with pytest.raises(ValueError, match="needs stream="):
            LoaderSpec(loader="stream", store=st).validate()
        with pytest.raises(ValueError, match="requires loader='stream'"):
            LoaderSpec(loader="solar", store=st, stream=StreamSpec()).validate()
        with pytest.raises(ValueError, match="plan_cache"):
            _stream_spec(st).replace(plan_cache=str(tmp_path)).validate()
        with pytest.raises(ValueError, match="admission"):
            _stream_spec(st, admission="bogus").validate()
        with pytest.raises(ValueError, match="no offline planner"):
            make_planner(_stream_spec(st))


def test_extend_rejects_geometry_mismatch(tmp_path):
    with _mem_store(tmp_path, tag="geom") as st:
        spec = _stream_spec(st)
        sess = IngestSession(st, admission="all", max_pending=512)
        _feed(sess, range(128))
        ids = sess.seal(min_fresh=0).ids
        seg = WindowPlanner.for_spec(spec).plan_window(ids)
        other = WindowPlanner.for_spec(
            spec.replace(local_batch=spec.local_batch * 2)).plan_window(ids)
        ex = execute(spec, seg, store=st)
        with pytest.raises(ValueError, match="local_batch"):
            ex.extend(other)


# ---------------------------------------------------------------------------
# The determinism contract: live windows == one-shot offline replan
# ---------------------------------------------------------------------------


def test_run_stream_overlap_and_stop_the_world_agree(tmp_path):
    """Overlapped window planning and stop-the-world replanning execute
    byte-identical batch streams, and both match the offline replan."""
    reports = {}
    for overlap in (False, True):
        with _mem_store(tmp_path, n=256, tag=f"ov{overlap}") as st:
            sess = IngestSession(st, seed=0, admission="all", max_pending=256)
            _feed(sess, range(256), threads=2)
            rep = run_stream(_stream_spec(st), sess, overlap=overlap, verify=True)
        assert rep.ok, rep.verify
        assert rep.windows == 4 and rep.steps == 16
        reports[overlap] = rep
    assert reports[False].plan_digest == reports[True].plan_digest
    assert reports[False].stream_digest == reports[True].stream_digest


def test_run_stream_drains_when_producers_finish(tmp_path):
    """With no window cap the stream runs until the producers finish and a
    seal comes back empty — and still replays offline digest-identically."""
    with _mem_store(tmp_path, n=384, tag="drain") as st:
        sess = IngestSession(st, seed=1, admission="all", max_pending=64)
        t = threading.Thread(target=_feed, args=(sess, range(384)),
                             kwargs=dict(threads=2), daemon=True)
        t.start()
        rep = run_stream(_stream_spec(st, max_windows=None, watermark=16), sess,
                         verify=True)
        t.join(timeout=30.0)
    assert rep.ok, rep.verify
    assert sess.finished and rep.windows >= 1
    assert rep.ingest_stats["admitted"] == 384


def test_prefetched_stream_matches_synchronous(tmp_path):
    """The pipelined executor coordinates with extend() at window
    boundaries (instead of deadlocking read-ahead) and reproduces the
    synchronous batch stream exactly."""
    digests = {}
    for depth in (0, 2):
        with _mem_store(tmp_path, n=256, tag=f"pf{depth}") as st:
            sess = IngestSession(st, seed=2, admission="all", max_pending=256)
            _feed(sess, range(256), threads=2)
            rep = run_stream(_stream_spec(st).replace(prefetch_depth=depth), sess,
                             verify=True)
        assert rep.ok, rep.verify
        digests[depth] = (rep.plan_digest, rep.stream_digest)
    assert digests[0] == digests[2]


# ---------------------------------------------------------------------------
# A rank whose slice is empty is a valid plan, not an error
# ---------------------------------------------------------------------------


def _offline_spec(tmp_path, *, nodes=2, tag="off"):
    path = str(tmp_path / f"ds_{tag}")
    create_store(path, "binary", spec=DatasetSpec(256, (8,), "<f4"), fill="arange").close()
    return LoaderSpec(
        loader="naive", backend="binary", path=path, num_nodes=nodes,
        local_batch=8, num_epochs=1, buffer_size=32, collect_data=True,
    )


def test_empty_rank_slice_is_a_valid_plan(tmp_path):
    spec = _offline_spec(tmp_path)
    sched = plan(spec)
    with pytest.raises(ValueError, match="out of range"):
        sched.for_node(2)
    empty = sched.for_node(0).for_node(1)  # rank 1 of a rank-0-only slice
    stats = empty.stats()
    assert stats.total_samples_trained == 0
    assert empty.artifact_digest()
    for ep in empty.epochs:
        for sp in ep.steps:
            assert sp.global_batch().size == 0 and sp.max_pfs_samples == 0
    ex = execute(spec, empty)
    h = hashlib.sha256()
    steps = 0
    for sb in ex:
        steps += 1
        assert sb.node_ids == []
    assert steps == sum(len(ep.steps) for ep in empty.epochs) > 0
    assert h.hexdigest() == hashlib.sha256().hexdigest()


@pytest.mark.dist
def test_distributed_rank_with_empty_slice_barriers_through(tmp_path):
    """A rank handed an empty slice must still register, barrier through
    every step, and report the empty-stream digest — not crash or stall."""
    from repro_torch.runtime.launcher import in_process_digests, run_distributed

    spec = _offline_spec(tmp_path, tag="dist")
    sched = plan(spec).for_node(0)  # rank 1's share of this plan is empty
    report = run_distributed(spec, schedule=sched, timeout_s=240.0)
    assert report.ok, f"dead ranks: {report.dead}"
    digests = report.digests()
    assert digests[1] == hashlib.sha256().hexdigest()
    assert digests == in_process_digests(spec, sched)


# ---------------------------------------------------------------------------
# Distributed streaming: broadcast windows, same-step cut-over, digest parity
# ---------------------------------------------------------------------------


def _run_distributed_stream(tmp_path, depth):
    from repro_torch.data import build_store
    from repro_torch.stream.distributed import run_stream_distributed

    spec = LoaderSpec(
        loader="stream", backend="sharded", path=str(tmp_path / "shard"),
        num_nodes=2, local_batch=4, buffer_size=64, seed=0,
        collect_data=True, prefetch_depth=depth,
        stream=StreamSpec(window_steps=4, watermark=0, max_windows=3),
    )
    store = build_store(spec, create=True, dataset=DatasetSpec(256, (8,), "<f4"),
                        fill="zeros")
    try:
        sess = IngestSession(store, seed=0, admission="all", max_pending=256)
        _feed(sess, range(256), threads=2)
        rep = run_stream_distributed(spec, sess, verify=True, timeout_s=240.0)
    finally:
        store.close()
    assert not rep.dead, f"dead ranks: {rep.dead}"
    assert rep.windows == 3 and rep.steps == 12
    assert rep.ok, rep.verify
    assert rep.verify["plan_parity"] and rep.verify["rank_parity"]
    return spec, rep


@pytest.mark.dist
def test_stream_distributed_two_ranks_digest_parity(tmp_path):
    _run_distributed_stream(tmp_path, 0)


@pytest.mark.dist
def test_stream_distributed_with_prefetch_depth_digest_parity(tmp_path):
    """Async prefetch inside streaming ranks: with ``prefetch_depth > 0``
    each rank's PrefetchExecutor reads ahead into its already-chained
    windows while the main thread waits at the w:k cutover barriers — and
    the digests still match the offline replan and the in-process
    reference bit for bit."""
    _run_distributed_stream(tmp_path, 2)


# ---------------------------------------------------------------------------
# PlanCache under concurrent writers
# ---------------------------------------------------------------------------

_CACHE_WORKER = r"""
import sys
from repro_torch.core.planners import PlanCache
from repro_torch.data import LoaderSpec, make_planner, open_store

path, cache_dir = sys.argv[1], sys.argv[2]
store = open_store(path, "binary")
spec = LoaderSpec(
    loader="solar", store=store, num_nodes=4, local_batch=8,
    num_epochs=2, buffer_size=64, seed=0,
)
planner = make_planner(spec)
sched, hit = PlanCache(cache_dir).load_or_build(planner, store.num_samples, 2)
print(sched.artifact_digest(), int(hit))
store.close()
"""


def test_plan_cache_safe_under_concurrent_writers(tmp_path):
    """N processes racing load_or_build on the same key must all come back
    with the same valid schedule — never a corrupt artifact or a
    miss-forever cache entry."""
    from repro_torch.data import open_store

    path = str(tmp_path / "race.bin")
    create_store(path, "binary", spec=DatasetSpec(512, (8,), "<f4"), fill="arange").close()
    cache_dir = str(tmp_path / "cache")
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [
        subprocess.Popen([sys.executable, "-c", _CACHE_WORKER, path, cache_dir],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for _ in range(4)
    ]
    outs = [p.communicate(timeout=240.0) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    digests = {out.split()[0] for out, _ in outs}
    assert len(digests) == 1, f"racing writers diverged: {digests}"
    with open_store(path, "binary") as store:
        spec = LoaderSpec(loader="solar", store=store, num_nodes=4, local_batch=8,
                          num_epochs=2, buffer_size=64, seed=0)
        planner = make_planner(spec)
        cache = PlanCache(cache_dir)
        key = planner.cache_key(store.num_samples, 2)
        cached = cache.get(key)
        assert cached is not None
        assert cached.artifact_digest() == digests.pop()
        sched, hit = cache.load_or_build(planner, store.num_samples, 2)
        assert hit
    leftovers = [f for f in os.listdir(cache_dir) if not f.endswith(".npz")]
    assert leftovers == [], f"stale temp files: {leftovers}"


# ---------------------------------------------------------------------------
# Parity with the JAX package, bit for bit
# ---------------------------------------------------------------------------


def test_admission_priority_and_synthetic_rows_equal_the_jax_package():
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, 2**31, 16)
    ids = rng.integers(0, 2**40, 64)
    for seed in seeds:
        for sid in ids:
            assert admission_priority(seed, sid) == jstream.admission_priority(seed, sid)
    for dtype, shape in (("<f4", (8,)), ("<i4", (33,)), ("<f2", (2, 3)), ("<u1", (5,))):
        for sid in rng.integers(0, 10_000, 8):
            got = synthetic_row(sid, shape, dtype, 3)
            want = jstream.synthetic_row(sid, shape, dtype, 3)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("admission,reservoir", [("reservoir", 48), ("latest", 40),
                                                  ("all", None)])
def test_admitted_set_equals_the_jax_package(tmp_path, admission, reservoir):
    """The same seed and arrival multiset, in another order on each side:
    the same sealed ids and the same row bytes."""
    trace = np.random.default_rng(4).integers(0, 300, 500).tolist()
    shuffled = list(trace)
    random.Random(1).shuffle(shuffled)
    out = {}
    for name, pkg, session_cls, order in (
            ("port", None, IngestSession, trace),
            ("jax", JAX, jstream.IngestSession, shuffled)):
        with _mem_store(tmp_path, n=300, tag=f"{name}_{admission}", pkg=pkg) as st:
            sess = session_cls(st, seed=7, admission=admission,
                               reservoir_size=reservoir, max_pending=len(order))
            _feed(sess, order, threads=2, seed=5, pkg=pkg)
            m = sess.seal(min_fresh=0)
            rows = st.read_scattered(m.ids)
            # the other counts (overwrites, evictions) follow the order
            out[name] = (m.ids, m.fresh, sess.stats["arrivals"], rows.tobytes())
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    assert out["port"][1:] == out["jax"][1:]


@pytest.mark.parametrize("peer_fetch", [False, True])
def test_window_plans_equal_the_jax_package(peer_fetch):
    """Window by window over growing and shrinking manifests, and the
    one-shot offline replan: the same artifact digests."""
    rng = np.random.default_rng(11)
    manifests = [np.sort(rng.choice(400, size=int(n), replace=False))
                 for n in (40, 90, 90, 150, 60)]
    kw = dict(num_nodes=3, local_batch=5, buffer_size=24, window_steps=3, seed=2,
              max_chunk=4, peer_fetch=peer_fetch)
    port, ref = WindowPlanner(**kw), jstream.WindowPlanner(**kw)
    assert port.config_hash() == ref.config_hash()
    for m in manifests:
        assert port.plan_window(m).artifact_digest() == ref.plan_window(m).artifact_digest()
    assert (port.replay_offline(manifests).artifact_digest()
            == ref.replay_offline(manifests).artifact_digest())
    assert port.clone().windows_planned == 0


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("overlap", [True, False])
def test_run_stream_digests_equal_the_jax_package(tmp_path, depth, overlap):
    """The same pre-fed trace (admission 'all', watermark 0): the live plan
    and the executed batch stream hash alike in both packages."""
    reps = {}
    for name, pkg, session_cls, runner in (
            ("port", None, IngestSession, run_stream),
            ("jax", JAX, jstream.IngestSession, jstream.run_stream)):
        with _mem_store(tmp_path, n=256, tag=f"{name}{depth}{overlap}", pkg=pkg) as st:
            sess = session_cls(st, seed=3, admission="all", max_pending=256)
            _feed(sess, range(256), threads=2, seed=1, pkg=pkg)
            spec = _stream_spec(st, window_steps=3, max_windows=3, pkg=pkg)
            reps[name] = runner(spec.replace(prefetch_depth=depth), sess,
                                overlap=overlap, verify=True)
    port, ref = reps["port"], reps["jax"]
    assert port.ok and ref.ok
    assert (port.plan_digest, port.stream_digest) == (ref.plan_digest, ref.stream_digest)
    assert (port.windows, port.steps) == (ref.windows, ref.steps) == (3, 9)
    assert port.verify == ref.verify
    summary = {k: v for k, v in port.summary().items()
               if k not in ("wall_s", "bootstrap_s", "blocked_on_planning_s", "plan_s")}
    want = {k: v for k, v in ref.summary().items()
            if k not in ("wall_s", "bootstrap_s", "blocked_on_planning_s", "plan_s")}
    for s in (summary, want):
        s["ingest"].pop("blocked_s")
        s["loader"].pop("wall_time_s")
    assert summary == want


def test_spec_errors_and_refusals_equal_the_jax_package(tmp_path):
    bad = [dict(window_steps=0), dict(admission="bogus"), dict(watermark=-1),
           dict(reservoir_size=0), dict(max_pending=0), dict(max_windows=0),
           dict(window_steps=-2, admission="x", watermark=-3, reservoir_size=0,
                max_pending=0, max_windows=0), {}]
    for kw in bad:
        assert StreamSpec(**kw).validate() == jstream.StreamSpec(**kw).validate()
    with _mem_store(tmp_path, tag="port_err") as st, \
            _mem_store(tmp_path, tag="jax_err", pkg=JAX) as jst:
        cases = [
            lambda pkg, s: pkg.LoaderSpec(loader="stream", store=s),
            lambda pkg, s: pkg.LoaderSpec(loader="solar", store=s, stream=pkg.StreamSpec()),
            lambda pkg, s: _stream_spec(s, pkg=pkg).replace(plan_path="x.npz"),
            lambda pkg, s: _stream_spec(s, pkg=pkg, window_steps=0, admission="no"),
        ]
        port_pkg = types.SimpleNamespace(LoaderSpec=LoaderSpec, StreamSpec=StreamSpec)
        for case in cases:
            with pytest.raises(ValueError) as got:
                case(port_pkg, st).validate()
            with pytest.raises(ValueError) as want:
                case(JAX, jst).validate()
            assert str(got.value) == str(want.value)
        with pytest.raises(ValueError, match="no offline planner"):
            make_planner(_stream_spec(st))
        with pytest.raises(ValueError, match="no offline planner"):
            jdata.make_planner(_stream_spec(jst, pkg=JAX))
        # a window config hash from another streaming config is refused alike
        spec, jspec = _stream_spec(st), _stream_spec(jst, pkg=JAX)
        seg = WindowPlanner.for_spec(spec.replace(seed=1)).plan_window(np.arange(64))
        with pytest.raises(ValueError, match="window config hash"):
            execute(spec, seg, store=st)
        jseg = jstream.WindowPlanner.for_spec(jspec.replace(seed=1)).plan_window(np.arange(64))
        with pytest.raises(ValueError, match="window config hash"):
            jdata.execute(jspec, jseg, store=jst)


@pytest.mark.dist
def test_distributed_rank_digests_equal_the_jax_in_process_digests(tmp_path):
    """The port's stream ranks against the JAX package's own reference: the
    same windows replanned by the JAX planner, and its per-rank digests
    over a JAX store holding the same rows."""
    spec, rep = _run_distributed_stream(tmp_path, 2)
    jspec = jdata.LoaderSpec(
        loader="stream", backend="sharded", path=str(tmp_path / "jshard"),
        num_nodes=2, local_batch=4, buffer_size=64, seed=0, collect_data=True,
        stream=jstream.StreamSpec(window_steps=4, watermark=0, max_windows=3))
    jstore = jdata.build_store(jspec, create=True,
                               dataset=jdata.DatasetSpec(256, (8,), "<f4"), fill="zeros")
    try:
        sess = jstream.IngestSession(jstore, seed=0, admission="all", max_pending=256)
        jstream.run_producers(sess, range(256), threads=2, data_seed=0)
        ids = sess.seal(min_fresh=0).ids
        sched = jstream.WindowPlanner.for_spec(jspec).replay_offline([ids] * rep.windows)
        assert sched.artifact_digest() == rep.plan_digest
        want = jlauncher.in_process_digests(jspec, sched, store=jstore)
    finally:
        jstore.close()
    assert {int(r): d for r, d in rep.rank_digests.items()} == want
    assert rep.verify["reference_digests"] == want


def _keys(tree):
    """The nested key structure of a JSON summary."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


@pytest.mark.parametrize("mode", [
    pytest.param([], id="overlap"),
    pytest.param(["--stop-the-world"], id="stop_the_world"),
    pytest.param(["--distributed"], id="distributed", marks=pytest.mark.dist),
])
def test_stream_cli_verifies_like_the_jax_cli(tmp_path, capsys, mode):
    """``launch.train stream --verify`` exits cleanly in both packages with
    the parities true, and prints summaries with the same keys (window
    and step counts follow the producers' timing, so they are not
    compared)."""
    argv = ["stream", "--nodes", "2", "--num-samples", "512", "--local-batch", "4",
            "--buffer", "64", "--window-steps", "4", "--watermark", "32",
            "--verify", "-q", *mode]
    port = ttrain.main(argv + ["--data", str(tmp_path / "port")])
    printed = json.loads(capsys.readouterr().out)
    jtrain.main(argv + ["--data", str(tmp_path / "jax")])
    want = json.loads(capsys.readouterr().out)
    assert printed == port
    assert _keys(port) == _keys(want)
    parity = "rank_parity" if mode == ["--distributed"] else "stream_parity"
    for out in (port, want):
        assert out["verify"]["plan_parity"] and out["verify"][parity]
        assert out["ingest"]["admitted"] == 512


# ---------------------------------------------------------------------------
# The slice as a whole: reduced hymba-1.5b trains on sealed windows
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)


def _jax_tree(arch, seed=0, noise=0.05):
    """The JAX init with seeded noise on every leaf (zero biases and norm
    scales would hide a bias or ``1 + scale`` fault)."""
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(seed),
                                                jax_config(arch).reduced()))
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(lambda a: (a + noise * rng.standard_normal(a.shape)).astype(a.dtype),
                        tree)


def test_hymba_trains_on_sealed_windows_like_the_jax_package(tmp_path):
    """2 windows x 2 steps of 2 nodes x 2 rows of 32 tokens from one pre-fed
    trace: each package's ``run_stream`` hands its batches to its own train
    step (the port's through the plain kernel versions on the CPU); the
    per-step loss agrees within 1e-5 relative, the token counts exactly."""
    arch, seq, nodes, rows = "hymba-1.5b", 32, 2, 2
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    assert (cfg.num_layers, cfg.param_dtype) == (2, "float32")
    tree = _jax_tree(arch)
    jopt = jadamw.AdamWConfig(**OPT)
    jfn = jax.jit(jstep.make_train_step(jcfg, jopt, lambda p, b: jlm.train_loss(p, b, jcfg)))
    opt = tadamw.AdamWConfig(**OPT)
    step = tstep.make_train_step(cfg, opt, lambda p, b: lm.train_loss(
        lm.nested_params(p), b, cfg))
    make_batch = ttrain.make_batch_fn(cfg, rows)

    def jax_batch(sb):  # the JAX launcher's make_batch
        data, weights = sb.to_global(rows)
        return {"tokens": jnp.asarray(data[:, :-1] % jcfg.vocab_size, jnp.int32),
                "labels": jnp.asarray(data[:, 1:] % jcfg.vocab_size, jnp.int32),
                "weights": jnp.asarray(weights)}

    state = {"port": tstep.init_train_state(convert.lm_params_from_jax(tree, "cpu"), opt),
             "jax": jstep.init_train_state(jax.tree.map(jnp.asarray, tree), jopt)}
    seen = {"port": [], "jax": []}

    def port_hook(sb):
        batch = {k: torch.from_numpy(v) for k, v in make_batch(sb).items()}
        state["port"], m = step(state["port"], batch)
        seen["port"].append((float(m["loss"]), float(m["tokens"]), sb.step))

    def jax_hook(sb):
        state["jax"], m = jfn(state["jax"], jax_batch(sb))
        seen["jax"].append((float(m["loss"]), float(m["tokens"]), sb.step))

    reps = {}
    for name, pkg, session_cls, runner, hook in (
            ("port", None, IngestSession, run_stream, port_hook),
            ("jax", JAX, jstream.IngestSession, jstream.run_stream, jax_hook)):
        create = pkg.create_store if pkg else create_store
        dspec = (pkg.DatasetSpec if pkg else DatasetSpec)(64, (seq + 1,), "<i4")
        with create(str(tmp_path / f"hymba_{name}"), "memory", spec=dspec,
                    fill="zeros") as st:
            sess = session_cls(st, seed=0, admission="all", max_pending=64)
            _feed(sess, range(64), threads=2, pkg=pkg)
            spec = _stream_spec(st, nodes=nodes, local_batch=rows, buffer=16,
                                window_steps=2, max_windows=2, pkg=pkg)
            reps[name] = runner(spec, sess, overlap=True, verify=True, on_batch=hook)
    assert reps["port"].ok and reps["jax"].ok
    assert reps["port"].stream_digest == reps["jax"].stream_digest
    assert len(seen["port"]) == len(seen["jax"]) == 4
    for (loss, tokens, s), (jloss, jtokens, js) in zip(seen["port"], seen["jax"]):
        assert s == js
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        assert tokens == jtokens == nodes * rows * seq
        assert np.isfinite(loss)
