"""The port's own copies of ``repro.core`` and ``repro.data`` against the JAX
package's: the same spec gives the same schedule (content digest and config
hash), plan artifacts and stores written by one package load in the other,
and replaying a plan gives the same batch stream (digest over ids, hit
masks and bytes) and the same loader accounting, with and without prefetch,
on the binary and memory backends, the peer tier included.  The streaming
path, not ported yet, raises; a socket spec needs a live transport."""
import numpy as np
import pytest
import torch

import repro.data as rdata
import repro_torch.data as tdata
from repro.core.plan import Schedule as RSchedule
from repro.core.scheduler import SolarConfig as RSolarConfig
from repro_torch.core.plan import Schedule as TSchedule
from repro_torch.core.scheduler import SolarConfig as TSolarConfig

torch.set_num_threads(1)

STRATEGIES = ["naive", "lru", "nopfs", "deepio", "solar"]
GEOMETRIES = {
    "A": dict(num_nodes=4, local_batch=8, num_epochs=2, buffer_size=64, seed=0),
    "B": dict(num_nodes=2, local_batch=16, num_epochs=3, buffer_size=96, seed=1),
}
PKGS = {"jax": (rdata, RSchedule), "torch": (tdata, TSchedule)}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """One 512 x (8,) f32 random dataset per backend, written by the JAX
    package and opened by both."""
    d = tmp_path_factory.mktemp("stores")
    out = {}
    for backend in ("binary", "memory"):
        path = str(d / f"ds.{backend}")
        r = rdata.create_store(path, backend, spec=rdata.DatasetSpec(512, (8,), "<f4"),
                               fill="random", seed=3)
        out[backend] = (r, tdata.open_store(path, backend))
    yield out
    for r, t in out.values():
        r.close()
        t.close()


def _spec(pkg, name, store, geo, **kw):
    return pkg.LoaderSpec(loader=name, store=store, collect_data=True, **geo, **kw)


def _accounting(report):
    s = report.summary()
    s.pop("wall_time_s")
    return (s, report.pfs_counts, report.miss_counts, report.remote_counts,
            report.batch_sizes, report.modeled_time_s, report.total_hits,
            report.total_samples)


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
@pytest.mark.parametrize("name", STRATEGIES)
def test_schedule_digest_and_config_hash_match(stores, name, geo):
    r_store, t_store = stores["binary"]
    rs = rdata.plan(_spec(rdata, name, r_store, GEOMETRIES[geo]))
    ts = tdata.plan(_spec(tdata, name, t_store, GEOMETRIES[geo]))
    assert ts.config_hash == rs.config_hash
    assert ts.artifact_digest() == rs.artifact_digest()
    assert ts.stats().summary() == rs.stats().summary()


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("name", STRATEGIES)
def test_plan_artifact_loads_in_the_other_package(stores, tmp_path, name, writer):
    geo = GEOMETRIES["B"]
    r_store, t_store = stores["binary"]
    reader = "torch" if writer == "jax" else "jax"
    (wpkg, _), (_, rcls) = PKGS[writer], PKGS[reader]
    store = r_store if writer == "jax" else t_store
    sched = wpkg.plan(_spec(wpkg, name, store, geo))
    path = str(tmp_path / "plan.npz")
    sched.save(path)
    back = rcls.load(path, expect_hash=sched.config_hash)
    assert back.artifact_digest() == sched.artifact_digest()
    # the loaded plan executes in the reading package
    rpkg = PKGS[reader][0]
    rstore = t_store if reader == "torch" else r_store
    spec = _spec(rpkg, name, rstore, geo)
    assert rpkg.stream_digest(rpkg.execute(spec, back)) == \
        wpkg.stream_digest(wpkg.execute(_spec(wpkg, name, store, geo), sched))


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("backend", ["binary", "memory"])
@pytest.mark.parametrize("name", STRATEGIES)
def test_batch_stream_and_accounting_match(stores, name, backend, depth):
    r_store, t_store = stores[backend]
    geo = GEOMETRIES["A"]
    rp = rdata.build_pipeline(_spec(rdata, name, r_store, geo, prefetch_depth=depth,
                                    num_workers=2))
    tp = tdata.build_pipeline(_spec(tdata, name, t_store, geo, prefetch_depth=depth,
                                    num_workers=2))
    assert tdata.stream_digest(tp) == rdata.stream_digest(rp)
    assert _accounting(tp.report) == _accounting(rp.report)


@pytest.mark.parametrize("depth", [0, 2])
def test_solar_peer_fetch_stream_and_accounting_match(tmp_path, depth):
    path = str(tmp_path / "peer.bin")
    r_store = rdata.create_store(path, "binary", spec=rdata.DatasetSpec(1024, (8,), "<f4"),
                                 fill="arange")
    t_store = tdata.open_store(path, "binary")
    geo = dict(num_nodes=4, local_batch=16, num_epochs=3, buffer_size=128, seed=0)
    kw = dict(peer_fetch=True, prefetch_depth=depth, num_workers=2)
    try:
        rp = rdata.build_pipeline(_spec(rdata, "solar", r_store, geo, solar=RSolarConfig(
            num_nodes=4, local_batch=16, buffer_size=128, capacity_factor=1.0,
            enable_peer=True, seed=0), **kw))
        tp = tdata.build_pipeline(_spec(tdata, "solar", t_store, geo, solar=TSolarConfig(
            num_nodes=4, local_batch=16, buffer_size=128, capacity_factor=1.0,
            enable_peer=True, seed=0), **kw))
        assert tdata.stream_digest(tp) == rdata.stream_digest(rp)
        assert _accounting(tp.report) == _accounting(rp.report)
        # the peer tier really served, and served the same
        assert tp.peer_exchange.served > 0
        assert (tp.peer_exchange.served, tp.peer_exchange.fallbacks) == \
            (rp.peer_exchange.served, rp.peer_exchange.fallbacks)
    finally:
        r_store.close()
        t_store.close()


@pytest.mark.parametrize("name", STRATEGIES)
def test_fast_forward_and_to_global_match(stores, name):
    r_store, t_store = stores["binary"]
    geo = GEOMETRIES["A"]
    rp = rdata.build_pipeline(_spec(rdata, name, r_store, geo))
    tp = tdata.build_pipeline(_spec(tdata, name, t_store, geo))
    rp.fast_forward(5)
    tp.fast_forward(5)
    rb, tb = list(rp), list(tp)
    assert tdata.stream_digest(tb) == rdata.stream_digest(rb)
    assert tp.capacity == rp.capacity
    for r, t in zip(rb[:3], tb[:3]):
        (rd, rw), (td, tw) = r.to_global(rp.capacity), t.to_global(tp.capacity)
        assert td.tobytes() == rd.tobytes() and tw.tobytes() == rw.tobytes()


def test_read_ahead_is_traced_as_the_step_it_serves(stores):
    """Chunk reads issued ahead, by the rank loop's read-ahead and by the
    prefetch executor, carry the step they serve, not the current one."""
    from repro_torch.data.prefetch import PrefetchExecutor, WindowReadAhead
    from repro_torch.obs import trace as obs_trace

    _, t_store = stores["binary"]
    pipe = tdata.build_pipeline(_spec(tdata, "solar", t_store, GEOMETRIES["A"]))
    _, sp = next(iter(pipe.plan_steps()))
    tracer = obs_trace.enable()
    try:
        tracer.set_step(1)
        with WindowReadAhead(2) as ra:
            assert WindowReadAhead.collect(ra.submit(t_store, sp, 4))
        ex = PrefetchExecutor(pipe, depth=2, num_workers=2)
        ex.first_step = 10
        with ex:
            got = [sb for _, sb in zip(range(3), ex)]
    finally:
        obs_trace.disable()
    assert len(got) == 3
    recs, threads, _ = tracer.records()
    rows = [(obs_trace.kind_name(int(r["kind"])), int(r["step"]), th)
            for r, th in zip(recs, threads)]
    reads = [(s, th) for k, s, th in rows if k == "chunk.read"]
    assembled = [s for k, s, _ in rows if k == "prefetch.assemble"]
    assert reads and all(th.startswith("solar-io") for _, th in reads)
    assert 4 in {s for s, _ in reads} and all(s == 4 or s >= 10 for s, _ in reads)
    assert assembled[:3] == [10, 11, 12] and assembled == sorted(assembled)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("backend", ["binary", "memory", "sharded", "hdf5"])
def test_store_reads_back_bit_for_bit_in_the_other_package(tmp_path, backend, writer):
    if backend == "hdf5":
        pytest.importorskip("h5py")
    reader = "torch" if writer == "jax" else "jax"
    wpkg, rpkg = PKGS[writer][0], PKGS[reader][0]
    path = str(tmp_path / f"ds.{backend}")
    w = wpkg.create_store(path, backend, spec=wpkg.DatasetSpec(300, (4, 3), "<f4"),
                          fill="random", seed=5)
    r = rpkg.open_store(path, backend)
    try:
        ids = np.array([0, 7, 8, 9, 150, 299], np.int64)
        assert r.read_scattered(ids).tobytes() == w.read_scattered(ids).tobytes()
        ranges = [(0, 10), (40, 41), (290, 300)]
        for a, b in zip(r.read_ranges(ranges), w.read_ranges(ranges)):
            assert a.tobytes() == b.tobytes()
        assert (r.num_samples, r.sample_shape, r.dtype) == \
            (w.num_samples, w.sample_shape, w.dtype)
    finally:
        r.close()
        w.close()


def test_streaming_and_socket_paths_raise_not_implemented(stores):
    """The streaming path is ported (``tests/test_torch_stream.py``): a
    stream spec validates, ``StreamSpec()`` constructs, and ``make_planner``
    refuses a stream spec with the JAX package's ``ValueError`` (windows are
    planned as manifests seal); nothing raises ``NotImplementedError``.
    The socket path's own test follows."""
    r_store, t_store = stores["binary"]
    geo = {k: v for k, v in GEOMETRIES["A"].items() if k != "num_epochs"}
    assert tdata.StreamSpec() == tdata.pipeline.StreamSpec()
    for pkg, store, stream_spec in ((tdata, t_store, tdata.StreamSpec),
                                    (rdata, r_store, rdata.pipeline.StreamSpec)):
        spec = pkg.LoaderSpec(loader="stream", store=store, stream=stream_spec(), **geo)
        spec.validate()
        with pytest.raises(ValueError, match="no offline planner"):
            pkg.make_planner(spec)


def test_socket_path_needs_a_live_transport_as_in_the_jax_package(stores):
    """``transport="socket"`` without a live transport raises ``ValueError``
    in both packages, and the port's ``SocketTransport`` constructs."""
    r_store, t_store = stores["binary"]
    geo = GEOMETRIES["A"]
    for pkg, store in ((rdata, r_store), (tdata, t_store)):
        spec = pkg.LoaderSpec(loader="solar", store=store, transport="socket", **geo)
        with pytest.raises(ValueError, match="live peer transport"):
            pkg.build_pipeline(spec)
        with pytest.raises(ValueError, match="live peer transport"):
            pkg.execute(spec, pkg.plan(spec))
    t = tdata.SocketTransport({1: ("localhost", 1)}, self_node=0)
    assert t.endpoints == {1: ("localhost", 1)} and t.stats()["retries"] == 0
    t.close()
