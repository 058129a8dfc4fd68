"""Plan-first pipeline API: ``plan(spec) -> Schedule``, ``execute(spec, schedule)``.

Every loading strategy compiles offline to the same
:class:`~repro_torch.core.plan.Schedule` IR and one runtime replays it
(:class:`~repro_torch.data.loaders.ScheduleExecutor`), so the public API splits
along exactly that seam:

    spec = LoaderSpec(
        loader="solar", backend="hdf5", path="/data/ptycho.h5",
        num_nodes=8, local_batch=32, num_epochs=6, buffer_size=1024,
        collect_data=True, prefetch_depth=2, num_workers=8,
    )
    schedule = plan(spec)                 # offline: compile (or load) the plan
    pipeline = execute(spec, schedule)    # runtime: replay it against the store
    for step_batch in pipeline:
        ...

``build_pipeline(spec)`` is their composition — the one-call form every
benchmark and the trainer use.  The plan side is where the amortization
lives: ``spec.plan_cache`` memoizes schedules on disk keyed by the
planner's config hash (:class:`~repro_torch.core.planners.PlanCache`),
``spec.plan_path`` pins one explicit artifact (loaded when present, built
and saved when not), and a standalone ``plan(spec, num_samples=...)`` can
precompute artifacts with no dataset in sight (``repro_torch.launch.train plan``).

``execute`` refuses schedules whose geometry or recorded ``config_hash``
contradicts the spec — replaying a plan built for a different run fails
loudly instead of training the wrong samples.

When the spec names a ``path``, the backend is opened (or, for
:func:`build_store`, created) through the registry in
:mod:`repro_torch.data.backends`; a pre-opened ``store`` short-circuits that and
is used as-is (``path`` and ``store`` are mutually exclusive on the spec).

Streaming specs (``loader="stream"``, :class:`StreamSpec`) have no offline
planner: :mod:`repro_torch.stream` compiles them window by window as
manifests seal and chains the segments onto a live executor.  A
``transport="socket"`` spec executes against a live
:class:`~repro_torch.data.peer.SocketTransport` passed to :func:`execute`;
:func:`repro_torch.runtime.run_distributed` wires one per rank.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

from repro_torch.core.costmodel import PeerCostModel, PFSCostModel
from repro_torch.core.plan import Schedule
from repro_torch.core.planners import PLANNERS, PlanCache, Planner, SolarPlanner
from repro_torch.core.scheduler import SolarConfig
from repro_torch.data.backends.base import backend_names, create_store, open_store
from repro_torch.stream.windows import STREAM_STRATEGY, StreamSpec, WindowPlanner

__all__ = [
    "LoaderSpec",
    "StreamSpec",
    "plan",
    "execute",
    "build_pipeline",
    "build_store",
    "make_planner",
]


@dataclasses.dataclass
class LoaderSpec:
    """Everything needed to stand up one data pipeline, in one place.

    The spec is plain data: cheap to construct, comparable, and
    ``dataclasses.replace``-able (see :meth:`replace`), so sweeps over
    loaders/backends/depths are one-liners.
    """

    #: loader strategy: ``naive`` | ``lru`` | ``nopfs`` | ``deepio`` | ``solar``.
    loader: str = "solar"
    #: storage backend name (see :func:`repro_torch.data.backends.backend_names`).
    backend: str = "binary"
    #: dataset path, opened through the backend registry ...
    path: str | None = None
    #: ... or a pre-opened store (any :class:`StorageBackend`), used as-is.
    #: Exactly one of ``path``/``store`` may be set.
    store: Any = None
    num_nodes: int = 1
    local_batch: int = 32
    num_epochs: int = 1
    buffer_size: int = 1024
    seed: int = 0
    #: materialize sample arrays (False = counting/accounting only).
    collect_data: bool = False
    #: async read-ahead in steps; 0 = fully synchronous iteration.
    prefetch_depth: int = 0
    #: I/O threads for schedule-driven parallel chunk reads.
    num_workers: int = 4
    #: plan + execute the peer-fetch tier (solar loader only, DESIGN.md §6):
    #: capacity-spilled misses are served from sibling node buffers instead
    #: of the PFS when the cost model prefers it.
    peer_fetch: bool = False
    #: peer-vs-PFS pricing override; derived from the store when None.
    peer_cost: PeerCostModel | None = None
    #: how planned peer fetches move: ``"shared"`` (in-process buffer
    #: mirrors) or ``"socket"`` (real per-node buffer servers over TCP;
    #: such specs are executed by
    #: :func:`repro_torch.runtime.run_distributed`, which supplies the live
    #: :class:`~repro_torch.data.peer.SocketTransport` per rank).
    transport: str = "shared"
    #: scheduler overrides (solar loader only); derived from the fields
    #: above when None.
    solar: SolarConfig | None = None
    #: PFS pricing override for modeled time; derived from the store when None.
    cost_model: PFSCostModel | None = None
    #: backend open/create options (e.g. ``simulated_latency_s``,
    #: ``rdcc_nbytes``/``align_chunks`` for hdf5, ``num_shards`` for sharded).
    backend_options: dict = dataclasses.field(default_factory=dict)
    #: directory memoizing compiled schedules by config hash (DESIGN.md §7);
    #: ``plan(spec)`` loads on hit, builds + stores on miss.
    plan_cache: str | None = None
    #: explicit plan-artifact path: loaded (and hash-verified) when present,
    #: built and saved there when not.  Mutually exclusive with ``plan_cache``.
    plan_path: str | None = None
    #: streaming-ingestion knobs (DESIGN.md §10); required iff
    #: ``loader="stream"``.  Stream specs compile plans incrementally per
    #: sealed window (:mod:`repro_torch.stream`), so offline ``plan()`` and the
    #: plan cache/artifact paths do not apply to them.
    stream: StreamSpec | None = None

    def replace(self, **changes) -> "LoaderSpec":
        return dataclasses.replace(self, **changes)

    def validate(self) -> "LoaderSpec":
        """Raise one ``ValueError`` naming every inconsistency in the spec."""
        errs = []
        if self.loader not in PLANNERS and self.loader != STREAM_STRATEGY:
            errs.append(
                f"unknown loader {self.loader!r}; have "
                f"{sorted(PLANNERS) + [STREAM_STRATEGY]}"
            )
        if self.loader == STREAM_STRATEGY and self.stream is None:
            errs.append(
                "loader='stream' needs stream=StreamSpec(...) on the spec"
            )
        if self.stream is not None:
            if self.loader != STREAM_STRATEGY:
                errs.append(
                    f"stream=StreamSpec(...) requires loader='stream', "
                    f"got loader={self.loader!r}"
                )
            errs.extend(self.stream.validate())
            if self.plan_cache is not None or self.plan_path is not None:
                errs.append(
                    "streaming specs compile plans incrementally per sealed "
                    "window — 'plan_cache'/'plan_path' do not apply"
                )
        if self.store is None:
            if self.path is None:
                errs.append("one of 'path' or 'store' is required")
            if self.backend not in backend_names():
                errs.append(
                    f"unknown backend {self.backend!r}; have {backend_names()}"
                )
        elif self.path is not None:
            errs.append(
                "'path' and 'store' are mutually exclusive — pass the opened "
                "store or the path, not both"
            )
        for name in ("num_nodes", "local_batch", "num_epochs", "buffer_size"):
            if int(getattr(self, name)) <= 0:
                errs.append(f"{name} must be positive, got {getattr(self, name)}")
        if int(self.seed) < 0:
            errs.append(f"seed must be >= 0, got {self.seed}")
        if int(self.prefetch_depth) < 0:
            errs.append(f"prefetch_depth must be >= 0, got {self.prefetch_depth}")
        if int(self.num_workers) <= 0:
            errs.append(f"num_workers must be positive, got {self.num_workers}")
        if self.transport not in ("shared", "socket"):
            errs.append(
                f"unknown transport {self.transport!r}; have 'shared' "
                "(in-process mirrors) and 'socket' (per-node buffer servers)"
            )
        if self.plan_cache is not None and self.plan_path is not None:
            errs.append(
                "'plan_cache' and 'plan_path' are mutually exclusive — a "
                "cache directory or one pinned artifact, not both"
            )
        if self.solar is not None:
            if self.loader != "solar":
                errs.append("'solar' scheduler config requires loader='solar'")
            else:
                for spec_f, cfg_f in (
                    ("num_nodes", "num_nodes"),
                    ("local_batch", "local_batch"),
                    ("buffer_size", "buffer_size"),
                ):
                    if getattr(self.solar, cfg_f) != getattr(self, spec_f):
                        errs.append(
                            f"solar config {cfg_f}={getattr(self.solar, cfg_f)} "
                            f"contradicts spec {spec_f}={getattr(self, spec_f)}"
                        )
                if self.peer_fetch and not self.solar.enable_peer:
                    errs.append(
                        "peer_fetch=True contradicts solar config with "
                        "enable_peer=False"
                    )
                if (
                    self.peer_cost is not None
                    and self.solar.peer_cost is not None
                    and self.solar.peer_cost != self.peer_cost
                ):
                    errs.append(
                        "peer_cost set on both the spec and the solar config"
                    )
        if self.peer_fetch and self.loader != "solar":
            errs.append("peer_fetch requires loader='solar'")
        if self.peer_cost is not None and not (
            self.peer_fetch or (self.solar is not None and self.solar.enable_peer)
        ):
            errs.append("peer_cost is set but the peer-fetch tier is disabled")
        if errs:
            raise ValueError("invalid LoaderSpec: " + "; ".join(errs))
        return self


def build_store(spec: LoaderSpec, *, create: bool = False, **create_options):
    """Resolve the spec's store: pre-opened > open(path) > create(path).

    With ``create=True`` the dataset is created at ``spec.path`` through the
    backend registry when it does not exist yet (``create_options`` are
    forwarded, e.g. ``dataset=DatasetSpec(...), fill="random"``).  A key
    appearing in both ``create_options`` and ``spec.backend_options`` is a
    caller ambiguity and is rejected by name.
    """
    if spec.store is not None:
        return spec.store
    from repro_torch.data.backends.base import get_backend

    cls = get_backend(spec.backend)
    if create and not cls.exists(spec.path):
        dataset = create_options.pop("dataset", None)
        if "spec" in create_options or "spec" in spec.backend_options:
            raise ValueError(
                "pass the dataset geometry as build_store(..., dataset=...), "
                "not as a 'spec' option — it collides with create_store's "
                "own parameter"
            )
        dup = sorted(set(create_options) & set(spec.backend_options))
        if dup:
            raise ValueError(
                "store options passed both directly to build_store and via "
                f"spec.backend_options: {dup} — set each option in one place"
            )
        return create_store(
            spec.path, spec.backend, spec=dataset,
            **create_options, **spec.backend_options,
        )
    return open_store(spec.path, spec.backend, **spec.backend_options)


def _resolve_store(spec: LoaderSpec, store) -> LoaderSpec:
    """Fold an explicitly passed (pre-opened) store into the spec.

    The ``store=`` keyword on :func:`plan`/:func:`execute`/
    :func:`build_pipeline` means "this is the opened store for this spec" —
    it replaces the spec's ``path`` resolution rather than silently racing
    it.  Passing a store that differs from one already on the spec is an
    error.
    """
    if store is None:
        return spec
    if spec.store is not None and spec.store is not store:
        raise ValueError(
            "conflicting stores: the spec carries one store and a different "
            "one was passed as the store= argument"
        )
    return spec.replace(store=store, path=None)


def _peer_needs_sample_bytes(spec: LoaderSpec) -> bool:
    """True when planning would have to derive a PeerCostModel from the
    store geometry (peer tier on, no explicit cost model anywhere)."""
    if spec.loader != "solar":
        return False
    peer_on = spec.peer_fetch or (
        spec.solar is not None and spec.solar.enable_peer
    )
    has_cost = spec.peer_cost is not None or (
        spec.solar is not None and spec.solar.peer_cost is not None
    )
    return peer_on and not has_cost


def make_planner(spec: LoaderSpec, *, sample_bytes: int | None = None) -> Planner:
    """Resolve the spec's strategy into a configured :class:`Planner`.

    ``sample_bytes`` (the store geometry) is needed only to derive a
    default :class:`PeerCostModel` when the peer tier is enabled without an
    explicit one — planning is otherwise dataset-content-free.
    """
    if spec.loader == STREAM_STRATEGY:
        raise ValueError(
            "stream specs have no offline planner: windows are compiled "
            "incrementally by repro_torch.stream.WindowPlanner as manifests seal "
            "(drive them with repro_torch.stream.run_stream / run_stream_distributed)"
        )
    if spec.loader == "solar":
        cfg = spec.solar
        if cfg is None:
            cfg = SolarConfig(
                num_nodes=spec.num_nodes,
                local_batch=spec.local_batch,
                buffer_size=spec.buffer_size,
                seed=spec.seed,
                enable_peer=spec.peer_fetch,
                peer_cost=spec.peer_cost,
            )
        elif spec.peer_cost is not None and cfg.peer_cost is None:
            cfg = dataclasses.replace(cfg, peer_cost=spec.peer_cost)
        if cfg.enable_peer and cfg.peer_cost is None:
            # Price the peer-vs-PFS decision with the store's real sample
            # size and the spec's PFS model.
            if sample_bytes is None:
                raise ValueError(
                    "planning the peer tier needs the store geometry "
                    "(sample_bytes) or an explicit peer_cost"
                )
            pfs = spec.cost_model or PFSCostModel(sample_bytes=sample_bytes)
            cfg = dataclasses.replace(
                cfg, peer_cost=PeerCostModel(sample_bytes=sample_bytes, pfs=pfs)
            )
        return SolarPlanner(config=cfg, seed=spec.seed)
    return PLANNERS[spec.loader](
        num_nodes=spec.num_nodes,
        local_batch=spec.local_batch,
        buffer_size=spec.buffer_size,
        seed=spec.seed,
    )


def plan(
    spec: LoaderSpec,
    *,
    store=None,
    num_samples: int | None = None,
) -> Schedule:
    """Compile (or load) the spec's :class:`Schedule` — the offline half.

    Resolution order: a ``plan_path`` artifact when it exists (verified
    against the spec's config hash — a stale or foreign file fails loudly),
    then the ``plan_cache`` keyed by config hash, then a fresh compile
    (saved back to ``plan_path``/``plan_cache`` when configured).

    Planning needs only the dataset *geometry*: pass ``num_samples`` to plan
    with no store at all (e.g. precomputing artifacts on a login node);
    otherwise the store is opened just long enough to read its size.
    """
    spec = _resolve_store(spec, store)
    if num_samples is not None and spec.store is None and spec.path is None:
        # geometry-only planning (e.g. precompute on a login node): no
        # dataset is required, so satisfy the path-or-store rule formally.
        spec.replace(path="<geometry-only>").validate()
    else:
        spec.validate()
    # Read the geometry whenever a store is already open — an explicit
    # num_samples must not cost the peer tier its sample_bytes.  A bare
    # path is opened when num_samples is missing, or briefly when the peer
    # tier needs sample_bytes anyway; pure geometry-only planning (neither
    # path nor store) stays dataset-free.
    sample_bytes = None
    if spec.store is not None:
        if num_samples is None:
            num_samples = spec.store.num_samples
        sample_bytes = spec.store.sample_bytes
    elif spec.path is not None and (
        num_samples is None or _peer_needs_sample_bytes(spec)
    ):
        st = build_store(spec)
        if num_samples is None:
            num_samples = st.num_samples
        sample_bytes = st.sample_bytes
        st.close()
    planner = make_planner(spec, sample_bytes=sample_bytes)
    key = planner.cache_key(num_samples, spec.num_epochs)
    if spec.plan_path is not None:
        if os.path.exists(spec.plan_path):
            return Schedule.load(spec.plan_path, expect_hash=key)
        schedule = planner.plan(num_samples, spec.num_epochs)
        schedule.save(spec.plan_path)
        return schedule
    if spec.plan_cache is not None:
        schedule, _hit = PlanCache(spec.plan_cache).load_or_build(
            planner, num_samples, spec.num_epochs
        )
        return schedule
    return planner.plan(num_samples, spec.num_epochs)


def execute(spec: LoaderSpec, schedule: Schedule, *, store=None,
            peer_transport=None):
    """Stand up the runtime half: replay ``schedule`` against the spec's store.

    Returns a :class:`~repro_torch.data.loaders.ScheduleExecutor`, wrapped in a
    :class:`~repro_torch.data.prefetch.PrefetchExecutor` when
    ``spec.prefetch_depth > 0`` — either way the result iterates
    :class:`~repro_torch.data.loaders.StepBatch` objects and proxies the
    executor's ``report``/``capacity``/``store`` attributes.  The opened
    store is reachable as ``pipeline.store``; closing it is the caller's job
    (executors never own their store — several pipelines may share one).

    ``peer_transport`` injects a live :class:`~repro_torch.data.peer.PeerTransport`
    (a rank's :class:`~repro_torch.data.peer.SocketTransport` in multi-process
    runs); specs asking for ``transport="socket"`` *require* it — the
    sockets only exist inside :func:`repro_torch.runtime.run_distributed`.

    The schedule must match the spec: strategy, geometry, epoch count, and —
    when the schedule records one — the planner's config hash.
    """
    from repro_torch.data.loaders import ScheduleExecutor

    spec = _resolve_store(spec, store).validate()
    if spec.transport == "socket" and peer_transport is None:
        raise ValueError(
            "transport='socket' needs a live peer transport: multi-process "
            "runs are stood up by repro_torch.runtime.run_distributed (which "
            "wires one SocketTransport per rank); use transport='shared' "
            "for in-process execution"
        )
    opened_here = spec.store is None
    st = spec.store if spec.store is not None else build_store(spec)
    try:
        solar_config = None
        serve_peers = None
        if spec.loader == STREAM_STRATEGY:
            # No offline planner: the schedule is the first window segment
            # (later ones arrive via executor.extend()); provenance is the
            # WindowPlanner's config hash instead of a planner cache key.
            _check_stream_schedule(spec, schedule)
            serve_peers = spec.stream.peer_fetch or peer_transport is not None
        else:
            planner = make_planner(spec, sample_bytes=st.sample_bytes)
            _check_schedule(spec, schedule, planner, st.num_samples)
            solar_config = (
                planner.config if isinstance(planner, SolarPlanner) else None
            )
        executor = ScheduleExecutor(
            st,
            schedule,
            collect_data=spec.collect_data,
            cost_model=spec.cost_model,
            solar_config=solar_config,
            peer_transport=peer_transport,
            serve_peers=serve_peers,
        )
    except BaseException:
        if opened_here:  # never leak a handle the caller cannot reach
            st.close()
        raise
    if spec.prefetch_depth:
        from repro_torch.data.prefetch import PrefetchExecutor

        return PrefetchExecutor(
            executor, depth=spec.prefetch_depth, num_workers=spec.num_workers
        )
    return executor


def _check_stream_schedule(spec: LoaderSpec, schedule: Schedule) -> None:
    errs = []
    if schedule.strategy != STREAM_STRATEGY:
        errs.append(
            f"schedule was planned by {schedule.strategy!r}, stream specs "
            f"replay {STREAM_STRATEGY!r} segments"
        )
    for field in ("num_nodes", "local_batch", "buffer_size"):
        if getattr(schedule, field) != getattr(spec, field):
            errs.append(
                f"schedule {field}={getattr(schedule, field)} contradicts "
                f"spec {field}={getattr(spec, field)}"
            )
    if schedule.config_hash:
        key = WindowPlanner.for_spec(spec).config_hash()
        if schedule.config_hash != key:
            errs.append(
                f"window config hash {schedule.config_hash} != the spec's "
                f"{key} — the segment was planned under a different "
                "streaming config"
            )
    if errs:
        raise ValueError("schedule does not match spec: " + "; ".join(errs))


def _check_schedule(
    spec: LoaderSpec, schedule: Schedule, planner: Planner, num_samples: int
) -> None:
    errs = []
    if schedule.strategy != spec.loader:
        errs.append(
            f"schedule was planned by {schedule.strategy!r}, spec asks for "
            f"{spec.loader!r}"
        )
    for field in ("num_nodes", "local_batch", "buffer_size"):
        if getattr(schedule, field) != getattr(spec, field):
            errs.append(
                f"schedule {field}={getattr(schedule, field)} contradicts "
                f"spec {field}={getattr(spec, field)}"
            )
    if len(schedule.epochs) != spec.num_epochs:
        errs.append(
            f"schedule plans {len(schedule.epochs)} epochs, spec asks for "
            f"{spec.num_epochs}"
        )
    if schedule.config_hash:
        key = planner.cache_key(num_samples, spec.num_epochs)
        if schedule.config_hash != key:
            errs.append(
                f"schedule config hash {schedule.config_hash} != the spec's "
                f"planner hash {key} — it was built for a different config"
            )
    if errs:
        raise ValueError("schedule does not match spec: " + "; ".join(errs))


def build_pipeline(spec: LoaderSpec, *, store=None):
    """``execute(spec, plan(spec))`` sharing one opened store.

    The one-call form: compiles (or cache-loads) the plan, then stands up
    the executor against the same store.
    """
    spec = _resolve_store(spec, store).validate()
    opened_here = spec.store is None
    st = spec.store if spec.store is not None else build_store(spec)
    spec = _resolve_store(spec, st)
    try:
        return execute(spec, plan(spec))
    except BaseException:
        if opened_here:  # e.g. a stale plan_path artifact failing its checks
            st.close()
        raise
