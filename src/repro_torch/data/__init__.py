"""Data substrate: pluggable storage backends, the plan-first loader
pipeline, and the async device-feed executor.

Typical entry point::

    from repro_torch.data import DatasetSpec, LoaderSpec, build_pipeline, create_store

    store = create_store(path, "hdf5", spec=DatasetSpec(16384, (1024,)))
    pipeline = build_pipeline(LoaderSpec(loader="solar", store=store, ...))

or, with the plan made explicit (precompute once, execute many)::

    from repro_torch.data import plan, execute

    schedule = plan(spec)              # -> repro_torch.core.plan.Schedule artifact
    pipeline = execute(spec, schedule)

Own copy of ``repro.data``; streaming specs (``loader="stream"``,
:class:`StreamSpec`) are driven by :mod:`repro_torch.stream`.
"""
from repro_torch.core.planners import PLANNERS, STRATEGIES, PlanCache
from repro_torch.data.backends import (
    DatasetSpec,
    StorageBackend,
    backend_names,
    create_store,
    get_backend,
    open_store,
)
from repro_torch.data.loaders import (
    LoaderReport,
    ScheduleExecutor,
    StepBatch,
    stream_digest,
    update_batch_digest,
)
from repro_torch.data.peer import (
    AddressBookError,
    PeerExchange,
    SharedViewTransport,
    SocketTransport,
)
from repro_torch.data.pipeline import (
    LoaderSpec,
    StreamSpec,
    build_pipeline,
    build_store,
    execute,
    make_planner,
    plan,
)
from repro_torch.data.prefetch import PrefetchExecutor
from repro_torch.data.storage import ChunkStore, create_synthetic_store

__all__ = [
    "AddressBookError",
    "ChunkStore",
    "DatasetSpec",
    "LoaderSpec",
    "StorageBackend",
    "StreamSpec",
    "backend_names",
    "build_pipeline",
    "build_store",
    "create_store",
    "create_synthetic_store",
    "execute",
    "get_backend",
    "make_planner",
    "open_store",
    "plan",
    "PeerExchange",
    "PrefetchExecutor",
    "SharedViewTransport",
    "SocketTransport",
    "LoaderReport",
    "PlanCache",
    "PLANNERS",
    "STRATEGIES",
    "ScheduleExecutor",
    "StepBatch",
    "stream_digest",
    "update_batch_digest",
]
