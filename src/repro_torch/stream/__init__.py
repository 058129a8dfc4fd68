"""Streaming ingestion: plan-first loading over data that doesn't exist yet.

Producers ``put()`` rows into a writable backend under seeded admission
(:mod:`repro_torch.stream.ingest`); sealed manifests feed a :class:`WindowPlanner`
that compiles rolling :class:`~repro_torch.core.plan.Schedule` segments
(:mod:`repro_torch.stream.windows`); drivers chain the segments onto a live
:class:`~repro_torch.data.loaders.ScheduleExecutor` — in-process with overlapped
planning (:func:`run_stream`) or across rank processes with plan broadcast
over the control plane (:func:`run_stream_distributed`).  See DESIGN.md §10.

Own copy of ``repro.stream`` (code identical but for import paths); numpy
only, like the launcher ranks that :mod:`repro_torch.stream.distributed`
spawns.
"""
from repro_torch.stream.ingest import (
    ADMISSION_POLICIES,
    IngestError,
    IngestSession,
    StreamClosed,
    WindowManifest,
    admission_priority,
    run_producers,
    synthetic_row,
)
from repro_torch.stream.windows import STREAM_STRATEGY, StreamSpec, WindowPlanner

__all__ = [
    "ADMISSION_POLICIES",
    "IngestError",
    "IngestSession",
    "StreamClosed",
    "WindowManifest",
    "admission_priority",
    "run_producers",
    "synthetic_row",
    "STREAM_STRATEGY",
    "StreamSpec",
    "WindowPlanner",
    "StreamReport",
    "run_stream",
    "StreamDistReport",
    "run_stream_distributed",
]

_LAZY = {
    # driver/distributed import repro_torch.data.pipeline, which imports
    # repro_torch.stream.windows — resolve them lazily so importing either side
    # first works.
    "StreamReport": "repro_torch.stream.driver",
    "run_stream": "repro_torch.stream.driver",
    "StreamDistReport": "repro_torch.stream.distributed",
    "run_stream_distributed": "repro_torch.stream.distributed",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.stream' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
