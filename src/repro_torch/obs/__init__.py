"""Observability: flight-recorder tracing, metrics, logging (DESIGN.md §13).

Own copy of the JAX package's ``repro.obs``:

* :mod:`repro_torch.obs.trace` — per-thread ring-buffer span tracer (no-op
  singleton unless enabled; JSONL + Chrome trace-event exports per rank,
  byte-identical to the JAX package's for the same records).
* :mod:`repro_torch.obs.metrics` — counters/gauges/deterministic log2
  histograms behind one :class:`~repro_torch.obs.metrics.MetricsRegistry`.
* :mod:`repro_torch.obs.log` — rank-tagged stdlib logging shared by the CLIs.
* :mod:`repro_torch.obs.report` — the ``python -m repro_torch.obs.report``
  CLI turning trace dumps into a per-step "where did each ms go" breakdown.
"""
from repro_torch.obs import log, metrics, trace  # noqa: F401
from repro_torch.obs.log import configure, get_logger  # noqa: F401
from repro_torch.obs.metrics import Histogram, MetricsRegistry  # noqa: F401
from repro_torch.obs.trace import Tracer  # noqa: F401

__all__ = [
    "log", "metrics", "trace",
    "configure", "get_logger", "Histogram", "MetricsRegistry", "Tracer",
]
