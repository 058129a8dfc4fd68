"""Observability: the flight-recorder span tracer (DESIGN.md §13).

:mod:`repro_torch.obs.trace` is an own copy of the JAX package's tracer, as
far as the port calls it.  The metrics registry, structured logging and the
report CLI are not ported yet (ROADMAP.md).
"""
from repro_torch.obs import trace  # noqa: F401
from repro_torch.obs.trace import Tracer  # noqa: F401

__all__ = ["trace", "Tracer"]
