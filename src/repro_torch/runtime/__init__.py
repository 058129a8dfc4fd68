"""Distributed runtime: wire protocol, buffer servers, fault injection.

Own copy of the JAX package's ``repro.runtime`` below its launcher: the
framed wire protocol (:mod:`~repro_torch.runtime.wire`, byte-identical to
the JAX package's), the per-node :class:`BufferServer` that serves peer
fetches and data-tier tenants out of a live buffer mirror, and the seeded
fault-injection harness (:mod:`~repro_torch.runtime.faults`).

    from repro_torch.runtime import BufferServer
    from repro_torch.data import SocketTransport

    server = BufferServer(0, (4,), "<f4").start()
    server.attach(lambda node: mirror)      # a live _DataMirror
    server.at_step(step)
    transport = SocketTransport({0: (server.host, server.port)},
                                sample_shape=(4,), dtype="<f4", timeout_s=2.0)
    transport.at_step(step)
    rows, ok = transport.fetch(0, ids)

The multi-process launcher (``run_distributed``, ``in_process_digests``)
is not ported yet: ROADMAP.md Queue 1 slice 6.
"""
from repro_torch.runtime.faults import ArmedFaults, Fault, FaultPlan
from repro_torch.runtime.server import BufferServer
from repro_torch.runtime.wire import (
    WIRE_VERSION,
    ChecksumMismatch,
    HandshakeError,
    ProtocolError,
    TruncatedFrame,
    WireError,
)

__all__ = [
    "ArmedFaults",
    "BufferServer",
    "ChecksumMismatch",
    "Fault",
    "FaultPlan",
    "HandshakeError",
    "ProtocolError",
    "TruncatedFrame",
    "WIRE_VERSION",
    "WireError",
]
