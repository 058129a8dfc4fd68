"""Distributed runtime: wire protocol, buffer servers, elastic launcher.

Own copy of the JAX package's ``repro.runtime``, the multi-process half of
the loader (DESIGN.md §8) and its elastic recovery layer (DESIGN.md §9):
one plan artifact, N spawned rank processes, peer fetches served over TCP
out of live buffer mirrors, heartbeat-driven failure detection with plan
re-slicing on rank death, and a seeded fault-injection harness.  Frames are
byte-identical to the JAX package's (:mod:`~repro_torch.runtime.wire`), and
the ranks import no torch: they hold no tensors.

    from repro_torch.runtime import run_distributed, in_process_digests

    report = run_distributed(spec)            # N = spec.num_nodes processes
    assert report.digests() == in_process_digests(spec)

    from repro_torch.runtime import FaultPlan, in_process_aggregate

    chaos = FaultPlan.compile(seed=7, num_ranks=2, crashes=1, corrupt=2)
    report = run_distributed(spec, faults=chaos)   # a rank dies mid-run...
    assert report.aggregate_digest() == in_process_aggregate(spec)  # ...and
    # the global sample stream is still executed exactly once.
"""
from repro_torch.runtime.faults import ArmedFaults, Fault, FaultPlan
from repro_torch.runtime.launcher import (
    DistributedReport,
    LauncherConfigError,
    RankResult,
    in_process_aggregate,
    in_process_digests,
    run_distributed,
)
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
    "DistributedReport",
    "Fault",
    "FaultPlan",
    "HandshakeError",
    "LauncherConfigError",
    "ProtocolError",
    "RankResult",
    "TruncatedFrame",
    "WIRE_VERSION",
    "WireError",
    "in_process_aggregate",
    "in_process_digests",
    "run_distributed",
]
