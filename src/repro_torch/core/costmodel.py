"""Parallel-file-system cost model.

The container has no Lustre/GPFS, so the benchmarks report two numbers for
every loader: (a) real wall-clock against the local chunked store, and (b) the
modeled PFS time under this cost model, which captures the first-order
behavior the paper measures — a fixed per-call cost (metadata + seek +
stripe-lock) plus a streaming term:

    T(read of k contiguous samples) = L + k * sample_bytes / B

Defaults are calibrated so the four access patterns of paper Table 3
(random / sequential-stride / chunk-cycle / full-chunk) reproduce the same
ordering and a comparable spread (~200× random → full-chunk).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PFSCostModel", "PeerCostModel"]


@dataclasses.dataclass(frozen=True)
class PFSCostModel:
    sample_bytes: int
    #: per-read-call fixed cost (seek + metadata round-trip), seconds.
    per_call_latency_s: float = 4e-3
    #: sustained per-process streaming bandwidth, bytes/s.
    bandwidth_bytes_per_s: float = 2.0e9
    #: extra penalty per backward seek (random access churns the stripe cache).
    backward_seek_penalty_s: float = 1e-3

    def read_time(self, num_samples: int) -> float:
        return (
            self.per_call_latency_s
            + num_samples * self.sample_bytes / self.bandwidth_bytes_per_s
        )

    def chunks_time(self, chunks) -> float:
        """Total time for one node's reads in a step (sequential per node)."""
        return float(sum(self.read_time(c.span) for c in chunks))

    def step_time(self, per_node_chunks) -> float:
        """Critical-path time of a step: nodes read in parallel."""
        if not per_node_chunks:
            return 0.0
        return max(self.chunks_time(c) for c in per_node_chunks)

    def trace_time(self, offsets: np.ndarray, run_lengths: np.ndarray) -> float:
        """Time of an explicit access trace (used by the Table-3 microbench)."""
        t = 0.0
        prev_end = None
        for off, k in zip(offsets.tolist(), run_lengths.tolist()):
            t += self.read_time(int(k))
            if prev_end is not None and off < prev_end:
                t += self.backward_seek_penalty_s
            prev_end = off + int(k)
        return t


@dataclasses.dataclass(frozen=True)
class PeerCostModel:
    """Inter-node buffer-fetch pricing + the peer-vs-PFS planning decision.

    NoPFS (Dryden et al., 2021) measures inter-node buffer fetches at one to
    two orders of magnitude cheaper than PFS reads: the transfer rides the
    training interconnect (per-fetch RPC latency + link bandwidth) and skips
    the PFS metadata/stripe-lock round-trip entirely.  The scheduler uses
    :meth:`prefer_peer` to decide, per coalesced chunk, whether serving a
    chunk's misses from sibling buffers beats issuing the ranged PFS read —
    a chunk whose read is amortized by co-resident *non-peer* misses is never
    split (the bytes travel anyway, so peer-resident riders stay on the PFS
    path), which is why the decision is taken at chunk granularity
    (DESIGN.md §6).
    """

    sample_bytes: int = 4096
    #: per-fetch RPC cost (request + response headers), seconds.
    per_fetch_latency_s: float = 5e-5
    #: sustained interconnect bandwidth per node pair, bytes/s.
    bandwidth_bytes_per_s: float = 1.0e10
    #: PFS pricing the peer alternative is compared against; a default
    #: :class:`PFSCostModel` over ``sample_bytes`` when None.
    pfs: PFSCostModel | None = None

    def pfs_model(self) -> PFSCostModel:
        return self.pfs or PFSCostModel(sample_bytes=self.sample_bytes)

    def fetch_time(self, num_samples: int) -> float:
        """Time to pull ``num_samples`` individual samples from peer buffers."""
        return num_samples * (
            self.per_fetch_latency_s
            + self.sample_bytes / self.bandwidth_bytes_per_s
        )

    def prefer_peer(self, num_peer: int, chunk_span: int) -> bool:
        """True when ``num_peer`` peer fetches beat the ranged PFS read of
        ``chunk_span`` samples that chunk coalescing would otherwise issue."""
        return self.fetch_time(num_peer) < self.pfs_model().read_time(chunk_span)
