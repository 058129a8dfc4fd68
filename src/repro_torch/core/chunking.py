"""Aggregated chunk loading (SOLAR §4.4).

With HDF5-style storage, one ranged read of samples ``[i, i+k)`` is far
cheaper than ``k`` scattered single-sample reads (paper Table 3: 203× between
full-chunk and random access), and remains cheaper even when the range covers
a few samples the step does not need.  SOLAR therefore sorts each node's miss
list and greedily coalesces nearby misses into ranged reads, bounded by

  * ``max_chunk`` — the benchmark-derived span threshold |chunk| (paper: 15):
    a ranged read longer than this stops amortizing the per-call cost, and
  * ``max_waste`` — the maximum number of *unneeded* samples a single read may
    drag in (our refinement; ``max_waste = max_chunk - 2`` reproduces the
    paper's span-only rule).

The coalescing rule is provably safe under the cost model
``T(read of k) = L + k·s/B``: merging two reads with gap ``g`` wins iff
``g·s/B < L``, so with ``max_waste ≤ B·L/s`` a plan is never slower than the
un-coalesced plan (tested property).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.plan import ChunkRead

__all__ = ["plan_chunks", "optimal_gap_threshold"]


def plan_chunks(
    miss_ids,
    max_chunk: int = 15,
    max_waste: int | None = None,
) -> tuple[ChunkRead, ...]:
    """Coalesce sorted miss ids into ranged reads.

    Returns reads covering every miss exactly once; reads never overlap.
    """
    ids = np.unique(np.asarray(list(miss_ids), dtype=np.int64))
    if ids.size == 0:
        return ()
    if max_chunk < 1:
        raise ValueError("max_chunk must be >= 1")
    if max_waste is None:
        max_waste = max(max_chunk - 2, 0)

    chunks: list[ChunkRead] = []
    start = last = int(ids[0])
    wanted = 1
    waste = 0
    for s in ids[1:].tolist():
        gap = s - last - 1
        span = s - start + 1
        if span <= max_chunk and waste + gap <= max_waste:
            last = s
            wanted += 1
            waste += gap
        else:
            chunks.append(ChunkRead(start, last + 1, wanted))
            start = last = s
            wanted, waste = 1, 0
    chunks.append(ChunkRead(start, last + 1, wanted))
    return tuple(chunks)


def optimal_gap_threshold(per_call_latency_s: float, sample_bytes: int,
                          bandwidth_bytes_per_s: float) -> int:
    """Largest gap (in samples) for which merging two reads is a strict win."""
    return int(per_call_latency_s * bandwidth_bytes_per_s / max(sample_bytes, 1))
