"""Node-to-sample remapping within a global batch (SOLAR §4.2.2).

Because data parallelism averages the per-device gradients of one *global*
batch, moving a sample from one device's mini-batch to another's leaves the
synchronized gradient unchanged (Yang & Cong 2019; paper Eq. 3).  SOLAR uses
this freedom to assign each sample of the global batch to a node that already
buffers it, eliminating both the PFS re-read and the inter-node exchange that
locality-aware loaders pay.

``assign_hits`` performs that remap against the current per-node buffer
contents; samples buffered nowhere are left to the load balancer
(:mod:`repro_torch.core.balance`) to place.
"""
from __future__ import annotations

import numpy as np

__all__ = ["assign_hits"]


def assign_hits(
    batch: np.ndarray,
    node_residency: list,
    capacity: int,
) -> tuple[list[list[int]], list[int]]:
    """Map buffered samples of ``batch`` onto their host nodes.

    Args:
      batch: sample ids of one global batch (any order).
      node_residency: per-node objects supporting ``in`` (buffers or sets).
      capacity: max samples a node may train this step (B_cap); hits beyond
        a node's capacity spill back to the miss pool.

    Returns:
      ``(hits, misses)`` where ``hits[n]`` lists samples served from node
      ``n``'s buffer and ``misses`` lists samples buffered on no node (or
      spilled).  A sample resident on several nodes goes to the least-loaded
      of them, which pre-balances the computation before the miss
      distribution runs.
    """
    num_nodes = len(node_residency)
    hits: list[list[int]] = [[] for _ in range(num_nodes)]
    misses: list[int] = []
    counts = np.zeros(num_nodes, dtype=np.int64)
    for s in batch.tolist():
        best = -1
        for n in range(num_nodes):
            if s in node_residency[n] and counts[n] < capacity:
                if best < 0 or counts[n] < counts[best]:
                    best = n
        if best < 0:
            misses.append(s)
        else:
            hits[best].append(s)
            counts[best] += 1
    return hits, misses
