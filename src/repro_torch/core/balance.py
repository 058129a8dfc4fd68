"""Loading-workload balancing (SOLAR §4.3).

After the locality remap, the per-node buffer-hit counts are skewed, so the
number of PFS reads per node — the expensive part of the step — is imbalanced
and the slowest node gates the synchronous step.  SOLAR's observation 2 is
that *computation* imbalance is nearly free for surrogate models, so it evens
out the **miss** counts instead of the batch sizes: every node performs
⌈M/N⌉-or-⌊M/N⌋ PFS reads, while per-node batch sizes (hits + assigned misses)
are allowed to drift around the nominal local batch.

Under SPMD/XLA all shards must be equal, so the runtime pads each node to a
fixed capacity ``B_cap`` with zero-weight rows; gradients are identical
because the *global* batch content is unchanged (DESIGN.md §3).

With the planned peer-fetch tier (DESIGN.md §6) enabled, misses split into
two cost classes: samples resident on *no* node (PFS reads, expensive) and
capacity-spilled samples resident in a sibling's buffer (peer fetches,
cheap).  :func:`distribute_tiered` equalizes the PFS class alone — the
actual critical path — and spreads the peer class by total load afterwards.
"""
from __future__ import annotations

import numpy as np

__all__ = ["distribute_misses", "distribute_tiered"]


def _check_fits(headroom: np.ndarray, needed: int, capacity: int) -> None:
    if int(headroom.sum()) < needed:
        raise ValueError(
            f"global batch does not fit: capacity {capacity} x {headroom.size} "
            f"nodes < batch; raise capacity_factor"
        )


def _assign_segments(samples, targets) -> list[list[int]]:
    """Slice the sorted sample list into per-node contiguous segments.

    Contiguity keeps each node's list clustered in id space so §4.4
    chunking has runs to coalesce (round-robin singles would balance the
    counts but drop the chunkable fraction to ~0, paper Fig. 13).
    """
    srt = sorted(samples)
    out, cursor = [], 0
    for take in targets:
        take = int(take)
        out.append(srt[cursor : cursor + take])
        cursor += take
    assert cursor == len(srt), (cursor, len(srt))
    return out


def distribute_misses(
    misses: list[int],
    hit_counts: np.ndarray,
    local_batch: int,
    capacity: int,
    balance: bool = True,
) -> list[list[int]]:
    """Assign miss samples to nodes.

    ``balance=True``  — SOLAR: equalize per-node *miss* counts subject to the
        per-node capacity; batch sizes become uneven (paper Fig. 16).
    ``balance=False`` — ablation/vanilla: restore equal batch sizes
        (each node trains exactly ``local_batch`` samples), reproducing the
        imbalanced-loading baseline of paper Fig. 12.

    Misses are handed out in sorted order, round-robin over the currently
    least-loaded nodes, which keeps each node's miss list clustered for the
    chunk coalescer.
    """
    num_nodes = hit_counts.size
    out: list[list[int]] = [[] for _ in range(num_nodes)]
    if not misses:
        return out
    miss_counts = np.zeros(num_nodes, dtype=np.int64)
    totals = hit_counts.astype(np.int64).copy()

    if not balance:
        # Fill each node back up to exactly `local_batch`.
        order = sorted(range(num_nodes), key=lambda n: -int(totals[n]))
        it = iter(sorted(misses))
        quota = {n: local_batch - int(totals[n]) for n in order}
        if sum(max(q, 0) for q in quota.values()) < len(misses):
            raise ValueError("misses exceed unbalanced quota; raise capacity")
        for n in order:
            for _ in range(max(quota[n], 0)):
                try:
                    out[n].append(next(it))
                except StopIteration:
                    return out
        return out

    # Water-filling to equal(±1) per-node miss counts, then contiguous
    # segment assignment (see _assign_segments).
    m = len(misses)
    headroom = np.maximum(capacity - totals, 0)
    _check_fits(headroom, m, capacity)
    targets = np.zeros(num_nodes, dtype=np.int64)
    remaining = m
    active = headroom > 0
    while remaining > 0:
        idx = np.flatnonzero(active & (targets < headroom))
        share = max(remaining // max(idx.size, 1), 1)
        for n in idx:
            take = int(min(share, headroom[n] - targets[n], remaining))
            targets[n] += take
            remaining -= take
            if remaining == 0:
                break
        active = targets < headroom
    # targets[n] <= headroom[n] by construction; counts are equal within the
    # final fill round.
    return _assign_segments(misses, targets)


def distribute_tiered(
    pfs_misses: list[int],
    peer_misses: list[int],
    hit_counts: np.ndarray,
    local_batch: int,
    capacity: int,
    balance: bool = True,
) -> tuple[list[list[int]], list[list[int]]]:
    """Assign misses in two cost tiers (DESIGN.md §6).

    ``pfs_misses`` (resident on no node) are the expensive reads: they are
    equalized across nodes exactly as :func:`distribute_misses` does, so the
    slowest node's PFS work stays minimal.  ``peer_misses`` (resident in some
    node's buffer, i.e. capacity-spilled hits) are near-free interconnect
    fetches: they then water-fill the *total* per-node load toward equal
    batch sizes.  Returns ``(pfs_assign, peer_assign)`` per node; the
    chunk-level peer-vs-PFS decision downstream may still keep a peer
    candidate on the PFS path when it rides a chunk read that happens anyway.

    With ``balance=False`` (ablation) both tiers share the vanilla
    equal-batch fill and are split back by tier afterwards.
    """
    num_nodes = int(hit_counts.size)
    if not balance:
        combined = distribute_misses(
            list(pfs_misses) + list(peer_misses),
            hit_counts,
            local_batch,
            capacity,
            balance=False,
        )
        peer_set = set(peer_misses)
        return (
            [[s for s in m if s not in peer_set] for m in combined],
            [[s for s in m if s in peer_set] for m in combined],
        )

    pfs_assign = distribute_misses(
        list(pfs_misses), hit_counts, local_batch, capacity, balance=True
    )
    peer_out: list[list[int]] = [[] for _ in range(num_nodes)]
    p = len(peer_misses)
    if p == 0:
        return pfs_assign, peer_out
    totals = hit_counts.astype(np.int64) + np.asarray(
        [len(m) for m in pfs_assign], dtype=np.int64
    )
    headroom = np.maximum(capacity - totals, 0)
    _check_fits(headroom, p, capacity)
    # Water-fill totals one sample at a time (peer counts are small): each
    # peer fetch goes to the currently least-loaded node with headroom.
    targets = np.zeros(num_nodes, dtype=np.int64)
    for _ in range(p):
        avail = np.flatnonzero(targets < headroom)
        n = avail[np.argmin(totals[avail] + targets[avail])]
        targets[n] += 1
    return pfs_assign, _assign_segments(peer_misses, targets)
