"""Runtime sample buffer with Belady (clairvoyant-optimal) eviction.

NoPFS approximates clairvoyance with a performance model because the online
shuffle only reveals one epoch at a time.  SOLAR's pre-determined shuffle makes
the *entire* future access string known, so the buffer can run true Belady:
on admission, evict the resident sample whose next use is farthest in the
future, and bypass admission entirely when the incoming sample's next use is
farther than every resident's.

The buffer is also consulted by the offline scheduler (the schedule simulation
and the runtime execution share this class, so hit/miss accounting cannot
drift between planning and execution).
"""
from __future__ import annotations

import heapq

import numpy as np

__all__ = ["BeladyBuffer", "LRUBuffer"]

_INF = np.iinfo(np.int64).max


class BeladyBuffer:
    """Capacity-bounded sample buffer with farthest-next-use eviction."""

    def __init__(self, capacity: int):
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity = int(capacity)
        self._next_use: dict[int, int] = {}
        # Lazy max-heap of (-next_use, sample).  Entries are invalidated by
        # updating ``_next_use``; stale entries are skipped on pop.
        self._heap: list[tuple[int, int]] = []

    def __len__(self) -> int:
        return len(self._next_use)

    def __contains__(self, sample: int) -> bool:
        return sample in self._next_use

    @property
    def resident(self) -> set[int]:
        return set(self._next_use)

    def update_next_use(self, sample: int, next_use: int) -> None:
        """Refresh a resident sample's next-use time (on a buffer hit)."""
        if sample in self._next_use:
            self._next_use[sample] = next_use
            heapq.heappush(self._heap, (-next_use, sample))

    def _pop_farthest(self) -> tuple[int, int]:
        while self._heap:
            neg, sample = heapq.heappop(self._heap)
            if self._next_use.get(sample) == -neg:
                return sample, -neg
        raise RuntimeError("buffer bookkeeping corrupted: heap empty")

    def admit(self, sample: int, next_use: int) -> int | None:
        """Admit ``sample``; returns the evicted sample id, or None.

        Samples that will never be used again (``next_use == INF``) are not
        admitted.  When full, the farthest-future resident is evicted unless
        it is needed sooner than the incoming sample (Belady bypass) — in that
        case the incoming sample is dropped and ``sample`` itself is returned
        as the "eviction".
        """
        if self.capacity == 0 or next_use >= _INF:
            return sample
        if sample in self._next_use:
            self.update_next_use(sample, next_use)
            return None
        if len(self._next_use) < self.capacity:
            self._next_use[sample] = next_use
            heapq.heappush(self._heap, (-next_use, sample))
            return None
        victim, victim_next = self._pop_farthest()
        if victim_next <= next_use:
            # Everything resident is needed sooner: bypass admission.
            heapq.heappush(self._heap, (-victim_next, victim))
            return sample
        del self._next_use[victim]
        self._next_use[sample] = next_use
        heapq.heappush(self._heap, (-next_use, sample))
        return victim

    def admit_many(self, samples, next_uses) -> list[int]:
        evicted = []
        for s, u in zip(samples, next_uses):
            v = self.admit(int(s), int(u))
            if v is not None and v != s:
                evicted.append(v)
        return evicted


class LRUBuffer:
    """Least-recently-used buffer — the PyTorch-DataLoader+LRU baseline (§5.3)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._order: dict[int, None] = {}  # insertion-ordered dict as LRU list

    def __len__(self) -> int:
        return len(self._order)

    def __contains__(self, sample: int) -> bool:
        return sample in self._order

    @property
    def resident(self) -> set[int]:
        return set(self._order)

    def touch(self, sample: int) -> None:
        if sample in self._order:
            self._order.pop(sample)
            self._order[sample] = None

    def admit(self, sample: int, next_use: int = 0) -> int | None:
        if self.capacity == 0:
            return sample
        if sample in self._order:
            self.touch(sample)
            return None
        victim = None
        if len(self._order) >= self.capacity:
            victim = next(iter(self._order))
            self._order.pop(victim)
        self._order[sample] = None
        return victim

    def update_next_use(self, sample: int, next_use: int) -> None:
        self.touch(sample)

    def admit_many(self, samples, next_uses=None) -> list[int]:
        evicted = []
        for s in samples:
            v = self.admit(int(s))
            if v is not None and v != s:
                evicted.append(v)
        return evicted
