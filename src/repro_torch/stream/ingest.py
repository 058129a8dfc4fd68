"""Producer-facing streaming ingest: admission, backpressure, sealed manifests.

Ensemble simulation runs (Meyer et al., PAPERS.md) produce training samples
*live*: rows arrive from many writer threads while the trainer replays the
current plan window.  This module owns the writer side of that handoff
(DESIGN.md §10):

  * :class:`IngestSession` — ``put(sample_id, x, y)`` writes a row into a
    pre-sized writable backend (``memory``/``sharded``) under a seeded
    admission policy, with backpressure when admissions outrun sealing.
  * **Sealed manifests** — :meth:`IngestSession.seal` atomically snapshots
    the admitted-id set into a sorted manifest.  A sealed id's row is
    immutable from then on (re-puts are refused), so window planners and
    executors replaying earlier windows never race a writer.
  * **Order-independent admission** — the retained set is the bottom-``R``
    of all arrived ids under a deterministic per-id priority (a bottom-k
    sketch), so the final admitted set is a pure function of the *set* of
    arrivals plus ``(seed, policy, R)`` — never of producer thread
    interleaving.  ``reservoir`` uses a seeded splitmix64 hash (uniform
    reservoir sample); ``latest`` uses ``-sample_id`` (staleness-aware: keep
    the freshest ``R`` ids); ``all`` never evicts.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import time

import numpy as np

__all__ = [
    "ADMISSION_POLICIES",
    "IngestError",
    "StreamClosed",
    "WindowManifest",
    "IngestSession",
    "admission_priority",
    "synthetic_row",
    "run_producers",
]

ADMISSION_POLICIES = ("all", "reservoir", "latest")

_MASK64 = (1 << 64) - 1


class IngestError(RuntimeError):
    """A streaming-ingest invariant was violated (bad id, read-only store...)."""


class StreamClosed(IngestError):
    """The session was closed while a producer was blocked or writing."""


def admission_priority(seed: int, sample_id: int) -> int:
    """Deterministic uniform-ish 64-bit priority of ``(seed, sample_id)``.

    splitmix64-style finalizer: a pure function of its arguments, so every
    producer thread computes the identical priority for the same id and the
    bottom-k retention is order-independent.
    """
    z = (
        int(sample_id) * 0x9E3779B97F4A7C15
        + int(seed) * 0xBF58476D1CE4E5B9
        + 0x94D049BB133111EB
    ) & _MASK64
    z ^= z >> 30
    z = (z * 0xBF58476D1CE4E5B9) & _MASK64
    z ^= z >> 27
    z = (z * 0x94D049BB133111EB) & _MASK64
    z ^= z >> 31
    return z


@dataclasses.dataclass(frozen=True)
class WindowManifest:
    """One sealed snapshot of the admitted-sample set."""

    index: int
    #: sorted admitted sample ids at seal time (rows immutable from now on).
    ids: np.ndarray
    #: ids newly admitted since the previous seal (the watermark measure).
    fresh: int


class IngestSession:
    """Writer-side streaming session over a pre-sized writable store.

    ``sample_id`` doubles as the store row index: the id space is fixed at
    store creation, rows are written in place, and ids retire (via sealing)
    but are never recycled — that is what makes sealed rows immutable and
    the writer/reader handoff race-free.
    """

    def __init__(
        self,
        store,
        *,
        seed: int = 0,
        admission: str = "reservoir",
        reservoir_size: int | None = None,
        max_pending: int = 4096,
    ):
        if admission not in ADMISSION_POLICIES:
            raise ValueError(
                f"unknown admission policy {admission!r}; have {ADMISSION_POLICIES}"
            )
        if not getattr(store, "writable", False):
            raise IngestError(
                f"store {getattr(store, 'path', store)!r} is not writable; "
                "streaming ingest needs the 'memory' or 'sharded' backend"
            )
        if reservoir_size is not None and reservoir_size < 1:
            raise ValueError("reservoir_size must be >= 1 (or None for unbounded)")
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.store = store
        self.seed = int(seed)
        self.admission = admission
        self.reservoir_size = None if admission == "all" else reservoir_size
        self.max_pending = int(max_pending)
        self._elems = int(np.prod(store.sample_shape, dtype=np.int64))

        self._cond = threading.Condition()
        self._resident: dict[int, int] = {}        # id -> priority
        self._heap: list[tuple[int, int]] = []     # (-priority, -id): max first
        self._fresh: set[int] = set()              # admitted since last seal
        self._inflight: set[int] = set()           # admitted, row write pending
        self._sealed_ids: set[int] = set()         # appeared in any manifest
        self._finished = False                     # producers done
        self._closed = False
        self.manifests: list[WindowManifest] = []
        self.stats = {
            "arrivals": 0,
            "admitted": 0,
            "overwrites": 0,
            "rejected_policy": 0,
            "rejected_sealed": 0,
            "evicted": 0,
            "blocked_s": 0.0,
        }

    # -- admission (bottom-k by deterministic priority) ------------------------

    def _priority(self, sample_id: int) -> int:
        if self.admission == "latest":
            return -int(sample_id)
        return admission_priority(self.seed, sample_id)

    def _evict_worst(self) -> int:
        while self._heap:
            neg_p, neg_id = heapq.heappop(self._heap)
            sid = -neg_id
            if self._resident.get(sid) == -neg_p:
                del self._resident[sid]
                self._fresh.discard(sid)
                return sid
        raise RuntimeError("reservoir bookkeeping corrupted: heap empty")

    def _admit_locked(self, sample_id: int) -> bool:
        """Admission decision; caller holds the lock.  True = write the row."""
        if sample_id in self._resident:
            # resident and unsealed (sealed was checked first): overwrite.
            self.stats["overwrites"] += 1
            return True
        prio = self._priority(sample_id)
        if self.reservoir_size is not None and len(self._resident) >= self.reservoir_size:
            # Peek the current worst (max (priority, id)) via the lazy heap.
            worst_key = None
            while self._heap:
                neg_p, neg_id = self._heap[0]
                if self._resident.get(-neg_id) == -neg_p:
                    worst_key = (-neg_p, -neg_id)
                    break
                heapq.heappop(self._heap)
            if worst_key is None:  # pragma: no cover - heap mirrors residents
                worst_key = max((p, sid) for sid, p in self._resident.items())
            if (prio, sample_id) >= worst_key:
                self.stats["rejected_policy"] += 1
                return False
            self._evict_worst()
            self.stats["evicted"] += 1
        self._resident[sample_id] = prio
        heapq.heappush(self._heap, (-prio, -sample_id))
        self._fresh.add(sample_id)
        self.stats["admitted"] += 1
        return True

    # -- producer surface ------------------------------------------------------

    def _make_row(self, x, y=None) -> np.ndarray:
        x = np.asarray(x, self.store.dtype).ravel()
        if y is not None:
            x = np.concatenate([x, np.asarray(y, self.store.dtype).ravel()])
        if x.size != self._elems:
            raise IngestError(
                f"row has {x.size} elements; store samples have {self._elems}"
            )
        return x.reshape(self.store.sample_shape)

    def put(self, sample_id: int, x, y=None, *, timeout_s: float | None = None) -> bool:
        """Offer one sample.  Returns True iff the row was admitted + written.

        Blocks (backpressure) while ``max_pending`` admissions await a seal;
        raises :class:`StreamClosed` if the session closes while blocked.
        """
        sample_id = int(sample_id)
        if not 0 <= sample_id < self.store.num_samples:
            raise IngestError(
                f"sample_id {sample_id} outside the store's id space "
                f"[0, {self.store.num_samples})"
            )
        row = self._make_row(x, y)
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        with self._cond:
            t0 = time.monotonic()
            while not self._closed and (
                sample_id in self._inflight          # same-id write pending
                or len(self._fresh) >= self.max_pending  # backpressure
            ):
                wait = 0.05 if deadline is None else min(0.05, deadline - time.monotonic())
                if wait <= 0:
                    self.stats["blocked_s"] += time.monotonic() - t0
                    raise TimeoutError(
                        f"put({sample_id}) blocked > {timeout_s}s on backpressure"
                    )
                self._cond.wait(wait)
            self.stats["blocked_s"] += time.monotonic() - t0
            if self._closed:
                raise StreamClosed("ingest session is closed")
            self.stats["arrivals"] += 1
            if sample_id in self._sealed_ids:
                # Immutable: the id is visible to (possibly replaying)
                # readers through a sealed manifest.
                self.stats["rejected_sealed"] += 1
                return False
            if not self._admit_locked(sample_id):
                return False
            self._inflight.add(sample_id)
        try:
            # Row write outside the lock: concurrent producers write disjoint
            # rows; same-id writers are serialized by the in-flight gate above.
            self.store.write_rows(sample_id, row[None])
        finally:
            with self._cond:
                self._inflight.discard(sample_id)
                self._cond.notify_all()
        return True

    def finish(self) -> None:
        """Producers are done; pending seals stop waiting for a watermark."""
        with self._cond:
            self._finished = True
            self._cond.notify_all()

    @property
    def finished(self) -> bool:
        return self._finished

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._finished = True
            self._cond.notify_all()

    # -- reader handoff --------------------------------------------------------

    def seal(self, *, min_fresh: int = 0, timeout_s: float | None = None) -> WindowManifest:
        """Seal the current admitted set into an immutable manifest.

        Waits until at least ``min_fresh`` new ids were admitted since the
        previous seal (the window watermark) or :meth:`finish` was called,
        and until no admitted row write is still in flight.  The store is
        flushed before the manifest is returned, so readers in other
        processes observe every row the manifest names.
        """
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        with self._cond:
            while not self._finished and len(self._fresh) < min_fresh:
                self._wait_or_timeout(deadline, f"seal waiting for {min_fresh} fresh")
            while self._inflight:
                self._wait_or_timeout(deadline, "seal waiting for in-flight rows")
            if self._closed and not self._resident:
                raise StreamClosed("ingest session is closed")
            manifest = WindowManifest(
                index=len(self.manifests),
                ids=np.asarray(sorted(self._resident), np.int64),
                fresh=len(self._fresh),
            )
            self._sealed_ids.update(self._resident)
            self._fresh.clear()
            self.manifests.append(manifest)
            self._cond.notify_all()  # backpressured producers may resume
        self.store.flush()
        return manifest

    def _wait_or_timeout(self, deadline, what: str) -> None:
        wait = 0.05 if deadline is None else min(0.05, deadline - time.monotonic())
        if wait <= 0:
            raise TimeoutError(what)
        self._cond.wait(wait)

    def __enter__(self) -> "IngestSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Synthetic ensemble producer (deterministic rows for tests and the CLI)
# ---------------------------------------------------------------------------


def synthetic_row(sample_id: int, sample_shape, dtype, data_seed: int = 0) -> np.ndarray:
    """Deterministic row content: a pure function of ``(data_seed, sample_id)``.

    Producer thread count and interleaving therefore never change the bytes
    a given id carries — the property the streaming determinism tests lean on.
    """
    dtype = np.dtype(dtype)
    rng = np.random.Generator(
        np.random.PCG64(np.random.SeedSequence([int(data_seed), int(sample_id)]))
    )
    if np.issubdtype(dtype, np.integer):
        return rng.integers(0, 255, size=sample_shape).astype(dtype)
    return rng.standard_normal(sample_shape).astype(dtype)


def run_producers(
    session: IngestSession,
    trace,
    *,
    threads: int = 1,
    data_seed: int = 0,
    rate_hz: float | None = None,
    finish: bool = True,
) -> list[threading.Thread]:
    """Drive a synthetic ensemble over ``trace`` (a sequence of sample ids).

    Splits the trace round-robin over ``threads`` producer threads, each
    putting :func:`synthetic_row` content; joins them, then (by default)
    marks the session finished.  ``rate_hz`` throttles the *aggregate*
    arrival rate.
    """
    trace = [int(s) for s in trace]
    delay = None if not rate_hz else threads / float(rate_hz)

    def _produce(ids):
        for sid in ids:
            try:
                session.put(
                    sid, synthetic_row(sid, session.store.sample_shape,
                                       session.store.dtype, data_seed)
                )
            except StreamClosed:
                return
            if delay:
                time.sleep(delay)

    workers = [
        threading.Thread(
            target=_produce, args=(trace[t::threads],), daemon=True,
            name=f"ingest-producer-{t}",
        )
        for t in range(max(1, int(threads)))
    ]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    if finish:
        session.finish()
    return workers
