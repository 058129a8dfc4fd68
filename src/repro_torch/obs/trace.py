"""Flight-recorder span tracer (DESIGN.md §13), as far as the port calls it.

One process holds at most one live :class:`Tracer` (module singleton); when
tracing is off the singleton is a :class:`_NullTracer` whose every method is
a no-op, so instrumented hot paths cost two cheap attribute calls and touch
nothing else — a tracing-off run is byte-identical to an uninstrumented one.

Records are **complete spans**: one fixed-dtype numpy row per span with
begin/end timestamps from ``time.perf_counter()`` (the per-process monotonic
clock).  Every thread appends into its own preallocated ring buffer, so
recording is lock-free and allocation-free: a full ring wraps and overwrites
the oldest rows (the count of overwritten rows is reported as ``dropped``).

Span *kinds* are interned strings.  The port's sites are the chunk reads of
the storage backends, the prefetch queue waits, peer gathers and socket
peer fetches (retries and breaker transitions as instants), the buffer
server's fetch, skew-park, tenant-yield and shed, fault firings, and the
trainer's make-batch and compute sections; each stamps two free integer
payload fields ``a``/``b`` and the tracer's *current step* (set by the
trainer via :meth:`Tracer.set_step`).

:meth:`Tracer.records` merges the rings.  The JAX package's JSONL and
Chrome trace exports and its report CLI are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import threading
import time

import numpy as np

__all__ = [
    "RECORD_DTYPE", "Tracer", "enable", "disable", "get",
    "kind_id", "kind_name", "kind_names",
]

#: One complete span: [t0, t1) in perf_counter seconds, an interned kind id,
#: the rank-loop step the tracer was stamped with, and two payload ints.
RECORD_DTYPE = np.dtype([
    ("t0", "f8"), ("t1", "f8"), ("kind", "u2"), ("step", "i8"),
    ("a", "i8"), ("b", "i8"),
])

_kind_lock = threading.Lock()
_kind_to_id: dict[str, int] = {}
_id_to_kind: list[str] = []


def kind_id(name: str) -> int:
    """Intern ``name`` -> a stable small int (registration order)."""
    with _kind_lock:
        kid = _kind_to_id.get(name)
        if kid is None:
            kid = len(_id_to_kind)
            if kid > np.iinfo(RECORD_DTYPE["kind"]).max:
                raise ValueError("span-kind table overflow")
            _kind_to_id[name] = kid
            _id_to_kind.append(name)
        return kid


def kind_name(kid: int) -> str:
    return _id_to_kind[kid]


def kind_names() -> list[str]:
    with _kind_lock:
        return list(_id_to_kind)


# -- well-known span kinds (the §13 names the port records) -----------------
CHUNK_READ = kind_id("chunk.read")              # backend _pread; a=samples
PREFETCH_QWAIT = kind_id("prefetch.qwait")      # consumer blocked on the queue
PEER_FETCH = kind_id("peer.fetch")              # one transport.fetch; a=source
PEER_RETRY = kind_id("peer.retry")              # instant; a=source, b=attempt
PEER_BREAKER_OPEN = kind_id("peer.breaker_open")    # instant; a=source
PEER_BREAKER_SKIP = kind_id("peer.breaker_skip")    # instant; a=source
PEER_GATHER = kind_id("peer.gather")            # one PeerExchange.gather; a=n
SERVE_FETCH = kind_id("serve.fetch")            # BufferServer fetch; a=node
SERVE_SKEW_PARK = kind_id("serve.skew_park")    # §11 bounded lead wait; a=node
SERVE_TENANT_YIELD = kind_id("serve.tenant_yield")  # §12 priority wait
SERVE_SHED = kind_id("serve.shed")              # instant; one shed tenant read
TRAIN_MAKE_BATCH = kind_id("train.make_batch")  # StepBatch -> device batch
TRAIN_COMPUTE = kind_id("train.compute")        # step + sync on its loss


class _Ring:
    """One thread's preallocated record buffer (count wraps, rows overwrite)."""

    __slots__ = ("buf", "n", "tid")

    def __init__(self, capacity: int, tid: str):
        self.buf = np.zeros(capacity, RECORD_DTYPE)
        self.n = 0
        self.tid = tid


class Tracer:
    """The live flight recorder: per-thread rings + a current-step stamp."""

    enabled = True

    def __init__(self, capacity: int = 65536):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self.capacity = int(capacity)
        self._local = threading.local()
        self._rings: list[_Ring] = []
        self._rings_lock = threading.Lock()
        #: the trainer's current step index, stamped into every record
        #: (including records from prefetch threads) — per-step attribution.
        self.step = -1

    # perf_counter straight through: site code does ``t0 = tr.t()``.
    t = staticmethod(time.perf_counter)

    def set_step(self, step: int) -> None:
        self.step = step

    def _ring(self) -> _Ring:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = _Ring(self.capacity, threading.current_thread().name)
            self._local.ring = ring
            with self._rings_lock:
                self._rings.append(ring)
        return ring

    def rec(self, kind: int, t0: float, t1: float | None = None,
            a: int = 0, b: int = 0) -> None:
        """Record one complete span ``[t0, t1)`` (``t1=None`` -> now)."""
        if t1 is None:
            t1 = time.perf_counter()
        ring = self._ring()
        ring.buf[ring.n % self.capacity] = (t0, t1, kind, self.step, a, b)
        ring.n += 1

    def instant(self, kind: int, a: int = 0, b: int = 0) -> None:
        now = time.perf_counter()
        self.rec(kind, now, now, a, b)

    # -- collection ------------------------------------------------------------

    def records(self) -> tuple[np.ndarray, list[str], int]:
        """Merged records sorted by ``t0`` + per-record thread names + drops."""
        with self._rings_lock:
            rings = list(self._rings)
        parts: list[np.ndarray] = []
        tids: list[str] = []
        dropped = 0
        for ring in rings:
            if ring.n <= self.capacity:
                part = ring.buf[:ring.n].copy()
            else:  # wrapped: oldest surviving row sits at n % capacity
                i = ring.n % self.capacity
                part = np.concatenate([ring.buf[i:], ring.buf[:i]])
                dropped += ring.n - self.capacity
            parts.append(part)
            tids.extend([ring.tid] * len(part))
        if not parts:
            return np.zeros(0, RECORD_DTYPE), [], 0
        merged = np.concatenate(parts)
        order = np.argsort(merged["t0"], kind="stable")
        return merged[order], [tids[i] for i in order.tolist()], dropped


class _NullTracer:
    """Tracing off: every operation is a no-op (the digest-parity default)."""

    enabled = False
    step = -1

    @staticmethod
    def t() -> float:
        return 0.0

    def set_step(self, step: int) -> None:
        pass

    def rec(self, kind: int, t0: float, t1: float | None = None,
            a: int = 0, b: int = 0) -> None:
        pass

    def instant(self, kind: int, a: int = 0, b: int = 0) -> None:
        pass


_NULL = _NullTracer()
_tracer: Tracer | _NullTracer = _NULL


def get() -> Tracer | _NullTracer:
    """The process's tracer — the no-op singleton unless :func:`enable` ran."""
    return _tracer


def enable(capacity: int = 65536) -> Tracer:
    """Install a live tracer (replacing any previous one) and return it."""
    global _tracer
    _tracer = Tracer(capacity)
    return _tracer


def disable() -> Tracer | None:
    """Swap the no-op singleton back in; returns the live tracer (for dumps)."""
    global _tracer
    prev, _tracer = _tracer, _NULL
    return prev if isinstance(prev, Tracer) else None
