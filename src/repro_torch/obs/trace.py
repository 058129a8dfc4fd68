"""Flight-recorder span tracer (DESIGN.md §13).

One process holds at most one live :class:`Tracer` (module singleton); when
tracing is off the singleton is a :class:`_NullTracer` whose every method is
a no-op, so instrumented hot paths cost two cheap attribute calls and touch
nothing else — a tracing-off run is byte-identical to an uninstrumented one.

Records are **complete spans**: one fixed-dtype numpy row per span with
begin/end timestamps from ``time.perf_counter()`` (the per-process monotonic
clock — timestamps compare within one rank process, never across ranks).
Every thread appends into its own preallocated ring buffer, so recording is
lock-free and allocation-free: a full ring wraps and overwrites the oldest
rows (the count of overwritten rows is reported as ``dropped``).

Span *kinds* are interned strings; the well-known kinds below cover the
whole data-loading runtime (chunk reads, prefetch queue waits, peer
fetch/retry/breaker, buffer-server serve/skew-park/tenant-yield, barrier
waits, rank-loop step sections, trainer compute, fault firings).  Sites
stamp two free integer payload fields ``a``/``b`` (bytes read, source node,
attempt index, ...) and the tracer's *current step* — set by the rank loop
via :meth:`Tracer.set_step` — so the report CLI can attribute every span,
including ones recorded on server/prefetch threads, to a training step.  A
thread whose work serves another step than the current one (a prefetch
thread assembling a batch ahead, an I/O worker reading for it) stamps that
step instead, through :meth:`Tracer.set_thread_step`.

The tracer also keeps a clock anchor: a ``perf_counter`` reading and a
``time.time_ns()`` reading taken back to back, at :func:`enable` and again
on :meth:`Tracer.anchor`.  :meth:`Tracer.epoch_s` maps a span's
``perf_counter`` seconds onto Unix-epoch seconds, the clock of
``torch.profiler``'s kineto events, so spans and device operations share
one time line.

Exports: ``trace-rank{r}.jsonl`` (one JSON object per record, seconds) and
``trace-rank{r}.trace.json`` (Chrome trace-event format, microseconds —
loadable in Perfetto / ``chrome://tracing``).

Own copy of the JAX package's ``obs/trace.py``: the same 20 well-known kinds
in the same registration order (the port's own kinds follow them) and
byte-identical exports for the same records, so either package's report
CLI reads the other's dumps.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import nullcontext

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


# -- well-known span kinds (the §13 vocabulary; ids are import-order stable) --
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
BARRIER_WAIT = kind_id("barrier.wait")          # ctrl.barrier; a=step
STEP = kind_id("step")                          # one rank-loop iteration
STEP_PRIME = kind_id("step.prime")              # plan pulls + read-ahead submit
STEP_PEER = kind_id("step.peer")                # gather_peers section
STEP_EXECUTE = kind_id("step.execute")          # mutating execute_step section
HB_SEND = kind_id("hb.send")                    # synchronous heartbeat
TRAIN_MAKE_BATCH = kind_id("train.make_batch")  # StepBatch -> model batch
TRAIN_COMPUTE = kind_id("train.compute")        # step + host copy of its metrics
FAULT = kind_id("fault")                        # instant; a=nth/step, b=seed
# -- the port's own kinds, after the 20 both packages share --------------------
BATCH_TO_GLOBAL = kind_id("batch.to_global")    # a=rows computed, b=rows of weight 0
BATCH_STAGE = kind_id("batch.stage")            # host batch -> device; a=bytes
PREFETCH_ASSEMBLE = kind_id("prefetch.assemble")    # peers + reads + execute_step
STEP_FORWARD = kind_id("step.forward")          # one microbatch's loss
STEP_BACKWARD = kind_id("step.backward")        # its gradients
STEP_ACCUMULATE = kind_id("step.accumulate")    # their adds into the accumulator
STEP_OPTIMIZER = kind_id("step.optimizer")      # AdamW's update
CONV_STEM_WGRAD = kind_id("conv.stem_wgrad")    # stem weight gradient; a=positions, b=taps
BLOCK_ATTENTION = kind_id("block.attention")    # interleaved attention block; a=layer, b=tokens
BLOCK_MAMBA = kind_id("block.mamba")            # interleaved Mamba block; a=layer, b=tokens

_NULL_CTX = nullcontext()


class _Ring:
    """One thread's preallocated record buffer (count wraps, rows overwrite)."""

    __slots__ = ("buf", "n", "tid", "step")

    def __init__(self, capacity: int, tid: str):
        self.buf = np.zeros(capacity, RECORD_DTYPE)
        self.n = 0
        self.tid = tid
        #: this thread's step stamp; None follows the tracer's current step
        self.step = None


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
        #: the rank loop's current step index, stamped into every record
        #: (including records from server/prefetch threads) — per-step
        #: attribution in ``repro_torch.obs.report``.
        self.step = -1
        self.anchor()

    # perf_counter straight through: site code does ``t0 = tr.t()``.
    t = staticmethod(time.perf_counter)

    def set_step(self, step: int) -> None:
        self.step = step

    def set_thread_step(self, step: int | None) -> None:
        """Stamp the calling thread's records with ``step`` (the step its
        work serves) in place of the current step; ``None`` follows the
        current step again."""
        self._ring().step = step

    def anchor(self) -> tuple[float, int]:
        """Take the clock anchor anew: ``(perf_counter seconds, Unix-epoch
        ns)`` read back to back, the ``perf_counter`` reading the mean of
        one taken before and one after the epoch reading."""
        p0 = time.perf_counter()
        ns = time.time_ns()
        p1 = time.perf_counter()
        self.clock = (0.5 * (p0 + p1), ns)
        return self.clock

    def epoch_s(self, t):
        """``perf_counter`` seconds ``t`` (a float or an array) as Unix-epoch
        seconds, through the latest anchor."""
        pc, ns = self.clock
        return ns * 1e-9 + (t - pc)

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
        step = self.step if ring.step is None else ring.step
        ring.buf[ring.n % self.capacity] = (t0, t1, kind, step, a, b)
        ring.n += 1

    def instant(self, kind: int, a: int = 0, b: int = 0) -> None:
        now = time.perf_counter()
        self.rec(kind, now, now, a, b)

    def span(self, kind: int, a: int = 0, b: int = 0):
        """Context-manager convenience for cold(ish) paths."""
        return _Span(self, kind, a, b)

    # -- collection / export -------------------------------------------------

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

    def dump(self, out_dir: str, rank: int = 0) -> dict:
        """Write both export formats; returns paths + record/drop counts."""
        recs, tids, dropped = self.records()
        os.makedirs(out_dir, exist_ok=True)
        jsonl = os.path.join(out_dir, f"trace-rank{rank}.jsonl")
        chrome = os.path.join(out_dir, f"trace-rank{rank}.trace.json")
        names = kind_names()
        with open(jsonl, "w") as f:
            f.write(json.dumps({
                "meta": True, "rank": int(rank), "pid": os.getpid(),
                "records": int(len(recs)), "dropped": int(dropped),
                "clock": "perf_counter",
            }) + "\n")
            for row, tid in zip(recs, tids):
                f.write(json.dumps({
                    "name": names[int(row["kind"])],
                    "ts": float(row["t0"]),
                    "dur": float(row["t1"] - row["t0"]),
                    "step": int(row["step"]),
                    "a": int(row["a"]),
                    "b": int(row["b"]),
                    "tid": tid,
                }) + "\n")
        events = [
            {
                "name": names[int(row["kind"])],
                "ph": "X",
                "ts": float(row["t0"]) * 1e6,
                "dur": float(row["t1"] - row["t0"]) * 1e6,
                "pid": int(rank),
                "tid": tid,
                "args": {
                    "step": int(row["step"]),
                    "a": int(row["a"]), "b": int(row["b"]),
                },
            }
            for row, tid in zip(recs, tids)
        ]
        with open(chrome, "w") as f:
            json.dump({
                "traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"rank": int(rank), "dropped": int(dropped)},
            }, f)
        return {
            "jsonl": jsonl, "chrome": chrome,
            "records": int(len(recs)), "dropped": int(dropped),
        }


class _Span:
    """Reusable enter/exit wrapper recording one complete span on exit."""

    __slots__ = ("_tr", "_kind", "_a", "_b", "_t0")

    def __init__(self, tr: Tracer, kind: int, a: int, b: int):
        self._tr, self._kind, self._a, self._b = tr, kind, a, b

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._tr.rec(self._kind, self._t0, a=self._a, b=self._b)


class _NullTracer:
    """Tracing off: every operation is a no-op (the digest-parity default)."""

    enabled = False
    step = -1

    @staticmethod
    def t() -> float:
        return 0.0

    def set_step(self, step: int) -> None:
        pass

    def set_thread_step(self, step: int | None) -> None:
        pass

    def rec(self, kind: int, t0: float, t1: float | None = None,
            a: int = 0, b: int = 0) -> None:
        pass

    def instant(self, kind: int, a: int = 0, b: int = 0) -> None:
        pass

    def span(self, kind: int, a: int = 0, b: int = 0):
        return _NULL_CTX


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
