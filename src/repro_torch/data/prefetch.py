"""Asynchronous pipelined execution of the SOLAR schedule.

The offline :class:`~repro_torch.core.plan.Schedule` makes every future access
known, so the runtime never has to guess what to read next — it only has to
*overlap* the reads with the consumer's compute.  :class:`PrefetchExecutor`
does exactly that:

  * **schedule mode** (any loader exposing ``plan_steps``/``execute_step``,
    i.e. :class:`~repro_torch.data.loaders.ScheduleExecutor` — since the plan-first
    refactor that is *every* strategy, baselines included): a pipeline
    thread walks the plan ``depth`` steps ahead of the consumer and submits
    every node-step's coalesced :class:`~repro_torch.core.plan.ChunkRead` batch to
    a thread pool, so PFS calls for *different* nodes and *future* steps are
    in flight concurrently; batches are then assembled strictly in plan
    order (buffer-mirror deltas are order-dependent) and handed to the
    consumer through a bounded queue.  A step's planned peer fetches
    (DESIGN.md §6) are gathered at assembly time — the only point where the
    buffer mirrors are in the start-of-step state the plan priced —
    overlapping the tail of that step's still-in-flight chunk reads.
  * **iterator mode** (plain iterables without a plan): the loader's own
    ``__iter__`` runs on the pipeline thread behind the same bounded queue —
    reads overlap the consumer's compute, but intra-step reads stay
    sequential because such loaders decide their accesses online.

The executor is storage-agnostic: chunk reads go through the wrapped
loader's ``store.read_ranges`` — any :class:`~repro_torch.data.backends.base.
StorageBackend` whose open/close lifecycle tolerates concurrent in-flight
reads (the fd/handle-pool contract every built-in backend implements).
Build one declaratively by setting ``prefetch_depth`` on a
:class:`~repro_torch.data.pipeline.LoaderSpec`.

The output queue is bounded (``depth`` entries, default 2 = double
buffering).  In schedule mode up to ``depth`` *assembled* batches queue for
the consumer while up to ``depth`` further steps of raw chunk reads are in
flight, so peak read-ahead is ~``2 * depth`` steps and host memory is
proportional to ``2 * depth * global_batch`` — size ``depth`` against host
RAM accordingly.  Shutdown is
cooperative: :meth:`close` (also triggered by abandoning the iterator or the
context manager) cancels the pipeline, drains the queue, joins the thread and
tears down the pool — no leaked threads, ever.  Every iteration owns its run
state (queue, cancel flag, threads), so finalizing a stale, abandoned
iterator can never cancel a newer one.
"""
from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from repro_torch.obs import trace as obs_trace

__all__ = ["PrefetchExecutor", "WindowReadAhead"]

_SENTINEL = object()


class WindowReadAhead:
    """Chunk-read pipelining for the distributed rank loop (DESIGN.md §11).

    The epoch-window protocol removes the per-step barriers, so a rank is
    free to issue the coalesced :class:`~repro_torch.core.plan.ChunkRead` batches
    of *future* steps (up to ``prefetch_depth`` ahead, never past the
    window edge) while the current step assembles — the same overlap
    :class:`PrefetchExecutor` gives a single-process run, restated for a
    loop that interleaves several owned node-executors and must keep
    gather/execute on the rank thread (the buffer-server mutation order is
    the protocol).  Only the PFS reads move off-thread; they are pure.
    """

    def __init__(self, num_workers: int = 4):
        self._pool = ThreadPoolExecutor(
            max_workers=max(int(num_workers), 1), thread_name_prefix="solar-io"
        )

    def submit(self, store, sp) -> list:
        """Issue one step-plan's per-node chunk reads; returns futures."""
        return [
            self._pool.submit(
                store.read_ranges, [(c.start, c.stop) for c in npn.chunks]
            )
            for npn in sp.nodes
        ]

    @staticmethod
    def collect(futs) -> list | None:
        """Resolve a :meth:`submit` result into ``chunk_arrays`` (or None)."""
        return [f.result() for f in futs] if futs else None

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "WindowReadAhead":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _Failure:
    """Wraps a producer-side exception for re-raise on the consumer thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _Run:
    """State owned by one iteration of the executor."""

    def __init__(self, depth: int, num_workers: int | None):
        self.cancel = threading.Event()
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.pool = (
            ThreadPoolExecutor(
                max_workers=num_workers, thread_name_prefix="solar-io"
            )
            if num_workers
            else None
        )
        self.thread: threading.Thread | None = None


class PrefetchExecutor:
    """Schedule-driven asynchronous prefetcher over a loader.

    Iterating a ``PrefetchExecutor`` yields exactly the same
    :class:`~repro_torch.data.loaders.StepBatch` sequence (and fills the same
    :class:`~repro_torch.data.loaders.LoaderReport`) as iterating the wrapped
    loader synchronously — only the wall-clock schedule changes.
    """

    def __init__(self, loader, depth: int = 2, num_workers: int = 4,
                 mode: str = "auto"):
        if mode not in ("auto", "schedule", "iterator"):
            raise ValueError(f"unknown prefetch mode {mode!r}")
        if mode == "auto":
            mode = "schedule" if hasattr(loader, "plan_steps") else "iterator"
        if mode == "schedule" and not hasattr(loader, "plan_steps"):
            raise ValueError(f"{type(loader).__name__} has no plan to pipeline")
        self.loader = loader
        self.mode = mode
        self.depth = max(int(depth), 1)
        self.num_workers = max(int(num_workers), 1)
        self._run: _Run | None = None

    # -- loader proxy ---------------------------------------------------------

    def __getattr__(self, name):
        # Fall through to the wrapped loader (report, capacity, store, ...)
        # so the executor is a drop-in replacement in the trainer/benchmarks.
        if name == "loader":
            raise AttributeError(name)
        return getattr(self.loader, name)

    # -- lifecycle ------------------------------------------------------------

    def __enter__(self) -> "PrefetchExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass

    @staticmethod
    def _close_run(run: _Run | None) -> None:
        if run is None:
            return
        run.cancel.set()
        thread = run.thread
        while thread is not None and thread.is_alive():
            try:  # drain so a producer blocked on a full queue can exit
                while True:
                    run.q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=0.05)
        run.thread = None
        if run.pool is not None:
            run.pool.shutdown(wait=True)
            run.pool = None

    def close(self) -> None:
        """Cancel the active pipeline and join every thread it started."""
        run, self._run = self._run, None
        self._close_run(run)

    # -- iteration ------------------------------------------------------------

    def __iter__(self):
        self.close()  # stop any previous in-flight run
        run = _Run(
            self.depth,
            self.num_workers
            if self.mode == "schedule" and self.loader.collect_data
            else None,
        )
        run.thread = threading.Thread(
            target=self._produce, args=(run,), name="solar-pipeline", daemon=True
        )
        self._run = run
        run.thread.start()
        return self._consume(run)

    def _consume(self, run: _Run):
        tr = obs_trace.get()
        try:
            while True:
                t0 = tr.t()
                item = run.q.get()
                tr.rec(obs_trace.PREFETCH_QWAIT, t0)
                if item is _SENTINEL:
                    break
                if isinstance(item, _Failure):
                    raise item.exc
                yield item
        finally:
            # Tear down *this* run only; a newer __iter__ owns self._run now.
            if self._run is run:
                self._run = None
            self._close_run(run)

    # -- producer side --------------------------------------------------------

    @staticmethod
    def _put(run: _Run, item) -> bool:
        """Blocking put that aborts when the pipeline is cancelled."""
        while not run.cancel.is_set():
            try:
                run.q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, run: _Run) -> None:
        try:
            if self.mode == "schedule":
                self._produce_schedule(run)
            else:
                for sb in self.loader:
                    if not self._put(run, sb):
                        return
        except BaseException as exc:  # surfaced on the consumer thread
            self._put(run, _Failure(exc))
        finally:
            if not self._put(run, _SENTINEL):
                try:  # consumer may already be gone; best effort
                    run.q.put_nowait(_SENTINEL)
                except queue.Full:
                    pass

    def _produce_schedule(self, run: _Run) -> None:
        ld = self.loader
        collect = ld.collect_data
        gather_peers = getattr(ld, "gather_peers", None)
        steps = iter(ld.plan_steps())
        #: (EpochPlan, StepPlan, per-node futures) issued but not yet assembled.
        pending: deque = deque()
        exhausted = False
        while not run.cancel.is_set():
            while not exhausted and len(pending) < self.depth:
                try:
                    ep, sp = next(steps)
                except StopIteration:
                    exhausted = True
                    break
                futs = None
                if collect:
                    futs = [
                        run.pool.submit(
                            ld.store.read_ranges,
                            [(c.start, c.stop) for c in npn.chunks],
                        )
                        for npn in sp.nodes
                    ]
                pending.append((ep, sp, futs))
            if not pending:
                return
            ep, sp, futs = pending.popleft()
            # Peer fetches are legal exactly now — the previous step's deltas
            # are applied, this step's are not — and they overlap the tail of
            # this step's in-flight chunk reads.
            peer_arrays = gather_peers(sp) if gather_peers is not None else None
            chunk_arrays = [f.result() for f in futs] if futs else None
            if gather_peers is not None:
                sb = ld.execute_step(
                    ep, sp, chunk_arrays=chunk_arrays, peer_arrays=peer_arrays
                )
            else:
                sb = ld.execute_step(ep, sp, chunk_arrays=chunk_arrays)
            if not self._put(run, sb):
                break
        # Cancelled: wait out in-flight reads so pool shutdown is clean.
        for _, _, futs in pending:
            for f in futs or ():
                f.cancel()
