"""The schedule executor: one runtime replays any strategy's plan.

Every loading strategy — SOLAR and all four baselines — compiles offline to
the same :class:`~repro_torch.core.plan.Schedule` IR (see
:mod:`repro_torch.core.planners`), so the runtime no longer needs a zoo of loader
classes improvising their access order inside ``__iter__``.  One
:class:`ScheduleExecutor` replays any plan against any
:class:`~repro_torch.data.backends.base.StorageBackend`:

  * buffer hits come out of a per-node :class:`_DataMirror` arena,
  * misses ride the plan's coalesced :class:`~repro_torch.core.plan.ChunkRead`
    ranged reads (``store.read_ranges``),
  * planned :class:`~repro_torch.core.plan.PeerFetch` records are served through a
    :class:`~repro_torch.data.peer.PeerExchange` when a transport is configured
    (SOLAR's interconnect tier, DESIGN.md §6) and fall back to coalesced
    scattered store reads otherwise (how NoPFS's emulated remote fetches are
    billed without a transport),
  * buffer state is maintained purely from the plan's recorded
    admission/eviction deltas — the runtime never re-decides.

The executor yields :class:`StepBatch` objects and accumulates a
:class:`LoaderReport` with numPFS / modeled PFS time / wall time, which is
what the paper's figures plot.  ``fast_forward(n)`` replays the first ``n``
steps' deltas without reading data — mid-epoch resume from a checkpointed
plan cursor costs no I/O.

Construct executors declaratively via :func:`repro_torch.data.pipeline.plan` /
:func:`~repro_torch.data.pipeline.execute` (or their composition
:func:`~repro_torch.data.pipeline.build_pipeline`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time

import numpy as np

from repro_torch.core.costmodel import PeerCostModel, PFSCostModel
from repro_torch.core.plan import Schedule
from repro_torch.data.backends.base import StorageBackend
from repro_torch.obs import trace as obs_trace

__all__ = [
    "StepBatch",
    "LoaderReport",
    "ScheduleExecutor",
    "update_batch_digest",
    "stream_digest",
]


@dataclasses.dataclass
class StepBatch:
    epoch: int
    step: int
    #: per-node real sample ids.
    node_ids: list[np.ndarray]
    #: per-node sample arrays, [num_real, *sample_shape]; None when counting only.
    node_data: list[np.ndarray] | None
    #: per-node hit masks (True = served from buffer).
    hit_masks: list[np.ndarray]

    def to_global(self, capacity: int):
        """Pad each node to ``capacity`` rows and stack: SPMD-ready batch.

        Returns ``(data, weights)`` with shapes ``[N*capacity, ...]`` and
        ``[N*capacity]``; dummy rows have weight 0 so the masked loss makes
        gradients identical to the unpadded batch (DESIGN.md §3).  Traced as
        ``batch.to_global``: a = rows computed, b = rows of weight 0.
        """
        assert self.node_data is not None
        tr = obs_trace.get()
        t0 = tr.t()
        n = len(self.node_ids)
        shape = self.node_data[0].shape[1:]
        dtype = self.node_data[0].dtype
        data = np.zeros((n, capacity) + shape, dtype)
        weights = np.zeros((n, capacity), np.float32)
        real = 0
        for i, arr in enumerate(self.node_data):
            k = min(arr.shape[0], capacity)
            data[i, :k] = arr[:k]
            weights[i, :k] = 1.0
            real += k
        tr.rec(obs_trace.BATCH_TO_GLOBAL, t0, a=n * capacity, b=n * capacity - real)
        return data.reshape((n * capacity,) + shape), weights.reshape(-1)


def update_batch_digest(h, sb: StepBatch) -> None:
    """Feed one batch's canonical bytes (epoch, step, ids, masks, data) to
    a hashlib object — the digest the parity tests and benchmarks pin."""
    h.update(np.int64(sb.epoch).tobytes())
    h.update(np.int64(sb.step).tobytes())
    for ids, mask in zip(sb.node_ids, sb.hit_masks):
        h.update(np.ascontiguousarray(ids, dtype=np.int64).tobytes())
        h.update(np.ascontiguousarray(mask, dtype=bool).tobytes())
    if sb.node_data is not None:
        for arr in sb.node_data:
            h.update(np.ascontiguousarray(arr).tobytes())


def stream_digest(batches) -> str:
    """SHA-256 over a whole :class:`StepBatch` stream, canonical encoding."""
    h = hashlib.sha256()
    for sb in batches:
        update_batch_digest(h, sb)
    return h.hexdigest()


@dataclasses.dataclass
class LoaderReport:
    name: str
    num_nodes: int
    #: per-(step, node) PFS sample counts (misses incl. chunk waste).
    pfs_counts: list[list[int]] = dataclasses.field(default_factory=list)
    #: per-(step, node) PFS miss counts (wanted samples only; misses served
    #: from a remote buffer are in ``remote_counts`` instead).
    miss_counts: list[list[int]] = dataclasses.field(default_factory=list)
    #: per-(step, node) remote-buffer fetch counts (NoPFS online fetches /
    #: SOLAR planned peer fetches).
    remote_counts: list[list[int]] = dataclasses.field(default_factory=list)
    #: per-(step, node) batch sizes.
    batch_sizes: list[list[int]] = dataclasses.field(default_factory=list)
    modeled_time_s: float = 0.0
    wall_time_s: float = 0.0
    total_hits: int = 0
    total_samples: int = 0
    #: samples served *by* each source node over the peer tier (serving-load
    #: accounting, mirrored from :attr:`PeerExchange.served_by_source` —
    #: read imbalance lives in ``pfs_counts``, serving imbalance lives here).
    served_by_source: dict = dataclasses.field(default_factory=dict)
    #: failure-ladder counters mirrored from the transport after each gather
    #: (``retries`` / ``breaker_opens`` / ``unknown_source_fallbacks`` / ...);
    #: empty for transports without a ladder (shared-view).
    transport_stats: dict = dataclasses.field(default_factory=dict)

    @property
    def total_pfs(self) -> int:
        return int(np.sum(self.pfs_counts)) if self.pfs_counts else 0

    @property
    def total_misses(self) -> int:
        return int(np.sum(self.miss_counts)) if self.miss_counts else 0

    @property
    def hit_rate(self) -> float:
        return self.total_hits / self.total_samples if self.total_samples else 0.0

    @property
    def total_remote(self) -> int:
        return int(np.sum(self.remote_counts)) if self.remote_counts else 0

    @property
    def max_step_pfs(self) -> np.ndarray:
        a = np.asarray(self.pfs_counts)
        if a.ndim < 2 or a.shape[1] == 0:
            # a rank whose plan slice is empty records zero-node steps
            return np.zeros(len(self.pfs_counts), np.int64)
        return a.max(axis=1)

    def summary(self) -> dict:
        return {
            "loader": self.name,
            "numPFS": self.total_pfs,
            "misses": self.total_misses,
            "remote_fetches": self.total_remote,
            "peer_served_by_source": {
                str(k): int(v) for k, v in sorted(self.served_by_source.items())
            },
            "hit_rate": round(self.hit_rate, 4),
            "modeled_time_s": round(self.modeled_time_s, 3),
            "wall_time_s": round(self.wall_time_s, 3),
            # the transport failure ladder (zeros for ladder-less transports)
            "retries": int(self.transport_stats.get("retries", 0)),
            "breaker_opens": int(self.transport_stats.get("breaker_opens", 0)),
            "unknown_source_fallbacks": int(
                self.transport_stats.get("unknown_source_fallbacks", 0)
            ),
        }


class _DataMirror:
    """Array-backed mirror of one node's buffer contents (id -> sample row).

    Lookups are vectorized (sorted id array + ``np.searchsorted``); admissions
    copy only the admitted rows into free slots of a preallocated arena and
    evictions only release slots — there is no per-step rebuild of the buffer.
    """

    def __init__(self, capacity: int, sample_shape: tuple[int, ...], dtype):
        self.capacity = max(int(capacity), 1)
        self._sample_shape = sample_shape
        self._dtype = dtype
        self._data: np.ndarray | None = None  # allocated on first admit
        self.ids = np.empty(0, np.int64)      # sorted
        self._slots = np.empty(0, np.int64)   # parallel to ids
        self._free = list(range(self.capacity - 1, -1, -1))
        #: optional list capturing ``(ids, rows)`` of everything evicted —
        #: the BufferServer's window-skew guard (DESIGN.md §11) binds it
        #: around a step's delta replay so peers still inside the skew
        #: window can be served rows this step just evicted.
        self.evict_sink: list | None = None

    def lookup(self, want: np.ndarray) -> np.ndarray:
        """Arena slot per wanted id, -1 where absent."""
        want = np.asarray(want, np.int64)
        if want.size == 0 or self.ids.size == 0:
            return np.full(want.size, -1, np.int64)
        pos = np.minimum(np.searchsorted(self.ids, want), self.ids.size - 1)
        return np.where(self.ids[pos] == want, self._slots[pos], -1)

    def rows(self, slots: np.ndarray) -> np.ndarray:
        assert self._data is not None
        return self._data[slots]

    def evict(self, ids) -> None:
        ids = np.asarray(ids, np.int64)
        if ids.size == 0 or self.ids.size == 0:
            return
        keep = ~np.isin(self.ids, ids, assume_unique=True)
        if self.evict_sink is not None and self._data is not None:
            gone = ~keep
            if gone.any():
                self.evict_sink.append(
                    (self.ids[gone].copy(), self._data[self._slots[gone]].copy())
                )
        self._free.extend(int(s) for s in self._slots[~keep].tolist())
        self.ids = self.ids[keep]
        self._slots = self._slots[keep]

    def admit(self, ids, rows) -> None:
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return
        present = self.lookup(ids) >= 0
        if present.any():  # re-admission of a resident id is a no-op
            ids, rows = ids[~present], rows[~present]
            if ids.size == 0:
                return
        if self._data is None:
            self._data = np.empty(
                (self.capacity,) + self._sample_shape, self._dtype
            )
        slots = np.asarray([self._free.pop() for _ in range(ids.size)], np.int64)
        self._data[slots] = rows
        all_ids = np.concatenate([self.ids, ids])
        all_slots = np.concatenate([self._slots, slots])
        order = np.argsort(all_ids, kind="stable")
        self.ids = all_ids[order]
        self._slots = all_slots[order]


class ScheduleExecutor:
    """Replay one :class:`~repro_torch.core.plan.Schedule` against one store.

    The executor is strategy-agnostic: everything it does — which samples a
    node trains, which bytes come from the buffer / a peer / the PFS, what
    enters and leaves the buffer — is recorded in the plan.  Peer serving is
    enabled by passing ``solar_config`` with ``enable_peer`` set (the
    pipeline layer does this) or an explicit ``peer_transport``; without
    either, planned peer fetches are billed as remote transfers but the
    bytes come from coalesced scattered store reads — which is exactly how
    the NoPFS baseline's emulated hierarchical fetches behave.
    """

    def __init__(
        self,
        store: StorageBackend,
        schedule: Schedule,
        *,
        collect_data: bool = False,
        cost_model: PFSCostModel | None = None,
        peer_cost: PeerCostModel | None = None,
        peer_transport=None,
        solar_config=None,
        serve_peers: bool | None = None,
    ):
        self.store = store
        self.schedule = schedule
        self.name = schedule.strategy
        self.num_nodes = schedule.num_nodes
        self.local_batch = schedule.local_batch
        self.num_epochs = len(schedule.epochs)
        self.buffer_size = schedule.buffer_size
        self.collect_data = collect_data
        self.cost = cost_model or PFSCostModel(sample_bytes=store.sample_bytes)
        self.solar_config = solar_config
        #: streaming mode (DESIGN.md §10): while open, a plan walk that runs
        #: out of epochs waits for extend() instead of finishing.
        self._stream_cond = threading.Condition()
        self._stream_open = False
        self.stream_timeout_s = 60.0
        if serve_peers is None:
            serve_peers = peer_transport is not None or bool(
                solar_config is not None and solar_config.enable_peer
            )
        if peer_cost is None and solar_config is not None:
            peer_cost = solar_config.peer_cost
        if serve_peers and peer_cost is None:
            # price the peer tier with this store's real sample size
            peer_cost = PeerCostModel(
                sample_bytes=store.sample_bytes, pfs=self.cost
            )
        self.peer_cost = peer_cost
        self.report = LoaderReport(name=self.name, num_nodes=self.num_nodes)
        #: per-node data buffers (actual arrays) when materializing batches.
        self._data_buf: list[_DataMirror | None] = [None] * self.num_nodes
        #: buffer occupancy per node, maintained from the plan's recorded
        #: admission/eviction deltas — no per-step resident-set rebuild.
        self._occupancy = [0] * self.num_nodes
        #: first plan step to *execute*; earlier steps replay deltas only.
        self._start_step = 0
        self.peer_exchange = None
        if serve_peers:
            from repro_torch.data.peer import PeerExchange, SharedViewTransport

            self.peer_exchange = PeerExchange(
                peer_transport or SharedViewTransport(self._mirror),
                self.store.sample_shape,
                self.store.dtype,
            )

    @property
    def capacity(self) -> int:
        return self.schedule.capacity

    @property
    def config_hash(self) -> str:
        return self.schedule.config_hash

    def remote_time(self, k: int, interconnect_bps: float = 1.0e10,
                    latency_s: float = 5e-5) -> float:
        if self.peer_cost is not None:
            return self.peer_cost.fetch_time(k)
        return k * (latency_s + self.store.sample_bytes / interconnect_bps)

    # -- plan walking ---------------------------------------------------------

    def reset_execution(self) -> None:
        """Forget buffer state so the schedule can be replayed from step 0."""
        self._occupancy = [0] * self.num_nodes
        self._data_buf = [None] * self.num_nodes

    def fast_forward(self, num_steps: int) -> None:
        """Start subsequent iterations at plan step ``num_steps``.

        The skipped steps' admission/eviction deltas are replayed without
        reading any batch data or accounting anything; then, when data is
        being collected, each node's buffer is re-staged with **one**
        coalesced scattered read of its resident set — so a resumed run pays
        a single bounded buffer refill instead of re-reading every skipped
        batch, and every later planned hit is served from RAM exactly as in
        an uninterrupted run.  Resumed batches stay bit-identical either
        way (an unstaged row would fall back to a store read).
        """
        self._start_step = max(int(num_steps), 0)

    def _skip_step(self, sp, resident: list[set]) -> None:
        for npn in sp.nodes:
            r = npn.node
            self._occupancy[r] += npn.admissions.size - npn.evictions.size
            resident[r].update(npn.admissions.tolist())
            resident[r].difference_update(npn.evictions.tolist())

    def _restage_buffers(self, resident: list[set]) -> None:
        """Refill the data mirrors after a fast-forward: one coalesced
        scattered read per node covering exactly its resident samples."""
        for r, ids in enumerate(resident):
            if not ids:
                continue
            ordered = np.fromiter(ids, np.int64, count=len(ids))
            ordered.sort()
            self._mirror(r).admit(ordered, self.store.read_scattered(ordered))

    def begin_stream(self) -> None:
        """Enter streaming mode: plan walks block at the end of the schedule
        (waiting for :meth:`extend`) instead of finishing."""
        with self._stream_cond:
            self._stream_open = True

    def finish_stream(self) -> None:
        """Leave streaming mode: blocked walks drain and finish normally."""
        with self._stream_cond:
            self._stream_open = False
            self._stream_cond.notify_all()

    def extend(self, schedule: Schedule) -> None:
        """Chain another plan segment onto the live schedule, no teardown.

        The appended segment must match the running schedule's geometry and
        strategy; its epochs join the walk in order.  Safe to call from a
        different thread than the one iterating (the streaming driver plans
        window ``k+1`` while the executor replays window ``k``): the epoch
        list is only appended to, and walks pick up appended epochs under
        the stream condition.
        """
        for field in ("num_nodes", "local_batch", "capacity", "buffer_size",
                      "strategy"):
            if getattr(schedule, field) != getattr(self.schedule, field):
                raise ValueError(
                    f"extend(): segment {field} "
                    f"{getattr(schedule, field)!r} != running "
                    f"{getattr(self.schedule, field)!r}"
                )
        with self._stream_cond:
            self.schedule.epochs.extend(schedule.epochs)
            self.schedule.epoch_order = np.concatenate(
                [
                    np.asarray(self.schedule.epoch_order, np.int64),
                    np.asarray(schedule.epoch_order, np.int64),
                ]
            )
            self.num_epochs = len(self.schedule.epochs)
            self._stream_cond.notify_all()

    def stream_steps_ready(self) -> int | None:
        """Yieldable plan steps currently materialized, or None when not in
        streaming mode (non-streaming walks never block).

        The prefetch pipeline probes this before pulling another step for
        its read-ahead window: when the walk would block waiting for the
        next ``extend()``, the pipeline assembles the steps it already holds
        instead of stalling the whole pipe at a window boundary.
        """
        with self._stream_cond:
            if not self._stream_open:
                return None
            total = sum(len(ep.steps) for ep in self.schedule.epochs)
            return max(total - self._start_step, 0)

    def _next_epoch(self, ei: int):
        """Epoch ``ei``, or None past the end — waiting in streaming mode."""
        with self._stream_cond:
            if ei < len(self.schedule.epochs):
                return self.schedule.epochs[ei]
            if not self._stream_open:
                return None
            deadline = time.monotonic() + self.stream_timeout_s
            while ei >= len(self.schedule.epochs) and self._stream_open:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"streaming walk waited > {self.stream_timeout_s}s "
                        f"for window {ei} (extend() never arrived)"
                    )
                self._stream_cond.wait(0.05)
            if ei < len(self.schedule.epochs):
                return self.schedule.epochs[ei]
            return None  # stream finished while waiting

    def plan_steps(self):
        """Walk the schedule in execution order, yielding (EpochPlan, StepPlan).

        This is the surface the :class:`repro_torch.data.prefetch.PrefetchExecutor`
        pipelines over: every future ChunkRead is visible here.  Each walk
        replays the buffer simulation from an empty buffer, honoring
        :meth:`fast_forward`.  The walk is index-based so epochs appended by
        :meth:`extend` mid-walk are picked up; in streaming mode it blocks
        at the end of the schedule until the next window or
        :meth:`finish_stream`.
        """
        self.reset_execution()
        idx = 0
        resident: list[set] = [set() for _ in range(self.num_nodes)]
        staged = self._start_step == 0
        ei = 0
        while True:
            ep = self._next_epoch(ei)
            if ep is None:
                return
            for sp in ep.steps:
                if idx < self._start_step:
                    self._skip_step(sp, resident)
                    idx += 1
                    continue
                if not staged:
                    staged = True
                    if self.collect_data:
                        self._restage_buffers(resident)
                idx += 1
                yield ep, sp
            ei += 1

    def __iter__(self):
        for ep, sp in self.plan_steps():
            yield self.execute_step(ep, sp)

    # -- one step -------------------------------------------------------------

    def gather_peers(self, sp) -> list | None:
        """Serve every node's planned peer fetches for one step, up front.

        Must run before any of the step's admission/eviction deltas are
        applied (the plan guarantees source residency only at step *start* —
        a source may evict the fetched sample in this very step, see
        :mod:`repro_torch.data.peer`).  Returns per-node ``(ids, rows)`` pairs (or
        ``None`` entries), ready for :meth:`execute_step`'s assembly; samples
        the transport could not serve are simply absent and fall back to
        store reads downstream.
        """
        if self.peer_exchange is None or not self.collect_data:
            return None
        t0 = time.perf_counter()
        out = []
        for npn in sp.nodes:
            if npn.peer_fetches:
                ids, rows, _missing = self.peer_exchange.gather(npn.peer_fetches)
                out.append((ids, rows))
            else:
                out.append(None)
        self.report.served_by_source = {
            int(k): int(v)
            for k, v in self.peer_exchange.served_by_source.items()
        }
        stats = getattr(self.peer_exchange.transport, "stats", None)
        if callable(stats):
            self.report.transport_stats = stats()
        self.report.wall_time_s += time.perf_counter() - t0
        return out

    def execute_step(self, ep, sp, chunk_arrays=None, peer_arrays=None) -> StepBatch:
        """Account + assemble one planned step into a :class:`StepBatch`.

        ``chunk_arrays`` optionally supplies per-node pre-read chunk data (the
        async pipeline reads them concurrently ahead of time); when ``None``
        and ``collect_data`` is set, chunk reads are issued synchronously.
        ``peer_arrays`` optionally supplies the step's already-gathered peer
        rows (the async pipeline overlaps :meth:`gather_peers` with in-flight
        chunk reads); when ``None`` they are gathered here, before any delta
        is applied.  The plan's recorded admissions/evictions are replayed as
        deltas so the data buffer mirrors the planned simulation exactly.
        """
        chunks = [n.chunks for n in sp.nodes]
        self._account(
            chunks,
            [n.num_pfs_misses for n in sp.nodes],
            [n.num_real for n in sp.nodes],
            [n.num_hits for n in sp.nodes],
            per_node_remote=[n.num_peer for n in sp.nodes],
            per_node_remote_billable=[
                sum(1 for f in n.peer_fetches if f.source != n.node)
                for n in sp.nodes
            ],
        )
        if peer_arrays is None:
            peer_arrays = self.gather_peers(sp)
        data = [] if self.collect_data else None
        # Per-node state (occupancy, mirrors) is keyed by the plan's global
        # node id, not list position: a for_node() slice carries one plan
        # per step whose ``node`` is the rank, and must not alias rank 0's
        # buffer.  chunk_arrays/peer_arrays stay positional (parallel to
        # sp.nodes).
        for n, npn in enumerate(sp.nodes):
            r = npn.node
            self._occupancy[r] += npn.admissions.size - npn.evictions.size
            assert self._occupancy[r] <= self.buffer_size
            if not self.collect_data:
                continue
            delta = (npn.admissions, npn.evictions)
            extra = peer_arrays[n] if peer_arrays is not None else None
            if chunk_arrays is None:
                data.append(
                    self._fetch(r, npn.sample_ids, npn.chunks, delta, extra=extra)
                )
            else:
                t0 = time.perf_counter()
                data.append(
                    self._assemble(
                        r, npn.sample_ids, npn.chunks, chunk_arrays[n], delta,
                        extra=extra,
                    )
                )
                self.report.wall_time_s += time.perf_counter() - t0
        return StepBatch(
            ep.epoch_id,
            sp.step,
            [n.sample_ids for n in sp.nodes],
            data,
            [n.hit_mask for n in sp.nodes],
        )

    # -- accounting -----------------------------------------------------------

    def _account(
        self,
        per_node_chunks,
        per_node_miss,
        per_node_batch,
        per_node_hits,
        per_node_remote=None,
        per_node_remote_billable=None,
    ) -> None:
        """``per_node_remote_billable`` prices the remote fetches when it
        differs from the reported count — SOLAR's self-source peer fetches
        (sample bounced back to its own holder) are counted but cost no
        transfer (DESIGN.md §6)."""
        r = self.report
        r.pfs_counts.append([sum(c.span for c in cs) for cs in per_node_chunks])
        r.miss_counts.append(list(per_node_miss))
        r.batch_sizes.append(list(per_node_batch))
        r.remote_counts.append(
            list(per_node_remote) if per_node_remote else [0] * self.num_nodes
        )
        r.total_hits += int(sum(per_node_hits))
        r.total_samples += int(sum(per_node_batch))
        if per_node_remote_billable is None:
            per_node_remote_billable = per_node_remote
        node_times = []
        for n, cs in enumerate(per_node_chunks):
            t = self.cost.chunks_time(cs)
            if per_node_remote_billable:
                t += self.remote_time(per_node_remote_billable[n])
            node_times.append(t)
        r.modeled_time_s += max(node_times) if node_times else 0.0

    # -- batch materialization ------------------------------------------------

    def _fetch(
        self, node: int, ids, chunks, delta=None, extra=None
    ) -> np.ndarray | None:
        """Materialize one node's batch: buffer hits from RAM, misses via reads."""
        if not self.collect_data:
            return None
        t0 = time.perf_counter()
        arrays = self.store.read_ranges([(c.start, c.stop) for c in chunks])
        out = self._assemble(node, ids, chunks, arrays, delta, extra=extra)
        self.report.wall_time_s += time.perf_counter() - t0
        return out

    def _assemble(
        self, node: int, ids, chunks, chunk_arrays, delta=None, extra=None
    ) -> np.ndarray:
        """Gather one node's batch rows from pre-read chunks + the buffer mirror.

        Vectorized: misses come out of the concatenated chunk arrays via
        ``np.searchsorted``, hits out of the :class:`_DataMirror` arena, and
        anything uncovered (e.g. peer fetches with no transport, or hits on
        rows the mirror dropped across a ``fast_forward``) falls back to a
        coalesced scattered read.  ``extra`` is an optional ``(ids, rows)``
        pair of already-fetched samples (the planned peer tier) merged into
        the fetched pool, so peer rows serve both batch assembly and buffer
        admission without touching the store.
        """
        ids = np.asarray(ids, np.int64)
        shape, dtype = self.store.sample_shape, self.store.dtype
        if chunks:
            fetched_ids = np.concatenate(
                [np.arange(c.start, c.stop, dtype=np.int64) for c in chunks]
            )
            fetched_data = (
                chunk_arrays[0]
                if len(chunk_arrays) == 1
                else np.concatenate(chunk_arrays)
            )
        else:
            fetched_ids = np.empty(0, np.int64)
            fetched_data = np.empty((0,) + shape, dtype)
        if extra is not None and extra[0].size:
            fetched_ids = np.concatenate([fetched_ids, extra[0]])
            fetched_data = (
                np.concatenate([fetched_data, extra[1]])
                if fetched_data.size
                else extra[1]
            )
        if fetched_ids.size > 1 and not (np.diff(fetched_ids) > 0).all():
            order = np.argsort(fetched_ids, kind="stable")
            fetched_ids, fetched_data = fetched_ids[order], fetched_data[order]
        out = np.empty((ids.size,) + shape, dtype)
        need = np.ones(ids.size, bool)
        if fetched_ids.size and ids.size:
            pos = np.minimum(np.searchsorted(fetched_ids, ids), fetched_ids.size - 1)
            from_chunks = fetched_ids[pos] == ids
            out[from_chunks] = fetched_data[pos[from_chunks]]
            need &= ~from_chunks
        if need.any():
            mirror = self._mirror(node)
            slots = mirror.lookup(ids[need])
            found = slots >= 0
            if found.any():
                idx = np.flatnonzero(need)[found]
                out[idx] = mirror.rows(slots[found])
                need[idx] = False
        if need.any():  # remote fetch / uncovered: coalesced direct reads
            fallback = self.store.read_scattered(ids[need])
            out[need] = fallback
            # merge into the fetched pool so the delta replay below can admit
            # these rows (e.g. transport-less peer fetches the plan buffers)
            # without issuing a second read for the same samples.
            uids, first = np.unique(ids[need], return_index=True)
            fetched_ids = np.concatenate([fetched_ids, uids])
            fetched_data = (
                np.concatenate([fetched_data, fallback[first]])
                if fetched_data.size
                else fallback[first]
            )
            order = np.argsort(fetched_ids, kind="stable")
            fetched_ids, fetched_data = fetched_ids[order], fetched_data[order]
        self._sync_data_buffer(node, fetched_ids, fetched_data, delta)
        return out

    def _mirror(self, node: int) -> _DataMirror:
        if self._data_buf[node] is None:
            self._data_buf[node] = _DataMirror(
                self.buffer_size, self.store.sample_shape, self.store.dtype
            )
        return self._data_buf[node]

    def _sync_data_buffer(
        self, node: int, fetched_ids: np.ndarray, fetched_data: np.ndarray, delta
    ) -> None:
        """Replay the plan's ``(admissions, evictions)`` delta on the mirror.

        Admitted rows come from the fetched pool (chunks + peer rows); any
        admission the pool does not cover — defensive, plans normally cover
        them — is read back from the store so the mirror never holds wrong
        bytes.
        """
        admissions, evictions = delta
        mirror = self._mirror(node)
        mirror.evict(evictions)
        admissions = np.asarray(admissions, np.int64)
        if admissions.size:
            pos = np.minimum(
                np.searchsorted(fetched_ids, admissions),
                max(fetched_ids.size - 1, 0),
            )
            covered = (
                fetched_ids[pos] == admissions
                if fetched_ids.size
                else np.zeros(admissions.size, bool)
            )
            rows = np.empty(
                (admissions.size,) + self.store.sample_shape, self.store.dtype
            )
            rows[covered] = fetched_data[pos[covered]]
            if not covered.all():
                rows[~covered] = self.store.read_scattered(admissions[~covered])
            mirror.admit(admissions, rows)
