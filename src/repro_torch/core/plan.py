"""Schedule IR: the single plan format every loading strategy compiles to.

A planner (``repro_torch.core.planners``) turns the pre-determined multi-epoch
shuffle into an executable :class:`Schedule`:

  Schedule
    └── EpochPlan           (one per epoch, in *optimized* epoch order)
          └── StepPlan      (one per global batch)
                └── NodeStepPlan   (one per data-parallel node)

Every :class:`NodeStepPlan` records which samples the node trains this step,
which of them are buffer hits, the coalesced chunk reads covering the
misses, the planned peer fetches, and the buffer admission/eviction deltas.
SOLAR's Belady decisions, the baselines' per-sample reads, LRU/next-use
evictions, and NoPFS-style remote fetches are all expressible as these
recorded decisions, so one runtime executor replays any strategy.

The IR is pure data (numpy + tuples), and a :class:`Schedule` is a real
artifact: :meth:`Schedule.save` / :meth:`Schedule.load` persist it as a
single ``.npz`` container (flat arrays + a JSON meta record carrying the
schema version, the planner's config hash, and a content digest — see
DESIGN.md §7), :meth:`Schedule.for_node` slices out one rank's share for a
future multi-process runtime, and ``config_hash`` keys the on-disk
:class:`~repro_torch.core.planners.PlanCache`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Iterator

import numpy as np

__all__ = [
    "ChunkRead",
    "PeerFetch",
    "NodeStepPlan",
    "StepPlan",
    "EpochPlan",
    "Schedule",
    "ScheduleStats",
    "PlanArtifactError",
    "PLAN_SCHEMA_VERSION",
    "concat_schedules",
]

#: bump on any change to the packed array layout or meta record.
PLAN_SCHEMA_VERSION = 1


class PlanArtifactError(ValueError):
    """A plan artifact could not be trusted: corrupt container, digest or
    config-hash mismatch, or an unknown schema version."""


@dataclasses.dataclass(frozen=True)
class ChunkRead:
    """One contiguous PFS read: samples ``[start, stop)`` (store order).

    ``wanted`` is the number of samples in the range that are actual misses;
    ``stop - start - wanted`` samples are redundant bytes fetched because the
    ranged read was still cheaper than splitting (paper §4.4, observation 3).
    """

    start: int
    stop: int
    wanted: int

    @property
    def span(self) -> int:
        return self.stop - self.start

    @property
    def waste(self) -> int:
        return self.span - self.wanted


@dataclasses.dataclass(frozen=True)
class PeerFetch:
    """One planned inter-node buffer fetch (DESIGN.md §6).

    ``sample`` is trained on the plan's node this step but resides in
    ``source``'s simulated buffer at the *start* of the step (the source may
    evict it in the same step — the runtime fetches every peer sample before
    applying any node's admission/eviction deltas, so the plan stays valid).
    ``source`` may equal the training node itself: a capacity-spilled hit
    that the load balancer sent back to its own holder is served from the
    local buffer at zero transfer cost.
    """

    sample: int
    source: int


@dataclasses.dataclass
class NodeStepPlan:
    """What node ``node`` does at one training step."""

    node: int
    #: sample ids trained on this node this step (real samples only).
    sample_ids: np.ndarray
    #: parallel bool mask: True where the sample is served from the buffer.
    hit_mask: np.ndarray
    #: coalesced PFS reads covering exactly the misses.
    chunks: tuple[ChunkRead, ...]
    #: sample ids actually admitted into this node's buffer this step
    #: (Belady may bypass admission; bypassed ids are absent here).
    admissions: np.ndarray
    #: sample ids evicted from this node's buffer after this step.
    evictions: np.ndarray
    #: misses served from a sibling node's buffer instead of the PFS
    #: (the planned peer-fetch tier, DESIGN.md §6).
    peer_fetches: tuple[PeerFetch, ...] = ()

    @property
    def num_real(self) -> int:
        return int(self.sample_ids.size)

    @property
    def num_hits(self) -> int:
        return int(self.hit_mask.sum())

    @property
    def num_misses(self) -> int:
        return self.num_real - self.num_hits

    @property
    def num_peer(self) -> int:
        return len(self.peer_fetches)

    @property
    def num_pfs_misses(self) -> int:
        """Misses that actually hit the PFS (peer-served ones excluded)."""
        return self.num_misses - self.num_peer

    @property
    def pfs_samples(self) -> int:
        """Samples actually fetched from the PFS including chunk waste."""
        return sum(c.span for c in self.chunks)

    def validate(self, exact: bool = True) -> None:
        """Check the plan's internal invariants.

        With ``exact`` (every strategy but DeepIO) the chunk reads must cover
        the PFS misses sample-for-sample.  DeepIO's stage-in step prefetches
        its whole partition in one ranged read — reads legitimately exceed
        misses — so its planner validates with ``exact=False``, keeping only
        the set-coverage invariants.
        """
        assert self.sample_ids.shape == self.hit_mask.shape
        if exact:
            covered = sum(c.wanted for c in self.chunks)
            assert covered == self.num_pfs_misses, (covered, self.num_pfs_misses)
        miss_ids = set(self.sample_ids[~self.hit_mask].tolist())
        peer_ids = {f.sample for f in self.peer_fetches}
        assert len(peer_ids) == len(self.peer_fetches), "duplicate peer fetch"
        assert peer_ids <= miss_ids, "peer fetches must be misses"
        in_chunks = set()
        for c in self.chunks:
            in_chunks.update(range(c.start, c.stop))
        assert not (peer_ids & in_chunks), "peer fetch duplicated by a chunk"
        assert miss_ids - peer_ids <= in_chunks, (
            "chunk reads must cover every non-peer miss"
        )


@dataclasses.dataclass
class StepPlan:
    step: int
    nodes: list[NodeStepPlan]

    def global_batch(self) -> np.ndarray:
        """The multiset of samples trained this step across all nodes."""
        if not self.nodes:
            # A for_node() slice of a rank with no work this step: an empty
            # batch, not an error — the runtime still barriers through it.
            return np.empty(0, np.int64)
        return np.concatenate([n.sample_ids for n in self.nodes])

    @property
    def max_pfs_samples(self) -> int:
        """Per-step critical path: the most-loaded node (nodes load in parallel)."""
        return max((n.pfs_samples for n in self.nodes), default=0)


@dataclasses.dataclass
class EpochPlan:
    #: index into the *original* shuffle (i.e. which epoch's permutation this is).
    epoch_id: int
    #: position in the optimized training order.
    order_pos: int
    steps: list[StepPlan]


@dataclasses.dataclass
class ScheduleStats:
    """Aggregate statistics used by the benchmarks (Figs. 10-13, 16)."""

    num_nodes: int
    num_epochs: int
    steps_per_epoch: int
    total_samples_trained: int
    total_hits: int
    total_misses: int
    total_pfs_samples: int          # misses + chunk waste
    total_chunk_reads: int
    total_singleton_reads: int
    #: per-(epoch, step) max over nodes of *PFS* miss count — the loading
    #: critical path (peer-served misses ride the interconnect, not the PFS).
    per_step_max_miss: np.ndarray
    #: per-(epoch, step, node) real batch size (Fig. 16 distribution).
    batch_sizes: np.ndarray
    #: per-(epoch, step, node) miss counts (Fig. 12).
    miss_counts: np.ndarray
    #: misses served by the planned peer-fetch tier instead of the PFS.
    total_peer_fetches: int = 0

    @property
    def hit_rate(self) -> float:
        t = self.total_hits + self.total_misses
        return self.total_hits / t if t else 0.0

    @property
    def chunked_fraction(self) -> float:
        """Fraction of *PFS* miss samples riding in a multi-sample chunk
        (Fig. 13; peer-served misses never touch the PFS so they are out of
        both numerator and denominator)."""
        pfs_misses = self.total_misses - self.total_peer_fetches
        if pfs_misses == 0:
            return 0.0
        chunked = pfs_misses - self.total_singleton_reads
        return chunked / pfs_misses

    def summary(self) -> dict:
        return {
            "hit_rate": round(self.hit_rate, 4),
            "total_misses": int(self.total_misses),
            "total_peer_fetches": int(self.total_peer_fetches),
            "total_pfs_samples": int(self.total_pfs_samples),
            "chunked_fraction": round(self.chunked_fraction, 4),
            "mean_step_max_miss": float(self.per_step_max_miss.mean())
            if self.per_step_max_miss.size
            else 0.0,
            "batch_size_std": float(self.batch_sizes.std())
            if self.batch_sizes.size
            else 0.0,
        }


@dataclasses.dataclass
class Schedule:
    """A fully materialized training schedule for any loading strategy."""

    num_nodes: int
    local_batch: int
    capacity: int                   # per-node padded batch capacity (B_cap)
    buffer_size: int                # per-node buffer size, in samples
    epoch_order: np.ndarray         # optimized order of epoch ids
    epochs: list[EpochPlan]
    #: which planner produced this (``naive``|``lru``|``nopfs``|``deepio``|
    #: ``solar``); the executor reports under this name.
    strategy: str = "solar"
    #: the producing planner's :meth:`~repro_torch.core.planners.Planner.cache_key`
    #: — empty for hand-built or legacy schedules (then provenance checks are
    #: skipped on execution).
    config_hash: str = ""

    def __iter__(self) -> Iterator[StepPlan]:
        for ep in self.epochs:
            yield from ep.steps

    @property
    def num_steps(self) -> int:
        return sum(len(ep.steps) for ep in self.epochs)

    def validate(self) -> None:
        """Validate every node-step plan (see :meth:`NodeStepPlan.validate`)."""
        exact = self.strategy != "deepio"
        for ep in self.epochs:
            for sp in ep.steps:
                for npn in sp.nodes:
                    npn.validate(exact=exact)

    def for_node(self, rank: int) -> "Schedule":
        """Slice out one rank's share of the plan.

        The returned schedule keeps the global geometry (``num_nodes`` etc.)
        but every :class:`StepPlan` holds only ``rank``'s
        :class:`NodeStepPlan` — the unit a multi-process runtime ships to
        each worker (DESIGN.md §6/§7): peer-fetch sources still name global
        node ids, and the union of all ranks' slices is the full plan.
        """
        if not 0 <= rank < self.num_nodes:
            raise ValueError(f"rank {rank} out of range [0, {self.num_nodes})")
        epochs = [
            EpochPlan(
                epoch_id=ep.epoch_id,
                order_pos=ep.order_pos,
                steps=[
                    StepPlan(sp.step, [n for n in sp.nodes if n.node == rank])
                    for sp in ep.steps
                ],
            )
            for ep in self.epochs
        ]
        return dataclasses.replace(self, epochs=epochs)

    # -- persistence (the plan artifact, DESIGN.md §7) -------------------------

    def save(self, path: str) -> str:
        """Write the plan as a single ``.npz`` artifact (atomic replace).

        Layout: every per-node-plan field is flattened into one array over
        all node plans in (epoch, step, node) order plus a CSR offsets array,
        and a ``__meta__`` JSON record carries the schema version, strategy,
        ``config_hash``, geometry, and a SHA-256 content digest over the
        packed arrays.  :meth:`load` refuses anything whose digest, schema,
        or (when expected) config hash does not match.
        """
        arrays = _pack_arrays(self)
        meta = {
            "schema": PLAN_SCHEMA_VERSION,
            "strategy": self.strategy,
            "config_hash": self.config_hash,
            "num_nodes": int(self.num_nodes),
            "local_batch": int(self.local_batch),
            "capacity": int(self.capacity),
            "buffer_size": int(self.buffer_size),
            "digest": _content_digest(arrays),
        }
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        # Unique temp name: concurrent writers to one shared cache path must
        # each stage their own file, or the replace is not actually atomic.
        fd, tmp = tempfile.mkstemp(
            prefix=os.path.basename(path) + ".", suffix=".tmp", dir=parent
        )
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(
                    f,
                    __meta__=np.frombuffer(
                        json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8
                    ),
                    **arrays,
                )
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        return path

    @classmethod
    def load(cls, path: str, expect_hash: str | None = None) -> "Schedule":
        """Load a saved plan, verifying integrity and (optionally) provenance.

        Raises :class:`PlanArtifactError` when the container is corrupt, the
        content digest or schema version does not match, or ``expect_hash``
        is given and differs from the artifact's ``config_hash``.
        """
        try:
            with np.load(path, allow_pickle=False) as z:
                meta = json.loads(bytes(z["__meta__"]).decode())
                arrays = {k: z[k] for k in z.files if k != "__meta__"}
        except PlanArtifactError:
            raise
        except Exception as e:
            raise PlanArtifactError(f"unreadable plan artifact {path!r}: {e}") from e
        if meta.get("schema") != PLAN_SCHEMA_VERSION:
            raise PlanArtifactError(
                f"plan artifact {path!r} has schema {meta.get('schema')!r}; "
                f"this build reads schema {PLAN_SCHEMA_VERSION}"
            )
        digest = _content_digest(arrays)
        if digest != meta.get("digest"):
            raise PlanArtifactError(
                f"plan artifact {path!r} is corrupt: content digest "
                f"{digest} != recorded {meta.get('digest')}"
            )
        if expect_hash is not None and meta.get("config_hash") != expect_hash:
            raise PlanArtifactError(
                f"plan artifact {path!r} was built for config hash "
                f"{meta.get('config_hash')!r}, expected {expect_hash!r}"
            )
        return _unpack_arrays(meta, arrays)

    def artifact_digest(self) -> str:
        """Content digest of the packed representation (process-stable)."""
        return _content_digest(_pack_arrays(self))

    def stats(self) -> ScheduleStats:
        hits = misses = pfs = chunk_reads = singleton = trained = peer = 0
        max_miss: list[int] = []
        bsz_rows: list[list[int]] = []
        msc_rows: list[list[int]] = []
        for ep in self.epochs:
            for sp in ep.steps:
                step_miss = []
                row_b, row_m = [], []
                for n in sp.nodes:
                    trained += n.num_real
                    hits += n.num_hits
                    misses += n.num_misses
                    peer += n.num_peer
                    pfs += n.pfs_samples
                    for c in n.chunks:
                        if c.wanted > 1:
                            chunk_reads += 1
                        else:
                            singleton += 1
                    step_miss.append(n.num_pfs_misses)
                    row_b.append(n.num_real)
                    row_m.append(n.num_misses)
                max_miss.append(max(step_miss) if step_miss else 0)
                bsz_rows.append(row_b)
                msc_rows.append(row_m)
        nsteps = self.num_steps
        # A for_node() slice carries fewer plans per step than num_nodes —
        # possibly zero for a rank with no work — so per-step rows can be
        # ragged.  Pad short rows with zeros instead of reshaping blindly.
        width = max((len(r) for r in bsz_rows), default=0)
        batch_sizes = np.zeros((nsteps, width), np.int64)
        miss_counts = np.zeros((nsteps, width), np.int64)
        for i, (rb, rm) in enumerate(zip(bsz_rows, msc_rows)):
            batch_sizes[i, : len(rb)] = rb
            miss_counts[i, : len(rm)] = rm
        return ScheduleStats(
            num_nodes=self.num_nodes,
            num_epochs=len(self.epochs),
            steps_per_epoch=nsteps // max(len(self.epochs), 1),
            total_samples_trained=trained,
            total_hits=hits,
            total_misses=misses,
            total_pfs_samples=pfs,
            total_chunk_reads=chunk_reads,
            total_singleton_reads=singleton,
            per_step_max_miss=np.asarray(max_miss, dtype=np.int64),
            batch_sizes=batch_sizes,
            miss_counts=miss_counts,
            total_peer_fetches=peer,
        )


def concat_schedules(segments: list["Schedule"]) -> "Schedule":
    """Concatenate plan segments (streaming windows) into one schedule.

    Every segment must share geometry (``num_nodes``, ``local_batch``,
    ``capacity``, ``buffer_size``) and ``strategy``; epochs and
    ``epoch_order`` are concatenated in segment order.  The result's
    ``config_hash`` is the segments' common hash when they agree, else empty
    (provenance checks are then skipped on execution).

    This is the identity behind the streaming determinism contract
    (DESIGN.md §10): ``concat(window_0 .. window_K)`` must be
    digest-identical to a one-shot offline plan over the same admitted
    manifests, because each window is a pure function of (seed, window
    index, manifest, carried buffer state).
    """
    if not segments:
        raise ValueError("concat_schedules needs at least one segment")
    head = segments[0]
    for seg in segments[1:]:
        for field in ("num_nodes", "local_batch", "capacity", "buffer_size",
                      "strategy"):
            if getattr(seg, field) != getattr(head, field):
                raise ValueError(
                    f"segment {field} mismatch: "
                    f"{getattr(seg, field)!r} != {getattr(head, field)!r}"
                )
    hashes = {seg.config_hash for seg in segments}
    return Schedule(
        num_nodes=head.num_nodes,
        local_batch=head.local_batch,
        capacity=head.capacity,
        buffer_size=head.buffer_size,
        epoch_order=np.concatenate(
            [np.asarray(seg.epoch_order, np.int64) for seg in segments]
        ),
        epochs=[ep for seg in segments for ep in seg.epochs],
        strategy=head.strategy,
        config_hash=head.config_hash if len(hashes) == 1 else "",
    )


# ---------------------------------------------------------------------------
# Artifact packing (flat arrays <-> nested IR)
# ---------------------------------------------------------------------------


def _concat(parts: list[np.ndarray], dtype) -> np.ndarray:
    if not parts:
        return np.empty(0, dtype)
    return np.concatenate([np.asarray(p, dtype) for p in parts])


def _offsets(counts: list[int]) -> np.ndarray:
    out = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(np.asarray(counts, np.int64), out=out[1:])
    return out


def _pack_arrays(schedule: Schedule) -> dict[str, np.ndarray]:
    """Flatten the nested IR into named flat arrays + CSR offsets.

    Node plans are laid out in (epoch, step, node) traversal order; every
    variable-length field gets a data array plus an offsets array of length
    ``num_plans + 1``.
    """
    epoch_ids, order_pos, epoch_steps = [], [], []
    step_numbers, step_nodes = [], []
    node_tbl = []
    samples, hits = [], []
    c_start, c_stop, c_want = [], [], []
    adm, evi, p_sample, p_source = [], [], [], []
    n_samples, n_chunks, n_adm, n_evi, n_peer = [], [], [], [], []
    for ep in schedule.epochs:
        epoch_ids.append(ep.epoch_id)
        order_pos.append(ep.order_pos)
        epoch_steps.append(len(ep.steps))
        for sp in ep.steps:
            step_numbers.append(sp.step)
            step_nodes.append(len(sp.nodes))
            for npn in sp.nodes:
                node_tbl.append(npn.node)
                samples.append(npn.sample_ids)
                hits.append(npn.hit_mask)
                n_samples.append(npn.sample_ids.size)
                c_start.extend(c.start for c in npn.chunks)
                c_stop.extend(c.stop for c in npn.chunks)
                c_want.extend(c.wanted for c in npn.chunks)
                n_chunks.append(len(npn.chunks))
                adm.append(npn.admissions)
                evi.append(npn.evictions)
                n_adm.append(npn.admissions.size)
                n_evi.append(npn.evictions.size)
                p_sample.extend(f.sample for f in npn.peer_fetches)
                p_source.extend(f.source for f in npn.peer_fetches)
                n_peer.append(len(npn.peer_fetches))
    return {
        "epoch_order": np.asarray(schedule.epoch_order, np.int64),
        "epoch_ids": np.asarray(epoch_ids, np.int64),
        "order_pos": np.asarray(order_pos, np.int64),
        "epoch_steps": np.asarray(epoch_steps, np.int64),
        "step_numbers": np.asarray(step_numbers, np.int64),
        "step_nodes": np.asarray(step_nodes, np.int64),
        "node_tbl": np.asarray(node_tbl, np.int64),
        "samples": _concat(samples, np.int64),
        "samples_off": _offsets(n_samples),
        "hit_mask": _concat(hits, bool),
        "chunk_start": np.asarray(c_start, np.int64),
        "chunk_stop": np.asarray(c_stop, np.int64),
        "chunk_wanted": np.asarray(c_want, np.int64),
        "chunks_off": _offsets(n_chunks),
        "admissions": _concat(adm, np.int64),
        "admissions_off": _offsets(n_adm),
        "evictions": _concat(evi, np.int64),
        "evictions_off": _offsets(n_evi),
        "peer_sample": np.asarray(p_sample, np.int64),
        "peer_source": np.asarray(p_source, np.int64),
        "peer_off": _offsets(n_peer),
    }


def _unpack_arrays(meta: dict, a: dict[str, np.ndarray]) -> Schedule:
    try:
        epochs: list[EpochPlan] = []
        plan_i = 0
        step_i = 0
        # Pre-convert the per-element-indexed arrays to python lists: scalar
        # numpy indexing in the reconstruction loop dominates load time
        # otherwise (cached loads must stay far cheaper than replanning).
        s_off = a["samples_off"].tolist()
        c_off = a["chunks_off"].tolist()
        a_off = a["admissions_off"].tolist()
        e_off = a["evictions_off"].tolist()
        p_off = a["peer_off"].tolist()
        node_tbl = a["node_tbl"].tolist()
        step_numbers = a["step_numbers"].tolist()
        step_nodes = a["step_nodes"].tolist()
        chunk = list(
            zip(a["chunk_start"].tolist(), a["chunk_stop"].tolist(),
                a["chunk_wanted"].tolist())
        )
        peer = list(zip(a["peer_sample"].tolist(), a["peer_source"].tolist()))
        for e in range(a["epoch_ids"].size):
            steps: list[StepPlan] = []
            for _ in range(int(a["epoch_steps"][e])):
                nodes: list[NodeStepPlan] = []
                for _ in range(step_nodes[step_i]):
                    i = plan_i
                    nodes.append(
                        NodeStepPlan(
                            node=node_tbl[i],
                            sample_ids=a["samples"][s_off[i] : s_off[i + 1]],
                            hit_mask=a["hit_mask"][s_off[i] : s_off[i + 1]],
                            chunks=tuple(
                                ChunkRead(*c)
                                for c in chunk[c_off[i] : c_off[i + 1]]
                            ),
                            admissions=a["admissions"][a_off[i] : a_off[i + 1]],
                            evictions=a["evictions"][e_off[i] : e_off[i + 1]],
                            peer_fetches=tuple(
                                PeerFetch(*p)
                                for p in peer[p_off[i] : p_off[i + 1]]
                            ),
                        )
                    )
                    plan_i += 1
                steps.append(StepPlan(step=step_numbers[step_i], nodes=nodes))
                step_i += 1
            epochs.append(
                EpochPlan(
                    epoch_id=int(a["epoch_ids"][e]),
                    order_pos=int(a["order_pos"][e]),
                    steps=steps,
                )
            )
        return Schedule(
            num_nodes=int(meta["num_nodes"]),
            local_batch=int(meta["local_batch"]),
            capacity=int(meta["capacity"]),
            buffer_size=int(meta["buffer_size"]),
            epoch_order=a["epoch_order"],
            epochs=epochs,
            strategy=str(meta["strategy"]),
            config_hash=str(meta["config_hash"]),
        )
    except PlanArtifactError:
        raise
    except Exception as e:  # truncated/inconsistent arrays
        raise PlanArtifactError(f"malformed plan artifact: {e}") from e


def _content_digest(arrays: dict[str, np.ndarray]) -> str:
    """SHA-256 over the packed arrays, independent of container byte order."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        arr = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()
