"""Planners: every loading strategy compiles to the same :class:`Schedule` IR.

SOLAR's core insight is that the entire multi-epoch access order is
pre-determined (paper §4, Fig. 4), so *all* loading decisions — not just
SOLAR's — can be made offline.  This module makes that the API: each
strategy is a :class:`Planner` that compiles the pre-determined shuffle into
a recorded :class:`~repro_torch.core.plan.Schedule`, and one runtime
(:class:`repro_torch.data.loaders.ScheduleExecutor`) replays any plan against any
storage backend.

  * :class:`NaivePlanner`  — PyTorch-DataLoader analog: fresh shuffle each
    epoch, contiguous node split, no buffer, per-sample PFS reads.
  * :class:`LRUPlanner`    — naive + per-node LRU buffer (paper §5.3's
    ablation baseline); LRU evictions become recorded deltas.
  * :class:`NoPFSPlanner`  — clairvoyant-*next-epoch* analog of Dryden et
    al. (2021): next-use eviction over a one-epoch horizon, remote-buffer
    fetches recorded as :class:`~repro_torch.core.plan.PeerFetch` decisions.
  * :class:`DeepIOPlanner` — Zhu et al. (2018) analog: partition-resident
    buffers staged in with one ranged read, node-local shuffle only.
  * :class:`SolarPlanner`  — the full offline scheduler
    (:class:`~repro_torch.core.scheduler.OfflineScheduler`).

Each planner exposes :meth:`Planner.cache_key` — a config hash over
everything the plan depends on — which keys the on-disk :class:`PlanCache`
(the plan-once / train-many amortization the paper argues for, §4.5) and is
stamped into ``Schedule.config_hash`` so executing a plan against the wrong
config fails loudly.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.buffer import BeladyBuffer, LRUBuffer
from repro_torch.core.chunking import plan_chunks
from repro_torch.core.plan import (
    ChunkRead,
    EpochPlan,
    NodeStepPlan,
    PeerFetch,
    PlanArtifactError,
    Schedule,
    StepPlan,
)
from repro_torch.core.scheduler import OfflineScheduler, SolarConfig, build_next_use_index
from repro_torch.core.shuffle import (
    default_node_assignment,
    generate_epoch_permutations,
    split_global_batches,
)

__all__ = [
    "Planner",
    "NaivePlanner",
    "LRUPlanner",
    "NoPFSPlanner",
    "DeepIOPlanner",
    "SolarPlanner",
    "PLANNERS",
    "STRATEGIES",
    "get_planner",
    "PlanCache",
]

_EMPTY = np.empty(0, np.int64)


@runtime_checkable
class Planner(Protocol):
    """What the pipeline layer requires of a strategy planner."""

    strategy: str

    def plan(self, num_samples: int, num_epochs: int) -> Schedule: ...

    def cache_key(self, num_samples: int, num_epochs: int) -> str: ...


def _singleton_chunks(ids) -> tuple[ChunkRead, ...]:
    return tuple(ChunkRead(int(s), int(s) + 1, 1) for s in sorted(ids))


def _delta(start: set, end: set) -> tuple[np.ndarray, np.ndarray]:
    """Start-vs-end resident-set difference: intra-step churn cancels out."""
    return (
        np.asarray(sorted(end - start), np.int64),
        np.asarray(sorted(start - end), np.int64),
    )


@dataclasses.dataclass(frozen=True)
class _BaselinePlanner:
    """Shared geometry + hashing for the four baseline planners."""

    num_nodes: int
    local_batch: int
    buffer_size: int
    seed: int = 0

    strategy = "baseline"

    @property
    def global_batch(self) -> int:
        return self.num_nodes * self.local_batch

    def cache_key(self, num_samples: int, num_epochs: int) -> str:
        blob = json.dumps(
            {"strategy": self.strategy, "D": int(num_samples),
             "E": int(num_epochs)} | dataclasses.asdict(self),
            sort_keys=True,
        ).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def _perms(self, num_samples: int, num_epochs: int) -> np.ndarray:
        return generate_epoch_permutations(num_samples, num_epochs, self.seed)

    def _schedule(self, epochs: list[EpochPlan], num_samples: int) -> Schedule:
        return Schedule(
            num_nodes=self.num_nodes,
            local_batch=self.local_batch,
            capacity=self.local_batch,  # baselines never pad above B_l
            buffer_size=self.buffer_size,
            epoch_order=np.arange(len(epochs), dtype=np.int64),
            epochs=epochs,
            strategy=self.strategy,
            config_hash=self.cache_key(num_samples, len(epochs)),
        )


class NaivePlanner(_BaselinePlanner):
    """Fresh shuffle, contiguous split, no buffer, per-sample reads."""

    strategy = "naive"

    def plan(self, num_samples: int, num_epochs: int) -> Schedule:
        perms = self._perms(num_samples, num_epochs)
        epochs = []
        for e in range(num_epochs):
            batches = split_global_batches(perms[e], self.global_batch)
            steps = []
            for k in range(batches.shape[0]):
                split = default_node_assignment(batches[k], self.num_nodes)
                nodes = [
                    NodeStepPlan(
                        node=n,
                        sample_ids=np.asarray(ids, np.int64),
                        hit_mask=np.zeros(len(ids), bool),
                        chunks=_singleton_chunks(ids),
                        admissions=_EMPTY,
                        evictions=_EMPTY,
                    )
                    for n, ids in enumerate(split)
                ]
                steps.append(StepPlan(step=k, nodes=nodes))
            epochs.append(EpochPlan(epoch_id=e, order_pos=e, steps=steps))
        return self._schedule(epochs, num_samples)


class LRUPlanner(_BaselinePlanner):
    """Naive + per-node LRU buffer; evictions recorded as plan deltas."""

    strategy = "lru"

    def plan(self, num_samples: int, num_epochs: int) -> Schedule:
        perms = self._perms(num_samples, num_epochs)
        bufs = [LRUBuffer(self.buffer_size) for _ in range(self.num_nodes)]
        epochs = []
        for e in range(num_epochs):
            batches = split_global_batches(perms[e], self.global_batch)
            steps = []
            for k in range(batches.shape[0]):
                split = default_node_assignment(batches[k], self.num_nodes)
                nodes = []
                for n, ids in enumerate(split):
                    start = bufs[n].resident
                    mask = np.asarray([int(s) in bufs[n] for s in ids], bool)
                    miss = [int(s) for s in ids[~mask]]
                    for s in ids:
                        bufs[n].admit(int(s))
                    adm, evi = _delta(start, bufs[n].resident)
                    nodes.append(
                        NodeStepPlan(
                            node=n,
                            sample_ids=np.asarray(ids, np.int64),
                            hit_mask=mask,
                            chunks=_singleton_chunks(miss),
                            admissions=adm,
                            evictions=evi,
                        )
                    )
                steps.append(StepPlan(step=k, nodes=nodes))
            epochs.append(EpochPlan(epoch_id=e, order_pos=e, steps=steps))
        return self._schedule(epochs, num_samples)


class NoPFSPlanner(_BaselinePlanner):
    """Clairvoyant-next-epoch buffering + remote fetches (NoPFS analog).

    Eviction uses exact next-use distances but only *within a one-epoch
    horizon* (NoPFS predicts the next epoch's distribution); a miss resident
    in another node's buffer becomes a recorded :class:`PeerFetch` — the
    hierarchical-storage fetch SOLAR avoids by construction — before falling
    back to the PFS.
    """

    strategy = "nopfs"

    def plan(self, num_samples: int, num_epochs: int) -> Schedule:
        perms = self._perms(num_samples, num_epochs)
        bufs = [BeladyBuffer(self.buffer_size) for _ in range(self.num_nodes)]
        gb = self.global_batch
        steps_per = num_samples // gb
        span = steps_per * gb
        horizon = 2 * span  # current + next epoch
        epochs = []
        for e in range(num_epochs):
            cur = perms[e, :span]
            nxt = perms[e + 1, :span] if e + 1 < num_epochs else None
            window = np.concatenate([cur, nxt]) if nxt is not None else cur
            next_use = build_next_use_index(window)
            batches = cur.reshape(steps_per, gb)
            steps = []
            for k in range(steps_per):
                split = default_node_assignment(batches[k], self.num_nodes)
                base = k * gb
                nodes = []
                for n, ids in enumerate(split):
                    start = bufs[n].resident
                    mask = np.zeros(len(ids), bool)
                    miss_pfs: list[int] = []
                    peers: list[PeerFetch] = []
                    for i, s in enumerate(ids.tolist()):
                        pos = base + n * self.local_batch + i
                        nu = int(next_use[pos]) if pos < window.size else horizon
                        if s in bufs[n]:
                            mask[i] = True
                            bufs[n].update_next_use(s, nu)
                            continue
                        src = next(
                            (r for r in range(self.num_nodes)
                             if r != n and s in bufs[r]),
                            None,
                        )
                        if src is not None:
                            peers.append(PeerFetch(s, src))
                        else:
                            miss_pfs.append(s)
                        bufs[n].admit(s, nu)
                    adm, evi = _delta(start, bufs[n].resident)
                    nodes.append(
                        NodeStepPlan(
                            node=n,
                            sample_ids=np.asarray(ids, np.int64),
                            hit_mask=mask,
                            chunks=_singleton_chunks(miss_pfs),
                            admissions=adm,
                            evictions=evi,
                            peer_fetches=tuple(peers),
                        )
                    )
                steps.append(StepPlan(step=k, nodes=nodes))
            epochs.append(EpochPlan(epoch_id=e, order_pos=e, steps=steps))
        return self._schedule(epochs, num_samples)


class DeepIOPlanner(_BaselinePlanner):
    """Partition-resident buffers + node-local shuffle (DeepIO analog).

    Maximum reuse, but the randomization is node-local only — the design
    SOLAR rejects because it degrades surrogate accuracy (paper §4.2.2).
    The stage-in step prefetches each node's whole partition in one ranged
    read, so its plans validate with ``exact=False`` (reads exceed misses by
    design).
    """

    strategy = "deepio"

    def plan(self, num_samples: int, num_epochs: int) -> Schedule:
        d = num_samples
        per = min(self.buffer_size, (d + self.num_nodes - 1) // self.num_nodes)
        partition = [
            np.arange(n * per, min((n + 1) * per, d)) for n in range(self.num_nodes)
        ]
        leftover = np.arange(min(per * self.num_nodes, d), d)
        rng = np.random.Generator(np.random.PCG64(self.seed + 7))
        steps_per = d // self.global_batch
        primed = [False] * self.num_nodes
        epochs = []
        for e in range(num_epochs):
            local_orders = [rng.permutation(p) for p in partition]
            lo = rng.permutation(leftover)
            lo_steps = (
                np.array_split(lo, steps_per)
                if lo.size
                else [np.empty(0, np.int64)] * steps_per
            )
            steps = []
            for k in range(steps_per):
                lo_split = np.array_split(lo_steps[k], self.num_nodes)
                nodes = []
                for n in range(self.num_nodes):
                    want = self.local_batch - lo_split[n].size
                    res = (
                        np.take(
                            local_orders[n],
                            np.arange(k * want, (k + 1) * want),
                            mode="wrap",
                        )
                        if local_orders[n].size
                        else np.empty(0, np.int64)
                    )
                    ids = np.concatenate([res, lo_split[n]])
                    mask = np.zeros(ids.size, bool)
                    adm = _EMPTY
                    if primed[n]:
                        # Residents are hits; only the leftover tail hits PFS.
                        mask[: res.size] = True
                        chunks = plan_chunks(lo_split[n], max_chunk=16)
                    else:
                        # Stage-in: one ranged read of the whole partition
                        # (DeepIO's whole point) + this step's leftovers.
                        part = partition[n]
                        chunks = ()
                        if part.size:
                            chunks = (
                                ChunkRead(int(part[0]), int(part[-1]) + 1,
                                          int(part.size)),
                            )
                            adm = np.asarray(part, np.int64)
                        chunks = chunks + plan_chunks(lo_split[n], max_chunk=16)
                        primed[n] = True
                    nodes.append(
                        NodeStepPlan(
                            node=n,
                            sample_ids=ids,
                            hit_mask=mask,
                            chunks=chunks,
                            admissions=adm,
                            evictions=_EMPTY,
                        )
                    )
                steps.append(StepPlan(step=k, nodes=nodes))
            epochs.append(EpochPlan(epoch_id=e, order_pos=e, steps=steps))
        return self._schedule(epochs, num_samples)


@dataclasses.dataclass(frozen=True)
class SolarPlanner:
    """The full offline scheduler behind the common planner surface.

    ``seed`` drives the pre-determined shuffle (it may differ from
    ``config.seed``, which seeds the epoch-order optimizer); ``config``
    carries every scheduler knob, including the peer tier's cost model —
    all of it feeds :meth:`cache_key`, so any knob change invalidates the
    cached plan.
    """

    config: SolarConfig
    seed: int = 0

    strategy = "solar"

    @property
    def num_nodes(self) -> int:
        return self.config.num_nodes

    def cache_key(self, num_samples: int, num_epochs: int) -> str:
        # The scheduler's own config hash (OfflineScheduler.cache_key — the
        # memoization key its docstring promises) plus the perm-stream seed,
        # which lives on the planner, not the SolarConfig.
        blob = json.dumps(
            {
                "strategy": self.strategy,
                "perm_seed": int(self.seed),
                "config_key": OfflineScheduler(self.config).cache_key(
                    num_samples, num_epochs
                ),
            },
            sort_keys=True,
        ).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def plan(self, num_samples: int, num_epochs: int) -> Schedule:
        perms = generate_epoch_permutations(num_samples, num_epochs, self.seed)
        schedule = OfflineScheduler(self.config).build(
            num_samples, num_epochs, perms=perms
        )
        schedule.config_hash = self.cache_key(num_samples, num_epochs)
        return schedule


STRATEGIES = ("naive", "lru", "nopfs", "deepio", "solar")

#: strategy name -> planner class (the registry LoaderSpec resolves through).
PLANNERS: dict[str, type] = {
    "naive": NaivePlanner,
    "lru": LRUPlanner,
    "nopfs": NoPFSPlanner,
    "deepio": DeepIOPlanner,
    "solar": SolarPlanner,
}


def get_planner(strategy: str) -> type:
    try:
        return PLANNERS[strategy]
    except KeyError:
        raise ValueError(
            f"unknown strategy {strategy!r}; have {sorted(PLANNERS)}"
        ) from None


class PlanCache:
    """On-disk schedule memoization keyed by the planner's config hash.

    One artifact per key under ``directory``
    (``plan_v<schema>_<key>.npz`` — schema-versioned so differently-schema'd
    builds can share a cache directory without thrashing it).  Cache
    invalidation is entirely hash-driven: any change to the planner config,
    dataset size, or epoch count produces a new key, so stale entries are
    never *wrong*, only unused.  Entries that fail integrity checks on read
    (corrupt container, digest mismatch) are dropped and rebuilt.
    """

    def __init__(self, directory: str):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)

    def path_for(self, key: str) -> str:
        # the schema version is part of the name so builds reading different
        # schemas can share one cache dir without thrashing each other's
        # (individually valid) entries.
        from repro_torch.core.plan import PLAN_SCHEMA_VERSION

        return os.path.join(
            self.directory, f"plan_v{PLAN_SCHEMA_VERSION}_{key}.npz"
        )

    def get(self, key: str) -> Schedule | None:
        path = self.path_for(key)
        try:
            before = os.stat(path)
        except OSError:
            return None
        try:
            return Schedule.load(path, expect_hash=key)
        except PlanArtifactError:
            # A corrupt/mismatched entry is a miss, never an error.  Only
            # drop the file if it is still the bytes we failed on: writers
            # stage to a unique temp and atomically replace, so a concurrent
            # builder may have installed a *valid* artifact between our open
            # and this cleanup — removing that would evict a good entry.
            try:
                after = os.stat(path)
                if (after.st_ino, after.st_mtime_ns, after.st_size) == (
                    before.st_ino, before.st_mtime_ns, before.st_size,
                ):
                    os.remove(path)
            except OSError:
                pass
            return None

    def put(self, key: str, schedule: Schedule) -> str:
        return schedule.save(self.path_for(key))

    def load_or_build(
        self, planner: Planner, num_samples: int, num_epochs: int
    ) -> tuple[Schedule, bool]:
        """Return ``(schedule, cache_hit)`` — building and caching on a miss."""
        key = planner.cache_key(num_samples, num_epochs)
        cached = self.get(key)
        if cached is not None:
            return cached, True
        schedule = planner.plan(num_samples, num_epochs)
        self.put(key, schedule)
        return schedule, False
