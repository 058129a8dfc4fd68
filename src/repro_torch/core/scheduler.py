"""The SOLAR offline scheduler (paper Fig. 4 + Fig. 5, §4).

Turns the pre-determined multi-epoch shuffle into a fully materialized
:class:`~repro_torch.core.plan.Schedule`:

  1. **Epoch-order optimization** (§4.2.1): reorder epochs along the
     min-cost Hamiltonian path of the reuse graph.
  2. **Locality remap** (§4.2.2): within each global batch, assign buffered
     samples to the node that buffers them.
  3. **Load balancing** (§4.3): spread the remaining misses so that every
     node performs the same number of PFS reads.
  4. **Aggregated chunking** (§4.4): coalesce each node's miss list into
     ranged reads.
  4b. **Peer-fetch planning** (our extension, DESIGN.md §6): misses resident
     in a sibling node's simulated buffer (capacity-spilled hits) are served
     over the interconnect instead of the PFS whenever the cost model says a
     chunk's ranged read is not amortized by co-resident true misses.
  5. **Belady buffer simulation**: the full future access string is known,
     so eviction decisions are clairvoyant-optimal and are *recorded in the
     plan* — the runtime replays them instead of re-deciding.

Every optimization is individually toggleable, which is how the Fig.-10
ablation benchmark is produced.

Complexity: O(E·D) for the shuffle and next-use index, O(E²·|Buffer|) for the
reuse matrix (vectorized), O(T log) for the simulation with T = total trained
samples.  The paper notes this one-time cost is amortized over runs and can
overlap the first epoch; schedules are additionally memoized on disk keyed
by a config hash (:meth:`OfflineScheduler.cache_key`) through
:class:`repro_torch.core.planners.PlanCache` — set ``plan_cache`` on a
:class:`~repro_torch.data.pipeline.LoaderSpec` to turn it on.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math

import numpy as np

from repro_torch.core import balance as balance_mod
from repro_torch.core import chunking, epoch_order, locality, shuffle
from repro_torch.core.buffer import BeladyBuffer
from repro_torch.core.costmodel import PeerCostModel
from repro_torch.core.plan import (
    ChunkRead,
    EpochPlan,
    NodeStepPlan,
    PeerFetch,
    Schedule,
    StepPlan,
)

__all__ = ["SolarConfig", "OfflineScheduler", "build_next_use_index"]

_INF = np.iinfo(np.int64).max


@dataclasses.dataclass(frozen=True)
class SolarConfig:
    num_nodes: int
    local_batch: int
    #: per-node buffer capacity, in samples.
    buffer_size: int
    #: per-node padded batch capacity factor: B_cap = ceil(Bl * factor).
    capacity_factor: float = 1.5
    epoch_order_method: str = "greedy2opt"   # 'pso' | 'greedy2opt' | 'exact' | 'none'
    max_chunk: int = 15
    max_waste: int | None = None
    #: ablation toggles (paper Fig. 10): O1 = EOO + locality, O2 = balance,
    #: O3 = chunking.
    enable_eoo: bool = True
    enable_locality: bool = True
    enable_balance: bool = True
    enable_chunking: bool = True
    #: admit chunk-waste samples to the buffer when Belady says they help.
    admit_waste: bool = True
    #: plan the peer-fetch tier (DESIGN.md §6): misses resident in a sibling
    #: node's simulated buffer become interconnect fetches instead of PFS
    #: reads when the cost model prefers it.
    enable_peer: bool = False
    #: peer-vs-PFS pricing for the chunk-level decision; defaults when None.
    peer_cost: PeerCostModel | None = None
    seed: int = 0

    @property
    def global_batch(self) -> int:
        return self.num_nodes * self.local_batch

    @property
    def capacity(self) -> int:
        return max(self.local_batch, math.ceil(self.local_batch * self.capacity_factor))

    def cache_key(self, num_samples: int, num_epochs: int) -> str:
        blob = json.dumps(
            dataclasses.asdict(self) | {"D": num_samples, "E": num_epochs},
            sort_keys=True,
        ).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def build_next_use_index(access: np.ndarray) -> np.ndarray:
    """next_use[t] = the next position > t at which access[t] occurs (else INF).

    Vectorized: stable-sort positions by sample id; within each sample's group
    the successor position is the next occurrence.
    """
    t = access.size
    order = np.argsort(access, kind="stable")
    nxt = np.full(t, _INF, dtype=np.int64)
    if t == 0:
        return nxt
    grouped_samples = access[order]
    succ = np.empty(t, dtype=np.int64)
    succ[:-1] = order[1:]
    succ[-1] = _INF
    # Group boundary: last occurrence of each sample has no successor.
    boundary = np.empty(t, dtype=bool)
    boundary[:-1] = grouped_samples[:-1] != grouped_samples[1:]
    boundary[-1] = True
    succ[boundary] = _INF
    nxt[order] = succ
    return nxt


class _OccurrenceIndex:
    """CSR index: all positions of each sample, for waste-sample next-use lookups."""

    def __init__(self, access: np.ndarray, num_samples: int):
        order = np.argsort(access, kind="stable")
        counts = np.bincount(access, minlength=num_samples)
        self._offsets = np.zeros(num_samples + 1, dtype=np.int64)
        np.cumsum(counts, out=self._offsets[1:])
        self._positions = order

    def next_after(self, sample: int, pos: int) -> int:
        lo, hi = self._offsets[sample], self._offsets[sample + 1]
        grp = self._positions[lo:hi]
        i = np.searchsorted(grp, pos, side="left")
        return int(grp[i]) if i < grp.size else _INF


class OfflineScheduler:
    """Builds a SOLAR :class:`Schedule` from a dataset size + epoch count."""

    def __init__(self, config: SolarConfig):
        self.config = config

    def cache_key(self, num_samples: int, num_epochs: int) -> str:
        """Config hash keying the on-disk plan memoization (PlanCache)."""
        return self.config.cache_key(num_samples, num_epochs)

    # -- schedule construction ------------------------------------------------

    def build(
        self, num_samples: int, num_epochs: int, perms: np.ndarray | None = None
    ) -> Schedule:
        cfg = self.config
        if perms is None:
            perms = shuffle.generate_epoch_permutations(
                num_samples, num_epochs, cfg.seed
            )
        num_epochs, num_samples = perms.shape

        total_buffer = cfg.buffer_size * cfg.num_nodes
        order, cost, id_cost = epoch_order.optimize_epoch_order(
            perms,
            total_buffer,
            method=cfg.epoch_order_method if cfg.enable_eoo else "none",
            seed=cfg.seed,
        )
        self.last_eoo_cost, self.last_identity_cost = cost, id_cost

        steps_per_epoch = num_samples // cfg.global_batch
        if steps_per_epoch == 0:
            raise ValueError("dataset smaller than one global batch")
        span = steps_per_epoch * cfg.global_batch

        # Concatenated access string in optimized order, tails dropped.
        access = perms[order, :span].reshape(-1)
        next_use = build_next_use_index(access)
        occ = _OccurrenceIndex(access, num_samples)

        buffers = [BeladyBuffer(cfg.buffer_size) for _ in range(cfg.num_nodes)]
        epochs: list[EpochPlan] = []
        for order_pos, eid in enumerate(order.tolist()):
            batches = perms[eid, :span].reshape(steps_per_epoch, cfg.global_batch)
            steps: list[StepPlan] = []
            for k in range(steps_per_epoch):
                base = (order_pos * steps_per_epoch + k) * cfg.global_batch
                steps.append(
                    self._plan_step(
                        k, batches[k], base, buffers, next_use, occ
                    )
                )
            epochs.append(EpochPlan(epoch_id=eid, order_pos=order_pos, steps=steps))

        return Schedule(
            num_nodes=cfg.num_nodes,
            local_batch=cfg.local_batch,
            capacity=cfg.capacity,
            buffer_size=cfg.buffer_size,
            epoch_order=order,
            epochs=epochs,
        )

    # -- one step -------------------------------------------------------------

    def _plan_step(
        self,
        step: int,
        batch: np.ndarray,
        base: int,
        buffers: list[BeladyBuffer],
        next_use: np.ndarray,
        occ: _OccurrenceIndex,
    ) -> StepPlan:
        cfg = self.config
        pos_of = {int(s): base + i for i, s in enumerate(batch.tolist())}
        peer_cost = (cfg.peer_cost or PeerCostModel()) if cfg.enable_peer else None

        def find_holders(samples):
            """Nodes buffering each sample at the *start* of this step."""
            return {
                s: [p for p in range(cfg.num_nodes) if s in buffers[p]]
                for s in samples
            }

        holders: dict[int, list[int]] = {}
        if cfg.enable_locality:
            # Without O2 (balance) every node trains exactly local_batch
            # samples, so hits must not exceed that quota either.
            hit_cap = cfg.capacity if cfg.enable_balance else cfg.local_batch
            hits, misses = locality.assign_hits(batch, buffers, hit_cap)
            hit_counts = np.asarray([len(h) for h in hits], dtype=np.int64)
            if peer_cost is not None:
                # Misses with a holder are capacity-spilled hits: the remap
                # wanted to train them on their holder but B_cap was full.
                holders = find_holders(misses)
                miss_assign, peer_assign = balance_mod.distribute_tiered(
                    [s for s in misses if not holders[s]],
                    [s for s in misses if holders[s]],
                    hit_counts,
                    cfg.local_batch,
                    cfg.capacity,
                    balance=cfg.enable_balance,
                )
            else:
                miss_assign = balance_mod.distribute_misses(
                    misses,
                    hit_counts,
                    cfg.local_batch,
                    cfg.capacity,
                    balance=cfg.enable_balance,
                )
                peer_assign = [[] for _ in range(cfg.num_nodes)]
        else:
            split = shuffle.default_node_assignment(batch, cfg.num_nodes)
            hits, miss_assign = [], []
            for n, ids in enumerate(split):
                h = [int(s) for s in ids.tolist() if s in buffers[n]]
                m = [int(s) for s in ids.tolist() if s not in buffers[n]]
                hits.append(h)
                miss_assign.append(m)
            peer_assign = [[] for _ in range(cfg.num_nodes)]
            if peer_cost is not None:
                holders = find_holders([s for m in miss_assign for s in m])
                peer_assign = [[s for s in m if holders[s]] for m in miss_assign]
                miss_assign = [
                    [s for s in m if not holders[s]] for m in miss_assign
                ]

        #: per-step serve counts, so peer traffic spreads over source nodes.
        serve_load = [0] * cfg.num_nodes
        node_plans: list[NodeStepPlan] = []
        for n in range(cfg.num_nodes):
            h = hits[n]
            m = sorted(miss_assign[n] + peer_assign[n])
            if cfg.enable_chunking:
                chunks = chunking.plan_chunks(m, cfg.max_chunk, cfg.max_waste)
            else:
                chunks = tuple(ChunkRead(s, s + 1, 1) for s in m)

            peer_fetches: list[PeerFetch] = []
            if peer_assign[n]:
                cand = set(peer_assign[n])
                kept: list[ChunkRead] = []
                for c in chunks:
                    wanted = [s for s in m if c.start <= s < c.stop]
                    # Chunk-level decision: a chunk whose PFS read is
                    # amortized by non-peer misses is issued anyway, so
                    # peer-resident riders stay on it for free.
                    if all(s in cand for s in wanted) and peer_cost.prefer_peer(
                        len(wanted), c.span
                    ):
                        for s in wanted:
                            hs = holders[s]
                            if n in hs:
                                src = n  # bounced back home: free local read
                            else:
                                src = min(hs, key=lambda p: (serve_load[p], p))
                                serve_load[src] += 1
                            peer_fetches.append(PeerFetch(s, src))
                    else:
                        kept.append(c)
                chunks = tuple(kept)

            buf = buffers[n]
            start_resident = buf.resident
            for s in h:
                buf.update_next_use(s, int(next_use[pos_of[s]]))
            for s in m:
                buf.admit(s, int(next_use[pos_of[s]]))
            if cfg.admit_waste:
                wanted_set = set(m)
                for c in chunks:
                    for w in range(c.start, c.stop):
                        if w in wanted_set or w in buf:
                            continue
                        # A copy on any node already serves future accesses
                        # (locality remap hits it there): admitting another
                        # copy would only evict useful residents.
                        if any(w in other for other in buffers):
                            continue
                        buf.admit(w, occ.next_after(w, base))

            # The recorded delta is the start-vs-end resident-set difference,
            # so intra-step churn (admit -> evict -> re-admit) cancels out and
            # replaying deltas reproduces the simulated occupancy exactly.
            end_resident = buf.resident
            admitted = sorted(end_resident - start_resident)
            evicted = sorted(start_resident - end_resident)

            ids = np.asarray(h + m, dtype=np.int64)
            mask = np.zeros(ids.size, dtype=bool)
            mask[: len(h)] = True
            node_plans.append(
                NodeStepPlan(
                    node=n,
                    sample_ids=ids,
                    hit_mask=mask,
                    chunks=chunks,
                    admissions=np.asarray(admitted, dtype=np.int64),
                    evictions=np.asarray(evicted, dtype=np.int64),
                    peer_fetches=tuple(peer_fetches),
                )
            )
        return StepPlan(step=step, nodes=node_plans)
