"""Rolling plan windows: compile ``Schedule`` segments over a live manifest.

The plan-first IR (DESIGN.md §7) assumed a fixed dataset; streaming breaks
that by feeding the planner *manifests* — sealed snapshots of the admitted
sample set (:mod:`repro_torch.stream.ingest`) — one per window.  The
:class:`WindowPlanner` compiles window ``k`` into a one-epoch
:class:`~repro_torch.core.plan.Schedule` segment while the executor replays window
``k-1``, carrying the end-of-window per-node buffer state forward so buffer
reuse (and planned peer fetches) span window boundaries.

Determinism contract (DESIGN.md §10): window ``k``'s access order is drawn
from ``PCG64(SeedSequence([seed, k]))`` over the sorted manifest and the
carried buffers evolve deterministically, so each segment is a pure function
of ``(planner config, k, manifest_k, state after window k-1)``.  By
induction, ``concat_schedules(window_0 .. window_K)`` is array-identical —
hence digest-identical — to a one-shot offline plan over the same manifest
sequence (:meth:`WindowPlanner.replay_offline`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from repro_torch.core.buffer import LRUBuffer
from repro_torch.core.chunking import plan_chunks
from repro_torch.core.plan import (
    EpochPlan,
    NodeStepPlan,
    PeerFetch,
    Schedule,
    StepPlan,
    concat_schedules,
)
from repro_torch.stream.ingest import ADMISSION_POLICIES

__all__ = ["StreamSpec", "WindowPlanner", "STREAM_STRATEGY"]

STREAM_STRATEGY = "stream"


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Streaming knobs attached to a :class:`~repro_torch.data.pipeline.LoaderSpec`.

    ``window_steps`` is the segment length in training steps; ``admission``
    and ``reservoir_size`` configure the ingest policy; ``watermark`` is the
    minimum number of newly-admitted samples a seal waits for before the
    next window may be planned; ``max_pending`` bounds admissions awaiting a
    seal (producer backpressure); ``max_windows`` caps the run; and
    ``peer_fetch`` turns on planned peer fetches across node buffers.
    """

    window_steps: int = 8
    admission: str = "reservoir"
    watermark: int = 1
    reservoir_size: int | None = None
    max_pending: int = 4096
    max_windows: int | None = None
    peer_fetch: bool = False

    def validate(self) -> list[str]:
        errs = []
        if self.window_steps < 1:
            errs.append(f"stream.window_steps must be >= 1, got {self.window_steps}")
        if self.admission not in ADMISSION_POLICIES:
            errs.append(
                f"stream.admission {self.admission!r} unknown; "
                f"have {ADMISSION_POLICIES}"
            )
        if self.watermark < 0:
            errs.append(f"stream.watermark must be >= 0, got {self.watermark}")
        if self.reservoir_size is not None and self.reservoir_size < 1:
            errs.append(
                f"stream.reservoir_size must be >= 1 or None, "
                f"got {self.reservoir_size}"
            )
        if self.max_pending < 1:
            errs.append(f"stream.max_pending must be >= 1, got {self.max_pending}")
        if self.max_windows is not None and self.max_windows < 1:
            errs.append(
                f"stream.max_windows must be >= 1 or None, got {self.max_windows}"
            )
        return errs


def _delta(start: set, end: set) -> tuple[np.ndarray, np.ndarray]:
    return (
        np.asarray(sorted(end - start), np.int64),
        np.asarray(sorted(start - end), np.int64),
    )


class WindowPlanner:
    """Compile rolling one-epoch ``Schedule`` segments over sealed manifests.

    Stateful across windows: per-node LRU buffers carry the end-of-window
    resident set into the next window's simulation, so a sample fetched in
    window ``k`` is a planned buffer hit in window ``k+1``.  Each window is
    one :class:`EpochPlan` with ``epoch_id = order_pos = k``.
    """

    strategy = STREAM_STRATEGY

    def __init__(
        self,
        *,
        num_nodes: int,
        local_batch: int,
        buffer_size: int,
        window_steps: int,
        seed: int = 0,
        max_chunk: int = 16,
        peer_fetch: bool = False,
    ):
        if num_nodes < 1 or local_batch < 1 or window_steps < 1:
            raise ValueError("num_nodes, local_batch, window_steps must be >= 1")
        self.num_nodes = int(num_nodes)
        self.local_batch = int(local_batch)
        self.buffer_size = int(buffer_size)
        self.window_steps = int(window_steps)
        self.seed = int(seed)
        self.max_chunk = int(max_chunk)
        self.peer_fetch = bool(peer_fetch)
        self._bufs = [LRUBuffer(self.buffer_size) for _ in range(self.num_nodes)]
        self.windows_planned = 0

    def config_hash(self) -> str:
        """Provenance hash over everything a window's arrays depend on
        (besides the manifest itself) — stamped into every segment."""
        blob = json.dumps(
            {
                "strategy": self.strategy,
                "num_nodes": self.num_nodes,
                "local_batch": self.local_batch,
                "buffer_size": self.buffer_size,
                "window_steps": self.window_steps,
                "seed": self.seed,
                "max_chunk": self.max_chunk,
                "peer_fetch": self.peer_fetch,
            },
            sort_keys=True,
        ).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    @classmethod
    def for_spec(cls, spec) -> "WindowPlanner":
        """Build the planner a :class:`~repro_torch.data.pipeline.LoaderSpec` (with
        ``stream`` set) describes — duck-typed to avoid a circular import."""
        ss = spec.stream
        if ss is None:
            raise ValueError("spec has no stream=StreamSpec(...)")
        return cls(
            num_nodes=spec.num_nodes,
            local_batch=spec.local_batch,
            buffer_size=spec.buffer_size,
            window_steps=ss.window_steps,
            seed=spec.seed,
            peer_fetch=ss.peer_fetch,
        )

    def clone(self) -> "WindowPlanner":
        """A fresh planner with the same config and *empty* buffer state."""
        return WindowPlanner(
            num_nodes=self.num_nodes,
            local_batch=self.local_batch,
            buffer_size=self.buffer_size,
            window_steps=self.window_steps,
            seed=self.seed,
            max_chunk=self.max_chunk,
            peer_fetch=self.peer_fetch,
        )

    # -- planning --------------------------------------------------------------

    def plan_window(self, manifest) -> Schedule:
        """Compile the next window over ``manifest`` (admitted sample ids).

        The access order is sampling-with-replacement from the sorted
        manifest under ``PCG64(SeedSequence([seed, k]))`` — no RNG state is
        carried between windows, so window ``k`` replans identically from
        any starting point with the same buffer state.
        """
        ids = np.unique(np.asarray(manifest, np.int64))
        if ids.size == 0:
            raise ValueError("cannot plan a window over an empty manifest")
        k = self.windows_planned
        rng = np.random.Generator(
            np.random.PCG64(np.random.SeedSequence([self.seed, k]))
        )
        draw = ids[
            rng.integers(
                0, ids.size,
                size=self.window_steps * self.num_nodes * self.local_batch,
            )
        ].reshape(self.window_steps, self.num_nodes, self.local_batch)

        steps: list[StepPlan] = []
        for t in range(self.window_steps):
            # Peer sources are checked against the start-of-step resident
            # sets, frozen before any node plans — matching the runtime,
            # which gathers every peer fetch before applying any node's
            # deltas (see PeerFetch's contract in core/plan.py).
            snapshot = [b.resident for b in self._bufs]
            nodes: list[NodeStepPlan] = []
            for n in range(self.num_nodes):
                batch = draw[t, n]
                buf = self._bufs[n]
                start = snapshot[n]
                mask = np.zeros(self.local_batch, bool)
                miss_pfs: list[int] = []
                peers: list[PeerFetch] = []
                seen: set[int] = set()
                for i, s in enumerate(batch.tolist()):
                    if s in start or s in seen:
                        # Resident at step start, or a repeat draw of an id
                        # this batch already fetches: served without a new
                        # PFS read either way.
                        mask[i] = True
                        seen.add(s)
                        continue
                    seen.add(s)
                    src = None
                    if self.peer_fetch:
                        src = next(
                            (
                                r
                                for r in range(self.num_nodes)
                                if r != n and s in snapshot[r]
                            ),
                            None,
                        )
                    if src is not None:
                        peers.append(PeerFetch(s, src))
                    else:
                        miss_pfs.append(s)
                for s in batch.tolist():
                    buf.admit(s)
                adm, evi = _delta(start, buf.resident)
                nodes.append(
                    NodeStepPlan(
                        node=n,
                        sample_ids=np.asarray(batch, np.int64),
                        hit_mask=mask,
                        chunks=plan_chunks(miss_pfs, max_chunk=self.max_chunk),
                        admissions=adm,
                        evictions=evi,
                        peer_fetches=tuple(peers),
                    )
                )
            steps.append(StepPlan(step=t, nodes=nodes))

        self.windows_planned = k + 1
        return Schedule(
            num_nodes=self.num_nodes,
            local_batch=self.local_batch,
            capacity=self.local_batch,  # streams never pad above B_l
            buffer_size=self.buffer_size,
            epoch_order=np.asarray([k], np.int64),
            epochs=[EpochPlan(epoch_id=k, order_pos=k, steps=steps)],
            strategy=self.strategy,
            config_hash=self.config_hash(),
        )

    def replay_offline(self, manifests) -> Schedule:
        """One-shot offline plan over a recorded manifest sequence.

        A fresh planner walks the same manifests from empty state; by the
        module-docstring induction its concatenation is digest-identical to
        the rolling segments planned live — the streaming determinism
        contract the tests and the CLI's ``--verify`` assert.
        """
        planner = self.clone()
        return concat_schedules([planner.plan_window(m) for m in manifests])
