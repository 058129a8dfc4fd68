"""Distributed streaming: broadcast sealed window plans to rank processes.

:func:`run_stream_distributed` stretches the in-process streaming driver
(:mod:`repro_torch.stream.driver`) across real OS processes using the existing
control plane (:mod:`repro_torch.runtime.launcher`):

  * the **parent** owns the :class:`~repro_torch.stream.ingest.IngestSession`
    (producers write into a *sharded* store — per-read ``pread`` of the
    same inode is what makes fresh rows visible to already-running rank
    processes) and the :class:`~repro_torch.stream.windows.WindowPlanner`;
  * each sealed window's segment is saved as one artifact and announced
    over the control plane **by content hash** — every rank reloads the
    file, recomputes :meth:`~repro_torch.core.plan.Schedule.artifact_digest`, and
    refuses a segment it cannot verify (same trust model as the offline
    launcher's plan distribution);
  * ranks cut over at the same step boundary: all ranks barrier on
    ``w:k`` after verifying + chaining window ``k`` and before *consuming*
    its first batch, so no rank's training loop can run ahead into a
    window a peer has not received.  With ``spec.prefetch_depth > 0`` each
    rank's :class:`~repro_torch.data.prefetch.PrefetchExecutor` may *read ahead*
    into a window this rank has already verified and chained (bounded by
    the depth and the chained schedule's edge) — pure store reads only, so
    the consumed batch stream and its digest are depth-invariant;
  * the parent paces its lookahead on those barriers — window ``k+1`` is
    sealed and planned while the ranks replay window ``k``, never further
    ahead — which is the distributed form of overlapped window planning.

Rank deaths degrade the run (they are reported, not recovered): streaming
ranks hold no peer-served state, so there is nothing to re-slice — the
surviving ranks simply keep training their own slices.
"""
from __future__ import annotations

import dataclasses
import hashlib
import multiprocessing
import os
import shutil
import tempfile
import time

from repro_torch.core.plan import concat_schedules
from repro_torch.data.pipeline import LoaderSpec
from repro_torch.stream.ingest import IngestSession
from repro_torch.stream.windows import STREAM_STRATEGY, WindowPlanner

__all__ = ["StreamDistReport", "run_stream_distributed", "_stream_rank_main"]


def _stream_rank_main(rank: int, cfg: dict) -> None:
    """One streaming rank: verify each announced window by hash, chain it
    onto the live executor, and cut over with the others at ``w:k``.

    Module-level and picklable (spawn entry point).  The rank hashes only
    batches its slice actually populates, so its stream digest matches the
    in-process per-node reference digest bit for bit.
    """
    from repro_torch.core.plan import Schedule
    from repro_torch.data.loaders import update_batch_digest
    from repro_torch.data.pipeline import build_store, execute
    from repro_torch.runtime.launcher import _HOST, _ControlClient

    spec = cfg["spec"]
    barrier_timeout_s = float(cfg["barrier_timeout_s"])
    ctrl = _ControlClient(cfg["control_port"], timeout_s=barrier_timeout_s)
    store = build_store(spec)
    ex = None
    try:
        ctrl.register(rank, _HOST, 0)  # no buffer server: port 0
        ctrl.start_heartbeats()
        h = hashlib.sha256()
        it = None
        k = 0
        steps = 0
        window_steps = spec.stream.window_steps
        t0 = time.perf_counter()
        while True:
            w = ctrl.wait_window(k, timeout_s=barrier_timeout_s)
            if w.get("halt"):
                break  # the stream drained with no window k
            seg = Schedule.load(w["path"])
            digest = seg.artifact_digest()
            if digest != w["digest"]:
                raise RuntimeError(
                    f"rank {rank}: window {k} artifact digest {digest} != "
                    f"announced {w['digest']} — refusing to execute a "
                    "segment I cannot verify"
                )
            my_slice = seg.for_node(rank)
            if ex is None:
                ex = execute(spec, my_slice, store=store)
                ex.begin_stream()
                it = iter(ex)
            else:
                ex.extend(my_slice)
            # Cut-over barrier: every rank holds (and verified) window k
            # before any rank executes its first step.
            ctrl.barrier(f"w:{k}")
            for _ in range(window_steps):
                sb = next(it)
                steps += 1
                if sb.node_ids:
                    update_batch_digest(h, sb)
            if w.get("last"):
                break
            k += 1
        if ex is not None:
            ex.finish_stream()
        ctrl.report({
            "rank": rank,
            "digest": h.hexdigest(),
            "steps": steps,
            "windows": (k + 1) if ex is not None else 0,
            "summary": ex.report.summary() if ex is not None else {},
            "wall_time_s": round(time.perf_counter() - t0, 4),
        })
    finally:
        if ex is not None:
            close = getattr(ex, "close", None)
            if callable(close):
                close()
        store.close()
        ctrl.close()


@dataclasses.dataclass
class StreamDistReport:
    """One distributed streaming run: per-rank digests + parity evidence."""

    num_ranks: int
    windows: int
    steps: int
    wall_s: float
    #: artifact digest of the concatenated window segments.
    plan_digest: str
    #: rank -> its own-slice stream digest (None for dead ranks).
    rank_digests: dict
    rank_reports: dict
    dead: list
    window_meta: list
    ingest_stats: dict
    #: populated when ``verify=True``: offline replan digest + in-process
    #: per-rank reference digests and their parities.
    verify: dict | None = None

    @property
    def ok(self) -> bool:
        if self.dead:
            return False
        if self.verify is None:
            return True
        return bool(
            self.verify["plan_parity"] and self.verify["rank_parity"]
        )

    def summary(self) -> dict:
        out = {
            "num_ranks": self.num_ranks,
            "windows": self.windows,
            "steps": self.steps,
            "wall_s": round(self.wall_s, 3),
            "plan_digest": self.plan_digest,
            "dead_ranks": list(self.dead),
            "rank_digests": {
                str(r): d for r, d in sorted(self.rank_digests.items())
            },
            "ingest": dict(self.ingest_stats),
        }
        if self.verify is not None:
            out["verify"] = {
                k: v for k, v in self.verify.items()
                if k != "reference_digests"
            }
        return out


def run_stream_distributed(
    spec: LoaderSpec,
    session: IngestSession,
    *,
    run_dir: str | None = None,
    timeout_s: float = 300.0,
    barrier_timeout_s: float = 60.0,
    seal_timeout_s: float = 120.0,
    verify: bool = False,
) -> StreamDistReport:
    """Stream-train ``spec.num_nodes`` rank processes over ``session``.

    The spec must be **path-based on the sharded backend** (ranks reopen
    the dataset; every read is a ``pread`` of the shard files the parent's
    ingest writes and fsyncs at each seal, so sealed rows are visible
    across the process boundary — the ``memory`` backend stages at open
    and would never see them).  Producers feed ``session`` concurrently on
    parent-side threads; this call seals windows, plans segments, and
    broadcasts them by content hash until the stream ends
    (``stream.max_windows``, or producers finishing with nothing fresh).
    """
    from repro_torch.runtime.launcher import _Coordinator

    spec.validate()
    if spec.loader != STREAM_STRATEGY:
        raise ValueError(
            f"run_stream_distributed needs loader='stream', got {spec.loader!r}"
        )
    if spec.store is not None or spec.path is None:
        raise ValueError(
            "run_stream_distributed needs a path-based LoaderSpec: every "
            "rank reopens the store itself; pass the ingest store's path"
        )
    if spec.backend != "sharded":
        raise ValueError(
            f"distributed streaming requires backend='sharded' (per-read "
            f"pread makes the parent's writes visible to running ranks); "
            f"got {spec.backend!r}"
        )
    if spec.stream.peer_fetch:
        raise ValueError(
            "distributed streaming does not serve the peer-fetch tier: "
            "set stream.peer_fetch=False (misses read the PFS directly)"
        )
    if session.store.path != spec.path:
        raise ValueError(
            f"the ingest session writes {session.store.path!r} but the "
            f"spec reads {spec.path!r} — ranks would train other data"
        )

    ss = spec.stream
    planner = WindowPlanner.for_spec(spec)
    # prefetch_depth rides into the ranks: execute() wraps each rank's
    # executor in a PrefetchExecutor whose stream_steps_ready probe caps
    # the pipeline at the chained schedule's edge, so read-ahead composes
    # with the w:k cutover barriers (and digests stay depth-invariant —
    # streaming ranks have no peer tier, only pure store reads to overlap).
    child_spec = spec.replace(collect_data=True)
    own_dir = run_dir is None
    if own_dir:
        run_dir = tempfile.mkdtemp(prefix="solar_stream_")

    coord = _Coordinator(
        spec.num_nodes,
        barrier_timeout_s=barrier_timeout_s,
        recovery="degrade",  # streaming ranks hold nothing to re-slice
    ).start()
    ctx = multiprocessing.get_context("spawn")
    procs: list = []
    segments: list = []
    manifests: list = []
    window_meta: list[dict] = []
    t0 = time.perf_counter()

    def _announce(k: int, seg, manifest, last: bool) -> None:
        path = os.path.join(run_dir, f"window_{k}.npz")
        seg.save(path)
        segments.append(seg)
        manifests.append(manifest)
        window_meta.append({
            "index": k, "manifest": int(manifest.ids.size),
            "fresh": int(manifest.fresh), "last": bool(last),
        })
        coord.broadcast_window({
            "index": k,
            "path": path,
            "digest": seg.artifact_digest(),
            "steps": int(ss.window_steps),
            "last": bool(last),
        })

    try:
        for rank in range(spec.num_nodes):
            cfg = {
                "spec": child_spec,
                "control_port": coord.port,
                "barrier_timeout_s": barrier_timeout_s,
            }
            p = ctx.Process(
                target=_stream_rank_main, args=(rank, cfg),
                name=f"solar-stream-rank-{rank}", daemon=True,
            )
            p.start()
            procs.append(p)

        def _is_last(idx: int) -> bool:
            return ss.max_windows is not None and idx + 1 >= ss.max_windows

        m = session.seal(
            min_fresh=max(ss.watermark, 1), timeout_s=seal_timeout_s
        )
        seg = planner.plan_window(m.ids)
        last = _is_last(0)
        _announce(0, seg, m, last)
        k = 0
        while not last:
            # Lookahead pacing: ranks are cutting over to (or replaying)
            # window k; seal + plan k+1 underneath their training.
            if not coord.wait_barrier(f"w:{k}", timeout_s=barrier_timeout_s):
                break  # ranks died or stalled: stop feeding windows
            m = session.seal(min_fresh=ss.watermark, timeout_s=seal_timeout_s)
            if ss.max_windows is None and session.finished and m.fresh == 0:
                coord.broadcast_window({"index": k + 1, "halt": True})
                break
            seg = planner.plan_window(m.ids)
            last = _is_last(k + 1)
            _announce(k + 1, seg, m, last)
            k += 1

        deadline = time.monotonic() + timeout_s
        while not coord.wait_done(1.0):
            for rank in range(spec.num_nodes):
                if procs[rank].exitcode is not None:
                    coord.mark_dead_if_silent(rank)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"distributed stream did not finish within {timeout_s}s: "
                    f"done={sorted(coord.done)} dead={sorted(coord.dead)} "
                    f"pending(last-contact ages s)={coord.pending_detail()}"
                )
        for p in procs:
            p.join(timeout=10.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        coord.close()
        if own_dir:
            shutil.rmtree(run_dir, ignore_errors=True)

    live = concat_schedules(segments)
    dead = sorted(
        r for r in range(spec.num_nodes) if r not in coord.reports
    )
    rank_digests = {
        r: (
            str(coord.reports[r]["digest"]) if r in coord.reports else None
        )
        for r in range(spec.num_nodes)
    }
    report = StreamDistReport(
        num_ranks=spec.num_nodes,
        windows=len(segments),
        steps=len(segments) * ss.window_steps,
        wall_s=time.perf_counter() - t0,
        plan_digest=live.artifact_digest(),
        rank_digests=rank_digests,
        rank_reports={r: dict(coord.reports[r]) for r in coord.reports},
        dead=dead,
        window_meta=window_meta,
        ingest_stats=dict(session.stats),
    )
    if verify:
        from repro_torch.runtime.launcher import in_process_digests

        offline = planner.replay_offline([m.ids for m in manifests])
        reference = in_process_digests(spec, live, store=session.store)
        report.verify = {
            "offline_plan_digest": offline.artifact_digest(),
            "plan_parity": offline.artifact_digest() == report.plan_digest,
            "reference_digests": {
                int(r): d for r, d in reference.items()
            },
            "rank_parity": all(
                rank_digests.get(r) == reference.get(r)
                for r in range(spec.num_nodes)
                if r not in dead
            ),
        }
    return report
