"""In-process streaming driver: overlap window planning with window replay.

:func:`run_stream` ties the three streaming pieces together for one process:
an :class:`~repro_torch.stream.ingest.IngestSession` (producers writing under
admission), a :class:`~repro_torch.stream.windows.WindowPlanner` (rolling
``Schedule`` segments), and a live
:class:`~repro_torch.data.loaders.ScheduleExecutor` in streaming mode.  While the
executor replays window ``k``, a planner thread seals the next manifest and
compiles window ``k+1``; at the boundary the driver joins the thread and
``extend()``\\ s the executor — the only training stall is whatever planning
work outran the window, which is the *steps blocked on planning* metric
(``blocked_on_planning_s``) set against the stop-the-world mode
(``overlap=False``: seal + plan synchronously at every boundary).  The
``on_batch`` hook is where a training step goes.

Termination: with ``stream.max_windows`` set, exactly that many windows run
(re-planning over a static manifest once producers finish).  Without it, the
stream ends at the first boundary where producers have finished and no new
sample was admitted since the last seal.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time

from repro_torch.core.plan import Schedule
from repro_torch.data.loaders import stream_digest, update_batch_digest
from repro_torch.data.pipeline import LoaderSpec, execute
from repro_torch.obs import log as obs_log
from repro_torch.stream.ingest import IngestSession, WindowManifest
from repro_torch.stream.windows import STREAM_STRATEGY, WindowPlanner

__all__ = ["StreamReport", "run_stream"]

_log = obs_log.get_logger("stream.driver")


@dataclasses.dataclass
class StreamReport:
    """What one streaming run did: sizes, stalls, digests, parity."""

    steps: int
    windows: int
    wall_s: float
    #: time the first window's seal + plan took (before training started;
    #: identical in overlapped and stop-the-world modes).
    bootstrap_s: float
    #: total time training sat stalled at window boundaries waiting for the
    #: next segment — the overlapped-vs-stop-the-world headline number.
    blocked_on_planning_s: float
    #: total planning compute (including work hidden under training).
    plan_s: float
    #: canonical digest over every executed StepBatch.
    stream_digest: str
    #: artifact digest of the concatenated live window segments.
    plan_digest: str
    overlap: bool
    #: concatenation of the live segments (the full plan that was executed).
    schedule: Schedule
    manifests: list[WindowManifest]
    window_meta: list[dict]
    ingest_stats: dict
    loader_summary: dict
    #: populated when ``verify=True``: offline one-shot replan + re-execution
    #: digests and their parity with the live run (DESIGN.md §10).
    verify: dict | None = None

    @property
    def ok(self) -> bool:
        if self.verify is None:
            return True
        return bool(self.verify["plan_parity"] and self.verify["stream_parity"])

    def summary(self) -> dict:
        out = {
            "mode": "overlap" if self.overlap else "stop_the_world",
            "steps": self.steps,
            "windows": self.windows,
            "wall_s": round(self.wall_s, 3),
            "bootstrap_s": round(self.bootstrap_s, 3),
            "blocked_on_planning_s": round(self.blocked_on_planning_s, 3),
            "plan_s": round(self.plan_s, 3),
            "stream_digest": self.stream_digest,
            "plan_digest": self.plan_digest,
            "ingest": dict(self.ingest_stats),
            "loader": self.loader_summary,
        }
        if self.verify is not None:
            out["verify"] = dict(self.verify)
        return out


def run_stream(
    spec: LoaderSpec,
    session: IngestSession,
    *,
    overlap: bool = True,
    verify: bool = False,
    on_batch=None,
    seal_timeout_s: float = 120.0,
) -> StreamReport:
    """Train over ``session``'s stream per ``spec`` (``loader='stream'``).

    Producers feed ``session`` concurrently (e.g. via
    :func:`~repro_torch.stream.ingest.run_producers` on other threads); this
    function seals manifests, compiles windows, and replays them on one
    executor without teardown.  ``on_batch(step_batch)`` is the training
    hook.  With ``verify=True`` the run additionally replans all manifests
    offline in one shot and re-executes that plan, asserting nothing —
    parities are reported in :attr:`StreamReport.verify` for the caller
    (tests, the CLI's ``--verify``) to check.
    """
    spec.validate()
    if spec.loader != STREAM_STRATEGY:
        raise ValueError(
            f"run_stream needs loader='stream', got {spec.loader!r}"
        )
    ss = spec.stream
    planner = WindowPlanner.for_spec(spec)
    t_run = time.perf_counter()

    # Window 0: nothing to overlap with — seal (waiting for at least one
    # admitted sample) and plan synchronously.
    m0 = session.seal(
        min_fresh=max(ss.watermark, 1), timeout_s=seal_timeout_s
    )
    t0 = time.perf_counter()
    seg0 = planner.plan_window(m0.ids)
    bootstrap_s = time.perf_counter() - t_run
    plan_s = time.perf_counter() - t0
    _log.info(
        "window 0 sealed: %d samples (%d fresh), planned in %.3fs",
        int(m0.ids.size), int(m0.fresh), plan_s,
    )
    segments = [seg0]
    manifests = [m0]
    window_meta = [
        {"index": 0, "manifest": int(m0.ids.size), "fresh": int(m0.fresh),
         "plan_s": round(plan_s, 4)}
    ]

    def _plan_next(holder: dict) -> None:
        """Seal + compile the next window into ``holder`` (planner thread)."""
        try:
            m = session.seal(min_fresh=ss.watermark, timeout_s=seal_timeout_s)
            if ss.max_windows is None and session.finished and m.fresh == 0:
                holder["segment"] = None  # stream drained: no new data ever
                return
            tp = time.perf_counter()
            seg = planner.plan_window(m.ids)
            holder["plan_s"] = time.perf_counter() - tp
            holder["meta"] = {
                "index": m.index, "manifest": int(m.ids.size),
                "fresh": int(m.fresh),
                "plan_s": round(holder["plan_s"], 4),
            }
            holder["manifest"] = m
            holder["segment"] = seg
        except BaseException as exc:  # surfaced on the driving thread
            holder["error"] = exc

    ex = execute(spec, seg0, store=session.store)
    ex.begin_stream()
    h = hashlib.sha256()
    steps = 0
    blocked_s = 0.0
    k = 0
    try:
        it = iter(ex)
        while True:
            last = ss.max_windows is not None and (k + 1) >= ss.max_windows
            holder: dict = {}
            th = None
            if not last and overlap:
                th = threading.Thread(
                    target=_plan_next, args=(holder,), daemon=True,
                    name=f"window-planner-{k + 1}",
                )
                th.start()
            for _ in range(ss.window_steps):
                sb = next(it)
                update_batch_digest(h, sb)
                steps += 1
                if on_batch is not None:
                    on_batch(sb)
            tb = time.perf_counter()
            if last:
                holder["segment"] = None
            elif not overlap:
                _plan_next(holder)  # stop-the-world: training stalls here
            else:
                th.join()
            boundary_wait = time.perf_counter() - tb
            blocked_s += boundary_wait
            if "error" in holder:
                raise holder["error"]
            seg = holder.get("segment")
            if seg is None:
                _log.info(
                    "stream drained after window %d (%d steps)", k, steps
                )
                break
            _log.debug(
                "window %d boundary: waited %.3fs on planning "
                "(%d samples, %d fresh)",
                k + 1, boundary_wait,
                holder["meta"]["manifest"], holder["meta"]["fresh"],
            )
            plan_s += holder["plan_s"]
            segments.append(seg)
            manifests.append(holder["manifest"])
            window_meta.append(holder["meta"])
            ex.extend(seg)
            k += 1
    finally:
        ex.finish_stream()
        close = getattr(ex, "close", None)
        if callable(close):
            close()

    # extend() chains segments onto the running schedule in place (the first
    # segment IS ex.schedule), so the executor's schedule already holds the
    # full live concatenation.
    live = ex.schedule
    report = StreamReport(
        steps=steps,
        windows=len(segments),
        wall_s=time.perf_counter() - t_run,
        bootstrap_s=bootstrap_s,
        blocked_on_planning_s=blocked_s,
        plan_s=plan_s,
        stream_digest=h.hexdigest(),
        plan_digest=live.artifact_digest(),
        overlap=overlap,
        schedule=live,
        manifests=manifests,
        window_meta=window_meta,
        ingest_stats=dict(session.stats),
        loader_summary=ex.report.summary(),
    )
    if verify:
        offline = planner.replay_offline([m.ids for m in manifests])
        ex2 = execute(
            spec.replace(prefetch_depth=0), offline, store=session.store
        )
        offline_stream = stream_digest(iter(ex2))
        report.verify = {
            "offline_plan_digest": offline.artifact_digest(),
            "offline_stream_digest": offline_stream,
            "plan_parity": offline.artifact_digest() == report.plan_digest,
            "stream_parity": offline_stream == report.stream_digest,
        }
    return report
