"""The port's program spans on the device trace's clock: what the host was
doing while the card sat idle, and where a step's batch assembly goes.

    python3 bench/spans.py --workload <cell> --seed <n> --seconds <s> \
        [--program-trace 0|1] [--out spans.jsonl]

Runs the cell as ``bench/run.py --trace 1`` does (the same ``cell.run``:
set-up, the window, a profiled stretch, the reference), with the port's
tracer (``repro_torch.obs.trace``) on from the start of the run.  Just
before the profiled stretch the tracer's clock anchor is taken anew, and
the stretch opens with a ``torch.cuda.synchronize`` bracketed by host
clock readings: its runtime call in the profiler's trace checks the
mapping.  Prints one JSON line: the run's result line (``bench/run.py``'s,
with ``window_rate``), the readings below, and the idle gaps labelled by
the CUDA runtime call at their midpoint, else by the innermost program span
there on the thread that ran the steps (``span:<kind>``), else ``host:
none``.  ``--program-trace 0`` leaves the tracer off: the same run, for
the tracer's cost.

The benchmark's own runs run none of this.  Its per-layer metrics would
need ``bench/cell.py`` to turn the tracer on for the ``--trace 1`` window
and stretch and to hand the records to ``Readings``, and
``bench/devtrace.py``'s ``Trace.idle_gaps`` to take the ``span:`` labels.

The reductions (everything above ``measure``) import nothing of the port.  A
span is ``(start, end, kind, thread, step, a, b)``, its times in seconds on
the profiler's clock (Unix epoch)."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    HERE = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != HERE]
    sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]

from bench.window import gaps  # noqa: E402

__all__ = ["map_spans", "merge", "overlap", "idle_in", "labelled_gaps", "per_step_ms",
           "queue_depth", "busy_share", "launches_outside", "readings"]

#: the trainer's spans that tile a step on the thread that runs it
STEP_KINDS = ("prefetch.qwait", "train.make_batch", "train.compute")
#: CUDA runtime calls that launch work on the card
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")


def map_spans(records, threads: list, names: list, epoch_s) -> list:
    """The tracer's records (``RECORD_DTYPE`` rows) as spans on the
    profiler's clock, through ``epoch_s`` (the tracer's map of
    ``perf_counter`` seconds to Unix-epoch seconds)."""
    return [(epoch_s(float(r["t0"])), epoch_s(float(r["t1"])), names[int(r["kind"])], tid,
             int(r["step"]), int(r["a"]), int(r["b"]))
            for r, tid in zip(records, threads)]


def merge(intervals) -> list:
    """Sorted, disjoint ``(start, end)`` covering the same points."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a: list, b: list) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _clipped(spans, kinds, thread, lo, hi) -> list:
    return merge((max(s, lo), min(e, hi)) for s, e, k, t, *_ in spans
                 if (kinds is None or k in kinds) and t == thread and e > lo and s < hi)


def idle_in(trace, spans: list, kinds, thread: str, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] in which the card ran nothing while ``thread``
    was inside a span of ``kinds`` (None: any span): every gap, by
    interval intersection."""
    inside = _clipped(spans, kinds, thread, lo, hi)
    busy = merge((s, e) for s, e, _ in trace.device_ops)
    return sum(e - s for s, e in inside) - overlap(inside, busy)


def _innermost(ivs: list, starts: list, mid: float):
    """The shortest of ``ivs`` (sorted by start) holding ``mid``."""
    best = None
    i = bisect.bisect_right(starts, mid)
    for iv in ivs[max(0, i - 5000):i]:
        if iv[1] >= mid and (best is None or iv[1] - iv[0] < best[1] - best[0]):
            best = iv
    return best


def labelled_gaps(trace, spans: list, thread: str, n: int = 10, longest: int = 500) -> list:
    """``Trace.idle_gaps`` with one more label: the card's ``longest`` idle
    stretches, their time summed by the innermost CUDA runtime call at each
    one's midpoint, else by the innermost span of ``thread`` there
    (``span:<kind>``), else ``host: none``; the ``n`` largest sums."""
    if not trace.device_ops:
        return []
    start = min(s for s, _, _ in trace.device_ops)
    end = max(e for _, e, _ in trace.device_ops)
    host = sorted(trace.host_ops)
    hstarts = [s for s, _, _ in host]
    own = sorted(sp for sp in spans if sp[3] == thread)
    ostarts = [sp[0] for sp in own]
    stretches = sorted(gaps([(s, e) for s, e, _ in trace.device_ops], start, end),
                       key=lambda g: g[0] - g[1])[:longest]
    by = defaultdict(float)
    for a, b in stretches:
        mid = (a + b) / 2
        call = _innermost(host, hstarts, mid)
        span = None if call else _innermost(own, ostarts, mid)
        label = call[2][:160] if call else ("span:" + span[2] if span else "host: none")
        by[label] += b - a
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


def per_step_ms(spans: list, kind: str, lo: float, hi: float, steps: int):
    """Milliseconds of ``kind`` spans starting in [lo, hi] per step; None
    where there are none."""
    d = [e - s for s, e, k, *_ in spans if k == kind and lo <= s <= hi]
    return 1e3 * sum(d) / steps if d and steps else None


def queue_depth(spans: list, lo: float, hi: float):
    """Mean of ``prefetch.qwait``'s a (assembled batches waiting at the
    get) over its spans starting in [lo, hi]."""
    a = [sp[5] for sp in spans if sp[2] == "prefetch.qwait" and lo <= sp[0] <= hi]
    return sum(a) / len(a) if a else None


def busy_share(spans: list, kind: str, lo: float, hi: float, workers: int):
    """Summed time of ``kind`` spans inside [lo, hi] over its length times
    ``workers`` (the threads that record them)."""
    d = [min(e, hi) - max(s, lo) for s, e, k, *_ in spans if k == kind and e > lo and s < hi]
    return sum(d) / ((hi - lo) * workers) if d else None


def launches_outside(trace, spans: list, thread: str, lo: float, hi: float) -> tuple:
    """(launches, launches outside every ``train.make_batch`` and
    ``train.compute`` span of ``thread``) in the first step that starts in
    [lo, hi]: from its ``train.make_batch``'s start to the next one's, or to
    ``hi``."""
    starts = sorted(s for s, _, k, t, *_ in spans
                    if k == "train.make_batch" and t == thread and lo <= s <= hi)
    if not starts:
        return 0, 0
    a, b = starts[0], starts[1] if len(starts) > 1 else hi
    inside = _clipped(spans, ("train.make_batch", "train.compute"), thread, a, b)
    calls = [(s, e) for s, e, name in trace.host_ops
             if a <= s < b and any(p in name for p in LAUNCHES)]
    out = sum(1 for s, e in calls if not any(x <= s and e <= y for x, y in inside))
    return len(calls), out


def readings(spans: list, dropped: int, trace, window: tuple, stretch: tuple, steps: int,
             trace_steps: int, workers: int, thread: str, suffix: str) -> dict:
    """Every reading of one run: ``window`` and ``stretch`` are the window's
    and the profiled stretch's (start, end) on the profiler's clock."""
    w0, w1 = window
    s0, s1 = stretch
    out = {"dropped": dropped}
    if dropped:  # a ring wrapped: the spans are not the run's
        return out
    for name, kind in (("to_global_ms", "batch.to_global"), ("stage_ms", "batch.stage"),
                       ("loader_assemble_ms", "prefetch.assemble")):
        out[f"{name}.{suffix}"] = per_step_ms(spans, kind, w0, w1, steps)
    out[f"prefetch_depth.{suffix}"] = queue_depth(spans, w0, w1)
    out[f"io_busy_share.{suffix}"] = busy_share(spans, "chunk.read", w0, w1, workers)
    if trace is None or not trace.device_ops:
        return out
    out[f"idle_in_batch_ms.{suffix}"] = (
        1e3 * idle_in(trace, spans, ("train.make_batch",), thread, s0, s1) / trace_steps)
    out[f"idle_in_step_ms.{suffix}"] = (
        1e3 * idle_in(trace, spans, ("train.compute",), thread, s0, s1) / trace_steps)
    # the stretch's idle time per step, split by each kind of the steps'
    # thread (a nested kind's idle time is also its parent's) and the rest
    idle = (s1 - s0) - overlap([(s0, s1)], merge((s, e) for s, e, _ in trace.device_ops))
    kinds = sorted({sp[2] for sp in spans if sp[3] == thread and sp[1] > s0 and sp[0] < s1})
    split = {k: 1e3 * idle_in(trace, spans, (k,), thread, s0, s1) / trace_steps
             for k in kinds}
    split["outside the step's spans"] = 1e3 * (
        idle - idle_in(trace, spans, STEP_KINDS, thread, s0, s1)) / trace_steps
    out["idle_ms_per_step"] = 1e3 * idle / trace_steps
    out["trace_idle_ms_per_step"] = 1e3 * (trace.window_s - trace.busy_s) / trace_steps
    out["idle_in_ms"] = split
    out["idle_gaps"] = labelled_gaps(trace, spans, thread)
    out["launches_first_step"] = launches_outside(trace, spans, thread, s0, s1)
    return out


def _anchor_check(trace, bracket: tuple):
    """(ms by which the profiler's synchronize call lies outside the mapped
    host bracket around it, ms from the bracket's midpoint to the call's)."""
    a, b = bracket
    calls = [(s, e) for s, e, name in trace.host_ops if "Synchronize" in name]
    if not calls:
        return None
    s, e = min(calls, key=lambda c: abs((c[0] + c[1]) / 2 - (a + b) / 2))
    return 1e3 * (max(0.0, a - s) + max(0.0, e - b)), 1e3 * ((s + e) / 2 - (a + b) / 2)


def measure(workload: str, seed: int, seconds: float, program_trace: bool, device,
            **cell_kw) -> dict:
    """One traced run of the cell (``cell.run``'s keywords pass through);
    returns its line."""
    import torch

    from bench import cell, devtrace, readers
    from bench import run as bench_run
    from repro_torch.obs import trace as obs_trace
    from repro_torch.train.trainer import Trainer

    calls, seen = [], {}
    run_steps, traced = Trainer.run, devtrace.traced

    def timed_run(self, max_steps=None):
        t0 = time.perf_counter()
        try:
            return run_steps(self, max_steps)
        finally:
            calls.append((t0, time.perf_counter()))

    def anchored(steps, dev):
        tr = obs_trace.get()
        if tr.enabled:
            tr.anchor()

        def bracketed():
            a = time.perf_counter()
            torch.cuda.synchronize(dev)
            seen["bracket"] = (a, time.perf_counter())
            steps()

        return traced(bracketed, dev)

    tracer = obs_trace.enable() if program_trace else None
    Trainer.run, devtrace.traced = timed_run, anchored
    try:
        out = cell.run(workload, seed, seconds, True, device, T_START,
                       log=lambda *a: print(*a, file=sys.stderr), **cell_kw)
    finally:
        Trainer.run, devtrace.traced = run_steps, traced
        obs_trace.disable()
    r = out["readings"]
    line = bench_run.result_line(out, workload, True, device)
    line.update(workload=workload, seed=seed, program_trace=int(program_trace),
                window_rate=readers.window_rate(r))
    if tracer is not None:
        recs, threads, dropped = tracer.records()
        spans = map_spans(recs, threads, obs_trace.kind_names(), tracer.epoch_s)
        window, stretch, bracket = (tuple(map(tracer.epoch_s, c))
                                    for c in (calls[-2], calls[-1], seen["bracket"]))
        line["spans"] = readings(
            spans, dropped, r.trace, window, stretch, len(r.steps), r.mix["trace_steps"],
            r.mix["num_workers"], threading.current_thread().name, r.config["kind"])
        line["spans"]["anchor_check_ms"] = _anchor_check(r.trace, bracket)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program-trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None, help="append the line to this file too")
    args = ap.parse_args(argv)

    from bench import run as bench_run

    bench_run._environment()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    line = measure(args.workload, args.seed, args.seconds, bool(args.program_trace),
                   torch.device("cuda", 0))
    text = json.dumps(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
