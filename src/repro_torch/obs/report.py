"""``python -m repro_torch.obs.report`` — where did each ms go? (DESIGN.md §13)

Reads the per-rank ``trace-rank*.jsonl`` files a traced run dumped into
``--trace-dir`` and renders per-step time attribution across the loading
ladder: disk/PFS chunk reads, the peer tier, barrier waits, skew parking,
tenant yields/sheds, heartbeats.  ``--check`` turns the same pass into a
validator (well-formed spans, per-thread monotonic timestamps, barrier time
accounted, nonzero chunk reads) for CI smokes.

    PYTHONPATH=src python -m repro_torch.obs.report TRACE_DIR [--check] [--json]

Own copy of the JAX package's ``obs/report.py``: it reads either package's
dumps and gives the same analysis for the same files.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

__all__ = ["load_traces", "analyze", "check", "main"]

#: the rendered breakdown: display stage -> span kinds whose time it sums.
#: ``step.*`` sections tile the rank loop; chunk/peer/serve kinds attribute
#: the same wall time at finer grain (they nest inside the sections), so
#: the coverage accounting below sums only the tiling sections.
STAGES = {
    "barrier": ("barrier.wait",),
    "peer": ("step.peer",),
    "execute": ("step.execute",),
    "prime": ("step.prime",),
    "hb": ("hb.send",),
}
DETAIL = {
    "disk_pfs": ("chunk.read",),
    "peer_wire": ("peer.fetch",),
    "skew_wait": ("serve.skew_park",),
    "tenant_yield": ("serve.tenant_yield",),
    "compute": ("train.compute",),
}
COUNTS = {
    "sheds": ("serve.shed",),
    "retries": ("peer.retry",),
    "breaker_opens": ("peer.breaker_open",),
    # fault firings are interned per kind+site ("fault.crash:32", ...)
    "faults": ("fault", "fault."),
}


def load_traces(trace_dir: str) -> dict[int, dict]:
    """rank -> {"meta": {...}, "records": [span dicts]} from the JSONL dumps."""
    out: dict[int, dict] = {}
    for path in sorted(glob.glob(os.path.join(trace_dir, "trace-rank*.jsonl"))):
        m = re.search(r"trace-rank(\d+)\.jsonl$", path)
        if m is None:
            continue
        rank = int(m.group(1))
        meta: dict = {}
        records: list[dict] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                if obj.get("meta"):
                    meta = obj
                else:
                    records.append(obj)
        out[rank] = {"meta": meta, "records": records, "path": path}
    return out


def _sum_by(records, kinds) -> float:
    names = set(kinds)
    return sum(r["dur"] for r in records if r["name"] in names)


def _count_by(records, kinds) -> int:
    exact = {k for k in kinds if not k.endswith(".")}
    prefixes = tuple(k for k in kinds if k.endswith("."))
    return sum(
        1 for r in records
        if r["name"] in exact
        or (prefixes and r["name"].startswith(prefixes))
    )


def analyze(trace_dir: str) -> dict:
    """Aggregate one traced run's dumps into per-rank + cluster attribution.

    Per rank: total/per-step milliseconds for every display stage, the
    fraction of measured step wall time the tiling sections account for
    (``coverage``), and the barrier overhead in ms/step — the number
    ``BENCH_dist.json`` previously derived from hand-inserted timers.
    """
    traces = load_traces(trace_dir)
    if not traces:
        raise FileNotFoundError(
            f"no trace-rank*.jsonl files under {trace_dir!r}"
        )
    ranks: dict[str, dict] = {}
    cluster_steps = 0
    cluster_totals: dict[str, float] = {}
    cluster_step_ms = 0.0
    cluster_coverage_num = 0.0
    cluster_coverage_den = 0.0
    for rank, tr in sorted(traces.items()):
        recs = tr["records"]
        steps = [r for r in recs if r["name"] == "step"]
        nsteps = len(steps)
        step_ms = _sum_by(recs, ("step",)) * 1e3
        stage_ms = {
            stage: _sum_by(recs, kinds) * 1e3
            for stage, kinds in STAGES.items()
        }
        detail_ms = {
            stage: _sum_by(recs, kinds) * 1e3
            for stage, kinds in DETAIL.items()
        }
        counts = {
            name: _count_by(recs, kinds) for name, kinds in COUNTS.items()
        }
        accounted = sum(stage_ms.values())
        # per-step rows (step index -> per-stage ms) for the detailed view
        per_step: dict[int, dict[str, float]] = {}
        for r in recs:
            for stage, kinds in {**STAGES, "step": ("step",)}.items():
                if r["name"] in kinds:
                    row = per_step.setdefault(int(r["step"]), {})
                    row[stage] = row.get(stage, 0.0) + r["dur"] * 1e3
        ranks[str(rank)] = {
            "steps": nsteps,
            "records": len(recs),
            "dropped": int(tr["meta"].get("dropped", 0)),
            "step_ms_total": round(step_ms, 3),
            "step_ms_mean": round(step_ms / nsteps, 3) if nsteps else 0.0,
            "stage_ms_total": {k: round(v, 3) for k, v in stage_ms.items()},
            "stage_ms_per_step": {
                k: round(v / nsteps, 3) if nsteps else 0.0
                for k, v in stage_ms.items()
            },
            "detail_ms_total": {k: round(v, 3) for k, v in detail_ms.items()},
            "counts": counts,
            "coverage": round(accounted / step_ms, 4) if step_ms else 0.0,
            "barrier_ms_per_step": (
                round(stage_ms["barrier"] / nsteps, 3) if nsteps else 0.0
            ),
            "per_step": {
                str(s): {k: round(v, 4) for k, v in sorted(row.items())}
                for s, row in sorted(per_step.items())
            },
        }
        cluster_steps += nsteps
        cluster_step_ms += step_ms
        for k, v in stage_ms.items():
            cluster_totals[k] = cluster_totals.get(k, 0.0) + v
        cluster_coverage_num += accounted
        cluster_coverage_den += step_ms
    return {
        "trace_dir": trace_dir,
        "num_ranks": len(traces),
        "ranks": ranks,
        "cluster": {
            "steps": cluster_steps,
            "step_ms_mean": (
                round(cluster_step_ms / cluster_steps, 3)
                if cluster_steps else 0.0
            ),
            "stage_ms_per_step": {
                k: round(v / cluster_steps, 3) if cluster_steps else 0.0
                for k, v in sorted(cluster_totals.items())
            },
            "barrier_ms_per_step": (
                round(cluster_totals.get("barrier", 0.0) / cluster_steps, 3)
                if cluster_steps else 0.0
            ),
            "coverage": (
                round(cluster_coverage_num / cluster_coverage_den, 4)
                if cluster_coverage_den else 0.0
            ),
        },
    }


def check(trace_dir: str, *, min_coverage: float = 0.9) -> list[str]:
    """Validate a traced run's dumps; returns a list of failures (empty=OK)."""
    failures: list[str] = []
    try:
        traces = load_traces(trace_dir)
    except OSError as exc:
        return [f"cannot read {trace_dir!r}: {exc}"]
    if not traces:
        return [f"no trace-rank*.jsonl files under {trace_dir!r}"]
    for rank, tr in sorted(traces.items()):
        recs = tr["records"]
        if not recs:
            failures.append(f"rank {rank}: empty trace")
            continue
        last_by_tid: dict[str, float] = {}
        for i, r in enumerate(recs):
            if not all(k in r for k in ("name", "ts", "dur", "step", "tid")):
                failures.append(f"rank {rank}: record {i} missing fields")
                break
            if r["dur"] < 0:
                failures.append(
                    f"rank {rank}: record {i} ({r['name']}) has dur < 0"
                )
            # records within one thread's ring are appended in time order;
            # the dump interleaves threads but must preserve that order.
            prev = last_by_tid.get(r["tid"])
            if prev is not None and r["ts"] < prev:
                failures.append(
                    f"rank {rank}: non-monotonic timestamps on {r['tid']}"
                )
                break
            last_by_tid[r["tid"]] = r["ts"]
        if _count_by(recs, ("chunk.read",)) == 0:
            failures.append(f"rank {rank}: no chunk.read spans recorded")
        if _count_by(recs, ("step",)) == 0:
            failures.append(f"rank {rank}: no step spans recorded")
    if len(traces) > 1:
        total_barrier = sum(
            _sum_by(tr["records"], ("barrier.wait",))
            for tr in traces.values()
        )
        if total_barrier <= 0.0:
            failures.append("multi-rank run recorded zero barrier.wait time")
    try:
        rep = analyze(trace_dir)
    except (OSError, KeyError, ValueError) as exc:
        failures.append(f"analyze failed: {exc}")
        return failures
    cov = rep["cluster"]["coverage"]
    if cov < min_coverage:
        failures.append(
            f"step coverage {cov:.3f} < {min_coverage} — the tiling "
            "sections no longer account for the rank loop"
        )
    return failures


def _render(rep: dict) -> str:
    lines = [
        f"trace: {rep['trace_dir']}  ({rep['num_ranks']} rank(s), "
        f"{rep['cluster']['steps']} step spans, "
        f"coverage {rep['cluster']['coverage']:.1%})",
        "",
        f"{'rank':>4} {'steps':>6} {'ms/step':>9} "
        + "".join(f"{s:>10}" for s in STAGES)
        + f"{'coverage':>10}",
    ]
    for rank, row in sorted(rep["ranks"].items(), key=lambda kv: int(kv[0])):
        lines.append(
            f"{rank:>4} {row['steps']:>6} {row['step_ms_mean']:>9.3f} "
            + "".join(
                f"{row['stage_ms_per_step'][s]:>10.3f}" for s in STAGES
            )
            + f"{row['coverage']:>10.1%}"
        )
    lines += [
        "",
        "cluster ms/step by stage: " + ", ".join(
            f"{k}={v}" for k, v in rep["cluster"]["stage_ms_per_step"].items()
        ),
        f"barrier overhead: {rep['cluster']['barrier_ms_per_step']} ms/step",
    ]
    detail = {
        k: round(sum(
            r["detail_ms_total"][k] for r in rep["ranks"].values()
        ), 3)
        for k in DETAIL
    }
    counts = {
        k: sum(r["counts"][k] for r in rep["ranks"].values()) for k in COUNTS
    }
    lines.append(
        "detail ms total: " + ", ".join(f"{k}={v}" for k, v in detail.items())
    )
    lines.append(
        "event counts: " + ", ".join(f"{k}={v}" for k, v in counts.items())
    )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.report",
        description="per-step time attribution from a traced run's dumps",
    )
    ap.add_argument("trace_dir", help="directory holding trace-rank*.jsonl")
    ap.add_argument("--json", action="store_true",
                    help="emit the full analysis as JSON instead of a table")
    ap.add_argument("--check", action="store_true",
                    help="validate the trace (exit 1 on any failure)")
    ap.add_argument("--min-coverage", type=float, default=0.9,
                    help="--check: minimum accounted step-time fraction")
    args = ap.parse_args(argv)
    if args.check:
        failures = check(args.trace_dir, min_coverage=args.min_coverage)
        if failures:
            for f in failures:
                print(f"CHECK FAIL: {f}", file=sys.stderr)
            return 1
        rep = analyze(args.trace_dir)
        print(
            f"trace OK: {rep['num_ranks']} rank(s), "
            f"{rep['cluster']['steps']} steps, "
            f"coverage {rep['cluster']['coverage']:.1%}, "
            f"barrier {rep['cluster']['barrier_ms_per_step']} ms/step"
        )
        return 0
    rep = analyze(args.trace_dir)
    print(json.dumps(rep, indent=1, sort_keys=True) if args.json
          else _render(rep))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
