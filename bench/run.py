"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared beside its
limit).  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics, read by ``bench/metrics/<name>.py`` from the
window and a profiled stretch after it.  Exits non-zero, printing no
result, without a CUDA card or with fewer than the cell asks for, and when
JAX or the JAX package is loaded once the window has closed."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no JAX through
    ``transformers``; the port and this package importable."""
    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # the script's own directory would shadow standard modules by this
    # package's file names: import the package from the checkout's root
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != Path(here)]
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules(modules=None) -> list:
    """Loaded modules (``sys.modules`` by default) whose top-level name is
    JAX's, jaxlib's, flax's or the JAX package's, compared whole."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(out: dict, cell: str, trace: bool, device) -> dict:
    """The printed JSON object."""
    import torch

    from bench import manifest

    bench = manifest.load()
    r = out["readings"]
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    metrics = {}
    if not trace:
        from bench import readers

        name, unit = r.kind.RATE
        values = {name: readers.window_rate(r), "setup_s": out["setup_s"]}
        for m in manifest.cell_metrics(bench, cell, "end_to_end"):
            # an end-to-end metric other than the kind's rate and set-up is
            # read by its own file, as a per-layer one is
            value = values[m["name"]] if m["name"] in values else (
                manifest.metric_reader(m["name"]).read(r))
            if value is None:
                raise RuntimeError(f"cell {cell} reports no {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        line = {"correct": out["correct"], "attempted": out["attempted"],
                "failed": out["failed"], "metrics": metrics, "device": dev}
    else:
        for m in manifest.cell_metrics(bench, cell, "per_layer"):
            value = manifest.metric_reader(m["name"]).read(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = r.trace.busy_s
        dev["window_s"] = r.trace.window_s
        line = {"correct": out["correct"], "attempted": out["attempted"],
                "failed": out["failed"], "metrics": metrics, "device": dev,
                "breakdown": {"device_ops": r.trace.top_device_ops(),
                              "idle_gaps": r.trace.idle_gaps()}}
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    import torch

    from bench import cell, manifest

    wl = manifest.workload(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the port on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    # a run that reports an end-to-end metric of the device's trace traces
    # its window
    trace_window = not args.trace and any(
        m["source"] == "device_trace"
        for m in manifest.cell_metrics(manifest.load(), args.workload, "end_to_end"))
    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace), device, T_START,
                   trace_window=trace_window, log=lambda *a: print(*a, file=sys.stderr))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    line = result_line(out, args.workload, bool(args.trace), device)
    parts = {k: round(1e3 * sum(s[k] for s in out["readings"].steps)
                      / max(1, len(out["readings"].steps)), 3)
             for k in ("wait_s", "load_s", "compute_s")}
    from bench import readers

    print(json.dumps({"why": out["why"], "steps_window": out["steps_window"],
                      "window_step_ms": parts,
                      "window_rate": readers.window_rate(out["readings"])}), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
