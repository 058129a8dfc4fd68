"""``BENCHMARK.json`` and the files it names, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json`` and ``metrics/<metric>.py``."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

__all__ = ["ROOT", "HERE", "load", "workload", "config", "metric_reader", "cell_metrics",
           "NAME", "UNIT"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(name: str) -> dict:
    """The cell's file: its configuration, traffic, chips, why and limits."""
    return json.loads((HERE / "workloads" / f"{name}.json").read_text())


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def metric_reader(name: str):
    """The module of the per-layer metric ``name`` (``metrics/<name>.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, part: str) -> list:
    """The entries of ``part`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those listing it under ``workloads``, and those without
    the key whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in bench[part]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif part == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out
