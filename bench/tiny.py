"""Tiny versions of the benchmark's cells, for the CPU tests: the same
files' configurations and traffic with every size cut, and the port in
float32 where the configuration says so.

A cell's cut is ``cuts/<cell>.json``: ``model`` (configuration changes),
``traffic`` (traffic changes) and, where the control's test needs larger
sizes, ``control`` with its own ``model`` and ``traffic``: at the smallest
sizes a lower precision's rounding has too few products to add up in."""
from __future__ import annotations

import json

from bench import kinds, manifest
from bench.traffic import generator

#: every cell with a cut file: {cell: its cut}
CUTS = {p.stem: json.loads(p.read_text())
        for p in sorted((manifest.HERE / "cuts").glob("*.json"))}


def cell(name: str, dtype: str | None = None, control: bool = False) -> tuple[dict, dict]:
    """(configuration, traffic) of cell ``name`` cut to a CPU test's size
    (with ``control``, the control test's); ``dtype`` sets the kind's
    ``DTYPE_KEYS`` (an LM's parameter and compute dtype)."""
    wl = manifest.workload(name)
    config, mix = manifest.config(wl["config"]), generator.load(wl["traffic"])
    cut = CUTS[name]
    if control:
        cut = cut.get("control", cut)
    config["model"].update(cut["model"])
    if dtype is not None:
        config["model"].update(dict.fromkeys(kinds.get(config["kind"]).DTYPE_KEYS, dtype))
    mix.update(cut["traffic"])
    return config, mix
