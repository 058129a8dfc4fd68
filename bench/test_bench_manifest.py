"""BENCHMARK.json against the contract's shape and against the files it
names: every name and unit in its alphabet, every configuration, traffic,
cell and per-layer metric in a file of its own, and every per-layer metric
moving an end-to-end metric that its cells report."""
from __future__ import annotations

import json
import math
import re

import pytest

from bench import kinds, manifest
from bench.traffic import generator

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_command_and_paths_stay_inside_the_benchmark():
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(LINE.match(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
        assert (manifest.ROOT / p).is_dir()
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_lines_use_the_allowed_characters(entry):
    assert manifest.NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert LINE.match(entry[key])
    if "unit" in entry:
        assert manifest.UNIT.match(entry["unit"])
    for key in ("config", "traffic"):
        if key in entry:
            assert manifest.NAME.match(entry[key])


def test_names_are_unique():
    for part in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[part]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_each_configuration_has_its_file(entry):
    cfg = manifest.config(entry["name"])
    assert entry["file"] == f"bench/configs/{entry['name']}.json"
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    assert all(manifest.NAME.match(k) for k in entry["reduced"])
    assert not any(k.endswith(("_dim", "_rank")) for k in entry["reduced"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    kinds.get(cfg["kind"])


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_has_its_file_traffic_and_limits(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = manifest.workload(cell)
    assert {k: wl[k] for k in ("config", "traffic", "chips", "why")} == {
        k: entry[k] for k in ("config", "traffic", "chips", "why")}
    assert cell == f"{entry['config']}.{entry['traffic']}"
    assert entry["chips"] in (1, 4)
    generator.load(entry["traffic"])
    assert set(wl["limits"]) <= {"batch_faults", "loss_gap", "grad_gap", "update_gap",
                                 "grad_err", "update_err"}
    assert wl["limits"]["batch_faults"] == 0 and len(wl["limits"]) >= 2
    assert all(v >= 0 for v in wl["limits"].values())


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, math.floor(len(CELLS) / 4))


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e = {m["name"] for m in manifest.cell_metrics(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    kind = kinds.get(manifest.config(manifest.workload(cell)["config"])["kind"])
    # besides set-up and the kind's rate, an end-to-end metric has a reader
    for name in e2e - {"setup_s", kind.RATE[0]}:
        m = next(x for x in BENCH["end_to_end"] if x["name"] == name)
        reader = manifest.metric_reader(name)
        assert (reader.UNIT, reader.SOURCE, reader.BETTER) == (
            m["unit"], m["source"], m["better"])
    assert manifest.cell_metrics(BENCH, cell, "per_layer")


def test_end_to_end_metrics_have_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("name", PER_LAYER)
def test_each_per_layer_metric_has_its_reader_and_agrees_with_it(name):
    m = next(x for x in BENCH["per_layer"] if x["name"] == name)
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    reader = manifest.metric_reader(name)
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES, reader.BETTER) == (
        m["layer"], m["unit"], m["source"], m["moves"], m["better"])
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    # without ``workloads`` a metric goes to every cell that reports what it moves
    cells = m.get("workloads") or [c for c in CELLS
                                   if m in manifest.cell_metrics(BENCH, c, "per_layer")]
    assert cells, name
    for cell in cells:
        e2e = {x["name"] for x in manifest.cell_metrics(BENCH, cell, "end_to_end")}
        assert m["moves"] in e2e, (name, cell)
    if name.endswith("_roofline") or "mfu" in name:
        assert m["unit"] == "%"


def test_metrics_of_one_layer_name_it_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"entry", "trainer", "loader", "model step", "kernels", "device"}


#: what each accepted cell reports; a metric names its cells, so a cell that
#: a later change adds inherits no reader it does not list
REPORTS = {
    "cosmoflow.solar-spill": (
        ["device_ms_per_sample", "setup_s"],
        ["batch_load_ms.surrogate", "device_step_ms.surrogate", "idle_share.surrogate",
         "loader_wait_ms.surrogate", "mfu.surrogate", "pad_share.surrogate",
         "pfs_reads_per_step", "samples_per_s.surrogate", "step_compute_ms.surrogate",
         "step_ms_p95.surrogate"]),
    "hymba-1.5b.train-solar-2k": (
        ["train_tokens_per_s", "setup_s"],
        ["batch_load_ms.lm", "device_step_ms.lm", "idle_share.lm", "k2_roofline",
         "k3_roofline", "loader_wait_ms.lm", "mfu.lm", "pad_share.lm", "step_compute_ms.lm"]),
}


@pytest.mark.parametrize("cell", sorted(REPORTS))
def test_each_accepted_cell_reports_the_metrics_it_reported(cell):
    assert ([m["name"] for m in manifest.cell_metrics(BENCH, cell, "end_to_end")],
            [m["name"] for m in manifest.cell_metrics(BENCH, cell, "per_layer")]) == REPORTS[cell]


def test_every_per_layer_metric_lists_its_cells():
    assert all(m.get("workloads") for m in BENCH["per_layer"])
