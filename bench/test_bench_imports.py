"""Nothing the benchmark loads on the card is JAX, jaxlib, flax or the JAX
package (top-level module names compared whole), and the command refuses
to print a result without a card or without the port."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import bench.run as run
run._environment()
import bench.cell, bench.follow, bench.devtrace, bench.readers, bench.compare
import bench.reference.lm, bench.reference.cnn, bench.reference.scan, bench.reference.solar
import bench.kinds.lm, bench.kinds.surrogate
from bench import manifest
for m in manifest.load()["per_layer"]:
    manifest.metric_reader(m["name"])
# what cell.run and the kinds import of the port
import repro_torch.data, repro_torch.train.step, repro_torch.train.trainer
import repro_torch.launch.train, repro_torch.launch.train_surrogate, repro_torch.configs
import repro_torch.models.lm, repro_torch.models.cnn
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _clean_env():
    import os

    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_harness_reference_and_port_paths_load_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=240, env=_clean_env(),
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in names and "bench" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_forbidden_modules_compare_whole_top_level_names():
    from bench import run

    assert run.forbidden_modules(["repro_torch", "repro_torch.train", "reprox", "jaxtyping"]) == []
    assert run.forbidden_modules(["repro.data", "torch"]) == ["repro"]
    assert run.forbidden_modules(["jax", "jaxlib.xla", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_no_result_without_a_card():
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "cosmoflow.solar-spill", "--seed", str(2 ** 31 + 5), "--seconds",
                          "1", "--trace", "0"], capture_output=True, text=True, timeout=240,
                         env=_clean_env(), cwd=str(ROOT))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_no_result_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time, torch; sys.path.insert(0, '.'); from bench import cell; "
            "cell.run('cosmoflow.solar-spill', 1, 1.0, False, torch.device('cpu'), "
            "time.perf_counter())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, env=_clean_env(), cwd=str(tmp_path))
    assert out.returncode != 0
    assert "repro_torch" in out.stderr
