"""The kind contract (``bench/kinds/__init__.py``): every kind module
provides it, and a new architecture enters the benchmark as new files only.
A copy of the benchmark gains a toy kind (the port's LM program and
batches, a layout and a dense reference of its own), its configuration,
traffic, cell and CPU cut, and its entries in the copy's
``BENCHMARK.json``; the copy's ``cell.run`` trains it on the CPU and reads
``correct``, no file the copy had being changed."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench import kinds, manifest

ROOT = Path(__file__).resolve().parents[1]
CONTRACT = ("RATE", "UNIT_NAME", "units_per_row", "model_flops_per_row", "program",
            "make_batch", "batch_rows", "expected_rows", "reference_step", "layout", "data",
            "DTYPE_KEYS", "CONTROL_ROWS", "PROGRAM_LOSS")
KINDS = sorted(p.stem for p in (ROOT / "bench" / "kinds").glob("*.py") if p.stem != "__init__")


def test_the_contract_is_written_down():
    missing = [n for n in CONTRACT if f"``{n}" not in kinds.__doc__]
    assert not missing, missing


@pytest.mark.parametrize("kind", KINDS)
def test_each_kind_module_provides_the_contract(kind):
    mod = kinds.get(kind)
    assert not [n for n in CONTRACT if not hasattr(mod, n)]
    assert all(callable(getattr(mod, n)) for n in CONTRACT if n[0].islower())
    name, unit = mod.RATE
    assert manifest.NAME.match(name) and manifest.UNIT.match(unit)
    module, loss = mod.PROGRAM_LOSS
    assert module.startswith("repro_torch.") and loss.isidentifier()


TOY_KIND = '''"""A toy dense LM: the port's LM program and batches; its own layout
(GPT-2's 0.02 normal, norms first) and its own dense reference."""
import math

import torch
import torch.nn.functional as F

from bench.kinds.lm import (CONTROL_ROWS, DTYPE_KEYS, PROGRAM_LOSS, RATE, UNIT_NAME,
                            batch_rows, data, expected_rows, make_batch,
                            model_flops_per_row, program, units_per_row)


def layout(config):
    m = config["model"]
    n, d, h, k, hd, f, v = (m["num_layers"], m["d_model"], m["num_heads"],
                            m["num_kv_heads"], m["head_dim"], m["d_ff"], m["vocab_size"])
    w, zero = ("normal", 0.02), ("const", 0.0)
    return [("final_norm", (d,), "float32", zero),
            ("layers.ln1", (n, d), "float32", zero),
            ("layers.ln2", (n, d), "float32", zero),
            ("layers.wi_gate", (n, d, f), "float32", w),
            ("layers.wi_up", (n, d, f), "float32", w),
            ("layers.wo_mlp", (n, f, d), "float32", w),
            ("layers.wq", (n, d, h, hd), "float32", w),
            ("layers.wk", (n, d, k, hd), "float32", w),
            ("layers.wv", (n, d, k, hd), "float32", w),
            ("layers.wo", (n, h, hd, d), "float32", w),
            ("unembed", (d, v), "float32", w),
            ("embed", (v, d), "float32", w)]


def _norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def _rope(x, theta):
    half = x.shape[-1] // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32) * (-math.log(theta) / half))
    ang = torch.arange(x.shape[-2], dtype=torch.float32)[:, None] * freqs
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * ang.cos() - x2 * ang.sin(), x2 * ang.cos() + x1 * ang.sin()], -1)


def reference_step(params, rows, config, mix, rnd):
    m = config["model"]
    for p in params.values():
        p.grad = None
    rows = rows.long()
    tokens, labels = rows[:, :-1], rows[:, 1:]
    eps, theta = m["norm_eps"], m["rope_theta"]
    rep = m["num_heads"] // m["num_kv_heads"]
    s = tokens.shape[1]
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    x = params["embed"][tokens]
    for i in range(m["num_layers"]):
        lp = {k[len("layers."):]: p[i] for k, p in params.items() if k.startswith("layers.")}
        h = _norm(x, lp["ln1"], eps)
        q = _rope(torch.einsum("bsd,dhk->bhsk", h, lp["wq"]), theta)
        k = _rope(torch.einsum("bsd,dhk->bhsk", h, lp["wk"]), theta).repeat_interleave(rep, 1)
        v = torch.einsum("bsd,dhk->bhsk", h, lp["wv"]).repeat_interleave(rep, 1)
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        att = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1) @ v
        x = x + torch.einsum("bhsk,hkd->bsd", att, lp["wo"])
        h = _norm(x, lp["ln2"], eps)
        x = x + (F.silu(h @ lp["wi_gate"]) * (h @ lp["wi_up"])) @ lp["wo_mlp"]
    logits = _norm(x, params["final_norm"], eps) @ params["unembed"]
    loss = F.cross_entropy(logits.flatten(0, 1), labels.flatten())
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in params.items()}
'''

TOY_CONFIG = {
    "name": "toy", "kind": "toy", "source": "https://arxiv.org/abs/1706.03762",
    "arch": "qwen2-0.5b",
    "model": {"family": "dense", "num_layers": 4, "d_model": 128, "num_heads": 4,
              "num_kv_heads": 2, "head_dim": 32, "d_ff": 256, "vocab_size": 512,
              "rope_theta": 10000.0, "norm_eps": 1e-6, "qkv_bias": False,
              "tie_embeddings": False, "param_dtype": "float32", "compute_dtype": "float32",
              "grad_accum": 2},
    "precision": "float32", "control": "bfloat16",
    "optimizer": {"lr": 0.001, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
                  "clip_norm": 1.0, "warmup_steps": 100, "total_steps": 100000},
    "reduced": [],
}
TOY_TRAFFIC = {"loader": "solar", "backend": "binary", "num_samples": 48, "seq_len": 64,
               "num_nodes": 2, "local_batch": 2, "buffer_size": 8, "num_workers": 1,
               "prefetch_depth": 2, "num_epochs": 4, "pfs_latency_s": 0.0,
               "warmup_steps": 3, "checked_steps": 2, "trace_steps": 1}
TOY_CELL = {"config": "toy", "traffic": "toy-train", "chips": 1,
            "why": "a toy dense LM on SOLAR batches",
            "limits": {"batch_faults": 0.0, "loss_gap": 1e-4, "grad_gap": 1e-3,
                       "update_gap": 1e-2, "grad_err": 1e-3}}
TOY_CUT = {"model": {"num_layers": 2, "d_model": 64, "d_ff": 128, "head_dim": 16},
           "traffic": {"num_samples": 24, "seq_len": 32}}

PROBE = """
import json, sys, time
import torch
from bench import cell, kinds, manifest, tiny
from bench.traffic import weights

config, mix = tiny.cell("toy.toy-train", "float32")
out = cell.run("toy.toy-train", 2 ** 31 + 29, 0.5, False, torch.device("cpu"),
               time.perf_counter(), config=config, mix=mix, full=("grad", "update"))
bench = manifest.load()
print(json.dumps({
    "correct": out["correct"], "checks": out["checks"], "numbers": out["why"]["numbers"],
    "own_layout": weights.layout(config) == kinds.get("toy").layout(config),
    "lm_layout": [x[:2] for x in kinds.get("lm").layout(config)],
    "toy_layout": [x[:2] for x in kinds.get("toy").layout(config)],
    "reports": [[m["name"] for m in manifest.cell_metrics(bench, "toy.toy-train", part)]
                for part in ("end_to_end", "per_layer")]}))
"""


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _write(path: Path, text: str) -> None:
    assert not path.exists(), path
    path.write_text(text)


def test_a_new_kind_enters_as_new_files_only(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(tmp_path)
    b = tmp_path / "bench"
    _write(b / "kinds" / "toy.py", TOY_KIND)
    _write(b / "configs" / "toy.json", json.dumps(TOY_CONFIG))
    _write(b / "traffic" / "toy-train.json", json.dumps(TOY_TRAFFIC))
    _write(b / "workloads" / "toy.toy-train.json", json.dumps(TOY_CELL))
    _write(b / "cuts" / "toy.toy-train.json", json.dumps(TOY_CUT))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({k: TOY_CONFIG[k] for k in ("name", "source", "reduced")}
                            | {"file": "bench/configs/toy.json", "why": "a toy dense LM"})
    bench["workloads"].append({"name": "toy.toy-train"}
                              | {k: TOY_CELL[k] for k in ("config", "traffic", "chips", "why")})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("train_tokens_per_s", "step_compute_ms.lm"):
            m["workloads"].append("toy.toy-train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), str(ROOT / "src")])
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                         timeout=240, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"], got["checks"]
    # the toy's own reference agrees with the port's arithmetic, not only
    # within the cell's limits
    assert got["numbers"]["loss_gap"] < 1e-5 and got["numbers"]["grad_err"] < 1e-4, got
    assert got["own_layout"] and got["toy_layout"] != got["lm_layout"]
    assert got["reports"] == [["train_tokens_per_s", "setup_s"], ["step_compute_ms.lm"]]
    after = _files(tmp_path)
    changed = sorted(k for k in before if after.get(k) != before[k])
    assert changed == ["BENCHMARK.json"], changed
