"""Decoder LMs (``configs/<name>.json`` with ``"kind": "lm"``), trained
through the port's ``launch/train.py``: its ``make_step`` and
``make_batch_fn``, the SOLAR rows split into ``grad_accum`` microbatches.

The weights are those of the port's dense, ssm and hybrid families (flat
names, per-layer leaves stacked on [L]), with the port's init scales: a
normal draw over sqrt(fan-in), norm scales 0 (the norm multiplies by 1 +
scale), zero biases; Mamba's dt bias softplus^-1(1), a_log log(1..N), D 1
(arXiv:2312.00752's init).  A configuration's ``init`` block may ask for two
more of the published inits: ``residual_scale`` divides the draws of the
projections that write into the residual stream (attention's ``wo``, the
MLP's ``wo_mlp``, Mamba's ``out_proj``) by sqrt(2 L) (GPT-2's init,
arXiv:1908.09203 §2.3), and ``dt_min``/``dt_max`` spread Mamba's dt over
the channels log-evenly between them, the bias being softplus^-1(dt)
(arXiv:2312.00752 §3.6).  The store's rows are ``seq_len + 1`` token ids
drawn uniformly from the vocabulary."""
from __future__ import annotations

import argparse
import math

import torch

from bench.counts.models import lm_dims, lm_train_flops
from bench.reference import lm

RATE = ("train_tokens_per_s", "tokens/s")
UNIT_NAME = "tokens"
DTYPE_KEYS = ("param_dtype", "compute_dtype")
#: the reference runs row by row: the control's CPU test follows two rows
#: of each checked step
CONTROL_ROWS = 2
PROGRAM_LOSS = ("repro_torch.models.lm", "train_loss")


def units_per_row(config: dict, mix: dict) -> int:
    return mix["seq_len"]


def model_flops_per_row(config: dict, mix: dict) -> float:
    return lm_train_flops(config["model"], 1, mix["seq_len"])


def program(config: dict, device):
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train

    cfg = get_config(config["arch"]).replace(**config["model"])
    o = config["optimizer"]
    opt, step = launch_train.make_step(
        cfg, argparse.Namespace(lr=o["lr"], steps=o["total_steps"]))
    return cfg, opt, step


def make_batch(cfg, capacity: int):
    from repro_torch.launch import train as launch_train

    return launch_train.make_batch_fn(cfg, capacity)


def batch_rows(batch: dict) -> dict:
    return {"tokens": batch["tokens"], "labels": batch["labels"]}


def expected_rows(rows: torch.Tensor, config: dict) -> dict:
    return {"tokens": rows[:, :-1].to(torch.int32), "labels": rows[:, 1:].to(torch.int32)}


def reference_step(params: dict, rows: torch.Tensor, config: dict, mix: dict, rnd):
    """Loss and gradients of one step over ``rows`` ([B, seq_len + 1] token
    ids): the mean NLL over every position of every row, one row at a time."""
    for p in params.values():
        p.grad = None
    rows = rows.long()
    denom = rows.shape[0] * (rows.shape[1] - 1)
    total = 0.0
    for r in range(rows.shape[0]):
        nll = lm.row_nll(params, rows[r, :-1], rows[r, 1:], config["model"], rnd)
        (nll / denom).backward()
        total += float(nll.detach())
    return total / denom, {k: p.grad for k, p in params.items()}


def layout(config: dict) -> list:
    m, init = config["model"], config.get("init", {})
    z = lm_dims(m)
    res = 1 / math.sqrt(2 * z["layers"]) if init.get("residual_scale") else 1.0
    dt_init = (("dt_range", (init["dt_min"], init["dt_max"])) if "dt_min" in init
               else ("const", math.log(math.e - 1)))
    pd = m.get("param_dtype", "float32")
    n, d, h, k, hd, f, v = (z["layers"], z["d"], z["h"], z["k"], z["hd"], z["f"],
                            z["v"])
    out = [("embed", (v, d), pd, ("normal", 1 / math.sqrt(d))),
           ("final_norm", (d,), pd, ("const", 0.0)),
           ("layers.ln1", (n, d), pd, ("const", 0.0)),
           ("layers.ln2", (n, d), pd, ("const", 0.0))]
    if z["family"] != "ssm":
        out += [("layers.wq", (n, d, h, hd), pd, ("normal", 1 / math.sqrt(d))),
                ("layers.wk", (n, d, k, hd), pd, ("normal", 1 / math.sqrt(d))),
                ("layers.wv", (n, d, k, hd), pd, ("normal", 1 / math.sqrt(d))),
                ("layers.wo", (n, h, hd, d), pd, ("normal", res / math.sqrt(h * hd)))]
        if z["bias"]:
            out += [("layers.bq", (n, h, hd), pd, ("const", 0.0)),
                    ("layers.bk", (n, k, hd), pd, ("const", 0.0)),
                    ("layers.bv", (n, k, hd), pd, ("const", 0.0))]
        out += [("layers.wi_gate", (n, d, f), pd, ("normal", 1 / math.sqrt(d))),
                ("layers.wi_up", (n, d, f), pd, ("normal", 1 / math.sqrt(d))),
                ("layers.wo_mlp", (n, f, d), pd, ("normal", res / math.sqrt(f)))]
    if z["family"] in ("ssm", "hybrid"):
        di, ns, r, ck = z["di"], z["n"], z["r"], z["ck"]
        out += [("layers.ssm.in_proj", (n, d, 2 * di), pd, ("normal", 1 / math.sqrt(d))),
                ("layers.ssm.conv_w", (n, ck, di), pd, ("normal", 1 / math.sqrt(ck))),
                ("layers.ssm.conv_b", (n, di), pd, ("const", 0.0)),
                ("layers.ssm.x_proj", (n, di, r + 2 * ns), pd,
                 ("normal", 1 / math.sqrt(di))),
                ("layers.ssm.dt_proj", (n, r, di), pd, ("normal", 1 / math.sqrt(r))),
                ("layers.ssm.dt_bias", (n, di), pd, dt_init),
                ("layers.ssm.a_log", (n, di, ns), "float32", ("a_log", None)),
                ("layers.ssm.d_skip", (n, di), "float32", ("const", 1.0)),
                ("layers.ssm.out_proj", (n, di, d), pd, ("normal", res / math.sqrt(di)))]
        if z["family"] == "hybrid":
            out.append(("layers.ln_ssm", (n, d), pd, ("const", 0.0)))
    if not z["tied"]:
        out.append(("unembed", (d, v), pd, ("normal", 1 / math.sqrt(d))))
    return out


def data(config: dict, mix: dict, gen, device) -> torch.Tensor:
    shape = (mix["num_samples"], mix["seq_len"] + 1)
    return torch.randint(0, config["model"]["vocab_size"], shape, generator=gen,
                         device=device, dtype=torch.int64).to(torch.int32)
