"""Decoders whose layers are of two kinds in one stack, Mamba-1 mixers and
attention, each followed by the SwiGLU MLP (``configs/<name>.json`` with
``"kind": "interleaved"``; AI21-Jamba2-3B).  The program, batches, rate and
store rows are the decoder LMs' (``bench/kinds/lm.py``); the weights, the
model FLOPs and the reference step are this stack's own.

The weights are the port's interleaved family: the norms and the MLP
stacked on all L layers, ``layers.attn.*`` on the attention layers and
``layers.ssm.*`` (Mamba's, with the dt, B and C norm scales) on the Mamba
layers, the embedding tied to the head.  The inits are ``lm.py``'s: a normal
draw over sqrt(fan-in), norm scales 0 (the norm multiplies by 1 + scale),
zero biases, a_log log(1..N), D 1; a configuration's ``init`` block may ask
for the residual scaling over sqrt(2 L) and Mamba's dt spread log-evenly
between ``dt_min`` and ``dt_max``."""
from __future__ import annotations

import math

import torch

from bench.counts.kernels import admitted_scores
from bench.counts.models import lm_dims
from bench.kinds.lm import (CONTROL_ROWS, DTYPE_KEYS, RATE, UNIT_NAME, batch_rows, data,
                            expected_rows, make_batch, program, units_per_row)
from bench.reference import jamba

__all__ = ["RATE", "UNIT_NAME", "DTYPE_KEYS", "CONTROL_ROWS", "PROGRAM_LOSS",
           "units_per_row", "model_flops_per_row", "program", "make_batch", "batch_rows",
           "expected_rows", "reference_step", "layout", "data"]

PROGRAM_LOSS = ("repro_torch.models.lm", "train_loss")


def matmul_params(m: dict) -> int:
    """Parameters that take part in a product: every layer's MLP, the
    attention layers' projections, the Mamba layers' mixer (its
    depthwise convolution included), and the tied head once."""
    z = lm_dims(m)
    d, h, k, hd, f = z["d"], z["h"], z["k"], z["hd"], z["f"]
    di, n, r = z["di"], z["n"], z["r"]
    kinds = jamba.layer_kinds(m)
    attn = d * h * hd + 2 * d * k * hd + h * hd * d
    mamba = d * 2 * di + di * z["ck"] + di * (r + 2 * n) + r * di + di * d
    return (z["layers"] * 3 * d * f + kinds.count("attention") * attn
            + kinds.count("mamba") * mamba + d * z["v"])


def model_flops_per_row(config: dict, mix: dict) -> float:
    """6 x the matmul parameters x the row's tokens, plus 12 hd FLOPs for
    each score the causal mask admits in each head of each attention
    layer."""
    m, s = config["model"], mix["seq_len"]
    z = lm_dims(m)
    scores = admitted_scores(s, s, True, 0) * z["h"] * jamba.layer_kinds(m).count("attention")
    return 6.0 * matmul_params(m) * s + 12.0 * z["hd"] * scores


def reference_step(params: dict, rows: torch.Tensor, config: dict, mix: dict, rnd):
    """Loss and gradients of one step over ``rows`` ([B, seq_len + 1] token
    ids): the mean NLL over every position of every row, one row at a time."""
    for p in params.values():
        p.grad = None
    rows = rows.long()
    denom = rows.shape[0] * (rows.shape[1] - 1)
    total = 0.0
    for r in range(rows.shape[0]):
        nll = jamba.row_nll(params, rows[r, :-1], rows[r, 1:], config["model"], rnd)
        (nll / denom).backward()
        total += float(nll.detach())
    return total / denom, {k: p.grad for k, p in params.items()}


def layout(config: dict) -> list:
    m, init = config["model"], config.get("init", {})
    z = lm_dims(m)
    kinds = jamba.layer_kinds(m)
    n, d, h, k, hd, f, v = (z["layers"], z["d"], z["h"], z["k"], z["hd"], z["f"], z["v"])
    na, nm = kinds.count("attention"), kinds.count("mamba")
    di, ns, r, ck = z["di"], z["n"], z["r"], z["ck"]
    res = 1 / math.sqrt(2 * n) if init.get("residual_scale") else 1.0
    dt_init = (("dt_range", (init["dt_min"], init["dt_max"])) if "dt_min" in init
               else ("const", math.log(math.e - 1)))
    pd = m.get("param_dtype", "float32")
    zero = ("const", 0.0)
    return [("embed", (v, d), pd, ("normal", 1 / math.sqrt(d))),
            ("final_norm", (d,), pd, zero),
            ("layers.ln1", (n, d), pd, zero),
            ("layers.ln2", (n, d), pd, zero),
            ("layers.wi_gate", (n, d, f), pd, ("normal", 1 / math.sqrt(d))),
            ("layers.wi_up", (n, d, f), pd, ("normal", 1 / math.sqrt(d))),
            ("layers.wo_mlp", (n, f, d), pd, ("normal", res / math.sqrt(f))),
            ("layers.attn.wq", (na, d, h, hd), pd, ("normal", 1 / math.sqrt(d))),
            ("layers.attn.wk", (na, d, k, hd), pd, ("normal", 1 / math.sqrt(d))),
            ("layers.attn.wv", (na, d, k, hd), pd, ("normal", 1 / math.sqrt(d))),
            ("layers.attn.wo", (na, h, hd, d), pd, ("normal", res / math.sqrt(h * hd))),
            ("layers.ssm.in_proj", (nm, d, 2 * di), pd, ("normal", 1 / math.sqrt(d))),
            ("layers.ssm.conv_w", (nm, ck, di), pd, ("normal", 1 / math.sqrt(ck))),
            ("layers.ssm.conv_b", (nm, di), pd, zero),
            ("layers.ssm.x_proj", (nm, di, r + 2 * ns), pd, ("normal", 1 / math.sqrt(di))),
            ("layers.ssm.dt_norm", (nm, r), pd, zero),
            ("layers.ssm.b_norm", (nm, ns), pd, zero),
            ("layers.ssm.c_norm", (nm, ns), pd, zero),
            ("layers.ssm.dt_proj", (nm, r, di), pd, ("normal", 1 / math.sqrt(r))),
            ("layers.ssm.dt_bias", (nm, di), pd, dt_init),
            ("layers.ssm.a_log", (nm, di, ns), "float32", ("a_log", None)),
            ("layers.ssm.d_skip", (nm, di), "float32", ("const", 1.0)),
            ("layers.ssm.out_proj", (nm, di, d), pd, ("normal", res / math.sqrt(di)))]
