"""Model FLOPs of a training step, counted from a configuration file's
sizes (no recomputation, no padding rows): the numerators of ``mfu.*``.

The LM count is ``launch/roofline.model_flops``'s 6·N·tokens, with N the
parameters that take part in a product (the input embedding is a lookup
and is left out), plus attention's score and value products over the
scores its masks admit (12·hd a score: 4·hd forward, 8·hd backward).  The
CNN count is three times each convolution's and the head's forward
multiply-adds (two FLOPs each), from the shapes a stride-2 "SAME"
convolution gives."""
from __future__ import annotations

import math

from bench.counts.kernels import admitted_scores


def lm_dims(m: dict) -> dict:
    """Resolved sizes of an LM configuration's ``model`` block."""
    d = m["d_model"]
    return {
        "d": d, "h": m["num_heads"], "k": m["num_kv_heads"],
        "hd": m.get("head_dim") or d // m["num_heads"], "f": m["d_ff"],
        "v": m["vocab_size"], "layers": m["num_layers"], "family": m["family"],
        "n": m.get("ssm_state", 0), "di": m.get("ssm_expand", 2) * d,
        "r": m.get("ssm_dt_rank") or math.ceil(d / 16), "ck": m.get("ssm_conv", 4),
        "window": m.get("sliding_window", 0) if m["family"] == "hybrid" else 0,
        "tied": bool(m.get("tie_embeddings", False)), "bias": bool(m.get("qkv_bias", False)),
    }


def lm_matmul_params(m: dict) -> int:
    """Parameters that take part in a product: every layer's projections,
    MLP, Mamba mixer, and the output head (the tied embedding counts once,
    as the head)."""
    z = lm_dims(m)
    d, h, k, hd, f = z["d"], z["h"], z["k"], z["hd"], z["f"]
    per = 0
    if z["family"] != "ssm":
        per += d * h * hd + 2 * d * k * hd + h * hd * d
        per += (h + 2 * k) * hd if z["bias"] else 0
        per += 3 * d * f
    if z["family"] in ("ssm", "hybrid"):
        di, n, r = z["di"], z["n"], z["r"]
        per += d * 2 * di + di * z["ck"] + di * (r + 2 * n) + r * di + di * d
    return z["layers"] * per + d * z["v"]


def lm_train_flops(m: dict, rows: int, seq: int) -> float:
    """Model FLOPs of training ``rows`` sequences of ``seq`` tokens."""
    z = lm_dims(m)
    flops = 6.0 * lm_matmul_params(m) * rows * seq
    if z["family"] != "ssm":
        scores = admitted_scores(seq, seq, True, z["window"])
        flops += 12.0 * z["hd"] * z["h"] * scores * z["layers"] * rows
    return flops


def cnn_forward_flops(m: dict) -> float:
    """Forward FLOPs of one sample through CosmoFlow's encoder (stride-2
    3x3x3 "SAME" convolutions, channels doubling from ``base_channels``)
    and its two-layer head (128 hidden units)."""
    if m["kind"] != "cosmoflow":
        raise ValueError(f"no FLOP count for surrogate kind {m['kind']!r}")
    spatial = list(m["input_shape"][:-1])
    cin = m["input_shape"][-1]
    flops = 0.0
    for i in range(m["depth"]):
        cout = m["base_channels"] * 2 ** i
        spatial = [math.ceil(s / 2) for s in spatial]
        flops += 2.0 * math.prod(spatial) * cout * cin * 27
        cin = cout
    flat = cin * math.prod(spatial)
    flops += 2.0 * (flat * 128 + 128 * m["output_shape"][0])
    return flops


def cnn_train_flops(m: dict, rows: int) -> float:
    return 3.0 * cnn_forward_flops(m) * rows
