"""Random weights from the seed, made on the device in a few large draws.

Every leaf of a dtype is a view of one flat buffer, filled from float32
normal draws of at most ``DRAW`` numbers, each leaf scaled by its own
factor and cast once; constant leaves are filled.  The layouts are those
the port's models take (flat names, per-layer leaves stacked on [L]), with
the port's init scales: a normal draw over sqrt(fan-in), norm scales 0 (the
norm multiplies by 1 + scale), zero biases; Mamba's dt bias softplus^-1(1),
a_log log(1..N), D 1 (arXiv:2312.00752's init).  A configuration's
``init`` block may ask for two more of the published inits: ``residual_scale``
divides the draws of the projections that write into the residual stream
(attention's ``wo``, the MLP's ``wo_mlp``, Mamba's ``out_proj``) by
sqrt(2 L) (GPT-2's init, arXiv:1908.09203 §2.3), and ``dt_min``/``dt_max``
spread Mamba's dt over the channels log-evenly between them, the bias being
softplus^-1(dt) (arXiv:2312.00752 §3.6).  The same seed on the same device
gives the same weights."""
from __future__ import annotations

import math

import torch

from bench.counts.models import lm_dims

__all__ = ["layout", "make", "generator"]

#: numbers a single normal draw makes
DRAW = 1 << 27

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one of the seed's streams (0 weights,
    1 data)."""
    return torch.Generator(device=device).manual_seed((seed * 2 + stream) % (1 << 63))


def _lm_layout(m: dict, init: dict) -> list:
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


def _cnn_layout(m: dict) -> list:
    out = []
    c = m["input_shape"][-1]
    spatial = list(m["input_shape"][:-1])
    for i in range(m["depth"]):
        co = m["base_channels"] * 2 ** i
        out += [(f"enc.{i}.w", (co, c, 3, 3, 3), "float32", ("normal", 1 / math.sqrt(c * 27))),
                (f"enc.{i}.b", (co,), "float32", ("const", 0.0))]
        c = co
        spatial = [-(-s // 2) for s in spatial]
    flat = c * math.prod(spatial)
    outs = m["output_shape"][0]
    out += [("head.w1", (flat, 128), "float32", ("normal", 1 / math.sqrt(flat))),
            ("head.b1", (128,), "float32", ("const", 0.0)),
            ("head.w2", (128, outs), "float32", ("normal", 1 / math.sqrt(128))),
            ("head.b2", (outs,), "float32", ("const", 0.0))]
    return out


def layout(config: dict) -> list:
    """``[(name, shape, dtype name, (init, arg)), ...]`` of a configuration
    file's model, in the order the port's init gives its leaves."""
    if config["kind"] == "lm":
        return _lm_layout(config["model"], config.get("init", {}))
    if config["kind"] == "surrogate":
        return _cnn_layout(config["model"])
    raise ValueError(f"no weight layout for kind {config['kind']!r}")


def make(config: dict, seed: int, device) -> dict:
    """The weights of ``config`` from ``seed``: ``{name: tensor}``."""
    leaves = layout(config)
    gen = generator(seed, 0, device)
    flats, offsets, totals = {}, {}, {}
    for name, shape, dt, _ in leaves:
        offsets[name] = totals.get(dt, 0)
        totals[dt] = offsets[name] + math.prod(shape)
    for dt, total in totals.items():
        flats[dt] = torch.empty(total, dtype=_DTYPES[dt], device=device)
    out = {name: flats[dt][offsets[name]:offsets[name] + math.prod(shape)].view(shape)
           for name, shape, dt, _ in leaves}
    normal = [(name, math.prod(shape), init[1]) for name, shape, _, init in leaves
              if init[0] == "normal"]
    # one stream of draws over the normal leaves in order, DRAW numbers a call
    todo = sum(n for _, n, _ in normal)
    leaf, done_in_leaf = 0, 0
    while todo:
        chunk = torch.randn(min(DRAW, todo), generator=gen, device=device,
                            dtype=torch.float32)
        used = 0
        while used < chunk.numel():
            name, n, scale = normal[leaf]
            take = min(n - done_in_leaf, chunk.numel() - used)
            dst = out[name].view(-1)[done_in_leaf:done_in_leaf + take]
            dst.copy_(chunk[used:used + take] * scale)
            used += take
            done_in_leaf += take
            if done_in_leaf == n:
                leaf, done_in_leaf = leaf + 1, 0
        todo -= chunk.numel()
        del chunk
    for name, shape, dt, (init, arg) in leaves:
        if init == "const":
            out[name].fill_(arg)
        elif init == "dt_range":
            lo, hi = math.log(arg[0]), math.log(arg[1])
            dt = torch.exp(torch.linspace(lo, hi, shape[-1], dtype=torch.float64,
                                          device=device))
            out[name].copy_(torch.log(torch.expm1(dt)).float().expand(shape))
        elif init == "a_log":
            out[name].copy_(torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                                   device=device)).expand(shape))
    return out
