"""A decoder LM's training loss in plain PyTorch, float32: the dense and
hybrid (Hymba) families as the configuration files describe them.

Written from the published descriptions, in the layout the benchmark's
weights come in (``bench/traffic/weights.py``: per-layer leaves stacked on a
leading [L] axis):

* RMSNorm ``x / sqrt(mean(x^2) + eps) * (1 + scale)``; rotary embedding on
  the two halves of each head (theta from the file); grouped-query
  attention, causal, with a sliding window (a key j is seen by query i when
  i - window < j <= i), scores scaled by 1/sqrt(head_dim);
* SwiGLU MLP ``(silu(x Wg) * (x Wu)) Wo``;
* hybrid (Hymba, arXiv:2411.13676): an attention and a Mamba-1 branch read
  the same normed input and are mean-fused, the SSM's output normed first:
  ``x + 0.5 (attn + rmsnorm(ssm))``; then the MLP.  Departures from the
  published Hymba that the configuration states: no meta tokens, no
  cross-layer KV sharing, every layer windowed;
* Mamba-1 (arXiv:2312.00752): in_proj to (x, z), a causal depthwise
  convolution of ``ssm_conv`` taps with bias and SiLU, x_proj to (dt, B,
  C), dt = softplus(dt dt_proj + dt_bias), A = -exp(a_log), the selective
  scan (``scan.py``) with the skip D, times silu(z), out_proj;
* the loss: the final norm, logits over the vocabulary, and the mean over
  the rows' tokens of the next-token negative log-likelihood.

Each row runs alone and each layer is recomputed in the backward
(``torch.utils.checkpoint``), so the live activations are one layer's of
one row.  ``rnd`` rounds every product's operands and result and every
activation the configuration keeps in its compute dtype (the control);
left at float32 it rounds nothing."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.counts.models import lm_dims
from bench.reference.common import Rounding
from bench.reference.scan import selective_scan

__all__ = ["row_nll"]


def _norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def _rope(x, theta):
    """x [H, S, hd]: rotate (x1, x2) halves by position * theta^(-i/half)."""
    s, hd = x.shape[1], x.shape[2]
    half = hd // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device)
                      * (-math.log(theta) / half))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(h, lp, z, theta, rnd):
    """h [S, d] -> [S, d]."""
    s = h.shape[0]
    q = rnd.einsum("sd,dhk->hsk", h, lp["wq"])
    k = rnd.einsum("sd,dhk->hsk", h, lp["wk"])
    v = rnd.einsum("sd,dhk->hsk", h, lp["wv"])
    if z["bias"]:
        q = q + lp["bq"][:, None]
        k = k + lp["bk"][:, None]
        v = v + lp["bv"][:, None]
    if theta > 0:
        q, k = _rope(q, theta), _rope(k, theta)
    q, k, v = rnd.act(q), rnd.act(k), rnd.act(v)
    rep = z["h"] // z["k"]
    k = k.repeat_interleave(rep, dim=0)   # query head j reads kv head j // rep
    v = v.repeat_interleave(rep, dim=0)
    scores = rnd.einsum("hqk,hsk->hqs", q, k) / math.sqrt(z["hd"])
    i = torch.arange(s, device=h.device)
    ok = i[None, :] <= i[:, None]
    if z["window"] > 0:
        ok &= i[:, None] - i[None, :] < z["window"]
    p = torch.softmax(scores.masked_fill(~ok, float("-inf")), dim=-1)
    out = rnd.act(rnd.einsum("hqs,hsk->hqk", p, v))
    return rnd.einsum("hsk,hkd->sd", out, lp["wo"])


def _mamba(h, p, z, rnd):
    di, n, r, ck = z["di"], z["n"], z["r"], z["ck"]
    xz = rnd.mm(h, p["in_proj"])
    xin, zg = xz[:, :di], xz[:, di:]
    xp = F.pad(xin, (0, 0, ck - 1, 0))
    s = xin.shape[0]
    conv = p["conv_b"] + sum(xp[j:j + s] * p["conv_w"][j] for j in range(ck))
    xc = rnd.act(F.silu(conv))
    dbc = rnd.mm(xc, p["x_proj"])
    dt = rnd.act(F.softplus(rnd.mm(dbc[:, :r], p["dt_proj"]) + p["dt_bias"]))
    y = selective_scan(xc, dt, -torch.exp(p["a_log"]), dbc[:, r:r + n].contiguous(),
                       dbc[:, r + n:].contiguous(), p["d_skip"])
    return rnd.mm(rnd.act(y * F.silu(zg)), p["out_proj"])


def _mlp(x, lp, rnd):
    hidden = rnd.act(F.silu(rnd.mm(x, lp["wi_gate"])) * rnd.mm(x, lp["wi_up"]))
    return rnd.mm(hidden, lp["wo_mlp"])


def _layer(x, lp, z, eps, theta, rnd):
    h = rnd.act(_norm(x, lp["ln1"], eps))
    if z["family"] == "ssm":
        return rnd.act(x + _mamba(h, lp["ssm"], z, rnd))
    mix = _attention(h, lp, z, theta, rnd)
    if z["family"] == "hybrid":
        ssm = rnd.act(_norm(_mamba(h, lp["ssm"], z, rnd), lp["ln_ssm"], eps))
        mix = rnd.act(0.5 * (mix + ssm))
    x = rnd.act(x + mix)
    return rnd.act(x + _mlp(rnd.act(_norm(x, lp["ln2"], eps)), lp, rnd))


def _layer_params(params: dict, i: int) -> dict:
    out = {"ssm": {}}
    for name, t in params.items():
        if not name.startswith("layers."):
            continue
        parts = name.split(".")
        if parts[1] == "ssm":
            out["ssm"][parts[2]] = t[i]
        else:
            out[parts[1]] = t[i]
    return out


def row_nll(params: dict, tokens: torch.Tensor, labels: torch.Tensor, model: dict,
            rnd: Rounding | None = None) -> torch.Tensor:
    """Σ over one row's positions of the next-token NLL (float32).
    tokens, labels [S] int64."""
    rnd = rnd or Rounding()
    z = lm_dims(model)
    eps, theta = model.get("norm_eps", 1e-6), model.get("rope_theta", 1e4)
    x = rnd.act(params["embed"][tokens])
    for i in range(z["layers"]):
        lp = _layer_params(params, i)
        x = checkpoint(_layer, x, lp, z, eps, theta, rnd, use_reentrant=False,
                       preserve_rng_state=False)
    x = rnd.act(_norm(x, params["final_norm"], eps))
    w = params["embed"].T if z["tied"] else params["unembed"]

    def nll(x, w):
        logits = rnd.mm(x, w)
        return (torch.logsumexp(logits, -1) - logits.gather(-1, labels[:, None])[:, 0]).sum()

    return checkpoint(nll, x, w, use_reentrant=False, preserve_rng_state=False)
