"""AI21-Jamba2-3B's training loss in plain PyTorch, float32: the layer
equations of transformers' ``models/jamba/modeling_jamba.py``, in the
layout the benchmark's weights come in (``bench/kinds/interleaved.py``:
the norms and the MLP stacked on all L layers, ``layers.attn.*`` on the
attention layers and ``layers.ssm.*`` on the Mamba layers, in layer order).

* ``JambaConfig.layers_block_type``: layer i is attention when
  ``i % attn_layer_period == attn_layer_offset``, else Mamba;
* each decoder layer: ``x + mixer(input_layernorm(x))``, then
  ``+ feed_forward(pre_ff_layernorm(.))``; the feed-forward is
  ``JambaMLP``, ``down(silu(gate(x)) * up(x))`` (``num_experts`` 1: no
  expert layer);
* ``JambaRMSNorm``: ``x / sqrt(mean(x^2) + eps) * w``, with ``w = 1 +
  scale`` (the weights' scale 0 is the source's weight-1 init);
* ``JambaAttention``: q, k, v projections without bias and without any
  positional encoding, query head j reading kv head j // (H / K), causal,
  ``softmax(q k^T / sqrt(head_dim)) v``, then ``o_proj``;
* ``JambaMambaMixer``: ``in_proj`` to (x, gate), a causal depthwise
  convolution of ``ssm_conv`` taps with bias and SiLU, ``x_proj`` to (dt,
  B, C), ``dt_layernorm``, ``b_layernorm`` and ``c_layernorm`` on them,
  ``dt = softplus(dt_proj(dt))`` (with bias), ``A = -exp(A_log)``, the
  selective scan (``scan.py``) with the skip D, times ``silu(gate)``,
  ``out_proj``;
* ``final_layernorm``, the tied head (the embedding's transpose) and the
  mean over the rows' tokens of the next-token negative log-likelihood.

No departure from the source.  Each row runs alone and each layer is
recomputed in the backward (``torch.utils.checkpoint``), so the live
activations are one layer's of one row.  ``rnd`` rounds every product's
operands and result and every activation the configuration keeps in its
compute dtype (the control); left at float32 it rounds nothing."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.counts.models import lm_dims
from bench.reference.common import Rounding
from bench.reference.scan import selective_scan

__all__ = ["layer_kinds", "row_nll"]


def layer_kinds(model: dict) -> list:
    """'attention' or 'mamba' for each layer of the ``model`` block."""
    period, offset = model["attn_layer_period"], model["attn_layer_offset"]
    return ["attention" if i % period == offset else "mamba"
            for i in range(model["num_layers"])]


def _norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def _attention(h, p, z, rnd):
    """h [S, d] -> [S, d]."""
    s = h.shape[0]
    q = rnd.act(rnd.einsum("sd,dhk->hsk", h, p["wq"]))
    k = rnd.act(rnd.einsum("sd,dhk->hsk", h, p["wk"]))
    v = rnd.act(rnd.einsum("sd,dhk->hsk", h, p["wv"]))
    rep = z["h"] // z["k"]
    k = k.repeat_interleave(rep, dim=0)
    v = v.repeat_interleave(rep, dim=0)
    scores = rnd.einsum("hqk,hsk->hqs", q, k) / math.sqrt(z["hd"])
    i = torch.arange(s, device=h.device)
    p_att = torch.softmax(scores.masked_fill(i[None, :] > i[:, None], float("-inf")), dim=-1)
    out = rnd.act(rnd.einsum("hqs,hsk->hqk", p_att, v))
    return rnd.einsum("hsk,hkd->sd", out, p["wo"])


def _mamba(h, p, z, eps, rnd):
    di, n, r, ck = z["di"], z["n"], z["r"], z["ck"]
    xz = rnd.mm(h, p["in_proj"])
    xin, gate = xz[:, :di], xz[:, di:]
    xp = F.pad(xin, (0, 0, ck - 1, 0))
    s = xin.shape[0]
    conv = p["conv_b"] + sum(xp[j:j + s] * p["conv_w"][j] for j in range(ck))
    xc = rnd.act(F.silu(conv))
    dbc = rnd.mm(xc, p["x_proj"])
    dt = rnd.act(_norm(dbc[:, :r], p["dt_norm"], eps))
    b = rnd.act(_norm(dbc[:, r:r + n], p["b_norm"], eps))
    c = rnd.act(_norm(dbc[:, r + n:], p["c_norm"], eps))
    dt = rnd.act(F.softplus(rnd.mm(dt, p["dt_proj"]) + p["dt_bias"]))
    y = selective_scan(xc, dt, -torch.exp(p["a_log"]), b.contiguous(), c.contiguous(),
                       p["d_skip"])
    return rnd.mm(rnd.act(y * F.silu(gate)), p["out_proj"])


def _layer(x, lp, mixer, kind, z, eps, rnd):
    h = rnd.act(_norm(x, lp["ln1"], eps))
    mix = _attention(h, mixer, z, rnd) if kind == "attention" else _mamba(h, mixer, z, eps, rnd)
    x = rnd.act(x + mix)
    h = rnd.act(_norm(x, lp["ln2"], eps))
    hidden = rnd.act(F.silu(rnd.mm(h, lp["wi_gate"])) * rnd.mm(h, lp["wi_up"]))
    return rnd.act(x + rnd.mm(hidden, lp["wo_mlp"]))


def row_nll(params: dict, tokens: torch.Tensor, labels: torch.Tensor, model: dict,
            rnd: Rounding | None = None) -> torch.Tensor:
    """Σ over one row's positions of the next-token NLL (float32).
    tokens, labels [S] int64."""
    rnd = rnd or Rounding()
    z = lm_dims(model)
    eps = model["norm_eps"]
    shared = {name.split(".")[1]: t for name, t in params.items()
              if name.startswith("layers.") and name.count(".") == 1}
    stacks = {kind: {name.split(".")[2]: t for name, t in params.items()
                     if name.startswith(f"layers.{sub}.")}
              for kind, sub in (("attention", "attn"), ("mamba", "ssm"))}
    seen = {"attention": 0, "mamba": 0}
    x = rnd.act(params["embed"][tokens])
    for i, kind in enumerate(layer_kinds(model)):
        j = seen[kind]
        seen[kind] += 1
        lp = {name: t[i] for name, t in shared.items()}
        mixer = {name: t[j] for name, t in stacks[kind].items()}
        x = checkpoint(_layer, x, lp, mixer, kind, z, eps, rnd, use_reentrant=False,
                       preserve_rng_state=False)
    x = rnd.act(_norm(x, params["final_norm"], eps))
    w = params["embed"].T

    def nll(x, w):
        logits = rnd.mm(x, w)
        return (torch.logsumexp(logits, -1) - logits.gather(-1, labels[:, None])[:, 0]).sum()

    return checkpoint(nll, x, w, use_reentrant=False, preserve_rng_state=False)
