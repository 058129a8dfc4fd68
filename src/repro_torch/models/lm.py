"""Decoder-only LM families: dense / GQA, MoE, the VLM stub (patch
embeddings prepended to the token stream), ssm (Mamba-1), hybrid (Hymba) and
interleaved (Jamba): init, the training loss, prefill and one decode step.

The port of the JAX package's ``models/lm.py``; the encoder-decoder family
has its own module (``models/encdec.py``), as there.
Parameters keep the JAX leaf names and layouts: per-layer leaves are stacked
on a leading ``[L, ...]`` axis (``wq [L, d, h, hd]``, ``ssm.in_proj
[L, d, 2*DI]``, ...), so carrying weights across is a copy
(``repro_torch.convert``).  The JAX ``lax.scan`` over layers is a Python
loop over the stacked leaves.

Unlike the JAX package, whose arrays are immutable, ``prefill`` allocates the
cache and ``decode_step`` writes each new position (and SSM state) into it in
place and returns the same dict.

Training (``train_loss``) runs the JAX package's ``forward_hidden`` and
chunked cross-entropy: per-block rematerialisation (``cfg.remat``) is
``torch.utils.checkpoint`` without reentry, the two-level ``scan_block``
scan is a checkpoint over each group of per-block checkpoints, and each
``ce_chunk`` of f32 logits is recomputed in the backward.  The port's train
step, optimizer and checkpoints take flat dicts: ``flat_params`` names each
leaf by its JAX pytree path (``layers.ssm.x_proj``), ``nested_params`` undoes
it.

In the ssm family the JAX code computes ``rms_norm(x, ln2)`` and discards it
(Mamba-1 has no MLP); the port skips that dead norm, with the same result
(``ln2`` gets a zero gradient, as in JAX).

The moe family pads its experts to a multiple of 16 (``padded_experts``;
qwen2-moe-a2.7b's 60 become 64) and masks the pad experts out of the router;
its blocks return the Switch aux loss, which ``forward_hidden`` sums over
the layers and ``train_loss`` adds times ``router_aux_coef``.  The vlm family
prepends ``patches @ mm_proj`` to the token embeddings; rope positions run
over patches and tokens together, the cache counts the prefix, and the loss
skips the patch positions.  The JAX package's unrolled decode step
(``_decode_step_unrolled``) is a variant for XLA and is not ported.

The interleaved family (``configs.InterleavedConfig``, the port's own) has
layers of two kinds in one stack: attention without positions or a Mamba-1
mixer with RMSNorms on dt, B and C, each followed by the SwiGLU MLP.  A layer carries only the leaves of its kind:
the norms and the MLP are stacked on all L layers, ``layers.attn.*`` on the
attention layers and ``layers.ssm.*`` on the Mamba layers, in layer order.
Each block's forward is traced as ``block.attention`` or ``block.mamba``
(``obs/trace.py``; a = the layer, b = the microbatch's tokens), again around
its recompute in the backward.  It trains only: serving and the ``model``
split raise.

Params that carry a split plan (``distributed/tensor_parallel.py``: the
sharded train step's view, ``tensor_parallel.local_view`` for serving)
hold a model rank's block of each part that splits along ``model``:
attention runs K2 on the rank's query and kv heads, the MLP (the moe
family: the shared expert) on its hidden units, the moe experts on its
block of the experts (routing stays whole), the Mamba mixer K3 on its
channels, the embedding and the logits on its vocabulary rows;
row-parallel outputs are all-reduced, the residual stream, every norm and
the vlm family's ``patches @ mm_proj`` stay whole.  The cache then holds the rank's kv heads
and channels, and prefill and decode return the whole vocabulary's logits.
Where attention does not split and its kv heads do not divide the model
axis, the cache holds the rank's block of the slots instead
(``tensor_parallel.cache_block``): prefill writes the slots of its block
(after a ring's roll), a decode step writes the token's K/V only on the
rank that holds its slot, and decode attention is the partial softmax
over the rank's slots (``layers.decode_attention(split=)``).  Prefill's
own attention over the prompt is unchanged.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import layers as L
from repro_torch.obs import trace as obs_trace

__all__ = ["init_lm", "train_loss", "forward_hidden", "flat_params", "nested_params",
           "prefill", "decode_step", "init_cache", "CacheSpec", "check_supported",
           "padded_experts"]

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "interleaved")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration this module does not run: a family other
    than ``FAMILIES`` (encdec has ``models/encdec.py``), or sinusoidal
    positions (``rope_theta <= 0`` outside the interleaved family, whose
    attention takes no positions), which no registered decoder-only
    architecture uses."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder: it runs through repro_torch.models.encdec")
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is none of the decoder-only "
            f"families {FAMILIES}")
    if cfg.rope_theta <= 0 and cfg.family != "interleaved":
        raise NotImplementedError(
            "decoder-only models with sinusoidal positions (rope_theta <= 0) are "
            "not ported: no registered architecture uses them")


def _refuse_serving(cfg: ModelConfig) -> None:
    if cfg.family == "interleaved":
        raise NotImplementedError(
            f"the interleaved family ({cfg.name}) trains only: no cache holds its KV and "
            f"SSM state side by side yet")


def padded_experts(cfg: ModelConfig, multiple: int = 16) -> int:
    """Experts rounded up to ``multiple`` (0 outside the moe family)."""
    if cfg.family != "moe":
        return 0
    return -(-cfg.num_experts // multiple) * multiple


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_lm(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random params in the JAX package's layout, from a seeded
    ``torch.Generator`` on ``device`` (not bit-equal to ``jax.random``).
    Norm scales and biases start at zero, as in the JAX init; the moe router
    is f32 whatever ``param_dtype`` is.  Stacked leaves are drawn one layer
    at a time, so no f32 temporary is larger than one layer's slice of a
    leaf.  On ``device="meta"`` the leaves have their shapes and dtypes and
    no values (no generator is drawn from): the dry run's params."""
    check_supported(cfg)
    device = resolve_device(device)
    meta = device.type == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(seed)
    pd = _dtype(cfg.param_dtype)
    n, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim
    h, k, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff

    def normal(shape, scale, dtype=pd):
        if meta:
            return torch.empty(shape, dtype=dtype, device=device)
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (x * scale).to(dtype)

    def stacked(shape, scale, dtype=pd, count=n):
        out = torch.empty((count, *shape), dtype=dtype, device=device)
        for i in range(0 if meta else count):
            out[i] = normal(shape, scale, dtype)
        return out

    def full(shape, value, dtype=pd, count=n):
        return torch.full((count, *shape), value, dtype=dtype, device=device)

    def attention(count=n):
        return dict(
            wq=stacked((d, h, hd), s_in, count=count),
            wk=stacked((d, k, hd), s_in, count=count),
            wv=stacked((d, k, hd), s_in, count=count),
            wo=stacked((h, hd, d), 1.0 / math.sqrt(h * hd), count=count),
        )

    s_in = 1.0 / math.sqrt(d)
    layers = {"ln1": full((d,), 0.0), "ln2": full((d,), 0.0)}
    kinds = getattr(cfg, "layer_kinds", ())
    if cfg.family not in ("ssm", "interleaved"):
        layers.update(attention())
        if cfg.qkv_bias:
            layers.update(bq=full((h, hd), 0.0), bk=full((k, hd), 0.0),
                          bv=full((k, hd), 0.0))
    if cfg.family in ("dense", "vlm", "hybrid", "interleaved"):
        layers.update(
            wi_gate=stacked((d, f), s_in),
            wi_up=stacked((d, f), s_in),
            wo_mlp=stacked((f, d), 1.0 / math.sqrt(f)),
        )
    elif cfg.family == "moe":
        e = padded_experts(cfg)
        layers.update(
            router=stacked((d, e), s_in, torch.float32),
            we_gate=stacked((e, d, f), s_in),
            we_up=stacked((e, d, f), s_in),
            we_down=stacked((e, f, d), 1.0 / math.sqrt(f)),
        )
        if cfg.num_shared_experts:
            fs = f * cfg.num_shared_experts
            layers.update(
                ws_gate=stacked((d, fs), s_in),
                ws_up=stacked((d, fs), s_in),
                ws_down=stacked((fs, d), 1.0 / math.sqrt(fs)),
            )
    if cfg.family == "interleaved":
        layers["attn"] = attention(kinds.count("attention"))
    if cfg.family in ("ssm", "hybrid", "interleaved"):
        di, ns, r, ck = (cfg.ssm_d_inner, cfg.ssm_state, cfg.resolved_dt_rank,
                         cfg.ssm_conv)
        m = kinds.count("mamba") if kinds else n
        a_log = torch.log(torch.arange(1, ns + 1, dtype=torch.float32, device=device))
        layers["ssm"] = {
            "in_proj": stacked((d, 2 * di), s_in, count=m),
            "conv_w": stacked((ck, di), 1.0 / math.sqrt(ck), count=m),
            "conv_b": full((di,), 0.0, count=m),
            "x_proj": stacked((di, r + 2 * ns), 1.0 / math.sqrt(di), count=m),
        }
        if cfg.family == "interleaved":
            layers["ssm"].update(dt_norm=full((r,), 0.0, count=m),
                                 b_norm=full((ns,), 0.0, count=m),
                                 c_norm=full((ns,), 0.0, count=m))
        layers["ssm"].update({
            "dt_proj": stacked((r, di), 1.0 / math.sqrt(r), count=m),
            "dt_bias": full((di,), math.log(math.e - 1), count=m),  # softplus^-1(1)
            "a_log": a_log.expand(m, di, ns).contiguous(),
            "d_skip": full((di,), 1.0, torch.float32, count=m),
            "out_proj": stacked((di, d), 1.0 / math.sqrt(di), count=m),
        })
        if cfg.family == "hybrid":
            layers["ln_ssm"] = full((d,), 0.0)
    params = {
        "embed": normal((cfg.vocab_size, d), s_in),
        "final_norm": torch.zeros((d,), dtype=pd, device=device),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = normal((d, cfg.vocab_size), s_in)
    if cfg.family == "vlm":
        params["mm_proj"] = normal((d, d), s_in)
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _part(plan, name: str):
    """``plan`` where its part ``name`` splits, else None."""
    return plan if plan is not None and getattr(plan, name) else None


def _qkv(x, lp, cfg: ModelConfig, positions, split=None):
    """Projections, bias and rope.  Returns contiguous q [B,H,S,hd] and
    k/v [B,K,S,hd] (the flash kernel takes contiguous inputs only); with
    ``split``, the rank's H / size query heads and their kv heads."""
    if split is not None:
        x = tp.copy_in(x, split)
    q = torch.einsum("bsd,dhk->bhsk", x, lp["wq"])
    k = torch.einsum("bsd,dhk->bhsk", x, lp["wk"])
    v = torch.einsum("bsd,dhk->bhsk", x, lp["wv"])
    if cfg.qkv_bias:
        q = q + lp["bq"][None, :, None, :]
        k = k + lp["bk"][None, :, None, :]
        v = v + lp["bv"][None, :, None, :]
    if cfg.family != "interleaved":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q.contiguous(), k.contiguous(), v.contiguous()


def _attn_out(out, lp, split=None):
    y = torch.einsum("bhsk,hkd->bsd", out, lp["wo"])
    return y if split is None else tp.reduce_out(y, split)


def _logits(params, hidden, cfg: ModelConfig):
    """f32 logits, as in the JAX package (a split vocabulary's gathered
    whole)."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = torch.einsum("bsd,dv->bsv", hidden.float(), w.float())
    split = _part(tp.plan_of(params), "vocab")
    return logits if split is None else tp.gather_vocab(logits, split)


def _layer(tree, i: int) -> dict:
    """Layer ``i`` of the stacked leaves, nested dicts (``ssm``) included."""
    return {name: _layer(leaf, i) if isinstance(leaf, dict) else leaf[i]
            for name, leaf in tree.items()}


def _interleaved_layer(tree, cfg: ModelConfig, i: int) -> dict:
    """Layer ``i`` of the interleaved family: its norms and MLP, and its
    kind's leaves from that kind's stack (attention's at the top level, as
    ``_qkv`` reads them; Mamba's under ``ssm``)."""
    kind, j = cfg.layer_slot(i)
    lp = {name: leaf[i] for name, leaf in tree.items() if not isinstance(leaf, dict)}
    if kind == "attention":
        lp.update(_layer(tree["attn"], j))
    else:
        lp["ssm"] = _layer(tree["ssm"], j)
    return lp


def _mlp(x, lp, cfg: ModelConfig, norm_impl: str, decode: bool = False, plan=None):
    """ln2, then the SwiGLU MLP or, in the moe family, the experts.  Returns
    (x + y, the moe aux loss or None).  A decode step routes each token as a
    group of its own, with a capacity factor of at least 2.  In the moe
    family the plan's ``experts`` part splits the routed experts and its
    ``mlp`` part the shared expert's hidden."""
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps, impl=norm_impl)
    if cfg.family != "moe":
        return x + L.swiglu_mlp(h2, lp["wi_gate"], lp["wi_up"], lp["wo_mlp"],
                                split=_part(plan, "mlp")), None
    shared = ((lp["ws_gate"], lp["ws_up"], lp["ws_down"])
              if cfg.num_shared_experts else None)
    cf = cfg.expert_capacity_factor
    y, aux = L.moe_layer(h2, lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"],
                         top_k=cfg.top_k, num_real_experts=cfg.num_experts,
                         capacity_factor=max(cf, 2.0) if decode else cf,
                         group_size=1 if decode else 256, shared=shared,
                         split=_part(plan, "experts"), shared_split=_part(plan, "mlp"))
    return x + y, aux


def _lookup(params, tokens, cfg: ModelConfig):
    """Token embeddings in the compute dtype (a split vocabulary's looked up
    by the rank that holds each row)."""
    split = _part(tp.plan_of(params), "vocab")
    x = (params["embed"][tokens] if split is None
         else tp.embed(params["embed"], tokens, split))
    return x.to(_dtype(cfg.compute_dtype))


def _embed(params, tokens, cfg: ModelConfig, patches):
    """Token embeddings in the compute dtype; the vlm family prepends
    ``patches [B, P, D] @ mm_proj``."""
    cd = _dtype(cfg.compute_dtype)
    x = _lookup(params, tokens, cfg)
    if cfg.family != "vlm":
        return x
    if patches is None:
        raise ValueError("the vlm family needs patch embeddings (patches=)")
    return torch.cat([patches.to(cd) @ params["mm_proj"].to(cd), x], dim=1)


def _mamba(h, lp, cfg: ModelConfig, return_state: bool = True, plan=None, **kw):
    return L.mamba_block(h, lp["ssm"], dt_rank=cfg.resolved_dt_rank,
                         ssm_state=cfg.ssm_state, conv_k=cfg.ssm_conv,
                         return_state=return_state, split=_part(plan, "mamba"),
                         norm_eps=cfg.norm_eps, **kw)


def _fuse(mix, ssm_o, lp, cfg: ModelConfig, norm_impl: str):
    """Hymba: mean-fuse the attention output with the normalised SSM output."""
    return 0.5 * (mix + L.rms_norm(ssm_o, lp["ln_ssm"], cfg.norm_eps, impl=norm_impl))


# ---------------------------------------------------------------------------
# Flat view of the params
# ---------------------------------------------------------------------------


def flat_params(params: dict, prefix: str = "") -> dict:
    """``{"embed": t, "layers.ln1": t, "layers.ssm.x_proj": t, ...}``: every
    leaf named by its JAX pytree path, in the nested dict's order.  The
    tensors are the same objects."""
    out = {}
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            out.update(flat_params(leaf, f"{prefix}{name}."))
        else:
            out[prefix + name] = leaf
    return out


def nested_params(flat: dict) -> dict:
    """The inverse of :func:`flat_params`."""
    out: dict = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


# ---------------------------------------------------------------------------
# Training: full-sequence causal forward and the weighted CE loss
# ---------------------------------------------------------------------------


def _block_train(x, lp, cfg: ModelConfig, positions, attn_impl: str, ssm_impl: str,
                 norm_impl: str, plan=None):
    """One block, full-sequence causal (``lm.py:_block_train`` of the JAX
    package).  Returns (x, the moe aux loss or None: the other families
    carry none).  The hybrid's fuse takes the attention and SSM outputs
    each all-reduced where split: the norm of the SSM output is not linear.
    An interleaved layer runs the mixer of its kind (its leaves say which),
    attention over the whole causal prefix."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps, impl=norm_impl)
    if cfg.family == "ssm" or (cfg.family == "interleaved" and "ssm" in lp):
        mix = _mamba(h, lp, cfg, return_state=False, plan=plan, impl=ssm_impl,
                     norm_impl=norm_impl)
    else:
        split = _part(plan, "attention")
        q, k, v = _qkv(h, lp, cfg, positions, split)
        window = cfg.sliding_window if cfg.family == "hybrid" else 0
        mix = _attn_out(L.attention(q, k, v, causal=True, window=window, impl=attn_impl),
                        lp, split)
        if cfg.family == "hybrid":
            ssm_o = _mamba(h, lp, cfg, return_state=False, plan=plan, impl=ssm_impl)
            mix = _fuse(mix, ssm_o, lp, cfg, norm_impl)
    x = x + mix
    return (x, None) if cfg.family == "ssm" else _mlp(x, lp, cfg, norm_impl, plan=plan)


def _remat(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def forward_hidden(params, tokens, cfg: ModelConfig, *, attn_impl: str = "auto",
                   ssm_impl: str = "auto", norm_impl: str = "auto", patches=None):
    """Embed -> blocks -> final norm.  tokens [B, S]; the vlm family takes
    ``patches [B, P, D]`` too.  Returns (hidden [B, P + S, D], aux: the moe
    blocks' aux losses summed in layer order from an f32 zero, which stays
    zero in the other families).  With ``cfg.remat`` each block is
    recomputed in the backward; with a ``scan_block`` that divides the layers
    too, each group of that many blocks is one more checkpoint around its
    blocks' checkpoints, so the residuals kept are L / K + K instead of L."""
    check_supported(cfg)
    x = _embed(params, tokens, cfg, patches)
    positions = torch.arange(x.shape[1], device=x.device)
    layers, plan = params["layers"], tp.plan_of(params)

    def block(x, i):
        if cfg.family != "interleaved":
            return _block_train(x, _layer(layers, i), cfg, positions, attn_impl, ssm_impl,
                                norm_impl, plan)
        # recorded in ``finally``: a recompute under remat stops early by
        # raising once it has rebuilt what the backward needs
        tr = obs_trace.get()
        t = tr.t()
        try:
            return _block_train(x, _interleaved_layer(layers, cfg, i), cfg, positions,
                                attn_impl, ssm_impl, norm_impl, plan)
        finally:
            kind = cfg.layer_slot(i)[0]
            tr.rec(obs_trace.BLOCK_ATTENTION if kind == "attention" else obs_trace.BLOCK_MAMBA,
                   t, a=i, b=x.shape[0] * x.shape[1])

    def run(x, aux, i):
        x, a = _remat(block, x, i) if cfg.remat else block(x, i)
        return x, aux if a is None else aux + a

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    k = cfg.scan_block
    if k and cfg.num_layers % k == 0 and cfg.remat:
        def group(x, aux, first):
            for i in range(first, first + k):
                x, aux = run(x, aux, i)
            return x, aux

        for first in range(0, cfg.num_layers, k):
            x, aux = _remat(group, x, aux, first)
    else:
        for i in range(cfg.num_layers):
            x, aux = run(x, aux, i)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps, impl=norm_impl), aux


def _ce_chunk(h, w32, labels, valid):
    """Σ weighted NLL of one chunk: f32 logits, logsumexp minus the target's
    logit, labels of -1 read at 0 and weighted 0 by ``valid``."""
    logits = torch.einsum("bsd,dv->bsv", h.float(), w32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    return ((lse - tgt) * valid).sum()


def _chunked_ce(params, hidden, labels, valid, cfg: ModelConfig):
    """(Σ weighted NLL, Σ weights) without materialising [B, S, V]: each
    ``ce_chunk`` positions (shrunk until it divides S) compute their own f32
    logits, which the backward recomputes instead of keeping.  A split
    vocabulary's chunks take the rank's logits (``tensor_parallel.ce_sum``)."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    w32 = w.float()
    split = _part(tp.plan_of(params), "vocab")
    ce = _ce_chunk
    if split is not None:
        hidden = tp.copy_in(hidden, split)

        def ce(h, w32, labels, valid):
            return tp.ce_sum(h, w32, labels, valid, split)
    s = hidden.shape[1]
    chunk = min(cfg.ce_chunk, s)
    while s % chunk:
        chunk -= 1
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    denom = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        nll = nll + _remat(ce, hidden[:, sl], w32, labels[:, sl], valid[:, sl])
        denom = denom + valid[:, sl].sum()
    return nll, denom


def train_loss(params, batch, cfg: ModelConfig, *, attn_impl: str = "auto",
               ssm_impl: str = "auto", norm_impl: str = "auto"):
    """Weighted next-token CE.  batch:
      tokens  [B, S] int   labels [B, S] int (shifted targets; -1 = ignore)
      weights [B] f32 (SOLAR per-sample mask: 0 = padding row; default 1)
    The vlm family adds ``patches [B, P, D]``, whose positions carry no
    loss; the moe family adds ``router_aux_coef * aux`` to the loss.
    Returns (loss, {"loss", "aux", "tokens"}).  ``tokens`` is the unclamped
    weight mass: gradient accumulation divides the summed gradient by the
    sum of ``tokens``, so an all-padding microbatch contributes exactly 0."""
    tokens, labels = batch["tokens"], batch["labels"]
    weights = batch.get("weights")
    if weights is None:
        weights = torch.ones((tokens.shape[0],), dtype=torch.float32, device=tokens.device)
    hidden, aux = forward_hidden(params, tokens, cfg, attn_impl=attn_impl,
                                 ssm_impl=ssm_impl, norm_impl=norm_impl,
                                 patches=batch.get("patches"))
    if cfg.family == "vlm":
        hidden = hidden[:, -tokens.shape[1]:]  # drop the patch positions
    valid = (labels >= 0).float() * weights.float()[:, None]
    nll_sum, denom = _chunked_ce(params, hidden, labels, valid, cfg)
    loss = nll_sum / torch.clamp_min(denom, 1.0)
    if cfg.family == "moe":
        loss = loss + cfg.router_aux_coef * aux
    return loss, {"loss": loss, "aux": aux, "tokens": denom}


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Cache layout: ``kv_heads`` stored heads, ``cache_len`` positions (for
    a sliding window shorter than the sequence, a ring of ``window``
    positions indexed by ``pos % window``), int8 payload with f32 per-row
    scales when ``quantized``.  The ssm family keeps no KV cache.  The
    encdec family's self-attention cache takes the same layout
    (``models/encdec.py``) with its true heads; its K/V are never quantized,
    as in the JAX package.  A vlm cache counts the patch prefix.

    ``kv_heads`` is the true kv heads, repeated so the head axis divides a
    model axis of ``model_axis`` devices where that can work (each kv head
    ``model_axis / K`` times, when ``model_axis`` is a multiple of K and
    divides the query heads; DESIGN.md §4); otherwise the true heads, and a
    mesh shards the sequence axis instead (``cache_sharding``).  Query head
    ``h`` reads the same K/V either way."""

    kv_heads: int
    cache_len: int
    ring: bool = False
    quantized: bool = False

    @staticmethod
    def build(cfg: ModelConfig, seq_len: int, model_axis: int = 1) -> "CacheSpec":
        if cfg.family != "encdec":
            check_supported(cfg)
            _refuse_serving(cfg)
        if cfg.family == "ssm":
            return CacheSpec(0, 0, False, False)
        k, h = cfg.num_kv_heads, cfg.num_heads
        quant = cfg.kv_cache_dtype == "int8"
        if k % model_axis == 0 or model_axis == 1:
            k_eff = k
        elif model_axis % k == 0 and h % model_axis == 0:
            k_eff = model_axis          # repeat each kv head model/k times
        else:
            k_eff = k                   # unshardable heads -> shard seq axis
        window = cfg.sliding_window if cfg.family == "hybrid" else 0
        if window and window < seq_len:
            return CacheSpec(k_eff, window, True, quant)
        return CacheSpec(k_eff, seq_len, False, quant)


def _cache_heads(spec: CacheSpec, plan) -> int:
    """The kv heads a rank's cache holds: ``spec``'s, or its block of them
    where attention splits (``spec`` built for the plan's model axis)."""
    split = _part(plan, "attention")
    if split is None:
        return spec.kv_heads
    if spec.kv_heads % split.size:
        raise ValueError(f"a cache of {spec.kv_heads} kv heads does not split over "
                         f"{split.size} model ranks: build the CacheSpec with "
                         f"model_axis={split.size}")
    return spec.kv_heads // split.size


def init_cache(cfg: ModelConfig, spec: CacheSpec, batch: int, *, dtype=None,
               device=None, plan=None) -> dict:
    """Allocate the zeroed decode cache; ``pos`` is the next position.  The
    SSM state ``ssm_h`` is f32 [L, B, DI, N]; ``conv`` holds the last
    ``conv_k - 1`` conv inputs [L, B, conv_k-1, DI] in the compute dtype.
    With a split ``plan``, the rank's kv heads or its block of the slots
    (``tensor_parallel.cache_block``), and its DI channels."""
    _refuse_serving(cfg)
    device = resolve_device(device)
    cd = dtype or _dtype(cfg.compute_dtype)
    cache = {"pos": 0}
    if cfg.family != "ssm":
        block = tp.cache_block(plan, spec)
        slots = spec.cache_len if block is None else block[1]
        shape = (cfg.num_layers, batch, _cache_heads(spec, plan), slots,
                 cfg.resolved_head_dim)
        store = torch.int8 if spec.quantized else cd
        cache["k"] = torch.zeros(shape, dtype=store, device=device)
        cache["v"] = torch.zeros(shape, dtype=store, device=device)
        if spec.quantized:
            cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
            cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    if cfg.family in ("ssm", "hybrid"):
        di, n, ck = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_conv
        split = _part(plan, "mamba")
        di = di if split is None else split.block(di)[1]
        cache["ssm_h"] = torch.zeros((cfg.num_layers, batch, di, n),
                                     dtype=torch.float32, device=device)
        cache["conv"] = torch.zeros((cfg.num_layers, batch, ck - 1, di), dtype=cd,
                                    device=device)
    return cache


def _repeat_to(kv, k_eff: int):
    """kv [B, K, S, hd] with each head repeated to ``k_eff`` heads."""
    k = kv.shape[1]
    return L.repeat_kv(kv, k_eff // k) if k_eff != k else kv


def _write_kv(cache, i: int, start: int, k, v, spec: CacheSpec, cd, block=None):
    """Write k/v [B, K, S, hd] into layer ``i`` at slots start..start+S; where
    the cache holds the slots ``block`` = (first, length) only, the part
    that falls in it (none, on the other ranks)."""
    if block is not None:
        first, n = block
        lo, hi = max(start, first), min(start + k.shape[2], first + n)
        if lo >= hi:
            return
        k, v = k[:, :, lo - start:hi - start], v[:, :, lo - start:hi - start]
        start = lo - first
    stop = start + k.shape[2]
    if spec.quantized:
        kq, ks = L.quantize_kv(k)
        vq, vs = L.quantize_kv(v)
        cache["k"][i, :, :, start:stop] = kq
        cache["v"][i, :, :, start:stop] = vq
        cache["k_scale"][i, :, :, start:stop] = ks
        cache["v_scale"][i, :, :, start:stop] = vs
    else:
        cache["k"][i, :, :, start:stop] = k.to(cd)
        cache["v"][i, :, :, start:stop] = v.to(cd)


def _write_prefill_kv(cache, i: int, k, v, spec: CacheSpec, cd, block=None):
    """The prompt's k/v into layer ``i`` (the slots of ``block`` only, where
    it is not None).  A ring keeps the last ``W`` positions, position ``p``
    at index ``p % W`` so decode continues the ring: the JAX package's roll
    of the tail by ``S % W``."""
    s, w = k.shape[2], spec.cache_len
    if spec.ring and s > w:
        k = torch.roll(k[:, :, -w:], shifts=s % w, dims=2)
        v = torch.roll(v[:, :, -w:], shifts=s % w, dims=2)
    _write_kv(cache, i, 0, k, v, spec, cd, block)


def prefill(params, tokens, cfg: ModelConfig, spec: CacheSpec, *,
            attn_impl: str = "auto", ssm_impl: str = "auto",
            norm_impl: str = "auto", patches=None):
    """Full-sequence forward.  tokens [B, S] on the params' device (the vlm
    family: and ``patches [B, P, D]``, prepended).  Returns (last-position
    f32 logits [B, V], filled cache).  ``attn_impl``, ``ssm_impl`` and
    ``norm_impl`` select attention, selective scan and RMSNorm ('pallas': the
    hand-written kernel; 'auto': the kernel for CUDA inputs, the plain
    version for CPU inputs)."""
    check_supported(cfg)
    _refuse_serving(cfg)
    cd = _dtype(cfg.compute_dtype)
    x = _embed(params, tokens, cfg, patches)
    b, s, _ = x.shape
    if cfg.family != "ssm" and not spec.ring and s > spec.cache_len:
        raise ValueError(
            f"prefill length {s} (with any patch prefix) exceeds cache_len "
            f"{spec.cache_len}; build the CacheSpec with a longer max_len")
    positions = torch.arange(s, device=x.device)
    window = cfg.sliding_window if cfg.family == "hybrid" else 0
    plan = tp.plan_of(params)
    split = _part(plan, "attention")
    cache = init_cache(cfg, spec, b, device=x.device, plan=plan)
    heads = cache["k"].shape[2] if "k" in cache else 0
    block = tp.cache_block(plan, spec) if "k" in cache else None
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps, impl=norm_impl)
        if cfg.family != "ssm":
            q, k, v = _qkv(h, lp, cfg, positions, split)
            o = L.attention(q, k, v, causal=True, window=window, impl=attn_impl)
            mix = _attn_out(o, lp, split)
            _write_prefill_kv(cache, i, _repeat_to(k, heads), _repeat_to(v, heads), spec, cd,
                              block)
        if cfg.family in ("ssm", "hybrid"):
            ssm_o, h_last, conv_tail = _mamba(h, lp, cfg, plan=plan, impl=ssm_impl)
            cache["ssm_h"][i] = h_last
            cache["conv"][i] = conv_tail.to(cd)
            mix = ssm_o if cfg.family == "ssm" else _fuse(mix, ssm_o, lp, cfg, norm_impl)
        x = x + mix
        if cfg.family != "ssm":
            x, _ = _mlp(x, lp, cfg, norm_impl, plan=plan)
    hidden = L.rms_norm(x, params["final_norm"], cfg.norm_eps, impl=norm_impl)
    cache["pos"] = s
    return _logits(params, hidden[:, -1:], cfg)[:, 0], cache


def decode_step(params, cache, tokens, cfg: ModelConfig, spec: CacheSpec, *,
                norm_impl: str = "auto"):
    """One new token per sequence.  tokens [B].  Writes the token's K/V (at
    ``pos % W`` in a ring; on the rank that holds that slot, where the
    cache holds a block of them) and the new SSM state into ``cache`` in
    place, advances ``cache['pos']`` and returns (f32 logits [B, V],
    cache).  The SSM branch runs the recurrent step, not the scan kernel."""
    _refuse_serving(cfg)
    cd = _dtype(cfg.compute_dtype)
    pos = cache["pos"]
    if cfg.family != "ssm" and not spec.ring and pos >= spec.cache_len:
        raise ValueError(f"cache is full ({spec.cache_len} positions)")
    write = pos % spec.cache_len if spec.ring else pos
    cache_len = min(pos + 1, spec.cache_len) if spec.ring else pos + 1
    x = _lookup(params, tokens[:, None], cfg)  # [B, 1, D]
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    plan = tp.plan_of(params)
    split = _part(plan, "attention")
    heads = cache["k"].shape[2] if "k" in cache else 0
    block = tp.cache_block(plan, spec) if "k" in cache else None
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps, impl=norm_impl)
        if cfg.family != "ssm":
            q, k, v = _qkv(h, lp, cfg, positions, split)
            _write_kv(cache, i, write, _repeat_to(k, heads), _repeat_to(v, heads), spec, cd,
                      block)
            scales = {}
            if spec.quantized:
                scales = {"k_scale": cache["k_scale"][i], "v_scale": cache["v_scale"][i]}
            o = L.decode_attention(q, cache["k"][i], cache["v"][i], cache_len, **scales,
                                   split=None if block is None else plan)
            mix = _attn_out(o, lp, split)
        if cfg.family in ("ssm", "hybrid"):
            ssm_o, h_new, conv_new = L.mamba_decode_step(
                h, lp["ssm"], cache["ssm_h"][i], cache["conv"][i],
                dt_rank=cfg.resolved_dt_rank, ssm_state=cfg.ssm_state,
                conv_k=cfg.ssm_conv, split=_part(plan, "mamba"))
            cache["ssm_h"][i] = h_new
            cache["conv"][i] = conv_new.to(cd)
            mix = ssm_o if cfg.family == "ssm" else _fuse(mix, ssm_o, lp, cfg, norm_impl)
        x = x + mix
        if cfg.family != "ssm":
            x, _ = _mlp(x, lp, cfg, norm_impl, decode=True, plan=plan)
    hidden = L.rms_norm(x, params["final_norm"], cfg.norm_eps, impl=norm_impl)
    cache["pos"] = pos + 1
    return _logits(params, hidden, cfg)[:, 0], cache
