"""Whisper-style encoder-decoder backbone: init, the training loss, prefill
and one decode step.

The port of the JAX package's ``models/encdec.py``.  The conv/mel frontend
is a stub there and here: the model consumes precomputed frame embeddings
``source [B, T_src, D]``.  Encoder = bidirectional self-attention + GELU
MLP with LayerNorm; decoder = causal self-attention + cross-attention
(non-causal) + GELU MLP.  Positions are sinusoidal on both sides; the output
head is tied to the token embedding.  Every LayerNorm takes ``cfg.norm_eps``
(1e-6 for whisper-medium, which does not set it), and the GELU is the tanh
form (``jax.nn.gelu(approximate=True)``).

Parameters keep the JAX leaf names and layouts, per-layer leaves stacked on a
leading ``[L, ...]`` axis (``enc_layers.attn.wq [L, d, h, hd]``,
``dec_layers.cross.wk``, ``enc_final.scale``), so carrying weights across is
a copy (``repro_torch.convert``).  As in ``models/lm.py``, the layer scans
are Python loops, each block rematerialised in the backward when
``cfg.remat``, and ``prefill`` allocates a cache that ``decode_step``
updates in place.  Attention goes through ``layers.attention`` (the
hand-written flash kernel for CUDA inputs under 'auto'); decode attends with
the plain ``decode_attention``, as in the JAX package, and LayerNorm is
plain everywhere, so a decode step launches no hand-written kernel.

Params that carry a split plan (``distributed/tensor_parallel.py``) hold a
model rank's heads of every attention (encoder self-, decoder self- and
cross-attention) and its GELU hidden units, and where the vocabulary
splits its rows of the tied embedding.  Each attention's and MLP's output
passes *g*, and in training its input *f*; the encoder output passes *f*
once as the cross-attention's k/v input, since each layer's cross k/v
projections give its gradient only the rank's part; ``bo`` and every
LayerNorm stay whole.  The caches hold the rank's kv heads, and serving
returns the whole vocabulary's logits.  (Serving takes no gradient, so
prefill and decode pass no *f*.)
"""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import layers as L
from repro_torch.models.lm import CacheSpec, _chunked_ce, _dtype, _layer, _lookup, _part, _remat

__all__ = ["init_encdec", "encode", "train_loss", "prefill", "decode_step"]


def init_encdec(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random params in the JAX package's layout, from a seeded
    ``torch.Generator`` on ``device`` (not bit-equal to ``jax.random``).
    LayerNorm scales start at one and every bias at zero, as in the JAX
    init.  On ``device="meta"`` the leaves have their shapes and dtypes and
    no values (no generator is drawn from)."""
    if cfg.family != "encdec":
        raise NotImplementedError(f"{cfg.name} is not an encoder-decoder")
    device = resolve_device(device)
    meta = device.type == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(seed)
    pd = _dtype(cfg.param_dtype)
    d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    h, k = cfg.num_heads, cfg.num_kv_heads

    def normal(shape, scale):
        if meta:
            return torch.empty(shape, dtype=pd, device=device)
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (x * scale).to(pd)

    def stacked(n, shape, scale):
        out = torch.empty((n, *shape), dtype=pd, device=device)
        for i in range(0 if meta else n):
            out[i] = normal(shape, scale)
        return out

    def zeros(*shape):
        return torch.zeros(shape, dtype=pd, device=device)

    def attn(n):
        s = 1.0 / math.sqrt(d)
        return {"wq": stacked(n, (d, h, hd), s), "wk": stacked(n, (d, k, hd), s),
                "wv": stacked(n, (d, k, hd), s),
                "wo": stacked(n, (h, hd, d), 1.0 / math.sqrt(h * hd))}

    def mlp(n):
        return {"wi": stacked(n, (d, f), 1.0 / math.sqrt(d)), "bi": zeros(n, f),
                "wo": stacked(n, (f, d), 1.0 / math.sqrt(f)), "bo": zeros(n, d)}

    def ln(*n):
        return {"scale": torch.ones((*n, d), dtype=pd, device=device),
                "bias": zeros(*n, d)}

    ne, nd = cfg.encoder_layers, cfg.num_layers
    enc = {"ln1": ln(ne), "attn": attn(ne), "ln2": ln(ne), "mlp": mlp(ne)}
    dec = {"ln1": ln(nd), "self": attn(nd), "ln_x": ln(nd), "cross": attn(nd),
           "ln2": ln(nd), "mlp": mlp(nd)}
    return {
        "embed": normal((cfg.vocab_size, d), 1.0 / math.sqrt(d)),
        "enc_layers": enc,
        "dec_layers": dec,
        "enc_final": ln(),
        "dec_final": ln(),
    }


def _ln(x, p, cfg: ModelConfig):
    return L.layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


def _proj(x, w):
    """x [B, S, D] @ w [D, H, hd] -> [B, H, S, hd], contiguous (the flash
    kernel takes contiguous inputs only)."""
    return torch.einsum("bsd,dhk->bhsk", x, w).contiguous()


def _out(o, p, split=None):
    """o [B, H, S, hd] @ wo -> [B, S, D]; a split rank's partial sum
    all-reduced."""
    y = torch.einsum("bhsk,hkd->bsd", o, p["wo"])
    return y if split is None else tp.reduce_out(y, split)


def _mha(x, p, *, causal: bool, kv=None, impl: str = "auto", split=None):
    """Self-attention, or cross-attention over ``kv`` (never causal).  With
    ``split`` the rank's heads: ``x`` passes *f* here, ``kv`` (the encoder
    output) has passed it once for every layer (``_decoder_hidden``)."""
    if split is not None:
        x = tp.copy_in(x, split)
    src = x if kv is None else kv
    o = L.attention(_proj(x, p["wq"]), _proj(src, p["wk"]), _proj(src, p["wv"]),
                    causal=causal and kv is None, impl=impl)
    return _out(o, p, split)


def _mlp(x, p, plan=None):
    return L.gelu_mlp(x, p["wi"], p["bi"], p["wo"], p["bo"], split=_part(plan, "mlp"))


def _with_positions(x, cfg: ModelConfig):
    cd = _dtype(cfg.compute_dtype)
    x = x.to(cd)
    return x + L.sinusoidal_positions(x.shape[1], cfg.d_model, cd, x.device)[None]


def _run(body, x, n: int, cfg: ModelConfig):
    """``body(x, i)`` over ``n`` layers, each rematerialised under
    ``cfg.remat``."""
    for i in range(n):
        x = _remat(body, x, i) if cfg.remat else body(x, i)
    return x


def encode(params, source, cfg: ModelConfig, *, attn_impl: str = "auto"):
    """source [B, T, D] -> encoder output [B, T, D] in the compute dtype."""
    layers, plan = params["enc_layers"], tp.plan_of(params)
    split = _part(plan, "attention")

    def body(x, i):
        lp = _layer(layers, i)
        x = x + _mha(_ln(x, lp["ln1"], cfg), lp["attn"], causal=False, impl=attn_impl,
                     split=split)
        return x + _mlp(_ln(x, lp["ln2"], cfg), lp["mlp"], plan)

    x = _run(body, _with_positions(source, cfg), cfg.encoder_layers, cfg)
    return _ln(x, params["enc_final"], cfg)


def _decoder_hidden(params, tokens, enc_out, cfg: ModelConfig, *, attn_impl: str = "auto"):
    layers, plan = params["dec_layers"], tp.plan_of(params)
    split = _part(plan, "attention")
    if split is not None:
        # through f once: each layer's cross k/v projections give the
        # encoder output's gradient only the rank's heads' part
        enc_out = tp.copy_in(enc_out, split)

    def body(x, i):
        lp = _layer(layers, i)
        x = x + _mha(_ln(x, lp["ln1"], cfg), lp["self"], causal=True, impl=attn_impl,
                     split=split)
        x = x + _mha(_ln(x, lp["ln_x"], cfg), lp["cross"], causal=False, kv=enc_out,
                     impl=attn_impl, split=split)
        return x + _mlp(_ln(x, lp["ln2"], cfg), lp["mlp"], plan)

    x = _run(body, _with_positions(_lookup(params, tokens, cfg), cfg), cfg.num_layers, cfg)
    return _ln(x, params["dec_final"], cfg)


def train_loss(params, batch, cfg: ModelConfig, *, attn_impl: str = "auto"):
    """batch: source [B, T, D] f32, tokens [B, S] int, labels [B, S] int
    (-1 = ignore), weights [B] f32 (default 1).  Returns (loss, {"loss",
    "tokens"}), ``tokens`` the unclamped weight mass, as in ``lm.train_loss``."""
    enc_out = encode(params, batch["source"], cfg, attn_impl=attn_impl)
    hidden = _decoder_hidden(params, batch["tokens"], enc_out, cfg, attn_impl=attn_impl)
    labels = batch["labels"]
    weights = batch.get("weights")
    if weights is None:
        weights = torch.ones((labels.shape[0],), dtype=torch.float32, device=labels.device)
    valid = (labels >= 0).float() * weights.float()[:, None]
    nll_sum, denom = _chunked_ce(params, hidden, labels, valid, cfg)
    loss = nll_sum / torch.clamp_min(denom, 1.0)
    return loss, {"loss": loss, "tokens": denom}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _tied_logits(params, hidden):
    """hidden [B, D] -> f32 logits [B, V] against the tied embedding (a split
    vocabulary's gathered whole)."""
    logits = hidden.float() @ params["embed"].float().T
    split = _part(tp.plan_of(params), "vocab")
    return logits if split is None else tp.gather_vocab(logits, split)


def _kv_heads(cfg: ModelConfig, split) -> int:
    """The kv heads a rank's caches hold: all of them, or its block (the
    one head its query heads read where they are repeated to the axis)."""
    return cfg.num_kv_heads if split is None else split.block(cfg.num_kv_heads)[1]


def prefill(params, tokens, source, cfg: ModelConfig, spec: CacheSpec, *,
            attn_impl: str = "auto"):
    """Encode ``source``, run the decoder over the prompt ``tokens [B, S]``,
    build the cache.  Returns (last-position f32 logits [B, V], cache): the
    self-attention K/V per decoder layer [L, B, K, cache_len, hd], the
    prompt's positions filled, and the cross-attention K/V computed once
    from the encoder output [L, B, K, T, hd], in the compute dtype; with a
    split plan, the rank's kv heads of both."""
    cd = _dtype(cfg.compute_dtype)
    plan = tp.plan_of(params)
    split = _part(plan, "attention")
    enc_out = encode(params, source, cfg, attn_impl=attn_impl)
    x = _with_positions(_lookup(params, tokens, cfg), cfg)
    b, s, _ = x.shape
    if s > spec.cache_len:
        raise ValueError(f"prompt {s} exceeds cache_len {spec.cache_len}")
    nl, hd, t = cfg.num_layers, cfg.resolved_head_dim, enc_out.shape[1]
    kh = _kv_heads(cfg, split)
    opts = dict(dtype=cd, device=x.device)
    cache = {"pos": s,
             "k": torch.zeros((nl, b, kh, spec.cache_len, hd), **opts),
             "v": torch.zeros((nl, b, kh, spec.cache_len, hd), **opts),
             "ck": torch.empty((nl, b, kh, t, hd), **opts),
             "cv": torch.empty((nl, b, kh, t, hd), **opts)}
    for i in range(nl):
        lp = _layer(params["dec_layers"], i)
        h = _ln(x, lp["ln1"], cfg)
        k, v = _proj(h, lp["self"]["wk"]), _proj(h, lp["self"]["wv"])
        o = L.attention(_proj(h, lp["self"]["wq"]), k, v, causal=True, impl=attn_impl)
        x = x + _out(o, lp["self"], split)
        cache["k"][i, :, :, :s] = k.to(cd)
        cache["v"][i, :, :, :s] = v.to(cd)
        h = _ln(x, lp["ln_x"], cfg)
        ck, cv = _proj(enc_out, lp["cross"]["wk"]), _proj(enc_out, lp["cross"]["wv"])
        o = L.attention(_proj(h, lp["cross"]["wq"]), ck, cv, causal=False, impl=attn_impl)
        x = x + _out(o, lp["cross"], split)
        cache["ck"][i] = ck.to(cd)
        cache["cv"][i] = cv.to(cd)
        x = x + _mlp(_ln(x, lp["ln2"], cfg), lp["mlp"], plan)
    hidden = _ln(x, params["dec_final"], cfg)
    return _tied_logits(params, hidden[:, -1]), cache


def decode_step(params, cache, tokens, cfg: ModelConfig, spec: CacheSpec):
    """One new token per sequence.  tokens [B].  Writes the token's
    self-attention K/V into ``cache`` at ``pos``, advances ``cache['pos']``
    and returns (f32 logits [B, V], cache).  Both attentions are the plain
    ``decode_attention``; the token's sinusoidal row is the one at ``pos``."""
    cd = _dtype(cfg.compute_dtype)
    pos = cache["pos"]
    if pos >= spec.cache_len:
        raise ValueError(f"cache is full ({spec.cache_len} positions)")
    plan = tp.plan_of(params)
    split = _part(plan, "attention")
    x = _lookup(params, tokens[:, None], cfg)
    x = x + L.sinusoidal_positions(pos + 1, cfg.d_model, cd, x.device)[pos:][None]
    for i in range(cfg.num_layers):
        lp = _layer(params["dec_layers"], i)
        h = _ln(x, lp["ln1"], cfg)
        cache["k"][i, :, :, pos:pos + 1] = _proj(h, lp["self"]["wk"]).to(cd)
        cache["v"][i, :, :, pos:pos + 1] = _proj(h, lp["self"]["wv"]).to(cd)
        o = L.decode_attention(_proj(h, lp["self"]["wq"]), cache["k"][i], cache["v"][i],
                               pos + 1)
        x = x + _out(o, lp["self"], split)
        h = _ln(x, lp["ln_x"], cfg)
        ck = cache["ck"][i]
        o = L.decode_attention(_proj(h, lp["cross"]["wq"]), ck, cache["cv"][i], ck.shape[2])
        x = x + _out(o, lp["cross"], split)
        x = x + _mlp(_ln(x, lp["ln2"], cfg), lp["mlp"], plan)
    hidden = _ln(x, params["dec_final"], cfg)
    cache["pos"] = pos + 1
    return _tied_logits(params, hidden[:, 0]), cache
