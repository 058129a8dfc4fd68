"""Decoder-only LM, dense family: init, prefill and one decode step.

The port of the JAX package's ``models/lm.py`` for the dense/GQA family.
Parameters keep the JAX leaf names and layouts: per-layer leaves are stacked
on a leading ``[L, ...]`` axis (``wq [L, d, h, hd]``, ``wo [L, h, hd, d]``,
...), so carrying weights across is a copy (``repro_torch.convert``).  The
JAX ``lax.scan`` over layers is a Python loop over the stacked leaves.

Unlike the JAX package, whose arrays are immutable, ``prefill`` allocates the
KV cache and ``decode_step`` writes each new position into it in place and
returns the same dict.

Not ported yet (ROADMAP.md Queue 1): the moe, ssm, hybrid, vlm and encdec
families, ``train_loss`` with its chunked cross-entropy, and the unrolled
decode step.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

__all__ = ["init_lm", "prefill", "decode_step", "init_cache", "CacheSpec",
           "check_supported"]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration this slice of the port does not run."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; "
            "ROADMAP.md Queue 1 lists it")
    if cfg.rope_theta <= 0:
        raise NotImplementedError(
            "sinusoidal positions are not ported yet (ROADMAP.md Queue 1)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_lm(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random params in the JAX package's layout, from a seeded
    ``torch.Generator`` on ``device`` (not bit-equal to ``jax.random``).
    Norm scales and biases start at zero, as in the JAX init."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    pd = _dtype(cfg.param_dtype)
    n, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim
    h, k, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff

    def normal(shape, scale):
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (x * scale).to(pd)

    def zeros(shape):
        return torch.zeros(shape, dtype=pd, device=device)

    s_in = 1.0 / math.sqrt(d)
    layers = {
        "ln1": zeros((n, d)),
        "ln2": zeros((n, d)),
        "wq": normal((n, d, h, hd), s_in),
        "wk": normal((n, d, k, hd), s_in),
        "wv": normal((n, d, k, hd), s_in),
        "wo": normal((n, h, hd, d), 1.0 / math.sqrt(h * hd)),
        "wi_gate": normal((n, d, f), s_in),
        "wi_up": normal((n, d, f), s_in),
        "wo_mlp": normal((n, f, d), 1.0 / math.sqrt(f)),
    }
    if cfg.qkv_bias:
        layers.update(bq=zeros((n, h, hd)), bk=zeros((n, k, hd)),
                      bv=zeros((n, k, hd)))
    params = {
        "embed": normal((cfg.vocab_size, d), s_in),
        "final_norm": zeros((d,)),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = normal((d, cfg.vocab_size), s_in)
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _qkv(x, lp, cfg: ModelConfig, positions):
    """Projections, bias and rope.  Returns contiguous q [B,H,S,hd] and
    k/v [B,K,S,hd] (the flash kernel takes contiguous inputs only)."""
    q = torch.einsum("bsd,dhk->bhsk", x, lp["wq"])
    k = torch.einsum("bsd,dhk->bhsk", x, lp["wk"])
    v = torch.einsum("bsd,dhk->bhsk", x, lp["wv"])
    if cfg.qkv_bias:
        q = q + lp["bq"][None, :, None, :]
        k = k + lp["bk"][None, :, None, :]
        v = v + lp["bv"][None, :, None, :]
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q.contiguous(), k.contiguous(), v.contiguous()


def _attn_out(out, lp):
    return torch.einsum("bhsk,hkd->bsd", out, lp["wo"])


def _logits(params, hidden, cfg: ModelConfig):
    """f32 logits, as in the JAX package."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return torch.einsum("bsd,dv->bsv", hidden.float(), w.float())


def _layer(params, i: int) -> dict:
    return {name: leaf[i] for name, leaf in params["layers"].items()}


def _mlp(x, lp, cfg: ModelConfig):
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.swiglu_mlp(h2, lp["wi_gate"], lp["wi_up"], lp["wo_mlp"])


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """KV-cache layout on one card: the true kv heads, ``cache_len``
    positions, int8 payload with f32 per-row scales when ``quantized``."""

    kv_heads: int
    cache_len: int
    quantized: bool = False

    @staticmethod
    def build(cfg: ModelConfig, seq_len: int) -> "CacheSpec":
        check_supported(cfg)
        return CacheSpec(cfg.num_kv_heads, seq_len, cfg.kv_cache_dtype == "int8")


def init_cache(cfg: ModelConfig, spec: CacheSpec, batch: int, *, dtype=None,
               device=None) -> dict:
    """Allocate the zeroed decode cache; ``pos`` is the next position."""
    device = resolve_device(device)
    cd = dtype or _dtype(cfg.compute_dtype)
    shape = (cfg.num_layers, batch, spec.kv_heads, spec.cache_len,
             cfg.resolved_head_dim)
    store = torch.int8 if spec.quantized else cd
    cache = {
        "pos": 0,
        "k": torch.zeros(shape, dtype=store, device=device),
        "v": torch.zeros(shape, dtype=store, device=device),
    }
    if spec.quantized:
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return cache


def _write_kv(cache, i: int, start: int, k, v, spec: CacheSpec, cd):
    """Write k/v [B, K, S, hd] into layer ``i`` at positions start..start+S."""
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


def prefill(params, tokens, cfg: ModelConfig, spec: CacheSpec, *,
            attn_impl: str = "auto"):
    """Full-sequence forward.  tokens [B, S] on the params' device.  Returns
    (last-position f32 logits [B, V], filled cache)."""
    cd = _dtype(cfg.compute_dtype)
    x = params["embed"][tokens].to(cd)
    b, s, _ = x.shape
    if s > spec.cache_len:
        raise ValueError(
            f"prefill length {s} exceeds cache_len {spec.cache_len}; "
            "build the CacheSpec with a longer max_len")
    positions = torch.arange(s, device=x.device)
    cache = init_cache(cfg, spec, b, device=x.device)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _qkv(h, lp, cfg, positions)
        o = L.attention(q, k, v, causal=True, window=0, impl=attn_impl)
        x = x + _attn_out(o, lp)
        _write_kv(cache, i, 0, k, v, spec, cd)
        x = _mlp(x, lp, cfg)
    hidden = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache["pos"] = s
    return _logits(params, hidden[:, -1:], cfg)[:, 0], cache


def decode_step(params, cache, tokens, cfg: ModelConfig, spec: CacheSpec):
    """One new token per sequence.  tokens [B].  Writes the token's K/V into
    ``cache`` in place, advances ``cache['pos']`` and returns
    (f32 logits [B, V], cache)."""
    cd = _dtype(cfg.compute_dtype)
    pos = cache["pos"]
    if pos >= spec.cache_len:
        raise ValueError(f"cache is full ({spec.cache_len} positions)")
    x = params["embed"][tokens[:, None]].to(cd)  # [B, 1, D]
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _qkv(h, lp, cfg, positions)
        _write_kv(cache, i, pos, k, v, spec, cd)
        scales = {}
        if spec.quantized:
            scales = {"k_scale": cache["k_scale"][i], "v_scale": cache["v_scale"][i]}
        o = L.decode_attention(q, cache["k"][i], cache["v"][i], pos + 1, **scales)
        x = x + _attn_out(o, lp)
        x = _mlp(x, lp, cfg)
    hidden = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache["pos"] = pos + 1
    return _logits(params, hidden, cfg)[:, 0], cache
