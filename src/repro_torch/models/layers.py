"""Model building blocks on tensors: the dense-decoder subset of the JAX
package's ``models/layers.py``.

Conventions follow the JAX package: activations ``x [B, S, D]``; attention
internals head-major ``q [B, H, S, hd]``, ``k/v [B, K, S, hd]`` (GQA: K
divides H).  Every function returns its input's dtype; softmax and norms run
in f32.  Where the JAX code asks for f32 accumulation of low-precision
operands (``preferred_element_type``), the operands are widened to f32.

Not ported yet (ROADMAP.md Queue 1): ``rms_norm``'s custom backward,
``layer_norm``, sinusoidal positions, ``attention_local``, ``gelu_mlp``,
``moe_layer`` and the Mamba block.  ``constrain`` has no counterpart: one
card has no mesh to constrain to.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, attention_ref

__all__ = [
    "rms_norm",
    "apply_rope",
    "repeat_kv",
    "attention_ref",
    "attention_blockwise",
    "attention",
    "quantize_kv",
    "decode_attention",
    "swiglu_mlp",
]


def rms_norm(x, scale, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in f32, cast to x's dtype.
    Forward only."""
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return ((xf * r) * (1.0 + scale.float())).to(x.dtype)


def apply_rope(x, positions, theta: float = 1e4):
    """Rotary embedding. x [B, H, S, hd]; positions [S] or [B, S]."""
    if theta <= 0:
        return x
    half = x.shape[-1] // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=x.device)
        * (-math.log(theta) / half)
    )
    angles = positions.float()[..., None] * freqs  # [S, half] or [B, S, half]
    angles = angles[None, None] if positions.dim() == 1 else angles[:, None]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def repeat_kv(kv, repeats: int):
    """[B, K, S, hd] -> [B, K*repeats, S, hd] (GQA head replication)."""
    if repeats == 1:
        return kv
    b, k, s, hd = kv.shape
    return kv[:, :, None].expand(b, k, repeats, s, hd).reshape(b, k * repeats, s, hd)


def _mask_bias(qpos, kpos, causal: bool, window: int):
    """Additive mask bias [Sq, Sk] from query/key positions."""
    q = qpos[:, None]
    k = kpos[None, :]
    ok = torch.ones((q.shape[0], k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k <= q
    if window > 0:
        ok &= q - k < window
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    return torch.where(ok, zero, NEG_INF)


def attention_blockwise(q, k, v, *, causal: bool = True, window: int = 0,
                        block_size: int = 512):
    """Online-softmax attention over KV blocks — O(Sq * block) memory."""
    b, h, sq, hd = q.shape
    kh, sk = k.shape[1], k.shape[2]
    k = repeat_kv(k, h // kh)
    v = repeat_kv(v, h // kh)
    nblocks = -(-sk // block_size)
    pad = nblocks * block_size - sk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    qq = (q.float() / math.sqrt(hd)).to(q.dtype).float()
    qpos = torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    for j in range(nblocks):
        sl = slice(j * block_size, (j + 1) * block_size)
        kj, vj = k[:, :, sl].float(), v[:, :, sl].float()
        kpos = j * block_size + torch.arange(block_size, device=q.device)
        s = torch.einsum("bhsd,bhtd->bhst", qq, kj)
        valid = torch.where(kpos < sk, 0.0, NEG_INF)
        s = s + _mask_bias(qpos, kpos, causal, window) + valid
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhst,bhtd->bhsd", p.to(q.dtype).float(), vj)
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def _flash_takes(q, k, v) -> bool:
    """Whether the flash kernel is built for these inputs: CUDA, a dtype and
    head dim it is instantiated for, contiguous."""
    return (q.is_cuda and q.dtype in _fa.DTYPES and q.shape[-1] in _fa.HEAD_DIMS
            and all(t.is_contiguous() for t in (q, k, v)))


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              impl: str = "auto", block_size: int = 512):
    """Dispatching attention entry point.

    impl: 'ref' | 'blockwise' | 'pallas' | 'auto'.  'pallas' is the selector
    of the hand-written flash-attention kernel (the name carries over from
    the JAX package).  'auto' takes the kernel for CUDA inputs it is built
    for; otherwise, as in the JAX package, ref up to 2048 positions, else
    blockwise.  The banded 'local' path of sliding windows waits for the
    hybrid family.
    """
    if impl == "pallas" or (impl == "auto" and _flash_takes(q, k, v)):
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    s = q.shape[2]
    if impl == "local" or (
        impl == "auto" and causal and window > 0 and s == k.shape[2]
        and s % window == 0 and s >= 2 * window
    ):
        raise NotImplementedError(
            "attention_local is not ported yet (ROADMAP.md Queue 1: hybrid family)")
    if impl == "ref" or (impl == "auto" and s <= 2048):
        return attention_ref(q, k, v, causal=causal, window=window)
    if impl not in ("blockwise", "auto"):
        raise ValueError(f"unknown attention impl {impl!r}")
    return attention_blockwise(q, k, v, causal=causal, window=window,
                               block_size=block_size)


def quantize_kv(x):
    """Symmetric int8 per-row quantization of K/V: x [..., hd] ->
    (int8 payload, f32 scale [...])."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-10)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def decode_attention(q, k_cache, v_cache, cache_len, *, k_scale=None,
                     v_scale=None):
    """Single-position attention against the KV cache.

    q [B, H, 1, hd]; caches [B, K, S_max, hd] (bf16/f32, or int8 with
    ``k_scale``/``v_scale`` [B, K, S_max]); ``cache_len`` = number of valid
    cache positions (the new token's K/V already written).
    """
    b, h, _, hd = q.shape
    kh, smax = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qq = (q.float() / math.sqrt(hd)).to(q.dtype).reshape(b, kh, g, hd)
    s = torch.einsum("bkgh,bkth->bkgt", qq.float(), k_cache.to(q.dtype).float())
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    valid = torch.arange(smax, device=q.device) < cache_len
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
    out = torch.einsum("bkgt,bkth->bkgh", p.to(q.dtype).float(),
                       v_cache.to(q.dtype).float())
    return out.reshape(b, h, 1, hd).to(q.dtype)


def swiglu_mlp(x, wi_gate, wi_up, wo):
    return (F.silu(x @ wi_gate) * (x @ wi_up)) @ wo
