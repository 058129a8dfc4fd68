"""Plain PyTorch versions of the hand-written kernels (the allclose targets).

Deliberately naive: materialize everything, f32 throughout, no tiling.  The
CPU path of each wrapper runs these, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.
"""
from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "attention_ref"]

#: Finite mask value, as in the JAX kernels: ``-inf`` would turn
#: ``exp(m_prev - m_new)`` on a still fully masked tile into NaN.
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,H,Sq,hd]; k/v [B,K,Sk,hd], K | H.  Causal alignment is top-left:
    query and key positions both count from 0, even when Sq != Sk."""
    b, h, sq, hd = q.shape
    kh, sk = k.shape[1], k.shape[2]
    g = h // kh
    kf = k.repeat_interleave(g, dim=1).float()
    vf = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kf) / math.sqrt(hd)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= qpos - kpos < window
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, vf).to(q.dtype)
