"""Plain PyTorch versions of the hand-written kernels (the allclose targets).

Deliberately naive: materialize everything, f32 throughout, no tiling.  The
CPU path of each wrapper runs these, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["NEG_INF", "attention_ref", "selective_scan_ref", "rms_norm_ref",
           "attention_ref_bwd", "selective_scan_ref_bwd", "rms_norm_ref_bwd",
           "conv3d_stem_wgrad_ref"]

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


def selective_scan_ref(u, dt, a, b_ssm, c_ssm, d_skip):
    """Sequential Mamba-1 recurrence from h=0, f32 throughout:
    ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t``, ``y_t = C_t . h_t + D u_t``.

    u, dt [B, S, DI]; a [DI, N]; b/c [B, S, N]; d_skip [DI].
    Returns (y [B, S, DI] f32, h_last [B, DI, N] f32)."""
    bsz, s, di = u.shape
    n = a.shape[1]
    uf, dtf = u.float(), dt.float()
    af, bf, cf = a.float(), b_ssm.float(), c_ssm.float()
    df = d_skip.float()
    h = torch.zeros((bsz, di, n), dtype=torch.float32, device=u.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t, :, None] * af)                  # [B, DI, N]
        h = decay * h + (dtf[:, t] * uf[:, t])[:, :, None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]) + df * uf[:, t])
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(uf)
    return y, h


def rms_norm_ref(x, scale, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in f32, cast to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# Plain versions of the backward kernels
# ---------------------------------------------------------------------------


def attention_ref_bwd(q, k, v, do, *, causal: bool = True, window: int = 0):
    """(dq, dk, dv): autograd through :func:`attention_ref`, in the inputs'
    dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_ref(*leaves, causal=causal, window=window)
        return torch.autograd.grad(out, leaves, do)


def selective_scan_ref_bwd(u, dt, a, b_ssm, c_ssm, d_skip, dy):
    """(du, ddt, da, db, dc, dd_skip) of y: autograd through
    :func:`selective_scan_ref`, in the inputs' dtypes."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (u, dt, a, b_ssm, c_ssm, d_skip)]
        y, _ = selective_scan_ref(*leaves)
        return torch.autograd.grad(y, leaves, dy)


def rms_norm_ref_bwd(x, scale, dy, eps: float = 1e-6):
    """(dx, ds) of :func:`rms_norm_ref` for the cotangent ``dy``: the JAX
    package's custom VJP (``repro/models/layers.py::_rms_norm_bwd``),
    ``dx = r g - x r^3 mean(x g)`` with ``g = dy (1 + scale)`` in f32, cast to
    x's dtype, and ``ds = sum over rows of dy x r`` in scale's dtype."""
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    g = dy.float() * (1.0 + scale.float())
    mean_xg = (xf * g).mean(dim=-1, keepdim=True)
    dx = r * g - xf * (r ** 3) * mean_xg
    ds = (dy.float() * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), ds.to(scale.dtype)


def conv3d_stem_wgrad_ref(x, dy, pads):
    """(dw [Cout, C, 3, 3, 3], db [Cout]) of ``F.conv3d(F.pad(x, pads), w,
    b, stride=2)`` for the output gradient ``dy``; x [N, C, D, H, W], dy [N,
    Cout, Do, Ho, Wo].  Each tap's weight gradient is dy against the padded
    input's stride-2 slice that the tap reads."""
    xp = F.pad(x, pads)
    do, ho, wo = dy.shape[2:]
    taps = [torch.einsum("ncdhw,nidhw->ci", dy,
                         xp[:, :, kd::2, kh::2, kw::2][..., :do, :ho, :wo])
            for kd in range(3) for kh in range(3) for kw in range(3)]
    dw = torch.stack(taps, dim=-1).reshape(dy.shape[1], x.shape[1], 3, 3, 3)
    return dw, dy.sum(dim=(0, 2, 3, 4))
