"""Model building blocks on tensors: the port of the JAX package's
``models/layers.py`` (dense, sliding-window, MoE, Mamba-1 and encoder-decoder
blocks), for serving and training.

Conventions follow the JAX package: activations ``x [B, S, D]``; attention
internals head-major ``q [B, H, S, hd]``, ``k/v [B, K, S, hd]`` (GQA: K
divides H).  Every function returns its input's dtype; softmax, norms and
the SSM scan run in f32.  Where the JAX code asks for f32 accumulation of
low-precision operands (``preferred_element_type``), the operands are
widened to f32.

``rms_norm``, ``attention`` and ``_selective_scan`` take an ``impl``
switch.  'pallas' selects the hand-written CUDA kernel (the name carries
over from the JAX package); 'auto' takes the kernel for CUDA inputs, which
raises on an input it does not take, and the JAX package's plain choice for
CPU inputs.  Every path is differentiable: the kernels through their
backward kernels, the plain ``rms_norm`` through the JAX package's custom
VJP (cotangents in the input dtypes), the rest through autograd.

``constrain`` has no counterpart: on a mesh the sharded train step hands
the model plain tensors (``distributed/fsdp.py``), so an activation is
never a DTensor and has no layout to pin.  Where JAX's constraints split
the SwiGLU or GELU hidden or the Mamba channels over ``model``,
:func:`swiglu_mlp`, :func:`gelu_mlp` and :func:`mamba_block` take
``split`` (a ``tensor_parallel.SplitPlan`` whose part splits): their
weights are then the model rank's block, and the region's input and output
pass the plan's *f* and *g*.  So does :func:`moe_layer` where the JAX
layout puts the experts over ``model``.  Where the JAX layout puts a decode
cache's sequence over ``model``, :func:`decode_attention` takes ``split``
and the rank's block of the slots.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, attention_ref, rms_norm_ref, rms_norm_ref_bwd

__all__ = [
    "rms_norm",
    "layer_norm",
    "sinusoidal_positions",
    "apply_rope",
    "repeat_kv",
    "attention_ref",
    "attention_blockwise",
    "attention_local",
    "attention",
    "quantize_kv",
    "decode_attention",
    "swiglu_mlp",
    "gelu_mlp",
    "route",
    "moe_layer",
    "mamba_block",
    "mamba_decode_step",
]


class _RMSNorm(torch.autograd.Function):
    """The plain RMSNorm with the JAX package's custom VJP
    (``repro/models/layers.py::rms_norm``): dx in x's dtype, ds in scale's."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rms_norm_ref(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, ds = rms_norm_ref_bwd(x, scale, dy, ctx.eps)
        return dx, ds, None


def rms_norm(x, scale, eps: float = 1e-6, *, impl: str = "auto"):
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in f32, cast to x's dtype.
    impl: 'ref' | 'pallas' | 'auto' (see the module doc)."""
    if impl == "pallas" or (impl == "auto" and x.is_cuda):
        return ops.rms_norm(x, scale, eps=eps)
    if impl not in ("ref", "auto"):
        raise ValueError(f"unknown rms_norm impl {impl!r}")
    return _RMSNorm.apply(x, scale, eps)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` in f32, cast to x's
    dtype.  The encoder-decoder passes ``cfg.norm_eps`` (1e-6 for
    whisper-medium), not this default."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def sinusoidal_positions(length: int, dim: int, dtype=torch.float32, device=None):
    """[length, dim] table: sin at even, cos at odd columns, in f32, cast to
    ``dtype``."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


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


def attention_local(q, k, v, *, window: int):
    """Banded causal attention for sliding windows: O(S * 2W) instead of
    O(S^2).  Each query chunk of size W attends to its own and the previous
    key chunk: every in-window key is covered, everything else is masked.
    Requires self-attention (Sq == Sk) with S % W == 0."""
    b, h, s, hd = q.shape
    kh = k.shape[1]
    k = repeat_kv(k, h // kh)
    v = repeat_kv(v, h // kh)
    w = window
    nc = s // w
    qc = (q.float() / math.sqrt(hd)).to(q.dtype).reshape(b, h, nc, w, hd)
    kc = k.reshape(b, h, nc, w, hd)
    vc = v.reshape(b, h, nc, w, hd)
    # previous chunk (zeros before chunk 0, masked out anyway)
    kp = F.pad(kc, (0, 0, 0, 0, 1, 0))[:, :, :-1]
    vp = F.pad(vc, (0, 0, 0, 0, 1, 0))[:, :, :-1]
    k2 = torch.cat([kp, kc], dim=3)                 # [.., nc, 2W, hd]
    v2 = torch.cat([vp, vc], dim=3)
    qpos = torch.arange(w, device=q.device)[:, None]           # within chunk
    krel = torch.arange(2 * w, device=q.device)[None, :] - w   # rel. to chunk start
    band = (krel <= qpos) & (qpos - krel < w)
    outs = []
    for j in range(nc):  # live score tensor is [B, H, W, 2W]
        scores = torch.einsum("bhqd,bhkd->bhqk", qc[:, :, j].float(),
                              k2[:, :, j].float())
        ok = band if j > 0 else band & (krel >= 0)  # chunk 0 has no predecessor
        p = torch.softmax(torch.where(ok, scores, NEG_INF), dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(),
                                 v2[:, :, j].float()))
    return torch.stack(outs, dim=2).reshape(b, h, s, hd).to(q.dtype)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              impl: str = "auto", block_size: int = 512):
    """Dispatching attention entry point.

    impl: 'ref' | 'blockwise' | 'local' | 'pallas' | 'auto'.  'pallas' is
    the hand-written flash-attention kernel.  'auto' takes the kernel for
    CUDA inputs; for CPU inputs, as in the JAX package, the banded local path
    for sliding windows, ref up to 2048 positions, else blockwise.
    """
    if impl == "pallas" or (impl == "auto" and q.is_cuda):
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    s = q.shape[2]
    if impl == "local" or (
        impl == "auto" and causal and window > 0 and s == k.shape[2]
        and s % window == 0 and s >= 2 * window
    ):
        return attention_local(q, k, v, window=window)
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
                     v_scale=None, split=None):
    """Single-position attention against the KV cache.

    q [B, H, 1, hd]; caches [B, K, S_max, hd] (bf16/f32, or int8 with
    ``k_scale``/``v_scale`` [B, K, S_max]); ``cache_len`` = number of valid
    cache positions (the new token's K/V already written).

    With ``split`` (a ``tensor_parallel.SplitPlan``) the caches hold the
    model rank's equal block of the slots, global slot ``split.rank * S_max
    + t``, and the softmax is flash-decoding's partial one: the max over
    the valid slots all-reduced (MAX) before any exponent is taken, so a
    rank with no valid slot adds exact zeros, then the sum of the
    exponents, then the product with V (normalised, cast and scaled as the
    JAX package orders it) are each all-reduced (SUM) over the model
    ranks.
    """
    b, h, _, hd = q.shape
    kh, smax = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qq = (q.float() / math.sqrt(hd)).to(q.dtype).reshape(b, kh, g, hd)
    s = torch.einsum("bkgh,bkth->bkgt", qq.float(), k_cache.to(q.dtype).float())
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    first = 0 if split is None else split.rank * smax
    valid = torch.arange(first, first + smax, device=q.device) < cache_len
    s = torch.where(valid, s, NEG_INF)
    m = _over_ranks(s.amax(dim=-1, keepdim=True), split, "max")
    p = torch.exp(s - m)
    p = p / torch.clamp_min(_over_ranks(p.sum(dim=-1, keepdim=True), split), 1e-30)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
    out = torch.einsum("bkgt,bkth->bkgh", p.to(q.dtype).float(),
                       v_cache.to(q.dtype).float())
    return _over_ranks(out, split).reshape(b, h, 1, hd).to(q.dtype)


def _over_ranks(x, split, op: str = "sum"):
    """``x`` all-reduced (``op``: sum or max) over ``split``'s model ranks;
    ``x`` itself where ``split`` is None."""
    if split is None:
        return x
    import torch.distributed as dist

    from repro_torch.distributed import tensor_parallel as tp

    return tp.all_reduce(x, split, dist.ReduceOp.MAX if op == "max" else None)


def swiglu_mlp(x, wi_gate, wi_up, wo, split=None):
    """``(silu(x wi_gate) * (x wi_up)) wo``.  With ``split`` the weights
    hold the rank's hidden units: its partial sum is all-reduced."""
    if split is None:
        return (F.silu(x @ wi_gate) * (x @ wi_up)) @ wo
    from repro_torch.distributed import tensor_parallel as tp

    x = tp.copy_in(x, split)
    return tp.reduce_out((F.silu(x @ wi_gate) * (x @ wi_up)) @ wo, split)


def gelu_mlp(x, wi, bi, wo, bo, split=None):
    """The JAX package's ``jax.nn.gelu(approximate=True)``: the tanh form,
    not torch's default erf form.  With ``split`` ``wi``, ``bi`` and ``wo``
    hold the rank's hidden units: its partial sum is all-reduced, and
    ``bo``, which is whole, is added once after it."""
    if split is None:
        return F.gelu((x @ wi) + bi, approximate="tanh") @ wo + bo
    from repro_torch.distributed import tensor_parallel as tp

    x = tp.copy_in(x, split)
    return tp.reduce_out(F.gelu((x @ wi) + bi, approximate="tanh") @ wo, split) + bo


# ---------------------------------------------------------------------------
# Mixture of Experts (Switch-style dropping dispatch)
# ---------------------------------------------------------------------------


def route(x, router_w, *, top_k: int, num_real_experts: int):
    """The router of :func:`moe_layer`.  x [..., D]; router_w [D, E_pad] f32.

    f32 logits ``x @ router_w`` (in full f32 on the card: TF32 stays off, as
    it is by PyTorch's default), pad experts (index >= ``num_real_experts``)
    masked with ``NEG_INF`` (-0.7 x the f32 max, as in the JAX package, not
    -inf), softmax, top-k, the k gates renormalised to sum to 1.
    Returns (probs [..., E_pad] f32, gates [..., k] f32, expert_idx [..., k]).
    ``torch.topk`` and ``lax.top_k`` order distinct values alike."""
    e_pad = router_w.shape[1]
    logits = x.float() @ router_w.float()
    if e_pad > num_real_experts:
        pad = torch.arange(e_pad, device=x.device) >= num_real_experts
        logits = torch.where(pad, NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    return probs, gates, expert_idx


def moe_layer(x, router_w, we_gate, we_up, we_down, *, top_k: int,
              num_real_experts: int, capacity_factor: float = 1.25,
              group_size: int = 256, shared: tuple | None = None, split=None,
              shared_split=None):
    """Top-k token-choice MoE with grouped one-hot dispatch, as the JAX
    package computes it.  x [B, S, D]; router_w [D, E_pad]; we_gate, we_up
    [E_pad, D, F]; we_down [E_pad, F, D]; ``shared`` (wi_gate [D, F_s], wi_up,
    wo) or None.  Returns (y [B, S, D], aux: the Switch load-balance loss).

    Tokens go in groups of ``min(group_size, S)`` along the sequence; each
    expert takes ``cap = max(1, ceil(gs * k * cf / E_real))`` choices a
    group.  A choice's slot is the running count of earlier choices of its
    expert in token-major order (token, then its k choices); choices past
    ``cap`` are dropped.  Which choices drop depends on that order, so the
    dispatch and combine stay one-hot einsums, not a scatter.

    With ``split`` (a ``tensor_parallel.SplitPlan`` whose experts split) the
    expert leaves hold the model rank's block of the E_pad experts.  Every
    rank routes the whole, replicated ``x`` and counts slots over all
    experts (the running count is per expert, so it commutes with cutting
    the expert axis), then dispatches, computes and combines only its own
    experts' slots.  ``x`` and the gates enter that region through *f*: a
    rank's combine reads only its experts' gates, so their gradient (and,
    through the router, ``x``'s) is summed over ``model``.  The
    probabilities take no *f*: the aux loss is computed whole on every rank
    and its gradient is already the whole.  With ``shared_split`` the
    shared expert's leaves hold the rank's block of its hidden.  Where both
    split, one *g* all-reduces the sum of the two partial sums; a region
    that splits alone has its own *f* and *g*.  A rank whose block holds
    only pad experts still computes their empty slots, as GSPMD does."""
    from repro_torch.distributed import tensor_parallel as tp

    b, s, d = x.shape
    e_pad = router_w.shape[1]
    gs = min(group_size, s)
    if s % gs:
        raise ValueError(f"sequence {s} is not a multiple of the group {gs}")
    ng = s // gs
    cap = max(1, int(math.ceil(gs * top_k * capacity_factor / num_real_experts)))

    xg = x.reshape(b, ng, gs, d)
    probs, gates, expert_idx = route(xg, router_w, top_k=top_k,
                                     num_real_experts=num_real_experts)
    onehot = F.one_hot(expert_idx, e_pad).float()                   # [b,ng,gs,k,e]
    flat = onehot.reshape(b, ng, gs * top_k, e_pad)
    pos_in_expert = (torch.cumsum(flat, dim=2) - flat).reshape(b, ng, gs, top_k, e_pad)
    disp = onehot * (pos_in_expert < cap)
    pos = torch.einsum("bnske,bnske->bnsk", pos_in_expert, disp)   # chosen slot
    slot_oh = F.one_hot(pos.long(), cap).float()                    # [b,ng,gs,k,cap]
    xr = x
    if split is not None:
        first, n = split.block(e_pad)
        if we_gate.shape[0] != n:
            raise ValueError(f"expert leaves of {we_gate.shape[0]} experts are not model "
                             f"rank {split.rank}'s block of {n} of {e_pad}")
        disp = disp[..., first:first + n]
        xr, gates = tp.copy_in(x, split), tp.copy_in(gates, split)
    # dispatch [b,ng,gs,e,cap]: token -> (expert, slot); combine adds the gate
    dispatch = torch.einsum("bnske,bnskc->bnsec", disp, slot_oh)
    combine = torch.einsum("bnske,bnskc->bnsec", gates[..., None] * disp, slot_oh)

    cd = x.dtype
    xe = torch.einsum("bnsd,bnsec->bnecd", xr.reshape(b, ng, gs, d),
                      dispatch.to(cd))                               # [b,ng,e,cap,d]
    h = F.silu(torch.einsum("bnecd,edf->bnecf", xe, we_gate)) * torch.einsum(
        "bnecd,edf->bnecf", xe, we_up)
    ye = torch.einsum("bnecf,efd->bnecd", h, we_down)
    y = torch.einsum("bnecd,bnsec->bnsd", ye, combine.to(cd)).reshape(b, s, d)

    me = probs.mean(dim=(0, 1, 2))                     # mean router prob
    ce = onehot.sum(dim=3).mean(dim=(0, 1, 2))         # token fraction
    aux = num_real_experts * torch.sum(me * ce) / top_k
    if shared is not None and split is not None and shared_split is not None:
        y = y + swiglu_mlp(xr, *shared)    # the rank's shared hidden: a partial sum
        shared = None
    if split is not None:
        y = tp.reduce_out(y, split)
    if shared is not None:
        y = y + swiglu_mlp(x, *shared, split=shared_split)
    return y, aux


# ---------------------------------------------------------------------------
# Mamba-1 block (selective scan)
# ---------------------------------------------------------------------------


def _prefix_scan(decay, inp):
    """Inclusive scan over dim 1 of the pairs (decay, inp) under
    ``(a1, b1) . (a2, b2) = (a1 a2, b2 + a2 b1)``: ceil(log2 Q) passes, each
    combining every element with the one ``off`` steps before it."""
    q = decay.shape[1]
    off = 1
    while off < q:
        a_prev, b_prev = decay[:, :-off], inp[:, :-off]
        inp = torch.cat([inp[:, :off], inp[:, off:] + decay[:, off:] * b_prev], dim=1)
        decay = torch.cat([decay[:, :off], decay[:, off:] * a_prev], dim=1)
        off *= 2
    return decay, inp


def _selective_scan(u, dt, a, b_ssm, c_ssm, d_skip, *, chunk: int = 256,
                    h0=None, impl: str = "auto"):
    """y_t = C_t . h_t + D u_t,   h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t.

    u, dt [B, S, DI]; a [DI, N]; b/c [B, S, N]; returns (y [B,S,DI] f32,
    h [B,DI,N] f32).  impl: 'ref' | 'pallas' | 'auto'.  The plain path runs
    sequence chunks of ``chunk`` steps in order (carry [B, DI, N]) with a
    log-step associative scan inside each chunk, as the JAX package does;
    it starts from ``h0`` when given (decode).  The kernel starts from 0 and
    raises on ``h0``.
    """
    if impl == "pallas" or (impl == "auto" and u.is_cuda):
        return ops.selective_scan(u, dt, a, b_ssm, c_ssm, d_skip, h0=h0)
    if impl not in ("ref", "auto"):
        raise ValueError(f"unknown selective scan impl {impl!r}")
    bsz, s, di = u.shape
    n = a.shape[1]
    af = a.float()
    h = (torch.zeros((bsz, di, n), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    # Steps past S would carry dt = 0 (decay 1, input 0) and leave h as it
    # is, so a short sequence takes one chunk of its own length.
    q = min(chunk, s)
    ys = []
    for t0 in range(0, s, q):
        sl = slice(t0, t0 + q)
        dtf = dt[:, sl].float()                                     # [B, Q, DI]
        decay = torch.exp(dtf[..., None] * af)                      # [B, Q, DI, N]
        inp = (dtf * u[:, sl].float())[..., None] * b_ssm[:, sl, None, :].float()
        dec, acc = _prefix_scan(decay, inp)
        hseq = dec * h[:, None] + acc                               # [B, Q, DI, N]
        ys.append(torch.einsum("bqdn,bqn->bqd", hseq, c_ssm[:, sl].float()))
        h = hseq[:, -1]
    y = torch.cat(ys, dim=1) + u.float() * d_skip.float()
    return y, h


def mamba_block(x, p, *, dt_rank: int, ssm_state: int, conv_k: int = 4,
                impl: str = "auto", h0=None, conv0=None, return_state=False,
                split=None, norm_eps: float = 1e-6, norm_impl: str = "auto"):
    """Mamba-1 mixer.  x [B, S, D]; params dict p (see ``lm.init_lm``).
    ``impl`` selects the selective scan.

    Where p holds ``dt_norm`` [R], ``b_norm`` and ``c_norm`` [N] (Jamba's
    mixer), dt, B and C are RMS-normalised after ``x_proj``, before
    ``dt_proj`` and the scan, with ``norm_eps`` through :func:`rms_norm`
    (``norm_impl``: K1 on the card); without them nothing else changes.

    With ``split`` the leaves hold the model rank's DI channels (``in_proj``
    its xin and z columns): the conv, ``dt_proj``, the scan and ``d_skip``
    run on them; ``x_proj``'s partial (dt, B, C) is all-reduced and its
    gradient too (it feeds every channel), ``out_proj``'s partial sum is
    all-reduced; states and conv tails are the rank's channels'.

    The depthwise causal conv is the JAX package's ``conv_general_dilated``
    with ``feature_group_count=DI`` and left padding ``conv_k - 1`` (none
    when ``conv0`` carries the previous inputs): a cross-correlation,
    written as ``conv_k`` shifted f32 multiply-adds, so no convolution
    library (and no TF32) is involved.

    With ``return_state`` also returns (h_last [B,DI,N], conv_tail
    [B, conv_k-1, DI]): the last ``conv_k - 1`` rows of the conv's input,
    its left zero padding included, so a prompt shorter than ``conv_k - 1``
    tokens still leaves a full tail and decode continues the full forward.
    (The JAX package slices the unpadded input and its decode then raises.)
    """
    if split is not None:
        from repro_torch.distributed import tensor_parallel as tp

        x = tp.copy_in(x, split)
    di = p["in_proj"].shape[1] // 2
    xin, z = (x @ p["in_proj"]).split(di, dim=-1)

    xin_ext = xin if conv0 is None else torch.cat([conv0.to(xin.dtype), xin], dim=1)
    xe = xin_ext.float()
    if conv0 is None:
        xe = F.pad(xe, (0, 0, conv_k - 1, 0))
    s_out = xe.shape[1] - conv_k + 1
    w = p["conv_w"].float()                                         # [k, DI]
    conv = p["conv_b"].float() + sum(xe[:, j:j + s_out] * w[j] for j in range(conv_k))
    xin_c = F.silu(conv).to(x.dtype)

    xdbc = xin_c @ p["x_proj"]                                      # [B,S,R+2N]
    if split is not None:
        xdbc = tp.copy_in(tp.reduce_out(xdbc, split), split)
    dt_raw = xdbc[..., :dt_rank]
    b_ssm = xdbc[..., dt_rank:dt_rank + ssm_state].contiguous()
    c_ssm = xdbc[..., dt_rank + ssm_state:].contiguous()
    if "dt_norm" in p:
        dt_raw = rms_norm(dt_raw.contiguous(), p["dt_norm"], norm_eps, impl=norm_impl)
        b_ssm = rms_norm(b_ssm, p["b_norm"], norm_eps, impl=norm_impl)
        c_ssm = rms_norm(c_ssm, p["c_norm"], norm_eps, impl=norm_impl)
    dt = F.softplus(dt_raw @ p["dt_proj"] + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    y, h_last = _selective_scan(xin_c, dt, a, b_ssm, c_ssm, p["d_skip"], h0=h0,
                                impl=impl)
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ p["out_proj"]
    if split is not None:
        out = tp.reduce_out(out, split)
    if return_state:
        conv_tail = xe[:, -(conv_k - 1):].to(xin.dtype) if conv_k > 1 else None
        return out, h_last, conv_tail
    return out


def mamba_decode_step(x, p, h, conv_state, *, dt_rank: int, ssm_state: int,
                      conv_k: int = 4, split=None):
    """One-token recurrent Mamba step through the plain scan (the kernel
    starts from h=0).  x [B, 1, D]; h [B, DI, N]; conv_state [B, conv_k-1, DI]
    (with ``split``: the rank's DI channels).
    Returns (y [B, 1, D], h', conv_state')."""
    return mamba_block(x, p, dt_rank=dt_rank, ssm_state=ssm_state, conv_k=conv_k,
                       impl="ref", h0=h, conv0=conv_state, return_state=True,
                       split=split)
