"""Gradient compression for bandwidth-constrained links: port of
``repro.distributed.compression``.

Int8 block quantization with error feedback: each leaf is flattened, padded
to blocks of 256, and quantized with a per-block f32 scale ``max|x| / 127``
(clamped at 1e-12); the quantization residual is added to the *next* step's
gradient (error feedback, Karimireddy 2019).  ``torch.round`` rounds half to
even like ``jnp.round``, so the payload matches the JAX package bit for bit.

Two entry points, as there: :func:`quantize_dequantize` (the numerics) and
:func:`compressed_psum`, the explicit int8 all-reduce over a
``torch.distributed`` group (the JAX package's is a ``shard_map``
collective over a mesh axis).
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.convert import from_jax_layout, to_jax_layout

__all__ = ["quantize", "dequantize", "quantize_dequantize", "compressed_psum",
           "init_error_feedback", "apply_error_feedback"]

_BLOCK = 256


def _blocked(x: torch.Tensor):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % _BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, _BLOCK), pad


def quantize(x: torch.Tensor):
    """x -> (int8 payload, f32 per-block scales, pad)."""
    blocks, pad = _blocked(x.to(torch.float32))
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, pad


def dequantize(q, scale, pad: int, shape, dtype):
    x = (q.to(torch.float32) * scale).reshape(-1)
    if pad:
        x = x[:-pad]
    return x.reshape(shape).to(dtype)


def quantize_dequantize(x: torch.Tensor) -> torch.Tensor:
    q, s, pad = quantize(x)
    return dequantize(q, s, pad, x.shape, x.dtype)


def init_error_feedback(grads: Mapping[str, torch.Tensor]) -> dict:
    return {k: torch.zeros_like(g, dtype=torch.float32) for k, g in grads.items()}


def apply_error_feedback(grads: Mapping[str, torch.Tensor], ef: Mapping[str, torch.Tensor]):
    """Returns (compressed grads, new error-feedback buffers).

    Which elements share a block's scale depends on the order a leaf is
    flattened in, so each leaf is blocked in the JAX package's element order
    (:func:`repro_torch.convert.to_jax_layout`: the surrogates' convolution
    kernels, which the port keeps in PyTorch's layout) and moved back."""
    sent, new_ef = {}, {}
    for k, g in grads.items():
        corrected = g.to(torch.float32) + ef[k]
        s = from_jax_layout(k, quantize_dequantize(to_jax_layout(k, corrected)))
        sent[k] = s.to(g.dtype)
        new_ef[k] = corrected - s.to(torch.float32)
    return sent, new_ef


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Int8 all-reduce of ``x`` over the ranks of ``group`` (a
    ``torch.distributed`` process group; None: the default group, e.g.
    ``mesh.get_group("data")`` for one mesh axis).

    The int8 payloads are widened to int32 and all-gathered with the f32
    scales; each rank then sums ``q·scale`` in f32 over the ranks, in rank
    order.  The result equals ``sum_r quantize_dequantize(x_r)``, on every
    rank, as the JAX package's does: quantization error only, no overflow.
    """
    import torch.distributed as dist

    q, scale, pad = quantize(x)
    world = dist.get_world_size(group)
    payloads = [torch.empty(q.shape, dtype=torch.int32, device=q.device)
                for _ in range(world)]
    scales = [torch.empty_like(scale) for _ in range(world)]
    dist.all_gather(payloads, q.to(torch.int32), group=group)
    dist.all_gather(scales, scale, group=group)
    total = payloads[0].to(torch.float32) * scales[0]
    for q_r, s_r in zip(payloads[1:], scales[1:]):
        total = total + q_r.to(torch.float32) * s_r
    out = total.reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape).to(x.dtype)
