"""Dispatching wrappers around the hand-written kernels.

A CUDA tensor goes to the kernel; a CPU tensor goes to the kernel's plain
version in ``ref.py``.  There is no fallback: a kernel that cannot take a
CUDA input raises.  The count of kernel launches lives on the kernel's
wrapper (``repro_torch.kernels.flash_attention.launches``).
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref

__all__ = ["flash_attention"]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128):
    """q [B, H, Sq, hd]; k/v [B, K, Sk, hd] with K | H.  Returns [B, H, Sq, hd].

    ``block_q``/``block_k`` are the Pallas kernel's tile sizes, kept so calls
    carry over from the JAX package; the result does not depend on them,
    and the CUDA kernel's tiles are fixed when it is compiled.
    """
    del block_q, block_k
    if q.is_cuda:
        return _fa.flash_attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return ref.attention_ref(q, k, v, causal=causal, window=window)
