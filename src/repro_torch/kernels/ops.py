"""Dispatching wrappers around the hand-written kernels.

A CUDA tensor goes to the kernel; a CPU tensor goes to the kernel's plain
version in ``ref.py``.  There is no fallback: a kernel that cannot take a
CUDA input raises.  A meta tensor (the dry run, ``launch/dryrun.py``) takes
the kernel's own wrapper, which returns empty meta outputs of the kernel's
shapes and dtypes and records the kernel's work (``kernels/work.py``),
forward and backward: nothing is computed, and nothing is counted as a
launch.  On the card each op is differentiable through its
backward kernel; on the CPU through autograd of the plain version.  The
counts of kernel launches live on each kernel's wrapper
(``repro_torch.kernels.flash_attention.launches`` and ``.bwd_launches``,
likewise for ``.selective_scan`` and ``.rmsnorm``; ``.conv_wgrad.launches``).
"""
from __future__ import annotations

from repro_torch.kernels import conv_wgrad as _cw
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import selective_scan as _ss

__all__ = ["flash_attention", "selective_scan", "rms_norm", "conv3d_stem_wgrad"]


def _on_cpu(t, op: str) -> bool:
    if t.is_cuda or t.is_meta:
        return False
    if t.device.type != "cpu":
        raise ValueError(f"{op} runs on cuda, cpu or meta, not {t.device}")
    return True


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128):
    """q [B, H, Sq, hd]; k/v [B, K, Sk, hd] with K | H.  Returns [B, H, Sq, hd].

    ``block_q``/``block_k`` are the Pallas kernel's tile sizes, kept so calls
    carry over from the JAX package; the result does not depend on them,
    and the CUDA kernel's tiles are fixed when it is compiled.
    """
    del block_q, block_k
    if _on_cpu(q, "flash_attention"):
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def selective_scan(u, dt, a, b_ssm, c_ssm, d_skip, *, h0=None,
                   block_d: int = 256, block_s: int = 128):
    """u, dt [B, S, DI]; a [DI, N]; b/c [B, S, N]; d_skip [DI].  From h=0.
    Returns (y [B, S, DI] f32, h_last [B, DI, N] f32).

    ``block_d``/``block_s`` are the Pallas kernel's tile sizes, kept so calls
    carry over; the result does not depend on them, and the CUDA kernel
    takes any DI and S.  ``h0`` raises, as in the JAX package: decode
    continues from a state through the recurrent step instead.
    """
    del block_d, block_s
    if h0 is not None:
        raise NotImplementedError(
            "kernel path starts from h0=0; decode uses the recurrent step")
    if _on_cpu(u, "selective_scan"):
        return ref.selective_scan_ref(u, dt, a, b_ssm, c_ssm, d_skip)
    return _ss.selective_scan(u, dt, a, b_ssm, c_ssm, d_skip)


def rms_norm(x, scale, *, eps: float = 1e-6, block_rows: int = 256):
    """x [..., d]; scale [d].  ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``
    in x's dtype.  ``block_rows`` is the Pallas kernel's row tile, kept so
    calls carry over; the CUDA kernel runs one row per warp."""
    del block_rows
    if _on_cpu(x, "rms_norm"):
        return ref.rms_norm_ref(x, scale, eps)
    return _rn.rms_norm(x, scale, eps=eps)


def conv3d_stem_wgrad(x, dy, pads):
    """x [N, C, D, H, W] (C 1, 4 or 8) and dy [N, Cout, Do, Ho, Wo], f32.  (dw
    [Cout, C, 3, 3, 3], db [Cout]) of ``F.conv3d(F.pad(x, pads), w, b,
    stride=2)`` for the output gradient ``dy``.  The kernel takes both in the
    channels-last layout."""
    if _on_cpu(x, "conv3d_stem_wgrad"):
        return ref.conv3d_stem_wgrad_ref(x, dy, pads)
    return _cw.conv3d_stem_wgrad(x, dy, pads)
