"""ctypes wrapper of the hand-written CUDA flash-attention kernel.

The kernel (``csrc/flash_attention.cu``) replaces the JAX package's Pallas
TPU kernel ``repro/kernels/flash_attention.py::flash_attention_kernel``.  It
launches on PyTorch's current stream, allocates nothing and does not
synchronise; this wrapper validates the inputs, allocates the output and
raises if the launch is refused.  ``launches`` counts successful launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "launches", "HEAD_DIMS", "DTYPES"]

#: Head dims and dtypes the kernel is instantiated for (template parameters).
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

#: Kernel launches since import (or since a caller last set it to 0).
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = ctypes.CDLL(str(_build.build("flash_attention")))
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = lib.flash_attention_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn = (fn, err)
    return _fn


def _check(q, k, v, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype {q.dtype} not in {DTYPES}")
    b, h, sq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    kh, sk = k.shape[1], k.shape[2]
    if h % kh:
        raise ValueError(f"kv heads {kh} must divide q heads {h}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if min(b, h, sq, sk) == 0 or b * h > 65535:
        raise ValueError(f"unsupported shape q {tuple(q.shape)} k {tuple(k.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B, H, Sq, hd]; k/v [B, K, Sk, hd] with K | H, all contiguous on one
    CUDA device, f32 or bf16.  Returns [B, H, Sq, hd] in q's dtype."""
    global launches
    _check(q, k, v, window)
    fn, err_str = _kernel()
    b, h, sq, hd = q.shape
    kh, sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 b, h, kh, sq, sk, hd, int(causal), int(window),
                 int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(hd), stream)
    if err:
        raise RuntimeError(
            f"flash_attention launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    return o
