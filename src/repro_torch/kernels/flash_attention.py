"""ctypes wrapper of the hand-written CUDA flash-attention kernel.

The kernel (``csrc/flash_attention.cu``) replaces the JAX package's Pallas
TPU kernel ``repro/kernels/flash_attention.py::flash_attention_kernel``: bf16
runs on the tensor cores in 64-row query tiles over 64-key tiles, f32 on the
CUDA cores.  It launches on PyTorch's current stream, allocates nothing and
does not synchronise; this wrapper validates the inputs, allocates the output
and raises if the launch is refused.  ``launches`` counts successful launches.

``key_tile_range`` and ``tile_needs_mask`` mirror the bf16 kernel's loop
bounds and mask test in pure Python, so the CPU tests can hold them against
the mask; ``tc_smem_bytes`` mirrors its shared-memory size.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "launches", "HEAD_DIMS", "DTYPES", "BLOCK_Q", "BLOCK_K",
           "key_tile_range", "tile_needs_mask", "tc_smem_bytes"]

#: Head dims and dtypes the kernel is instantiated for (template parameters).
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
#: The bf16 kernel's query rows per block and keys per tile.
BLOCK_Q = 64
BLOCK_K = 64

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


def key_tile_range(q0: int, sq: int, sk: int, causal: bool, window: int, *,
                   block_q: int = BLOCK_Q, block_k: int = BLOCK_K) -> tuple[int, int]:
    """Keys ``[begin, end)`` the query tile ``[q0, q0 + block_q)`` visits, in
    tiles of ``block_k`` from ``begin``.  Mirrors ``key_tile_range`` in
    ``csrc/flash_attention.cu``; change the two together."""
    q_last = min(q0 + block_q, sq) - 1
    end = min(sk, q_last + 1) if causal else sk
    begin = (max(0, q0 - window + 1) // block_k) * block_k if window > 0 else 0
    return begin, end


def tile_needs_mask(q0: int, kt: int, sq: int, sk: int, causal: bool, window: int, *,
                    block_q: int = BLOCK_Q, block_k: int = BLOCK_K) -> bool:
    """False only if the mask admits every (query row < sq, key) pair of the
    key tile ``[kt, kt + block_k)`` for the query tile at ``q0``.  Mirrors
    ``tile_needs_mask`` in ``csrc/flash_attention.cu``."""
    q_last = min(q0 + block_q, sq) - 1
    return (kt + block_k > sk or (causal and kt + block_k - 1 > q0)
            or (window > 0 and q_last - kt >= window))


def tc_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one bf16 block: the Q tile and two stages of
    K and V tiles.  Mirrors ``tc_smem_bytes`` in ``csrc/flash_attention.cu``."""
    return (BLOCK_Q + 2 * 2 * BLOCK_K) * hd * 2


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
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte copies)")
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
    """q [B, H, Sq, hd]; k/v [B, K, Sk, hd] with K | H, all contiguous,
    16-byte aligned and on one CUDA device, f32 or bf16.  Returns
    [B, H, Sq, hd] in q's dtype."""
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
