"""ctypes wrappers of the hand-written CUDA flash-attention kernels.

The forward (``csrc/flash_attention.cu``) replaces the JAX package's Pallas
TPU kernel ``repro/kernels/flash_attention.py::flash_attention_kernel``: bf16
runs on the tensor cores in 64-row query tiles over 64-key tiles, f32 on the
CUDA cores.  The backward (``csrc/flash_attention_bwd.cu``) has no Pallas
original; it computes the gradient of the plain attention from the row
log-sum-exp the forward writes when autograd will need it: bf16 on the
tensor cores over 64-row query tiles and 64-key tiles (``BWD_BLOCK_Q``,
``BWD_BLOCK_K``), f32 on the CUDA cores over 16-row and 32-key tiles
(``SIMT_BWD_BLOCK_Q``, ``SIMT_BWD_BLOCK_K``).  Both launch on
PyTorch's current stream, allocate nothing and do not synchronise; these
wrappers validate the inputs, allocate outputs and scratch and raise if a
launch is refused.  ``flash_attention`` is a ``torch.autograd.Function``
where grad is enabled and an input requires it, and the plain forward call
otherwise (serving: no log-sum-exp is written).  ``launches`` and
``bwd_launches`` count successful forward and backward launches.  On meta
tensors (the dry run) the wrappers allocate what a launch would, launch
nothing and count nothing; on either device they hand each call's work to
``work.record``.

``key_tile_range``, ``tile_needs_mask`` and ``query_tile_range`` mirror the
kernels' loop bounds and mask test in pure Python, so the CPU tests can hold
them against the mask; ``tc_smem_bytes`` and ``bwd_tc_smem_bytes`` mirror
the bf16 kernels' shared-memory sizes.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, work
from repro_torch.kernels._build import SMS, device_sms

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd", "launches",
           "bwd_launches", "HEAD_DIMS", "DTYPES", "BLOCK_Q", "BLOCK_K", "BWD_BLOCK_Q",
           "BWD_BLOCK_K", "SIMT_BWD_BLOCK_Q", "SIMT_BWD_BLOCK_K", "key_tile_range",
           "tile_needs_mask", "query_tile_range", "tc_smem_bytes", "bwd_tc_smem_bytes",
           "bwd_gqa_splits"]

#: Head dims and dtypes the kernel is instantiated for (template parameters).
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
#: The bf16 kernel's query rows per block and keys per tile.
BLOCK_Q = 64
BLOCK_K = 64

#: The bf16 backward's query rows and keys per tile (``kTcBlock`` in
#: ``csrc/flash_attention_bwd.cu``), and the f32 SIMT backward's (``kBlockQ``,
#: ``kBlockK`` there).
BWD_BLOCK_Q = 64
BWD_BLOCK_K = 64
SIMT_BWD_BLOCK_Q = 16
SIMT_BWD_BLOCK_K = 32

#: dK/dV blocks an SM holds at once (255 registers a thread, 4 warps).
_BWD_BLOCKS_PER_SM = 2

#: Forward and backward launches since import (or since a caller last set
#: them to 0).
launches = 0
bwd_launches = 0

_fn = None
_bwd_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = ctypes.CDLL(str(_build.build("flash_attention")))
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = lib.flash_attention_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn = (fn, err)
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        lib = ctypes.CDLL(str(_build.build("flash_attention_bwd")))
        fn = lib.flash_attention_bwd
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = lib.flash_attention_bwd_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _bwd_fn = (fn, err)
    return _bwd_fn


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


def query_tile_range(k0: int, sq: int, sk: int, causal: bool, window: int, *,
                     block_q: int = BWD_BLOCK_Q, block_k: int = BWD_BLOCK_K
                     ) -> tuple[int, int]:
    """Query rows ``[begin, end)`` that can see a key of the tile ``[k0, k0 +
    block_k)``, ``begin`` a multiple of ``block_q``: the rows the backward's
    dK/dV block visits (the bf16 kernel's tiles by default; the f32 one
    takes ``SIMT_BWD_BLOCK_Q``/``SIMT_BWD_BLOCK_K``).  Mirrors
    ``query_tile_range`` in ``csrc/flash_attention_bwd.cu``; change the two
    together."""
    k_last = min(k0 + block_k, sk) - 1
    begin = (min(k0, sq) // block_q) * block_q if causal else 0
    end = min(sq, k_last + window) if window > 0 else sq
    return begin, end


def tc_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one bf16 block: the Q tile and two stages of
    K and V tiles.  Mirrors ``tc_smem_bytes`` in ``csrc/flash_attention.cu``."""
    return (BLOCK_Q + 2 * 2 * BLOCK_K) * hd * 2


def bwd_tc_smem_bytes(hd: int) -> tuple[int, int]:
    """Dynamic shared memory of one bf16 backward block: (dK/dV block: K and
    V tiles, two stages of Q and dO tiles and of their rows' lse and D in
    f32; dQ block: Q and dO tiles, two stages of K and V tiles).  Mirrors
    ``tc_dkdv_smem_bytes``/``tc_dq_smem_bytes`` in
    ``csrc/flash_attention_bwd.cu``."""
    tiles = (2 + 2 * 2) * BWD_BLOCK_Q * hd * 2
    return tiles + 2 * 2 * BWD_BLOCK_Q * 4, tiles


def bwd_gqa_splits(b: int, h: int, kh: int, sq: int, sk: int, causal: bool, window: int, *,
                   sms: int = SMS) -> int:
    """Chunks to cut each GQA group of the bf16 dK/dV kernel into (1: the
    whole group in one block's registers).  A block per (kv head, 64-key
    tile) loops over the group's heads and the query tiles
    ``query_tile_range`` admits; under a causal mask without a window the
    first key tile sees every query tile and the last one, so the heaviest
    blocks outlast the rest.  Where the heaviest block holds over 1.5 times
    a block slot's share of the work (``sms`` SMs of two blocks), the group
    is cut into the fewest chunks that bring it within that share; the
    chunks' f32 partial rows are then summed by a second kernel.  On an H100
    (``kernels/bwd_variants.py`` times every count) this picks the fastest
    at hymba-1.5b's training shape (1: 0.2871 ms; 3: 0.2998) and at
    qwen2-0.5b's with a batch of 1 (7: 0.1141; 4: 0.1551), and at
    qwen2-0.5b's training shape 3 (0.4096 ms), within 1% of the fastest, 4
    (0.4061); 2 to 5 lie within 1.5% of each other there, 1 takes 0.5199."""
    group = h // kh
    tiles = []
    for k0 in range(0, sk, BWD_BLOCK_K):
        begin, end = query_tile_range(k0, sq, sk, causal, window)
        tiles.append(-(-(end - begin) // BWD_BLOCK_Q) if end > begin else 0)
    heaviest, share = max(tiles), b * kh * group * sum(tiles) / (sms * _BWD_BLOCKS_PER_SM)
    if group == 1 or group * heaviest <= 1.5 * share:
        return 1
    return next((s for s in range(2, group) if -(-group // s) * heaviest <= share), group)


def _check(q, k, v, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not (t.is_cuda or t.is_meta):
            raise ValueError(f"{name} must be a CUDA tensor (or meta), got {t.device}")
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


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        with_lse: bool = False):
    """The forward kernel: returns (o [B, H, Sq, hd] in q's dtype, and with
    ``with_lse`` each query row's log-sum-exp of the scaled scores, f32
    [B, H, Sq], else None)."""
    global launches
    _check(q, k, v, window)
    b, h, sq, hd = q.shape
    kh, sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if not q.is_meta:
        fn, err_str = _kernel()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     None if lse is None else lse.data_ptr(),
                     b, h, kh, sq, sk, hd, int(causal), int(window),
                     int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(hd), stream)
        if err:
            raise RuntimeError(
                f"flash_attention launch failed: {err_str(err).decode()} ({err})")
        launches += 1
    work.record("flash_attention", work.attention(b, h, kh, sq, sk, hd, causal, window,
                                                  q.element_size(), lse=with_lse), q.dtype)
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True, window: int = 0):
    """The backward kernels: (dq, dk, dv) of ``flash_attention_fwd``'s output
    ``o`` for the cotangent ``do``, in q's dtype; dk and dv summed over each
    kv head's group of query heads."""
    global bwd_launches
    _check(q, k, v, window)
    do = do.contiguous()
    if do.data_ptr() % 16:  # the kernels read dO in 16-byte vectors
        do = do.clone()
    if do.shape != q.shape or do.dtype != q.dtype or o.shape != q.shape or \
            lse.shape != q.shape[:3] or do.device != q.device or \
            not o.is_contiguous() or o.data_ptr() % 16:
        raise ValueError(f"o {tuple(o.shape)} / do {tuple(do.shape)} {do.dtype} / lse "
                         f"{tuple(lse.shape)} do not fit q {tuple(q.shape)} {q.dtype}")
    b, h, sq, hd = q.shape
    kh, sk = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    # the f32 kernels sum the whole group in registers
    splits = bwd_gqa_splits(b, h, kh, sq, sk, causal, window,
                            sms=device_sms(q.device)) if bf16 else 1
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    part = (torch.empty((2, splits, b * kh, sk, hd), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    if not q.is_meta:
        fn, err_str = _bwd_kernel()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), None if part is None else part.data_ptr(), b, h, kh, sq,
                     sk, hd, int(causal), int(window), splits, int(bf16), 1.0 / math.sqrt(hd),
                     stream)
        if err:
            raise RuntimeError(
                f"flash_attention_bwd launch failed: {err_str(err).decode()} ({err})")
        bwd_launches += 1
    work.record("flash_attention_bwd", work.attention_bwd(b, h, kh, sq, sk, hd, causal, window,
                                                          q.element_size()), q.dtype)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B, H, Sq, hd]; k/v [B, K, Sk, hd] with K | H, all contiguous,
    16-byte aligned and on one CUDA device, f32 or bf16.  Returns
    [B, H, Sq, hd] in q's dtype, differentiable through the backward kernels
    where grad is enabled and an input requires it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window)
    return flash_attention_fwd(q, k, v, causal=causal, window=window)[0]
