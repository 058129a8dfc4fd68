"""ctypes wrappers of the hand-written CUDA RMSNorm kernels.

The forward (``csrc/rms_norm.cu``) replaces the JAX package's Pallas TPU
kernel ``repro/kernels/rmsnorm.py::rms_norm_kernel``.  The backward
(``csrc/rms_norm_bwd.cu``) has no Pallas original: it computes the JAX
package's custom VJP of the plain ``rms_norm`` (``repro/models/layers.py::
_rms_norm_bwd``), dx in x's dtype and ds summed over rows in scale's dtype.
Both launch on PyTorch's current stream, allocate nothing and do not
synchronise; these wrappers validate the inputs, allocate outputs and
scratch and raise if a launch is refused.  ``rms_norm`` is a
``torch.autograd.Function`` where grad is enabled and an input requires it.
``launches`` and ``bwd_launches`` count successful launches.  On meta
tensors (the dry run) the wrappers allocate what a launch would, launch
nothing and count nothing; on either device they hand each call's work to
``work.record``.

``launch_shape`` and ``bwd_launch_shape`` pick the kernels' instantiations
and grids in pure Python, so the CPU tests reach them.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, work

__all__ = ["rms_norm", "rms_norm_fwd", "rms_norm_bwd", "launches", "bwd_launches", "DTYPES",
           "MAX_D", "PER_LANE", "WARPS", "ROWS_PER_WARP", "MAX_BLOCKS", "BWD_PER_LANE",
           "BWD_SPLITS", "BWD_PLANS", "BWD_WARPS", "BWD_BLOCKS_PER_SM", "LaunchShape",
           "launch_shape", "BwdShape", "bwd_launch_shape", "bwd_smem_bytes", "bwd_registers"]

#: dtypes the kernel is instantiated for, for x and (independently) scale.
DTYPES = (torch.float32, torch.bfloat16)
#: Widest row the kernel takes (226 KB of f32, the limit of the earlier
#: design that staged the row in shared memory, kept so every d runs still).
MAX_D = 226 * 1024 // 4
#: 16-byte vectors a lane can hold in registers (the kernel's kV template
#: instantiations): up to 16 x 32 lanes x 16 bytes, d = 4096 bf16 or 2048 f32.
PER_LANE = (1, 2, 4, 8, 16)
#: Warps of a block; each takes one row at a time.
WARPS = 4
#: Rows a warp takes in turn, reusing the scale it holds in registers: the
#: grid has rows / (WARPS * ROWS_PER_WARP) blocks, at most MAX_BLOCKS (132
#: SMs x 4), past which warps take more rows.  Chosen on an H100 among grids
#: of 264-1536 blocks at hymba-1.5b's and falcon-mamba-7b's prefill rows.
ROWS_PER_WARP = 2
MAX_BLOCKS = 528

#: The backward's register path: 16-byte vectors of x and dy a lane holds
#: (kV), over 1, 2 or 4 warps a row (kSplit).  A row of more than 4 vectors
#: a lane splits, so d = 4096 bf16 holds 4 a lane over 4 warps; a wider row
#: streams.  ``BWD_PLANS`` are the (per_lane, split) pairs the C's ``picked``
#: instantiates: 8 vectors a lane took 209-242 registers, one 8-warp block an
#: SM, and was slower at every training shape on an H100 (PERF.md §6).
BWD_PER_LANE = (1, 2, 4)
BWD_SPLITS = (1, 2, 4)
BWD_PLANS = ((1, 1), (2, 1), (4, 1), (4, 2), (4, 4))
#: The backward's grid: blocks of BWD_WARPS warps, at most BWD_BLOCKS_PER_SM
#: blocks an SM (one wave at ~126 registers a thread), each block writing one
#: f32 partial row of ds.  Chosen on an H100 among 4- and 8-warp blocks and
#: 1-4 blocks an SM at the three training shapes (``bwd_variants``).
BWD_WARPS = 8
BWD_BLOCKS_PER_SM = 2
#: Dynamic shared memory a backward block may use (one f32 row of ds a
#: team): 227 KB less the split rows' sums the kernel keeps beside it.
_BWD_SMEM = 227 * 1024 - 128

#: Forward and backward launches since import (or since a caller last set
#: them to 0).
launches = 0
bwd_launches = 0

_fn = None
_bwd_fn = None


class LaunchShape(NamedTuple):
    vec: bool      # 16-byte loads; False: scalar loads
    per_lane: int  # 16-byte vectors of the row a lane holds; 0: the row is read twice
    blocks: int    # grid of WARPS-warp blocks


def launch_shape(rows: int, d: int, x_dtype, *, aligned: bool = True) -> LaunchShape:
    """The kernel instantiation and grid for ``rows`` rows of ``d`` elements
    of ``x_dtype``.  ``aligned``: x, scale and out start on 16 bytes."""
    width = 16 // x_dtype.itemsize
    vec = aligned and d % width == 0
    need = math.ceil(d / width / 32)
    per_lane = next((v for v in PER_LANE if v >= need), 0) if vec else 0
    return LaunchShape(vec, per_lane,
                       min(MAX_BLOCKS, math.ceil(rows / (WARPS * ROWS_PER_WARP))))


class BwdShape(NamedTuple):
    vec: bool      # 16-byte loads; False: scalar loads
    per_lane: int  # 16-byte vectors of the row a lane holds; 0: the streaming path
    split: int     # warps that share a row (a team)
    warps: int     # warps of a block
    blocks: int    # grid, and the rows of the ds partials


def bwd_launch_shape(rows: int, d: int, x_dtype, *, aligned: bool = True,
                     sms: int = _build.SMS) -> BwdShape:
    """The backward's instantiation and grid for ``rows`` rows of ``d``
    elements of ``x_dtype`` on a card of ``sms`` SMs.  ``aligned``: x,
    scale, dy and dx start on 16 bytes.  The register path takes rows of at
    most 4 warps x 4 vectors a lane; the streaming path keeps a warp's f32 row
    of ds in shared memory, so wide rows take fewer warps."""
    width = 16 // x_dtype.itemsize
    vec = aligned and d % width == 0
    need = math.ceil(d / width / 32)  # vectors a lane, one warp a row
    most = BWD_PER_LANE[-1]
    if vec and need <= BWD_SPLITS[-1] * most:  # the row fits a team's registers
        split = next(s for s in BWD_SPLITS if need <= s * most)
        per_lane = next(v for v in BWD_PER_LANE if split * v >= need)
        warps = BWD_WARPS
    else:
        split, per_lane = 1, 0
        warps = next(w for w in (BWD_WARPS, 4, 2, 1) if w * d * 4 <= _BWD_SMEM or w == 1)
    blocks = min(BWD_BLOCKS_PER_SM * sms, math.ceil(rows / (warps // split)))
    return BwdShape(vec, per_lane, split, warps, blocks)


def bwd_smem_bytes(shape: BwdShape, d: int) -> int:
    """Dynamic shared memory of a backward block: an f32 row of ds a team."""
    return shape.warps // shape.split * d * 4


def bwd_registers(per_lane: int, x_dtype, scale_dtype) -> int:
    """32-bit registers a lane of the register path holds its row in: x and
    dy packed (4 words a vector each), scale packed and the f32 sums of ds
    (one word an element)."""
    width = 16 // x_dtype.itemsize
    return per_lane * (4 + 4 + width * scale_dtype.itemsize // 4 + width)


def _kernel():
    global _fn
    if _fn is None:
        lib = ctypes.CDLL(str(_build.build("rms_norm")))
        fn = lib.rms_norm_fwd
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = lib.rms_norm_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn = (fn, err)
    return _fn


def _check(x, scale):
    for name, t in (("x", x), ("scale", scale)):
        if not (t.is_cuda or t.is_meta):
            raise ValueError(f"{name} must be a CUDA tensor (or meta), got {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype not in DTYPES:
            raise ValueError(f"{name} dtype {t.dtype} not in {DTYPES}")
    if x.dim() == 0 or scale.shape != (x.shape[-1],):
        raise ValueError(f"scale {tuple(scale.shape)} does not fit x {tuple(x.shape)}")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if not 0 < d <= MAX_D or not 0 < rows < 2**31:
        raise ValueError(f"unsupported shape x {tuple(x.shape)}")


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        lib = ctypes.CDLL(str(_build.build("rms_norm_bwd")))
        fn = lib.rms_norm_bwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = lib.rms_norm_bwd_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _bwd_fn = (fn, err)
    return _bwd_fn


def rms_norm_bwd(x, scale, dy, *, eps: float = 1e-6):
    """The backward kernels: (dx in x's dtype, ds [d] in scale's dtype) of
    ``rms_norm`` for the cotangent ``dy``."""
    global bwd_launches
    _check(x, scale)
    dy = dy.contiguous()
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not fit x "
                         f"{tuple(x.shape)} {x.dtype}")
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x)
    ds = torch.empty_like(scale)
    aligned = not any(t.data_ptr() % 16 for t in (x, scale, dy, dx))
    shape = bwd_launch_shape(rows, d, x.dtype, aligned=aligned,
                             sms=_build.device_sms(x.device))
    partial = torch.empty((shape.blocks, d), dtype=torch.float32, device=x.device)
    if not x.is_meta:
        fn, err_str = _bwd_kernel()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                     partial.data_ptr(), ds.data_ptr(), rows, d,
                     int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
                     int(shape.vec), shape.per_lane, shape.split, shape.warps, shape.blocks,
                     eps, stream)
        if err:
            raise RuntimeError(f"rms_norm_bwd launch failed: {err_str(err).decode()} ({err})")
        bwd_launches += 1
    work.record("rms_norm_bwd", work.norm_bwd(rows, d, x.element_size(), scale.element_size()),
                x.dtype)
    return dx, ds


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rms_norm_fwd(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, ds = rms_norm_bwd(x, scale, dy, eps=ctx.eps)
        return dx, ds, None


def rms_norm(x, scale, *, eps: float = 1e-6):
    """x [..., d] and scale [d], each f32 or bf16, contiguous on one CUDA
    device.  Returns ``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in x's
    dtype, with the arithmetic in f32; differentiable through the backward
    kernels where grad is enabled and an input requires it."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return rms_norm_fwd(x, scale, eps=eps)


def rms_norm_fwd(x, scale, *, eps: float = 1e-6):
    """The forward kernel alone."""
    global launches
    _check(x, scale)
    d = x.shape[-1]
    rows = x.numel() // d
    out = torch.empty_like(x)
    if not x.is_meta:
        fn, err_str = _kernel()
        aligned = not (x.data_ptr() % 16 or scale.data_ptr() % 16 or out.data_ptr() % 16)
        shape = launch_shape(rows, d, x.dtype, aligned=aligned)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
                     int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
                     int(shape.vec), shape.per_lane, shape.blocks, eps, stream)
        if err:
            raise RuntimeError(f"rms_norm launch failed: {err_str(err).decode()} ({err})")
        launches += 1
    work.record("rms_norm", work.norm(rows, d, x.element_size(), scale.element_size()),
                x.dtype)
    return out
