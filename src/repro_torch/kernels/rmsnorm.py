"""ctypes wrapper of the hand-written CUDA RMSNorm kernel.

The kernel (``csrc/rms_norm.cu``) replaces the JAX package's Pallas TPU
kernel ``repro/kernels/rmsnorm.py::rms_norm_kernel``.  It launches on
PyTorch's current stream, allocates nothing and does not synchronise; this
wrapper validates the inputs, allocates the output and raises if the launch
is refused.  ``launches`` counts successful launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["rms_norm", "launches", "DTYPES", "MAX_D"]

#: dtypes the kernel is instantiated for, for x and (independently) scale.
DTYPES = (torch.float32, torch.bfloat16)
#: Widest row: the row is kept in shared memory as f32 (227 KB a block,
#: less 1 KB for the reduction's own).
MAX_D = 226 * 1024 // 4

#: Kernel launches since import (or since a caller last set it to 0).
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = ctypes.CDLL(str(_build.build("rms_norm")))
        fn = lib.rms_norm_fwd
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = lib.rms_norm_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn = (fn, err)
    return _fn


def _check(x, scale):
    for name, t in (("x", x), ("scale", scale)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
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


def rms_norm(x, scale, *, eps: float = 1e-6):
    """x [..., d] and scale [d], each f32 or bf16, contiguous on one CUDA
    device.  Returns ``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in x's
    dtype, with the arithmetic in f32."""
    global launches
    _check(x, scale)
    fn, err_str = _kernel()
    d = x.shape[-1]
    rows = x.numel() // d
    out = torch.empty_like(x)
    width = 16 // x.element_size()  # elements in one 16-byte load
    vec = d % width == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
                 int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
                 int(vec), eps, stream)
    if err:
        raise RuntimeError(f"rms_norm launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    return out
