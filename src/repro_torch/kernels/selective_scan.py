"""ctypes wrapper of the hand-written CUDA selective-scan kernel.

The kernel (``csrc/selective_scan.cu``) replaces the JAX package's Pallas
TPU kernel ``repro/kernels/selective_scan.py::selective_scan_kernel``.  It
launches on PyTorch's current stream, allocates nothing and does not
synchronise; this wrapper validates the inputs, allocates the outputs and
raises if the launch is refused.  ``launches`` counts successful launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["selective_scan", "launches", "STATES", "DTYPES"]

#: State sizes N and input dtypes the kernel is instantiated for.
STATES = (4, 8, 16)
DTYPES = (torch.float32, torch.bfloat16)

#: Kernel launches since import (or since a caller last set it to 0).
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = ctypes.CDLL(str(_build.build("selective_scan")))
        fn = lib.selective_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.selective_scan_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn = (fn, err)
    return _fn


def _check(u, dt, a, b_ssm, c_ssm, d_skip):
    named = (("u", u), ("dt", dt), ("a", a), ("b_ssm", b_ssm), ("c_ssm", c_ssm),
             ("d_skip", d_skip))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if u.dtype not in DTYPES:
        raise ValueError(f"dtype {u.dtype} not in {DTYPES}")
    for name, t in named[1:]:
        want = torch.float32 if name in ("a", "d_skip") else u.dtype
        if t.dtype != want:
            raise ValueError(f"{name} is {t.dtype}, want {want}")
    if u.dim() != 3:
        raise ValueError(f"u must be [B, S, DI], got shape {tuple(u.shape)}")
    bsz, s, di = u.shape
    if a.dim() != 2 or a.shape[0] != di:
        raise ValueError(f"a must be [DI={di}, N], got {tuple(a.shape)}")
    n = a.shape[1]
    if n not in STATES:
        raise ValueError(f"state size {n} not in {STATES}")
    if dt.shape != u.shape or b_ssm.shape != (bsz, s, n) or c_ssm.shape != (bsz, s, n) \
            or d_skip.shape != (di,):
        raise ValueError(
            f"shapes do not fit: u {tuple(u.shape)} dt {tuple(dt.shape)} a {tuple(a.shape)} "
            f"b {tuple(b_ssm.shape)} c {tuple(c_ssm.shape)} d_skip {tuple(d_skip.shape)}")
    if min(bsz, s, di) == 0 or bsz > 65535 or max(s, di) >= 2**31:
        raise ValueError(f"unsupported shape u {tuple(u.shape)}")


def selective_scan(u, dt, a, b_ssm, c_ssm, d_skip):
    """u, dt [B, S, DI] and b/c [B, S, N] in f32 or bf16 (one dtype); a
    [DI, N] and d_skip [DI] in f32; all contiguous on one CUDA device.
    Starts from h=0.  Returns (y [B, S, DI] f32, h_last [B, DI, N] f32)."""
    global launches
    _check(u, dt, a, b_ssm, c_ssm, d_skip)
    fn, err_str = _kernel()
    bsz, s, di = u.shape
    n = a.shape[1]
    y = torch.empty((bsz, s, di), dtype=torch.float32, device=u.device)
    h_last = torch.empty((bsz, di, n), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(u.data_ptr(), dt.data_ptr(), a.data_ptr(), b_ssm.data_ptr(),
                 c_ssm.data_ptr(), d_skip.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                 bsz, s, di, n, int(u.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(
            f"selective_scan launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    return y, h_last
