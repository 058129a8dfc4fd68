"""ctypes wrapper of the hand-written CUDA weight gradient of a 3D
surrogate's stem convolution.

``csrc/conv3d_stem_wgrad.cu`` replaces no Pallas kernel: the JAX package
leaves its convolutions to XLA.  It computes the weight and bias gradients
of ``models/cnn.py``'s stride-2, 3x3x3 ``"SAME"`` convolution of an input
with few channels, which cuDNN's float32 weight gradient ran at 0.4% of its
bound (the source's note says why, and what bounds the kernel).  It launches
on PyTorch's current stream, allocates nothing and does not synchronise;
this wrapper validates the inputs, allocates outputs and scratch and raises
if a launch is refused.  ``launches`` counts successful launches.  On meta
tensors it allocates what a launch would, launches nothing and counts
nothing; on either device it hands each call's work to ``work.record``.

:func:`routes` is the rule that sends a convolution here, decided by shape:
a float32 3D convolution of ``CIN`` input channels (1, 4 or 8, the stems of
AutoPhaseNN and CosmoFlow and their reduced second layers) into a multiple
of 4 output channels.  The limit is the kernel's: a tile's x planes of all
its input channels sit in shared memory, which holds at most 8.  Wider
inputs stay on cuDNN, and not all of them are well served there: at 16
input channels (the default CosmoFlow's ``enc.1``) cuDNN still runs its
grouped-direct float32 weight gradient (PERF.md, Open questions).
:func:`launch_plan` mirrors the C's grid in pure Python, so the CPU tests
reach it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, work

__all__ = ["conv3d_stem_wgrad", "launches", "routes", "launch_plan", "LaunchPlan", "CIN",
           "TILE_ROWS", "TILE_COLS", "CO_SLICE"]

#: Input channel counts the C instantiates.
CIN = (1, 4, 8)
#: A block's tile of output rows and columns, and of output channels.
TILE_ROWS = 2
TILE_COLS = 64
CO_SLICE = 32

#: Launches since import (or since a caller last set it to 0).
launches = 0

_fn = None


class LaunchPlan(NamedTuple):
    tiles: int    # grid.x, and the rows of the partial sums
    slices: int   # grid.y: groups of CO_SLICE output channels
    entries: int  # a partial row: cout * 27 * cin + cout


def routes(rank: int, cin: int, cout: int, dtype) -> bool:
    """Whether ``models/cnn.py`` computes a stride-2 convolution's weight
    gradient with this kernel (on the CPU, with its plain version)."""
    return rank == 3 and dtype == torch.float32 and cin in CIN and cout % 4 == 0


def launch_plan(n: int, cin: int, cout: int, oh: int, ow: int) -> LaunchPlan:
    """The C's grid for ``n`` samples of ``cin`` channels giving ``cout``
    channels at ``oh`` x ``ow`` output rows and columns."""
    tiles = n * -(-oh // TILE_ROWS) * -(-ow // TILE_COLS)
    return LaunchPlan(tiles, -(-cout // CO_SLICE), cout * (27 * cin + 1))


def _kernel():
    global _fn
    if _fn is None:
        lib = ctypes.CDLL(str(_build.build("conv3d_stem_wgrad")))
        fn = lib.conv3d_stem_wgrad
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.conv3d_stem_wgrad_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn = (fn, err)
    return _fn


def _check(x, dy, pads):
    for name, t in (("x", x), ("dy", dy)):
        if not (t.is_cuda or t.is_meta):
            raise ValueError(f"{name} must be a CUDA tensor (or meta), got {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} dtype {t.dtype} is not float32")
        if t.dim() != 5:
            raise ValueError(f"{name} must be [N, C, D, H, W], got {tuple(t.shape)}")
        if not t.permute(0, 2, 3, 4, 1).is_contiguous():
            raise ValueError(f"{name} must be contiguous channels-last (channels_last_3d)")
    if x.shape[1] not in CIN or dy.shape[1] % 4:
        raise ValueError(f"x has {x.shape[1]} channels and dy {dy.shape[1]}: the kernel takes "
                         f"{CIN} into a multiple of 4")
    if not dy.is_meta and dy.data_ptr() % 16:
        raise ValueError("dy must be 16-byte aligned")
    if len(pads) != 6 or any(p not in (0, 1) for p in pads[::2]):
        raise ValueError(f"pads {pads} are not F.pad's six with 0 or 1 before each axis")
    padded = [x.shape[2 + i] + pads[4 - 2 * i] + pads[5 - 2 * i] for i in range(3)]
    if dy.shape[0] != x.shape[0] or list(dy.shape[2:]) != [(p - 3) // 2 + 1 for p in padded]:
        raise ValueError(f"dy {tuple(dy.shape)} does not fit x {tuple(x.shape)} padded by {pads}")


def conv3d_stem_wgrad(x, dy, pads):
    """x [N, C, D, H, W] and dy [N, Cout, Do, Ho, Wo], float32 in the
    channels-last layout (``channels_last_3d``), on one CUDA device, C in
    ``CIN``, Cout a multiple of 4 and dy 16-byte aligned; ``pads``
    as ``F.pad`` takes them (last axis first), 0 or 1 before each axis.
    Returns (dw [Cout, C, 3, 3, 3], db [Cout]) of ``F.conv3d(F.pad(x,
    pads), w, b, stride=2)`` for the output gradient ``dy``, in float32."""
    global launches
    _check(x, dy, pads)
    n, cin, d, h, w = x.shape
    cout, od, oh, ow = dy.shape[1:]
    plan = launch_plan(n, cin, cout, oh, ow)
    dw = torch.empty((cout, cin, 3, 3, 3), dtype=torch.float32, device=x.device)
    db = torch.empty(cout, dtype=torch.float32, device=x.device)
    partial = torch.empty((plan.tiles, plan.entries), dtype=torch.float32, device=x.device)
    if not x.is_meta:
        fn, err_str = _kernel()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                     db.data_ptr(), n, d, h, w, cin, cout, od, oh, ow, pads[4], pads[2],
                     pads[0], plan.tiles, stream)
        if err:
            raise RuntimeError(f"conv3d_stem_wgrad launch failed: {err_str(err).decode()} ({err})")
        launches += 1
    work.record("conv3d_stem_wgrad", work.conv_wgrad(n * od * oh * ow, cin * 27, cout,
                                                     n * d * h * w * cin), x.dtype)
    return dw, db
