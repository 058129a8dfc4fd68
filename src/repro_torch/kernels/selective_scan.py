"""ctypes wrappers of the hand-written CUDA selective-scan kernels.

The forward (``csrc/selective_scan.cu``) replaces the JAX package's Pallas
TPU kernel ``repro/kernels/selective_scan.py::selective_scan_kernel``.  The
backward (``csrc/selective_scan_bwd.cu``) has no Pallas original: it
computes the gradient of y of the plain scan, recomputing h from the
checkpoints the forward writes every ``CKPT_STEPS`` steps when autograd will
need them.  Both launch on PyTorch's current stream, allocate nothing and do
not synchronise; these wrappers validate the inputs, allocate outputs and
scratch and raise if a launch is refused.  ``selective_scan`` is a
``torch.autograd.Function`` where grad is enabled and an input requires it
(``h_last`` is not differentiable: no training path reads it).
``launches`` and ``bwd_launches`` count successful launches.  On meta
tensors (the dry run) the wrappers allocate what a launch would, launch
nothing and count nothing; on either device they hand each call's work to
``work.record``.

``launch_plan`` picks the forward kernel's plan for a shape (lanes per
channel, channels per block, the grid and the shared memory) and
``bwd_launch_plan`` the backward's, in pure Python, so the CPU tests reach
them.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, work
from repro_torch.kernels._build import SMS, device_sms

__all__ = ["selective_scan", "selective_scan_fwd", "selective_scan_bwd", "launches",
           "bwd_launches", "CKPT_STEPS", "bwd_smem_bytes", "STATES", "DTYPES", "CHUNK",
           "THREADS", "SMS", "PLANS", "BWD_PLANS", "ScanPlan", "launch_plan",
           "bwd_launch_plan", "plan_fits", "bwd_plan_fits", "block_channels", "smem_bytes"]

#: State sizes N and input dtypes the kernel is instantiated for.
STATES = (4, 8, 16)
DTYPES = (torch.float32, torch.bfloat16)
#: Timesteps the kernel stages per round (``kChunk`` in the source).
CHUNK = 64
#: Threads of a block: 128 / L groups of L lanes.
THREADS = 128
#: The plans the kernel is instantiated for (``picked`` in the source), as
#: (L, K) by N: L lanes share K channels, N / L states of each.  The first
#: is taken where its grid has a block for every SM, else the second, whose
#: blocks hold half the channels.  On an H100 (4, 2) is the fastest of the
#: 12 plans at both serving shapes, and (8, 2) the fastest, or within 5% of
#: it, where (4, 2) leaves SMs idle: hymba-1.5b's shape at a batch of 1 or
#: 2, falcon-mamba-7b's at 1 (PERF.md §6).  N = 8 and 4 are not timed; they
#: keep K = 2 and the same step of L.
PLANS = {16: ((4, 2), (8, 2)), 8: ((2, 2), (4, 2)), 4: ((2, 2), (4, 2))}

#: The backward's plan, (L, K) by N, the only one ``picked`` in
#: ``csrc/selective_scan_bwd.cu`` instantiates: 32 channels a block.  On an
#: H100 (``kernels/bwd_variants.py``) it is the fastest of the plans of 4 or
#: more lanes at hymba-1.5b's width and batch 2 for N = 16, 8 and 4, and at
#: falcon-mamba-7b's for N = 16 at batch 2 and 1.  Where its grid leaves SMs
#: idle (hymba-1.5b's width at batch 1: 100 blocks) 16 channels a block, (8,
#: 1), are 16% faster; no training shape of the repo takes a batch of 1.
BWD_PLANS = {16: (8, 2), 8: (4, 1), 4: (4, 1)}

#: Steps between the forward's checkpoints of h (``kSeg`` in both sources).
CKPT_STEPS = 16

#: Forward and backward launches since import (or since a caller last set
#: them to 0).
launches = 0
bwd_launches = 0

_fn = None
_bwd_fn = None


class ScanPlan(NamedTuple):
    lanes: int       # L: lanes that share a group of channels, N / L states each
    per_lane: int    # K: channels of a group
    channels: int    # channels of a block: THREADS / L * K
    grid: tuple      # (ceil(DI / channels), B) blocks of THREADS threads
    smem_bytes: int  # dynamic shared memory of a block
    vec: bool        # 16-byte copies; False: plain loads


def block_channels(lanes: int, per_lane: int) -> int:
    return THREADS // lanes * per_lane


def plan_fits(n: int, lanes: int, per_lane: int) -> bool:
    """Whether the kernel's code takes this (N, L, K) (``plan_fits`` in the
    source): L divides N, at most 16 states a lane and 128 channels a
    block.  Only ``PLANS`` are instantiated."""
    return (lanes in (1, 2, 4, 8, 16) and per_lane in (1, 2, 4) and n % lanes == 0
            and per_lane * (n // lanes) <= 16 and block_channels(lanes, per_lane) <= 128)


def smem_bytes(channels: int, n: int, itemsize: int) -> int:
    """A block's dynamic shared memory (``smem_bytes`` in the source): B, C
    widened to f32 [CHUNK][N], then two stages of u, dt [CHUNK][channels] and
    B, C [CHUNK][N] in the input dtype."""
    return 2 * CHUNK * n * 4 + 2 * 2 * CHUNK * (channels + n) * itemsize


def bwd_plan_fits(n: int, lanes: int, per_lane: int) -> bool:
    """Whether the backward's code takes this (N, L, K) (``plan_fits`` in
    ``csrc/selective_scan_bwd.cu``): 2 to 16 lanes that divide N, at most 16
    states a lane and 128 channels a block."""
    return (lanes in (2, 4, 8, 16) and per_lane in (1, 2, 4) and n % lanes == 0
            and per_lane * (n // lanes) <= 16 and block_channels(lanes, per_lane) <= 128)


def bwd_smem_bytes(n: int, lanes: int, per_lane: int, itemsize: int) -> int:
    """A backward block's dynamic shared memory (``bwd_smem_bytes`` in
    ``csrc/selective_scan_bwd.cu``): a segment's h, [CKPT_STEPS][K * N / L]
    [THREADS] f32; per-warp sums of dB and dC, [2][4][CHUNK][N] f32; two
    stages of dy [CHUNK][channels] f32, of u and dt [CHUNK][channels] and of B
    and C [CHUNK][N] in the input dtype; the output chunk of du and ddt
    [CHUNK][channels] in the input dtype."""
    ch = block_channels(lanes, per_lane)
    return ((CKPT_STEPS * per_lane * (n // lanes) * THREADS + 2 * 4 * CHUNK * n
             + 2 * CHUNK * ch) * 4
            + (2 * (2 * CHUNK * ch + 2 * CHUNK * n) + 2 * CHUNK * ch) * itemsize)


def launch_plan(bsz: int, seq: int, di: int, n: int, dtype=torch.bfloat16, *,
                aligned: bool = True, sms: int = SMS) -> ScanPlan:
    """The kernel's plan for u [bsz, seq, di] of ``dtype`` and N = ``n``
    states on a card of ``sms`` SMs.  ``aligned``: u, dt, b and c start on
    16 bytes.  Raises ValueError on a shape the kernel does not take."""
    if n not in STATES:
        raise ValueError(f"state size {n} not in {STATES}")
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype} not in {DTYPES}")
    if min(bsz, seq, di) <= 0 or bsz > 65535 or max(seq, di) >= 2**31:
        raise ValueError(f"unsupported shape B={bsz} S={seq} DI={di}")
    full, small = PLANS[n]
    lanes, per_lane = full if math.ceil(di / block_channels(*full)) * bsz >= sms else small
    channels = block_channels(lanes, per_lane)
    width = 16 // dtype.itemsize
    vec = aligned and di % width == 0 and seq * n % width == 0
    return ScanPlan(lanes, per_lane, channels, (math.ceil(di / channels), bsz),
                    smem_bytes(channels, n, dtype.itemsize), vec)


def bwd_launch_plan(bsz: int, seq: int, di: int, n: int, dtype=torch.bfloat16, *,
                    aligned: bool = True) -> ScanPlan:
    """The backward kernel's plan, ``BWD_PLANS[n]``, as ``launch_plan`` gives
    the forward's (``aligned``: u, dt, b, c and dy start on 16 bytes)."""
    fwd = launch_plan(bsz, seq, di, n, dtype, aligned=aligned)  # validates
    lanes, per_lane = BWD_PLANS[n]
    channels = block_channels(lanes, per_lane)
    return ScanPlan(lanes, per_lane, channels, (math.ceil(di / channels), bsz),
                    bwd_smem_bytes(n, lanes, per_lane, dtype.itemsize), fwd.vec)


def _kernel():
    global _fn
    if _fn is None:
        lib = ctypes.CDLL(str(_build.build("selective_scan")))
        fn = lib.selective_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.selective_scan_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn = (fn, err)
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        lib = ctypes.CDLL(str(_build.build("selective_scan_bwd")))
        fn = lib.selective_scan_bwd
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.selective_scan_bwd_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _bwd_fn = (fn, err)
    return _bwd_fn


def _check(u, dt, a, b_ssm, c_ssm, d_skip, *, backward: bool = False, dy=None):
    named = (("u", u), ("dt", dt), ("a", a), ("b_ssm", b_ssm), ("c_ssm", c_ssm),
             ("d_skip", d_skip))
    for name, t in named:
        if not (t.is_cuda or t.is_meta):
            raise ValueError(f"{name} must be a CUDA tensor (or meta), got {t.device}")
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
    if dt.shape != u.shape or b_ssm.shape != (bsz, s, n) or c_ssm.shape != (bsz, s, n) \
            or d_skip.shape != (di,):
        raise ValueError(
            f"shapes do not fit: u {tuple(u.shape)} dt {tuple(dt.shape)} a {tuple(a.shape)} "
            f"b {tuple(b_ssm.shape)} c {tuple(c_ssm.shape)} d_skip {tuple(d_skip.shape)}")
    aligned = all(t.data_ptr() % 16 == 0 for t in (u, dt, b_ssm, c_ssm))
    if backward:
        return bwd_launch_plan(bsz, s, di, n, u.dtype, aligned=aligned and dy.data_ptr() % 16 == 0)
    return launch_plan(bsz, s, di, n, u.dtype, aligned=aligned, sms=device_sms(u.device))


def selective_scan_fwd(u, dt, a, b_ssm, c_ssm, d_skip, *, checkpoints: bool = False):
    """The forward kernel: (y [B, S, DI] f32, h_last [B, DI, N] f32, and
    with ``checkpoints`` the states entering each ``CKPT_STEPS``-step
    segment, f32 [B, ceil(S / CKPT_STEPS), DI, N] (segment 0 starts from 0
    and is not written), else None)."""
    global launches
    plan = _check(u, dt, a, b_ssm, c_ssm, d_skip)
    bsz, s, di = u.shape
    n = a.shape[1]
    y = torch.empty((bsz, s, di), dtype=torch.float32, device=u.device)
    h_last = torch.empty((bsz, di, n), dtype=torch.float32, device=u.device)
    hck = (torch.empty((bsz, -(-s // CKPT_STEPS), di, n), dtype=torch.float32,
                       device=u.device) if checkpoints else None)
    if not u.is_meta:
        fn, err_str = _kernel()
        with torch.cuda.device(u.device):
            stream = torch.cuda.current_stream(u.device).cuda_stream
            err = fn(u.data_ptr(), dt.data_ptr(), a.data_ptr(), b_ssm.data_ptr(),
                     c_ssm.data_ptr(), d_skip.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                     None if hck is None else hck.data_ptr(),
                     bsz, s, di, n, plan.lanes, plan.per_lane, int(plan.vec),
                     int(u.dtype == torch.bfloat16), stream)
        if err:
            raise RuntimeError(
                f"selective_scan launch failed: {err_str(err).decode()} ({err})")
        launches += 1
    work.record("selective_scan", work.scan(bsz, s, di, n, u.element_size(),
                                            ckpt_steps=CKPT_STEPS if checkpoints else 0),
                u.dtype)
    return y, h_last, hck


def selective_scan_bwd(u, dt, a, b_ssm, c_ssm, d_skip, hck, dy):
    """The backward kernels: (du, ddt, da, db, dc, dd_skip) of y for the
    cotangent ``dy`` [B, S, DI], from ``selective_scan_fwd``'s checkpoints
    ``hck``; du, ddt, db, dc in the inputs' dtype, da and dd_skip f32."""
    global bwd_launches
    dy = dy.contiguous().float()
    plan = _check(u, dt, a, b_ssm, c_ssm, d_skip, backward=True, dy=dy)
    bsz, s, di = u.shape
    n = a.shape[1]
    if dy.shape != u.shape or dy.device != u.device or hck.dtype != torch.float32 or \
            hck.shape != (bsz, -(-s // CKPT_STEPS), di, n) or not hck.is_contiguous():
        raise ValueError(f"dy {tuple(dy.shape)} or checkpoints {tuple(hck.shape)} do not "
                         f"fit u {tuple(u.shape)}, N={n}")
    du, ddt = torch.empty_like(u), torch.empty_like(dt)
    db, dc = torch.empty_like(b_ssm), torch.empty_like(c_ssm)
    da, dd = torch.empty_like(a), torch.empty_like(d_skip)
    f32 = dict(dtype=torch.float32, device=u.device)
    db_part = torch.empty((plan.grid[0], bsz, s, n), **f32)
    dc_part = torch.empty((plan.grid[0], bsz, s, n), **f32)
    da_part = torch.empty((bsz, di, n), **f32)
    dd_part = torch.empty((bsz, di), **f32)
    if not u.is_meta:
        fn, err_str = _bwd_kernel()
        with torch.cuda.device(u.device):
            stream = torch.cuda.current_stream(u.device).cuda_stream
            err = fn(*(t.data_ptr() for t in (
                         u, dt, a, b_ssm, c_ssm, d_skip, hck, dy, du, ddt, da, db, dc, dd,
                         db_part, dc_part, da_part, dd_part)),
                     bsz, s, di, n, plan.lanes, plan.per_lane, int(plan.vec),
                     int(u.dtype == torch.bfloat16), stream)
        if err:
            raise RuntimeError(
                f"selective_scan_bwd launch failed: {err_str(err).decode()} ({err})")
        bwd_launches += 1
    work.record("selective_scan_bwd", work.scan_bwd(bsz, s, di, n, u.element_size(),
                                                    ckpt_steps=CKPT_STEPS), u.dtype)
    return du, ddt, da, db, dc, dd


class _SelectiveScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, dt, a, b_ssm, c_ssm, d_skip):
        y, h_last, hck = selective_scan_fwd(u, dt, a, b_ssm, c_ssm, d_skip, checkpoints=True)
        ctx.save_for_backward(u, dt, a, b_ssm, c_ssm, d_skip, hck)
        ctx.mark_non_differentiable(h_last)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, _dh_last):
        return selective_scan_bwd(*ctx.saved_tensors, dy)


def selective_scan(u, dt, a, b_ssm, c_ssm, d_skip):
    """u, dt [B, S, DI] and b/c [B, S, N] in f32 or bf16 (one dtype); a
    [DI, N] and d_skip [DI] in f32; all contiguous on one CUDA device.
    Starts from h=0.  Returns (y [B, S, DI] f32, h_last [B, DI, N] f32), y
    differentiable through the backward kernels where grad is enabled and an
    input requires it."""
    args = (u, dt, a, b_ssm, c_ssm, d_skip)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _SelectiveScan.apply(*args)
    return selective_scan_fwd(*args)[:2]
