"""The work of the hand-written kernels, counted from their shapes.

One place for the formulas that both the dry run's accounting
(``launch/op_analysis.py``) and the card's roofline bounds
(``chip_smoke.py``) use.  A :class:`Work` is what one call must do: the
products of the attention's scores and values (``dot_flops``, two a
multiply-add, in the inputs' dtype), the scan's exps and other f32
operations, and the bytes it must move, each input read once and each output
written once.  Attention counts only the scores its masks admit
(:func:`admitted_scores`, in closed form: a causal or windowed mask of 32768
keys would be a 1 GB boolean tensor).

:func:`record` hands one call's work to every active recorder
(:func:`recording`).  The wrappers call it for every call, on the card and
on meta tensors alike, so a program run under ``op_analysis`` counts the
same kernel work in both.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

__all__ = ["Work", "admitted_scores", "attention", "attention_bwd", "scan", "scan_bwd",
           "norm", "norm_bwd", "conv_wgrad", "record", "recording"]


class Work(NamedTuple):
    dot_flops: int = 0
    f32_ops: int = 0
    exps: int = 0
    bytes: int = 0


def _positive_sum(c0: int, c1: int, lo: int, hi: int) -> int:
    """``sum(max(0, c0 + c1 * q) for q in range(lo, hi))`` for c1 in -1, 0, 1."""
    if hi <= lo:
        return 0
    if c1 == 0:
        return max(0, c0) * (hi - lo)
    if c1 > 0:  # positive from q > -c0 on
        lo = max(lo, -c0 + 1)
    else:  # positive while q < c0
        hi = min(hi, c0)
    if hi <= lo:
        return 0
    first, last = c0 + c1 * lo, c0 + c1 * (hi - 1)
    return (first + last) * (hi - lo) // 2


def admitted_scores(sq: int, sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs of one head that the masks admit: key ``j``
    for query ``i`` where ``j <= i`` (causal) and ``i - j < window``
    (``window > 0``), positions counted from 0 on both sides, as the kernel
    and ``kernels/ref.py`` mask them.  Query ``i`` sees keys ``lo(i) ..
    hi(i)`` with ``hi = min(sk - 1, i)`` (or ``sk - 1``) and ``lo = max(0, i -
    window + 1)`` (or 0); the sum is cut where ``hi`` and ``lo`` change
    branch, and each piece is an arithmetic series."""
    cuts = {0, sq}
    if causal:
        cuts.add(min(max(sk - 1, 0), sq))
    if window > 0:
        cuts.add(min(max(window - 1, 0), sq))
    cuts = sorted(cuts)
    total = 0
    for lo, hi in zip(cuts, cuts[1:]):
        # within [lo, hi) each bound is one branch, affine in i: hi_i - lo_i + 1
        hi0, hi1 = (sk - 1, 0) if not causal or lo >= sk - 1 else (0, 1)
        lo0, lo1 = (0, 0) if window <= 0 or lo < window - 1 else (1 - window, 1)
        total += _positive_sum(hi0 - lo0 + 1, hi1 - lo1, lo, hi)
    return total


def attention(b: int, h: int, kh: int, sq: int, sk: int, hd: int, causal: bool,
              window: int, itemsize: int, *, lse: bool = False) -> Work:
    """The forward: q.k and p.v for every admitted score (``4 * hd`` FLOPs);
    q, k, v read and o written, and with ``lse`` each row's f32 log-sum-exp."""
    scores = admitted_scores(sq, sk, causal, window) * b * h
    nbytes = (2 * b * h * sq * hd + 2 * b * kh * sk * hd) * itemsize
    return Work(dot_flops=4 * hd * scores, bytes=nbytes + (4 * b * h * sq if lse else 0))


def attention_bwd(b: int, h: int, kh: int, sq: int, sk: int, hd: int, causal: bool,
                  window: int, itemsize: int) -> Work:
    """The backward: S recomputed, dP, dV, dQ, dK for every admitted score
    (five products, ``10 * hd`` FLOPs); q, o, dO, k, v and the f32 row
    log-sum-exp read, dq, dk, dv written."""
    scores = admitted_scores(sq, sk, causal, window) * b * h
    nbytes = (4 * b * h * sq * hd + 4 * b * kh * sk * hd) * itemsize + 4 * b * h * sq
    return Work(dot_flops=10 * hd * scores, bytes=nbytes)


def scan(b: int, s: int, di: int, n: int, itemsize: int, *, ckpt_steps: int = 0) -> Work:
    """The forward: one exp per (b, t, d, n) and six f32 operations (dt*a;
    decay*h + du*B; y += h*C); u, dt, B, C in the inputs' dtype and the f32
    a, d_skip read, the f32 y and h_last written, and with ``ckpt_steps``
    the f32 state entering each segment of that many steps."""
    elems = b * s * di * n
    nbytes = (2 * b * s * di + 2 * b * s * n) * itemsize + (di * n + di) * 4 \
        + (b * s * di + b * di * n) * 4
    if ckpt_steps:
        nbytes += b * math.ceil(s / ckpt_steps) * di * n * 4
    return Work(f32_ops=6 * elems, exps=elems, bytes=nbytes)


def scan_bwd(b: int, s: int, di: int, n: int, itemsize: int, *,
             ckpt_steps: int = 0) -> Work:
    """The backward: one exp per (b, t, d, n) (each step's decay) and 14 f32
    operations (dh = decay * dh + C dy; one FMA each into dA, ddt, du, dB,
    dC); u, dt, B, C, a, d_skip and the f32 dy read, du, ddt, dB, dC in the
    inputs' dtype and the f32 da, dd_skip written, and with ``ckpt_steps``
    the forward's f32 checkpoints read."""
    elems = b * s * di * n
    nbytes = 2 * (2 * b * s * di + 2 * b * s * n) * itemsize + 2 * (di * n + di) * 4 \
        + b * s * di * 4
    if ckpt_steps:
        nbytes += b * math.ceil(s / ckpt_steps) * di * n * 4
    return Work(f32_ops=14 * elems, exps=elems, bytes=nbytes)


def norm(rows: int, d: int, x_itemsize: int, scale_itemsize: int) -> Work:
    """RMSNorm: x read and out written once, scale read once (a few f32
    operations an element are far below the bytes)."""
    return Work(bytes=2 * rows * d * x_itemsize + d * scale_itemsize)


def norm_bwd(rows: int, d: int, x_itemsize: int, scale_itemsize: int) -> Work:
    """RMSNorm's backward: x and dy read, dx written, scale read and ds
    written once."""
    return Work(bytes=3 * rows * d * x_itemsize + 2 * d * scale_itemsize)


def conv_wgrad(positions: int, taps: int, cout: int, x_elems: int) -> Work:
    """The stem convolution's weight and bias gradients: one f32 multiply-add
    per (position, tap, output channel) and one add per (position, output
    channel); x and dy read once, dw and db written once (f32)."""
    return Work(f32_ops=(2 * taps + 1) * positions * cout,
                bytes=4 * (x_elems + positions * cout + cout * taps + cout))


_recorders: list = []


def record(kernel: str, work: Work, dtype) -> None:
    """Hand one call of ``kernel`` (its work, its inputs' torch dtype) to
    every active recorder."""
    for sink in _recorders:
        sink(kernel, work, dtype)


@contextlib.contextmanager
def recording(sink):
    """Call ``sink(kernel, work, dtype)`` for every kernel call in the block."""
    _recorders.append(sink)
    try:
        yield sink
    finally:
        _recorders.remove(sink)
