"""The work of the port's hand-written kernels, counted from their shapes.

A frozen copy of ``repro_torch/kernels/work.py`` (the attention and scan
formulas) and of ``chip_smoke.py``'s bounds: the least time a call could
take on an H100, the larger of its operations over their peak and its bytes
over HBM, each input read once and each output written once."""
from __future__ import annotations

from typing import NamedTuple

from bench.counts.peaks import (HBM_BW, MAX_SM_CLOCK_HZ, PEAK_FLOPS, SFU_PER_SM_CLK,
                                SMS)


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
    if c1 > 0:
        lo = max(lo, -c0 + 1)
    else:
        hi = min(hi, c0)
    if hi <= lo:
        return 0
    first, last = c0 + c1 * lo, c0 + c1 * (hi - 1)
    return (first + last) * (hi - lo) // 2


def admitted_scores(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs of one head that the masks admit: key ``j`` for
    query ``i`` where ``j <= i`` (causal) and ``i - j < window`` (window >
    0), in closed form (arithmetic series between the points where the
    bounds change branch)."""
    cuts = {0, sq}
    if causal:
        cuts.add(min(max(sk - 1, 0), sq))
    if window > 0:
        cuts.add(min(max(window - 1, 0), sq))
    cuts = sorted(cuts)
    total = 0
    for lo, hi in zip(cuts, cuts[1:]):
        hi0, hi1 = (sk - 1, 0) if not causal or lo >= sk - 1 else (0, 1)
        lo0, lo1 = (0, 0) if window <= 0 or lo < window - 1 else (1 - window, 1)
        total += _positive_sum(hi0 - lo0 + 1, hi1 - lo1, lo, hi)
    return total


def attention(b, h, kh, sq, sk, hd, causal, window, itemsize) -> Work:
    """Forward: q.k and p.v for every admitted score (4·hd FLOPs); q, k, v
    read and o written."""
    scores = admitted_scores(sq, sk, causal, window) * b * h
    nbytes = (2 * b * h * sq * hd + 2 * b * kh * sk * hd) * itemsize
    return Work(dot_flops=4 * hd * scores, bytes=nbytes)


def attention_bwd(b, h, kh, sq, sk, hd, causal, window, itemsize) -> Work:
    """Backward: S recomputed, dP, dV, dQ, dK (10·hd FLOPs a score); q, o,
    dO, k, v and the f32 row log-sum-exp read, dq, dk, dv written."""
    scores = admitted_scores(sq, sk, causal, window) * b * h
    nbytes = (4 * b * h * sq * hd + 4 * b * kh * sk * hd) * itemsize + 4 * b * h * sq
    return Work(dot_flops=10 * hd * scores, bytes=nbytes)


def scan(b, s, di, n, itemsize) -> Work:
    """Forward: one exp and six f32 operations per (b, t, d, n); u, dt, B, C
    in the inputs' dtype and the f32 a, d_skip read, f32 y and h_last
    written."""
    elems = b * s * di * n
    nbytes = (2 * b * s * di + 2 * b * s * n) * itemsize + (di * n + di) * 4 \
        + (b * s * di + b * di * n) * 4
    return Work(f32_ops=6 * elems, exps=elems, bytes=nbytes)


def scan_bwd(b, s, di, n, itemsize) -> Work:
    """Backward: one exp and 14 f32 operations per (b, t, d, n); the inputs
    and the f32 dy read, their gradients written."""
    elems = b * s * di * n
    nbytes = 2 * (2 * b * s * di + 2 * b * s * n) * itemsize + 2 * (di * n + di) * 4 \
        + b * s * di * 4
    return Work(f32_ops=14 * elems, exps=elems, bytes=nbytes)


def bound_s(w: Work, dot_precision: str = "bfloat16") -> float:
    """Least seconds for ``w``: the largest of its dot FLOPs over the dot
    peak, its exps over the special function units at the maximum SM clock,
    its f32 operations over the f32 peak, and its bytes over HBM."""
    return max(w.dot_flops / PEAK_FLOPS[dot_precision],
               w.exps / (SFU_PER_SM_CLK * SMS * MAX_SM_CLOCK_HZ),
               w.f32_ops / PEAK_FLOPS["float32"],
               w.bytes / HBM_BW)
