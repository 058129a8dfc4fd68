"""A traced stretch of steps, reduced: every device operation's interval
from ``torch.profiler``, their union (the device's busy time), device time
by name, and the longest idle stretches by what the host was doing.

Only the intervals are kept from the profiler; the reduction is this
file's, and imports nothing of the port."""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

from bench.window import gaps, union_length

__all__ = ["traced", "Trace"]


class Trace:
    """Device and host intervals of one traced window, in seconds."""

    def __init__(self, device_ops: list, host_ops: list, window_s: float):
        #: (start, end, name) of every operation that ran on the device
        self.device_ops = device_ops
        #: (start, end, name) of every host operation
        self.host_ops = host_ops
        self.window_s = window_s

    @property
    def busy_s(self) -> float:
        return union_length([(s, e) for s, e, _ in self.device_ops])

    def kernels(self, *patterns: str) -> list:
        """(start, end, name) of the device operations whose name holds one
        of ``patterns``."""
        return [op for op in self.device_ops if any(p in op[2] for p in patterns)]

    def top_device_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for s, e, name in self.device_ops:
            by[name[:160]] += e - s
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10, longest: int = 500) -> list:
        """The device's ``longest`` idle stretches, their time summed by the
        innermost host operation running at each one's midpoint ("host:
        none" where none was), the ``n`` largest sums."""
        if not self.device_ops:
            return []
        start = min(s for s, _, _ in self.device_ops)
        end = max(e for _, e, _ in self.device_ops)
        host = sorted(self.host_ops)
        starts = [s for s, _, _ in host]
        stretches = sorted(gaps([(s, e) for s, e, _ in self.device_ops], start, end),
                           key=lambda g: g[0] - g[1])[:longest]
        by = defaultdict(float)
        for a, b in stretches:
            mid, best = (a + b) / 2, None
            i = bisect.bisect_right(starts, mid)
            for s, e, name in host[max(0, i - 5000):i]:
                if e >= mid and (best is None or e - s < best[1] - best[0]):
                    best = (s, e, name)
            by[best[2][:160] if best else "host: none"] += b - a
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


def _events(prof):
    """(device ops, host ops) from the profiler's kineto events, seconds."""
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        kind = str(ev.device_type())
        if kind.endswith("CUDA"):
            dev.append((s, e, ev.name()))
        elif kind.endswith("CPU"):
            host.append((s, e, ev.name()))
    return dev, host


def traced(run_steps, device) -> Trace:
    """Run ``run_steps()`` under ``torch.profiler`` and reduce its trace.
    Only the device activity is traced (with the CUDA runtime calls that
    launch it): recording every host operator as well doubled a hymba
    step's time, and so the idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps()
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
    dev, host = _events(prof)
    return Trace(dev, host, t1 - t0)
