"""Metrics registry: counters, gauges, deterministic log2 histograms (§13).

One :class:`MetricsRegistry` per process (or per rank) absorbs the runtime's
scattered ad-hoc counters — the loader counters, the §9 failure-ladder
counters, the §12 tenant counters — behind namespaced metric names
(``loader.misses``, ``ladder.retries``, ``tenant.tenant_sheds``, ...)
via :meth:`MetricsRegistry.fold`, *without* changing any existing
``summary()`` key: folding reads the legacy dicts, it never rewrites them.

Histograms are fixed-shape log2 buckets over **microseconds**: a value lands
in bucket ``i = bit_length(int(v_us))`` (bucket 0 is ``[0, 1)`` µs, bucket
``i>0`` is ``[2^(i-1), 2^i)`` µs, top bucket clamps).  Quantiles walk the
cumulative counts and return the matched bucket's upper bound — a pure
function of the recorded multiset, so two runs that observe the same
latencies report byte-identical p50/p95/p99 regardless of arrival order,
and per-rank histograms merge exactly by adding bucket counts.

Own copy of the JAX package's ``obs/metrics.py``: the same buckets,
quantiles and snapshots.
"""
from __future__ import annotations

import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "latency_summary", "merge_histograms",
]

NBUCKETS = 64


class Counter:
    """A monotonically-increasing integer."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += int(n)


class Gauge:
    """A last-write-wins float."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


def bucket_index(value_us: float) -> int:
    """The deterministic log2 bucket for a microsecond value."""
    v = int(value_us)
    if v <= 0:
        return 0
    return min(v.bit_length(), NBUCKETS - 1)


def bucket_upper_us(i: int) -> float:
    """Bucket ``i``'s exclusive upper bound in µs (``2^i``, ``2^0`` for 0)."""
    return float(1 << i)


class Histogram:
    """Fixed 64-bucket log2 histogram of microsecond values."""

    __slots__ = ("counts", "count", "sum_us")

    def __init__(self):
        self.counts = [0] * NBUCKETS
        self.count = 0
        self.sum_us = 0.0

    def record(self, value_us: float) -> None:
        self.counts[bucket_index(value_us)] += 1
        self.count += 1
        self.sum_us += max(float(value_us), 0.0)

    def quantile_us(self, q: float) -> float:
        """Deterministic quantile: the upper bound of the bucket holding the
        ``ceil(q * count)``-th smallest recorded value (0.0 when empty)."""
        if self.count <= 0:
            return 0.0
        q = min(max(float(q), 0.0), 1.0)
        target = max(int(q * self.count + 0.999999), 1)
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return bucket_upper_us(i)
        return bucket_upper_us(NBUCKETS - 1)

    def bucket_dict(self) -> dict[str, int]:
        """Sparse JSON-safe form: nonzero bucket index -> count."""
        return {str(i): c for i, c in enumerate(self.counts) if c}

    def merge_buckets(self, buckets: dict) -> None:
        """Fold a :meth:`bucket_dict` (e.g. from another rank) into this one."""
        for i, c in buckets.items():
            i, c = int(i), int(c)
            if not 0 <= i < NBUCKETS:
                raise ValueError(f"bucket index {i} out of range")
            self.counts[i] += c
            self.count += c
            # the merged sum is a lower bound (bucket floors); quantiles —
            # the contract — are exact.
            self.sum_us += c * (bucket_upper_us(i) / 2.0)

    def summary(self, unit: str = "ms") -> dict:
        scale = 1e-3 if unit == "ms" else 1.0
        return {
            "count": self.count,
            f"p50_{unit}": self.quantile_us(0.50) * scale,
            f"p95_{unit}": self.quantile_us(0.95) * scale,
            f"p99_{unit}": self.quantile_us(0.99) * scale,
        }


def merge_histograms(bucket_dicts) -> Histogram:
    """One cluster histogram from per-rank :meth:`Histogram.bucket_dict`s."""
    h = Histogram()
    for b in bucket_dicts:
        if b:
            h.merge_buckets(b)
    return h


def latency_summary(step_hist: Histogram, fetch_hist: Histogram) -> dict:
    """The quantile block carried on ``RankResult`` / report summaries."""
    out = {}
    for name, h in (("step", step_hist), ("fetch", fetch_hist)):
        for q in (0.50, 0.95, 0.99):
            out[f"{name}_ms_p{int(q * 100)}"] = h.quantile_us(q) / 1e3
        out[f"{name}_count"] = h.count
    return out


class MetricsRegistry:
    """Named counters/gauges/histograms with get-or-create semantics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram()
            return h

    def fold(self, prefix: str, mapping: dict) -> None:
        """Absorb a legacy counter dict as ``{prefix}.{key}`` counters.

        Only scalar int/bool values fold (floats become gauges); nested
        dicts and strings are skipped — the source dict is never mutated,
        so every existing ``summary()`` stays byte-for-byte stable.
        """
        for k, v in (mapping or {}).items():
            name = f"{prefix}.{k}"
            if isinstance(v, bool) or isinstance(v, int):
                self.counter(name).inc(int(v))
            elif isinstance(v, float):
                self.gauge(name).set(v)

    def snapshot(self) -> dict:
        """JSON-safe point-in-time view of every registered metric."""
        with self._lock:
            return {
                "counters": {
                    k: c.value for k, c in sorted(self._counters.items())
                },
                "gauges": {
                    k: g.value for k, g in sorted(self._gauges.items())
                },
                "histograms": {
                    k: {**h.summary("ms"), "buckets": h.bucket_dict()}
                    for k, h in sorted(self._histograms.items())
                },
            }
