"""Always-on metrics registry: counters, gauges, log-bucket histograms.

Unlike spans (which are off unless ``REPRO_TRACE`` enables them),
metrics are plain in-process accumulators cheap enough to leave on:
a counter add is one lock + one float add.  The serving loop uses them
for request-latency histograms and queue-depth gauges; the Chrome-trace
export embeds a snapshot so a ``trace.json`` carries both timelines and
totals.

    from repro_torch.obs import metrics
    metrics.counter("serve.tokens").add(5)
    metrics.gauge("serve.queue_depth").set(len(queue))
    metrics.histogram("serve.request_latency_s").observe(dt)
    metrics.snapshot()   # {name: {...}} for reports/exports
"""
from __future__ import annotations

import math
import threading

#: histogram bucket range: powers of two from 2**_LOW to 2**_HIGH
#: (~1 µs .. ~9 h when observations are seconds)
_LOW = -20
_HIGH = 15


class Counter:
    """Monotonically increasing sum."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def as_dict(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Gauge:
    """Last-set value, with the max seen (e.g. peak queue depth)."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.max = float("-inf")
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)
            if self.value > self.max:
                self.max = self.value

    def as_dict(self) -> dict:
        return {"kind": self.kind, "value": self.value,
                "max": self.max if self.max > float("-inf") else 0.0}


class Histogram:
    """Log-scale (power-of-two) bucket histogram with count/sum/min/max.

    Percentiles are resolved to a bucket's upper edge — coarse (a factor
    of two) but allocation-free and monotone, which is all the latency
    reports need.
    """

    kind = "histogram"

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.buckets = [0] * (_HIGH - _LOW + 1)
        self._lock = threading.Lock()

    @staticmethod
    def _bucket(value: float) -> int:
        if value <= 0:
            return 0
        return min(max(int(math.ceil(math.log2(value))) - _LOW, 0),
                   _HIGH - _LOW)

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            self.sum += value
            if value < self.min:
                self.min = value
            if value > self.max:
                self.max = value
            self.buckets[self._bucket(value)] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Upper edge of the bucket holding the p-th percentile
        observation (p in [0, 100])."""
        with self._lock:
            if not self.count:
                return 0.0
            target = max(1, math.ceil(self.count * p / 100.0))
            seen = 0
            for i, n in enumerate(self.buckets):
                seen += n
                if seen >= target:
                    return min(2.0 ** (i + _LOW), self.max)
            return self.max

    def as_dict(self) -> dict:
        return {"kind": self.kind, "count": self.count, "sum": self.sum,
                "mean": self.mean,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "p50": self.percentile(50), "p99": self.percentile(99)}


class Registry:
    """Name -> metric map; get-or-create, type-checked."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(m).__name__}, "
                    f"not a {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.as_dict() for name, m in sorted(items)}

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


#: the process-global registry (modules use the helpers below)
REGISTRY = Registry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


def snapshot() -> dict[str, dict]:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()
