"""Process-wide metrics registry: counters + histograms (the port's copy
of `leann_tpu/utils/metrics.py`; the Prometheus export waits for the
HTTP server's slice).
"""

from __future__ import annotations

import threading
from typing import Dict, List


class _Histogram:
    __slots__ = ("count", "total", "min", "max", "samples")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.samples: List[float] = []  # ring of recent samples for p50/p99

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.samples.append(value)
        if len(self.samples) > 1024:
            del self.samples[:512]

    def quantile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        ordered = sorted(self.samples)
        idx = min(len(ordered) - 1, int(q * len(ordered)))
        return ordered[idx]


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._histograms: Dict[str, _Histogram] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            hist = self._histograms.get(name)
            if hist is None:
                hist = self._histograms[name] = _Histogram()
            hist.observe(value)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            out: Dict[str, dict] = {}
            for name, val in self._counters.items():
                out[name] = {"type": "counter", "value": val}
            for name, hist in self._histograms.items():
                out[name] = {
                    "type": "histogram",
                    "count": hist.count,
                    "sum": hist.total,
                    "avg": hist.total / hist.count if hist.count else 0.0,
                    "min": hist.min if hist.count else 0.0,
                    "max": hist.max if hist.count else 0.0,
                    "p50": hist.quantile(0.50),
                    "p99": hist.quantile(0.99),
                }
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._histograms.clear()


METRICS = Metrics()
