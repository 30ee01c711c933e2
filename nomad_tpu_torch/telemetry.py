"""In-process timing samples (the port's copy of the reference's
telemetry.py, itself after armon/go-metrics as the reference Nomad wires
it, command/agent/command.go:1034-1140).

The spine samples the reference's scheduler metrics:
  nomad.plan.submit (and nomad.plan.submit.ns.<namespace>)  core/worker.py
  nomad.plan.evaluate                                       core/plan_apply.py
and the bench reads them per scenario with `take_sample`.  Only timing
samples are kept: the port has no /v1/metrics endpoint, counters or
gauges yet (ROADMAP A6).
"""
from __future__ import annotations

import random
import threading
import time
from collections import defaultdict
from typing import Dict, List


class _Sample:
    __slots__ = ("count", "total", "max", "values", "_rng")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self.values: List[float] = []          # bounded reservoir
        # seeded so summaries are reproducible across runs; per-instance
        # so concurrent series don't share generator state
        self._rng = random.Random(0x5EED)

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.max = max(self.max, v)
        if len(self.values) < 1024:
            self.values.append(v)
        else:
            # Vitter's Algorithm R: keep the new value with probability
            # 1024/count at a uniform slot, so every observation has
            # equal weight in the percentiles
            j = self._rng.randrange(self.count)
            if j < 1024:
                self.values[j] = v

    def summary(self) -> dict:
        vals = sorted(self.values)
        p50 = vals[min(len(vals) - 1, int(len(vals) * 0.50))] if vals else 0.0
        p99 = vals[min(len(vals) - 1, int(len(vals) * 0.99))] if vals else 0.0
        return {"count": self.count,
                "mean": self.total / self.count if self.count else 0.0,
                "max": self.max, "p50": p50, "p99": p99}


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._samples: Dict[str, _Sample] = defaultdict(_Sample)

    def add_sample(self, name: str, value: float) -> None:
        with self._lock:
            self._samples[name].add(value)

    def measure_since(self, name: str, start: float) -> None:
        """Sample the milliseconds since `start` (a time.time() value)."""
        self.add_sample(name, (time.time() - start) * 1000.0)

    def take_sample(self, name: str) -> dict:
        """Summary of one timing series, then reset it — per-window
        measurement (bench scenarios, tests)."""
        with self._lock:
            s = self._samples.pop(name, None)
        return s.summary() if s is not None else _Sample().summary()


# process-global default registry (the reference's metrics.Default())
global_metrics = MetricsRegistry()
