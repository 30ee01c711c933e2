"""In-process timing samples (the port's copy of the reference's
telemetry.py, itself after armon/go-metrics as the reference Nomad wires
it, command/agent/command.go:1034-1140).

The spine samples the reference's scheduler metrics:
  nomad.plan.submit (and nomad.plan.submit.ns.<namespace>)  core/worker.py
  nomad.plan.evaluate                                       core/plan_apply.py
and the bench reads them per scenario with `take_sample`.  The control
loops count what they do (`heartbeat.*` in core/heartbeat.py,
`stream.*` in core/events.py).  Counters, gauges and timing samples
with mean/max/p99; `snapshot` gives the JSON form and `prometheus` the
text exposition of the reference's /v1/metrics (the port has no HTTP
endpoint yet: ROADMAP A8).
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
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._samples: Dict[str, _Sample] = defaultdict(_Sample)

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def set_gauges(self, values: Dict[str, float],
                   prefix: str = "") -> None:
        """Bulk gauge publish under ONE lock acquisition — a snapshot
        reader never sees half of a related set (e.g. the recompile
        budget's per-kernel counts) from two different instants."""
        with self._lock:
            for name, value in values.items():
                self._gauges[prefix + name] = value

    def add_sample(self, name: str, value: float) -> None:
        with self._lock:
            self._samples[name].add(value)

    def measure_since(self, name: str, start: float) -> None:
        self.add_sample(name, (time.time() - start) * 1000.0)  # ms

    def take_sample(self, name: str) -> dict:
        """Summary of one timing series, then reset it — per-window
        measurement (bench scenarios, tests)."""
        with self._lock:
            s = self._samples.pop(name, None)
        return s.summary() if s is not None else _Sample().summary()

    class _Timer:
        __slots__ = ("reg", "name", "start")

        def __init__(self, reg, name):
            self.reg = reg
            self.name = name

        def __enter__(self):
            self.start = time.time()
            return self

        def __exit__(self, *exc):
            self.reg.measure_since(self.name, self.start)
            return False

    def timer(self, name: str) -> "_Timer":
        return self._Timer(self, name)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "Counters": [{"Name": k, "Count": v}
                             for k, v in sorted(self._counters.items())],
                "Gauges": [{"Name": k, "Value": v}
                           for k, v in sorted(self._gauges.items())],
                "Samples": [dict(Name=k, **s.summary())
                            for k, s in sorted(self._samples.items())],
            }

    def prometheus(self) -> str:
        """Prometheus text exposition: every family gets HELP + TYPE,
        counters carry the conventional `_total` suffix, and when two
        raw names sanitize to the same exposition name only the first is
        exported (scrapers hard-fail on duplicate TYPE blocks; the
        skipped name is noted in a comment so the collision is
        visible)."""
        def san(n):
            return n.replace(".", "_").replace("-", "_")
        lines: List[str] = []
        seen: Dict[str, str] = {}   # exposition name -> raw name

        def family(raw: str, name: str, kind: str) -> bool:
            if name in seen:
                lines.append(f"# collision: {raw!r} sanitizes to "
                             f"{name} (already exported for "
                             f"{seen[name]!r}); skipped")
                return False
            seen[name] = raw
            lines.append(f"# HELP {name} nomad_tpu {kind} {raw}")
            lines.append(f"# TYPE {name} {kind}")
            return True

        with self._lock:
            for k, v in sorted(self._counters.items()):
                name = san(k) + "_total"
                if family(k, name, "counter"):
                    lines.append(f"{name} {v}")
            for k, v in sorted(self._gauges.items()):
                name = san(k)
                if family(k, name, "gauge"):
                    lines.append(f"{name} {v}")
            for k, s in sorted(self._samples.items()):
                m = s.summary()
                base = san(k)
                if family(k, base, "summary"):
                    lines.append(f'{base}{{quantile="0.5"}} {m["p50"]}')
                    lines.append(f'{base}{{quantile="0.99"}} {m["p99"]}')
                    lines.append(f"{base}_sum {s.total}")
                    lines.append(f"{base}_count {m['count']}")
        return "\n".join(lines) + "\n"


# process-global default registry (the reference's metrics.Default())
global_metrics = MetricsRegistry()
