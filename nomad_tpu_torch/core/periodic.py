"""Periodic job dispatcher (reference: nomad/periodic.go — cron-style
launcher creating child jobs '<parent>/periodic-<ts>' with evals).

Supported specs: standard 5-field cron (minute hour dom month dow, with
*, */N, N, N-M, comma lists) and '@every <seconds>s'.
"""
from __future__ import annotations

import logging
import threading
import time as _time
from datetime import datetime, timedelta, timezone
from typing import List, Optional

log = logging.getLogger(__name__)


def _field_matches(field: str, value: int) -> bool:
    for part in field.split(","):
        if part == "*":
            return True
        if part.startswith("*/"):
            if value % int(part[2:]) == 0:
                return True
        elif "-" in part:
            lo, hi = part.split("-")
            if int(lo) <= value <= int(hi):
                return True
        elif part.isdigit() and int(part) == value:
            return True
    return False


def next_cron_after(spec: str, after: float) -> Optional[float]:
    """Next fire time strictly after `after` (UTC), or None."""
    if spec.startswith("@every"):
        secs = float(spec.split()[1].rstrip("s"))
        return after + secs
    fields = spec.split()
    if len(fields) != 5:
        return None
    minute, hour, dom, month, dow = fields
    t = datetime.fromtimestamp(after, tz=timezone.utc).replace(second=0, microsecond=0)
    t += timedelta(minutes=1)
    for _ in range(366 * 24 * 60):      # bounded search: one year
        # cron day-of-week: Sunday=0 (and 7 also means Sunday)
        cron_dow = (t.weekday() + 1) % 7
        dow_ok = _field_matches(dow, cron_dow) or (
            cron_dow == 0 and _field_matches(dow, 7))
        if (_field_matches(minute, t.minute) and _field_matches(hour, t.hour)
                and _field_matches(dom, t.day) and _field_matches(month, t.month)
                and dow_ok):
            return t.timestamp()
        t += timedelta(minutes=1)
    return None


class PeriodicDispatcher:
    def __init__(self, server, tick: float = 0.5):
        self.server = server
        self.tick = tick
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next_fire: dict = {}     # (ns, job_id) -> ts

    def start(self) -> None:
        self._stop = threading.Event()   # fresh per leadership tenure
        self._thread = threading.Thread(target=self._run, name="periodic",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(60.0)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.dispatch_due(_time.time())
            except Exception:           # noqa: BLE001
                log.exception("periodic")
            self._stop.wait(self.tick)

    def dispatch_due(self, now: float) -> List[str]:
        launched = []
        for job in self.server.store.jobs():
            if not job.is_periodic() or job.stopped() or job.parent_id:
                continue
            if not job.periodic.enabled:
                continue
            key = (job.namespace, job.id)
            nxt = self._next_fire.get(key)
            if nxt is None:
                nxt = next_cron_after(job.periodic.spec, now)
                self._next_fire[key] = nxt
                continue
            if nxt is not None and now >= nxt:
                if job.periodic.prohibit_overlap and self._has_running_child(job):
                    self._next_fire[key] = next_cron_after(job.periodic.spec, now)
                    continue
                launched.append(self._launch(job, nxt))
                self._next_fire[key] = next_cron_after(job.periodic.spec, now)
        return launched

    def _has_running_child(self, job) -> bool:
        for j in self.server.store.jobs():
            if j.parent_id != job.id or j.status == "dead":
                continue
            allocs = self.server.store.allocs_by_job(j.namespace, j.id)
            if any(not a.terminal_status() for a in allocs):
                return True
            if not allocs:
                # child not placed yet (pending eval) still counts as
                # running for prohibit_overlap (reference periodic.go)
                evals = self.server.store.evals_by_job(j.namespace, j.id)
                if not allocs and (not evals
                                   or any(not e.terminal() for e in evals)):
                    return True
        return False

    def _launch(self, job, fire_time: float) -> str:
        """Create the child job '<id>/periodic-<unix>' (reference
        periodic.go derivedJob)."""
        child = job.copy()
        child.id = f"{job.id}/periodic-{int(fire_time)}"
        child.parent_id = job.id
        child.periodic = None
        self.server.register_job(child)
        return child.id
