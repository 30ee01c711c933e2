"""Core scheduler: internal GC job (reference: nomad/core_sched.go —
CoreScheduler.Process:44, jobGC:94, evalGC:231, nodeGC:434,
deploymentGC:545; enqueued by the leader's periodic timers,
leader.go:782-810).

Eval types: 'job-gc', 'eval-gc', 'node-gc', 'deployment-gc', or the
'force-gc' catch-all.
"""
from __future__ import annotations

import time as _time
from typing import Optional

from nomad_tpu_torch.raft import MessageType
from nomad_tpu_torch.structs import JobStatus
from nomad_tpu_torch.structs.node import NodeStatus

JOB_GC_THRESHOLD = 4 * 3600.0
EVAL_GC_THRESHOLD = 1 * 3600.0
NODE_GC_THRESHOLD = 24 * 3600.0
DEPLOYMENT_GC_THRESHOLD = 1 * 3600.0


class CoreScheduler:
    """Registered under the '_core' job type; processes GC evals."""

    def __init__(self, server):
        self.server = server

    def process(self, gc_type: str, now: Optional[float] = None,
                force: bool = False) -> dict:
        now = now if now is not None else _time.time()
        stats = {}
        if gc_type in ("eval-gc", "force-gc"):
            stats["evals"] = self.eval_gc(now, force)
        if gc_type in ("job-gc", "force-gc"):
            stats["jobs"] = self.job_gc(now, force)
        if gc_type in ("node-gc", "force-gc"):
            stats["nodes"] = self.node_gc(now, force)
        if gc_type in ("deployment-gc", "force-gc"):
            stats["deployments"] = self.deployment_gc(now, force)
        if gc_type in ("service-gc", "force-gc"):
            stats["services"] = self.service_gc()
        return stats

    # ------------------------------------------------------------- passes

    def _old_enough(self, ts: float, now: float, threshold: float,
                    force: bool) -> bool:
        return force or (ts and now - ts >= threshold)

    def eval_gc(self, now: float, force: bool = False) -> int:
        """Terminal evals (and their terminal allocs) past the threshold."""
        store = self.server.store
        gc_evals, gc_allocs = [], []
        for ev in store.evals():
            if not ev.terminal():
                continue
            if not self._old_enough(ev.modify_time or ev.create_time, now,
                                    EVAL_GC_THRESHOLD, force):
                continue
            allocs = store.allocs_by_eval(ev.id)
            if all(a.terminal_status() for a in allocs):
                gc_evals.append(ev.id)
                gc_allocs.extend(a.id for a in allocs)
        if gc_evals:
            self.server.apply(MessageType.EVAL_DELETE,
                              {"eval_ids": gc_evals, "alloc_ids": gc_allocs})
        return len(gc_evals)

    def job_gc(self, now: float, force: bool = False) -> int:
        """Dead jobs with only terminal allocs and terminal evals."""
        store = self.server.store
        n = 0
        for job in store.jobs():
            if job.status != JobStatus.DEAD and not job.stop:
                continue
            if job.is_periodic() and not job.stop:
                continue
            if not self._old_enough(job.submit_time, now, JOB_GC_THRESHOLD,
                                    force):
                continue
            allocs = store.allocs_by_job(job.namespace, job.id)
            evals = store.evals_by_job(job.namespace, job.id)
            if all(a.terminal_status() for a in allocs) and \
                    all(e.terminal() for e in evals):
                self.server.apply(MessageType.EVAL_DELETE,
                                  {"eval_ids": [e.id for e in evals],
                                   "alloc_ids": [a.id for a in allocs]})
                self.server.apply(MessageType.JOB_DEREGISTER,
                                  {"namespace": job.namespace,
                                   "job_id": job.id, "purge": True})
                n += 1
        return n

    def node_gc(self, now: float, force: bool = False) -> int:
        """Down nodes with no non-terminal allocs."""
        store = self.server.store
        n = 0
        for node in store.nodes():
            if node.status != NodeStatus.DOWN:
                continue
            if not self._old_enough(node.status_updated_at, now,
                                    NODE_GC_THRESHOLD, force):
                continue
            if any(not a.terminal_status()
                   for a in store.allocs_by_node(node.id)):
                continue
            self.server.apply(MessageType.NODE_DEREGISTER,
                              {"node_id": node.id})
            n += 1
        return n

    def service_gc(self) -> int:
        """Orphaned nomad-service registrations: a client that dies
        without deregistering leaves rows behind; sweep any registration
        whose allocation is gone or terminal (reference
        core_sched.go csiPluginGC analog for service_registrations)."""
        store = self.server.store
        doomed = []
        for sr in store.services():
            a = store.alloc_by_id(sr.alloc_id)
            if a is None or a.terminal_status():
                doomed.append(sr.id)
        if doomed:
            self.server.apply(MessageType.SERVICE_DEREGISTER,
                              {"ids": doomed})
        return len(doomed)

    def deployment_gc(self, now: float, force: bool = False) -> int:
        store = self.server.store
        n = 0
        for d in store.deployments():
            if d.active():
                continue
            if not self._old_enough(d.modify_time or d.create_time, now,
                                    DEPLOYMENT_GC_THRESHOLD, force):
                continue
            self.server.apply(MessageType.DEPLOYMENT_DELETE,
                              {"deployment_id": d.id})
            n += 1
        return n
