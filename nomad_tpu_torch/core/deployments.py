"""Deployment watcher (reference: nomad/deploymentwatcher/ —
deployments_watcher.go:60 Watcher, deployment_watcher.go per-deployment
logic): drives rolling updates, canary auto-promotion, auto-revert, and
progress deadlines by watching allocation health and emitting evaluations.

The reference's multiregion rollout (kicking the next region, failing
the sibling regions) reaches other regions over RPC and stays out of
this port with federation (ROADMAP A7); `multiregion_fail` raises.
`reconcile_all(now)` is the loop's body, callable with a given clock.
"""
from __future__ import annotations

import logging
import threading
import time as _time
from typing import List, Optional

from nomad_tpu_torch.raft import MessageType
from nomad_tpu_torch.structs import (
    AllocClientStatus,
    Deployment,
    DeploymentStatus,
    Evaluation,
    EvalStatus,
)
from nomad_tpu_torch.structs.evaluation import EvalTrigger

log = logging.getLogger(__name__)


def _stamp(d: Deployment) -> Deployment:
    """Propose-time timestamps: they ride in the raft log payload so the
    FSM never reads the clock (replicas/replay must agree byte-for-byte;
    see nomad_tpu.analysis fsm-determinism)."""
    d.modify_time = _time.time()
    if not d.create_time:
        d.create_time = d.modify_time
    return d


class DeploymentWatcher:
    def __init__(self, server, interval: float = 0.1):
        self.server = server
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dirty = threading.Event()
        # subscribe to alloc/deployment changes
        server.store.watch(self._on_change)

    def start(self) -> None:
        self._stop = threading.Event()   # fresh per leadership tenure
        self._thread = threading.Thread(target=self._run, name="deploy-watcher",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._dirty.set()
        if self._thread:
            self._thread.join(60.0)

    def _on_change(self, table: str, obj) -> None:
        if table in ("allocs", "deployments"):
            self._dirty.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._dirty.wait(timeout=self.interval)
            self._dirty.clear()
            if self._stop.is_set():
                return
            try:
                self.reconcile_all()
            except Exception:               # noqa: BLE001
                log.exception("deployment watcher")

    # ------------------------------------------------------------- logic

    def reconcile_all(self, now: Optional[float] = None) -> None:
        now = now if now is not None else _time.time()
        for d in self.server.store.deployments():
            if d.active():
                self._reconcile(d, now)
            elif d.status == DeploymentStatus.FAILED:
                self._retry_revert(d)

    def _retry_revert(self, d: Deployment) -> None:
        """A FAILED auto-revert deployment whose revert register_job was
        lost (leadership churn or partition between the FAILED upsert and
        the revert landing) leaves the job stuck on the bad version with
        nothing to retry it — the deployment is no longer active, so
        _reconcile never sees it again.  Retry while the job still sits
        at the deployment's version.  Any version advance (the revert
        landing, or a newer registration) makes this a no-op, so a
        re-entered watcher pass can never double-revert or touch a
        deployment that has been superseded."""
        if not any(s.auto_revert for s in d.task_groups.values()):
            return
        server = self.server
        job = server.store.job_by_id(d.namespace, d.job_id)
        if job is None or job.stop or job.version != d.job_version:
            return
        stable = self._latest_stable(d.namespace, d.job_id, d.job_version)
        if stable is not None:
            server.register_job(stable.copy())

    def _reconcile(self, d: Deployment, now: float) -> None:
        server = self.server
        store = server.store
        allocs = [a for a in store.allocs_by_job(d.namespace, d.job_id)
                  if a.deployment_id == d.id]

        updated = d.copy()
        failed = False
        unhealthy_alloc = None
        for state in updated.task_groups.values():
            state.placed_allocs = 0
            state.healthy_allocs = 0
            state.unhealthy_allocs = 0
        for a in allocs:
            state = updated.task_groups.get(a.task_group)
            if state is None:
                continue
            if not a.server_terminal_status():
                state.placed_allocs += 1
            if a.is_healthy():
                state.healthy_allocs += 1
            elif a.is_unhealthy():
                state.unhealthy_allocs += 1
                failed = True
                unhealthy_alloc = a
            if a.client_status == AllocClientStatus.FAILED:
                failed = True
                unhealthy_alloc = a

        # progress deadline
        deadline_failed = any(
            s.require_progress_by and now > s.require_progress_by
            and s.healthy_allocs < s.desired_total
            for s in updated.task_groups.values())

        if failed or deadline_failed:
            self._fail_deployment(updated, deadline_failed)
            return

        # canary auto-promotion: all canaries healthy -> promote
        if updated.has_auto_promote() and not all(
                s.promoted for s in updated.task_groups.values()
                if s.desired_canaries > 0):
            ready = all(
                len([c for c in s.placed_canaries
                     if (al := store.alloc_by_id(c)) is not None and al.is_healthy()])
                >= s.desired_canaries
                for s in updated.task_groups.values() if s.desired_canaries > 0)
            if ready:
                self.promote(updated.id)
                return

        # successful when every group reached desired healthy count
        complete = all(
            s.healthy_allocs >= s.desired_total
            and (s.desired_canaries == 0 or s.promoted)
            for s in updated.task_groups.values())
        if complete and updated.task_groups:
            updated.status = DeploymentStatus.SUCCESSFUL
            updated.status_description = DeploymentStatus.DESC_SUCCESSFUL
            server.apply(MessageType.DEPLOYMENT_UPSERT, {"deployment": _stamp(updated)})
            self._mark_job_stable(d)
            return

        # health progressed: emit an eval so the reconciler can continue
        # the rollout (the reference watcher creates evals on alloc health
        # transitions, deployment_watcher.go)
        def counts(dep):
            return {k: (s.placed_allocs, s.healthy_allocs, s.unhealthy_allocs,
                        s.promoted) for k, s in dep.task_groups.items()}

        progressed = any(
            k in d.task_groups
            and updated.task_groups[k].healthy_allocs
            > d.task_groups[k].healthy_allocs
            for k in updated.task_groups)
        # only write when something actually changed — an unconditional
        # upsert re-triggers this watcher through its own state watch
        if counts(updated) != counts(d) or updated.status != d.status:
            server.apply(MessageType.DEPLOYMENT_UPSERT, {"deployment": _stamp(updated)})
        if progressed:
            self._emit_eval(updated)

    def _mark_job_stable(self, d: Deployment) -> None:
        self.server.set_job_stability(d.namespace, d.job_id, d.job_version, True)

    def _fail_deployment(self, d: Deployment, deadline: bool) -> None:
        server = self.server
        d.status = DeploymentStatus.FAILED
        d.status_description = (
            DeploymentStatus.DESC_PROGRESS_DEADLINE
            if deadline else DeploymentStatus.DESC_FAILED_ALLOCATIONS)
        server.apply(MessageType.DEPLOYMENT_UPSERT, {"deployment": _stamp(d)})
        # auto-revert to the latest stable version
        if any(s.auto_revert for s in d.task_groups.values()):
            job = server.store.job_by_id(d.namespace, d.job_id)
            if job is not None and job.version == d.job_version:
                stable = self._latest_stable(d.namespace, d.job_id, d.job_version)
                if stable is not None:
                    revert = stable.copy()
                    server.register_job(revert)
                    return
        self._emit_eval(d)

    def multiregion_fail(self, namespace: str, job_id: str,
                         rollout: str = "") -> bool:
        """Deployment.MultiregionFail, the receiving side of
        cross-region failure propagation: not in this port (ROADMAP A7,
        federation).  The port's server refuses multiregion jobs at
        registration, so no deployment here has a peer region."""
        raise NotImplementedError(
            "nomad_tpu_torch.core.deployments: multiregion deployments "
            "come with federation (ROADMAP A7)")

    def _latest_stable(self, namespace: str, job_id: str, before_version: int):
        versions = self.server.store.job_versions(namespace, job_id)
        for j in sorted(versions, key=lambda x: -x.version):
            if j.stable and j.version < before_version:
                return j
        return None

    def _emit_eval(self, d: Deployment) -> None:
        job = self.server.store.job_by_id(d.namespace, d.job_id)
        if job is None:
            return
        self.server.create_evals([Evaluation(
            namespace=d.namespace, priority=d.eval_priority, type=job.type,
            job_id=d.job_id, deployment_id=d.id,
            triggered_by=EvalTrigger.DEPLOYMENT_WATCHER,
            status=EvalStatus.PENDING)])

    # ------------------------------------------------------------- API

    def promote(self, deployment_id: str, groups: Optional[List[str]] = None) -> bool:
        """Deployment.Promote RPC: mark canaries promoted, emit an eval so
        the reconciler replaces the remaining old-version allocs."""
        server = self.server
        d = server.store.deployment_by_id(deployment_id)
        if d is None or not d.active():
            return False
        updated = d.copy()
        for name, state in updated.task_groups.items():
            if groups is None or name in groups:
                state.promoted = True
        server.apply(MessageType.DEPLOYMENT_UPSERT, {"deployment": _stamp(updated)})
        self._emit_eval(updated)
        return True

    def fail(self, deployment_id: str) -> bool:
        d = self.server.store.deployment_by_id(deployment_id)
        if d is None or not d.active():
            return False
        self._fail_deployment(d.copy(), deadline=False)
        return True

    def pause(self, deployment_id: str, pause: bool) -> bool:
        d = self.server.store.deployment_by_id(deployment_id)
        if d is None or not d.active():
            return False
        updated = d.copy()
        updated.status = (DeploymentStatus.PAUSED if pause
                          else DeploymentStatus.RUNNING)
        self.server.apply(MessageType.DEPLOYMENT_UPSERT, {"deployment": _stamp(updated)})
        if not pause:
            self._emit_eval(updated)
        return True
