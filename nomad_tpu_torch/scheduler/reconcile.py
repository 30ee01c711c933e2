"""Allocation reconciler: desired-state diff engine for service/batch jobs.

Reference: scheduler/reconcile.go (allocReconciler:39, Compute:204,
computeGroup:383) and reconcile_util.go (allocSet filters).  Host-side pure
set logic — not a hot loop (SURVEY.md section 7 item 4); the output drives
the dense placement kernel.

Given a job (possibly stopped / a new version), its existing allocations,
node taint info, and the active deployment, computes per task group:
place / stop / ignore / migrate / in-place-update / destructive-update /
canary / disconnect / reconnect sets, plus deployment status updates and
delayed-reschedule follow-up evals.
"""
from __future__ import annotations

import math
import time as _time
import uuid

from nomad_tpu_torch.utils import generate_uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from nomad_tpu_torch.structs import (
    Allocation,
    AllocClientStatus,
    AllocDesiredStatus,
    Deployment,
    DeploymentState,
    DeploymentStatus,
    Evaluation,
    EvalStatus,
    Job,
    TaskGroup,
)
from nomad_tpu_torch.structs.alloc import alloc_name
from nomad_tpu_torch.structs.evaluation import EvalTrigger
from nomad_tpu_torch.structs.job import JobType, ReschedulePolicy

# desired-description strings (reference structs allocs' DesiredDescription)
ALLOC_NOT_NEEDED = "alloc not needed due to job update"
ALLOC_MIGRATING = "alloc is being migrated"
ALLOC_RESCHEDULED = "alloc was rescheduled because it failed"
ALLOC_LOST = "alloc was lost since its node is down"
ALLOC_UNKNOWN = "alloc is unknown since its node is disconnected"
ALLOC_CANARY = "alloc is a canary"
ALLOC_RECONNECTED = "alloc is reconnecting"
ALLOC_DUPLICATE = "alloc duplicates another allocation's name"


@dataclass
class PlacementRequest:
    task_group: str
    name: str                     # "<job>.<group>[i]"
    previous_alloc: Optional[Allocation] = None
    is_canary: bool = False
    is_destructive: bool = False
    is_rescheduling: bool = False
    min_job_version: int = 0


@dataclass
class StopRequest:
    alloc: Allocation
    status_description: str = ""
    client_status: str = ""
    followup_eval_id: str = ""


@dataclass
class ReconcileResults:
    """Reference reconcileResults (reconcile.go:97-137)."""
    place: List[PlacementRequest] = field(default_factory=list)
    stop: List[StopRequest] = field(default_factory=list)
    inplace_update: List[Allocation] = field(default_factory=list)
    destructive_stop: List[StopRequest] = field(default_factory=list)
    attribute_updates: Dict[str, Allocation] = field(default_factory=dict)
    disconnect_updates: Dict[str, Allocation] = field(default_factory=dict)
    reconnect_updates: Dict[str, Allocation] = field(default_factory=dict)
    deployment: Optional[Deployment] = None
    deployment_updates: List[dict] = field(default_factory=list)
    desired_followup_evals: Dict[str, List[Evaluation]] = field(default_factory=dict)
    desired_tg_updates: Dict[str, dict] = field(default_factory=dict)

    def tg_update(self, tg: str) -> dict:
        return self.desired_tg_updates.setdefault(tg, {
            "ignore": 0, "place": 0, "migrate": 0, "stop": 0,
            "in_place_update": 0, "destructive_update": 0, "canary": 0,
            "preemptions": 0})


def tasks_updated(a: TaskGroup, b: TaskGroup) -> bool:
    """Whether moving from group a to b needs a destructive update
    (reference scheduler/util.go:488 tasksUpdated)."""
    if len(a.tasks) != len(b.tasks):
        return True
    if _nets_updated(a.networks, b.networks):
        return True
    if (a.ephemeral_disk.size_mb != b.ephemeral_disk.size_mb
            or a.ephemeral_disk.sticky != b.ephemeral_disk.sticky):
        return True
    bt = {t.name: t for t in b.tasks}
    for t in a.tasks:
        o = bt.get(t.name)
        if o is None:
            return True
        if (t.driver != o.driver or t.config != o.config or t.env != o.env
                or t.artifacts != o.artifacts or t.meta != o.meta
                or t.templates != o.templates or t.vault != o.vault):
            return True
        ra, rb = t.resources, o.resources
        if (ra.cpu != rb.cpu or ra.cores != rb.cores
                or ra.memory_mb != rb.memory_mb
                or ra.memory_max_mb != rb.memory_max_mb
                or len(ra.devices) != len(rb.devices)
                or _nets_updated(ra.networks, rb.networks)):
            return True
    return False


def _nets_updated(a, b) -> bool:
    if len(a) != len(b):
        return True
    for na, nb in zip(a, b):
        if na.mode != nb.mode or na.mbits != nb.mbits:
            return True
        if ([(p.label, p.value, p.to) for p in na.reserved_ports]
                != [(p.label, p.value, p.to) for p in nb.reserved_ports]):
            return True
        if ([(p.label, p.to) for p in na.dynamic_ports]
                != [(p.label, p.to) for p in nb.dynamic_ports]):
            return True
    return False


def reschedule_delay(policy: ReschedulePolicy, attempt: int) -> float:
    """Backoff for the next reschedule attempt (reference
    structs.ReschedulePolicy delay functions)."""
    if policy.delay_function == "constant":
        d = policy.delay_s
    elif policy.delay_function == "exponential":
        d = policy.delay_s * (2 ** attempt)
    elif policy.delay_function == "fibonacci":
        a, b = policy.delay_s, policy.delay_s
        for _ in range(attempt):
            a, b = b, a + b
        d = a
    else:
        d = policy.delay_s
    if policy.max_delay_s:
        d = min(d, policy.max_delay_s)
    return d


def should_reschedule_now(alloc: Allocation, policy: Optional[ReschedulePolicy],
                          now: float, is_batch: bool) -> Tuple[bool, float]:
    """-> (eligible, wait_until).  wait_until 0 means immediately.
    Mirrors Allocation.ShouldReschedule / NextRescheduleTime."""
    if policy is None:
        return False, 0.0
    if alloc.desired_transition.should_force_reschedule():
        return True, 0.0
    if alloc.client_status != AllocClientStatus.FAILED:
        return False, 0.0
    events = alloc.reschedule_tracker.events if alloc.reschedule_tracker else []
    attempt = len(events)
    if not policy.unlimited:
        if policy.attempts == 0:
            return False, 0.0
        window_start = now - policy.interval_s
        recent = [e for e in events if e.reschedule_time >= window_start]
        if len(recent) >= policy.attempts:
            return False, 0.0
    delay = reschedule_delay(policy, attempt) if not is_batch else 0.0
    if is_batch or delay <= 0:
        return True, 0.0
    fail_time = _alloc_fail_time(alloc, now)
    ready_at = fail_time + delay
    return True, (ready_at if ready_at > now else 0.0)


def _alloc_fail_time(alloc: Allocation, now: float) -> float:
    latest = 0.0
    for ts in alloc.task_states.values():
        latest = max(latest, ts.finished_at)
    return latest or now


class AllocReconciler:
    def __init__(self, job: Optional[Job], job_id: str, existing: List[Allocation],
                 tainted_nodes: Dict[str, object], deployment: Optional[Deployment],
                 eval_id: str = "", batch: bool = False, now: Optional[float] = None,
                 eval_priority: int = 50, supports_disconnected: bool = True):
        self.job = job
        self.job_id = job_id
        self.existing = existing
        self.tainted = tainted_nodes        # node_id -> Node (down/draining/disconnected)
        self.deployment = deployment
        self.eval_id = eval_id
        self.batch = batch
        self.now = now if now is not None else _time.time()
        self.eval_priority = eval_priority
        self.results = ReconcileResults()
        self.deployment_paused = bool(
            deployment and deployment.status in (DeploymentStatus.PAUSED,
                                                 DeploymentStatus.PENDING))
        self.deployment_failed = bool(
            deployment and deployment.status == DeploymentStatus.FAILED)

    # ------------------------------------------------------------- compute

    def compute(self) -> ReconcileResults:
        job_stopped = self.job is None or self.job.stopped()

        # cancel an ACTIVE deployment for a stopped job or older version;
        # terminal deployments (failed/successful/cancelled) are left alone
        # and must not gate the next rollout via stale paused/failed flags
        if self.deployment is not None and not self.deployment.active():
            self.deployment = None
            self.deployment_paused = False
            self.deployment_failed = False
        if self.deployment is not None:
            cancel = False
            desc = ""
            if job_stopped:
                cancel, desc = True, "Cancelled because job is stopped"
            elif self.job.version != self.deployment.job_version:
                cancel, desc = True, DeploymentStatus.DESC_NEWER_JOB
            if cancel:
                self.results.deployment_updates.append({
                    "deployment_id": self.deployment.id,
                    "status": DeploymentStatus.CANCELLED,
                    "description": desc})
                self.deployment = None

        if job_stopped:
            self._stop_all()
            return self.results

        groups = {tg.name: tg for tg in self.job.task_groups}
        by_group: Dict[str, List[Allocation]] = {g: [] for g in groups}
        for a in self.existing:
            if a.task_group in by_group:
                by_group[a.task_group].append(a)
            else:
                # group removed from the job
                if not a.terminal_status():
                    self.results.stop.append(StopRequest(a, ALLOC_NOT_NEEDED))

        deployment_complete = True
        for name, tg in groups.items():
            complete = self._compute_group(tg, by_group[name])
            deployment_complete = deployment_complete and complete

        # an alloc chosen for stop must not also ride along as an update
        stopped_ids = {sr.alloc.id for sr in self.results.stop}
        stopped_ids |= {sr.alloc.id for sr in self.results.destructive_stop}
        self.results.inplace_update = [
            u for u in self.results.inplace_update if u.id not in stopped_ids]

        self._finalize_deployment(deployment_complete)
        return self.results

    def _stop_all(self) -> None:
        for a in self.existing:
            if not a.terminal_status():
                desc = ("alloc not needed due to job being stopped"
                        if self.job is not None else "alloc not needed as job was purged")
                self.results.stop.append(StopRequest(a, desc))
                if self.job is not None:
                    self.results.tg_update(a.task_group)["stop"] += 1

    # ------------------------------------------------------- group compute

    def _filter_by_tainted(self, allocs: List[Allocation], tg: TaskGroup):
        """Split allocs by node state (reference reconcile_util.go
        filterByTainted): -> (untainted, migrate, lost, disconnecting,
        reconnecting, ignore_terminal)."""
        untainted, migrate, lost = [], [], []
        disconnecting, reconnecting = [], []
        supports_disconnect = tg.max_client_disconnect_s is not None
        for a in allocs:
            node = self.tainted.get(a.node_id)
            if a.client_status == AllocClientStatus.UNKNOWN:
                if node is None or getattr(node, "status", "") == "ready":
                    reconnecting.append(a)
                    continue
                if getattr(node, "status", "") == "disconnected":
                    expires = getattr(a, "disconnected_at", 0.0) + \
                        (tg.max_client_disconnect_s or 0.0)
                    if getattr(a, "disconnected_at", 0.0) and \
                            self.now >= expires:
                        # max_client_disconnect elapsed (this pass is the
                        # MAX_DISCONNECT_TIMEOUT follow-up eval): the
                        # alloc is lost and a replacement must place
                        lost.append(a)
                    else:
                        untainted.append(a)   # still unknown; wait
                    continue
                # node is down: unknown -> lost below
            if node is None:
                untainted.append(a)
                continue
            status = getattr(node, "status", "down")
            draining = getattr(node, "draining", False)
            if a.terminal_status():
                untainted.append(a)
                continue
            if status == "disconnected" and supports_disconnect:
                disconnecting.append(a)
            elif status in ("down", "disconnected"):
                # node state beats drain state: a node hard-killed
                # mid-drain has lost its allocs — routing them through
                # migrate (or leaving them untainted awaiting a migrate
                # slot) would strand them behind a drainer that can no
                # longer talk to the node
                lost.append(a)
            elif draining:
                if a.desired_transition.should_migrate():
                    migrate.append(a)
                else:
                    untainted.append(a)
            else:
                untainted.append(a)
        return untainted, migrate, lost, disconnecting, reconnecting

    def _compute_group(self, tg: TaskGroup, all_allocs: List[Allocation]) -> bool:
        res = self.results
        upd = res.tg_update(tg.name)
        is_service = not self.batch

        # batch jobs ignore successfully-completed allocs entirely
        live: List[Allocation] = []
        terminal: List[Allocation] = []
        for a in all_allocs:
            if a.terminal_status():
                terminal.append(a)
            else:
                live.append(a)

        untainted, migrate, lost, disconnecting, reconnecting = \
            self._filter_by_tainted(live, tg)

        # --- disconnecting -> mark unknown, schedule timeout followup
        for a in disconnecting:
            u = a.copy()
            u.client_status = AllocClientStatus.UNKNOWN
            u.desired_description = ALLOC_UNKNOWN
            u.disconnected_at = self.now
            timeout_eval = Evaluation(
                id=generate_uuid(), namespace=a.namespace, priority=self.eval_priority,
                type=self.job.type, triggered_by=EvalTrigger.MAX_DISCONNECT_TIMEOUT,
                job_id=self.job_id, status=EvalStatus.PENDING,
                wait_until=self.now + (tg.max_client_disconnect_s or 0.0))
            res.desired_followup_evals.setdefault(tg.name, []).append(timeout_eval)
            u.followup_eval_id = timeout_eval.id
            res.disconnect_updates[a.id] = u

        # --- reconnecting -> keep newest; stop failed/replaced duplicates
        for a in reconnecting:
            if a.client_status == AllocClientStatus.FAILED:
                res.stop.append(StopRequest(a, ALLOC_RESCHEDULED))
                upd["stop"] += 1
            else:
                u = a.copy()
                u.client_status = AllocClientStatus.RUNNING
                u.disconnected_at = 0.0
                res.reconnect_updates[a.id] = u
                untainted.append(a)

        # --- lost allocations stop with client status lost
        for a in lost:
            res.stop.append(StopRequest(
                a, ALLOC_LOST, client_status=AllocClientStatus.LOST))
            upd["stop"] += 1

        # --- rescheduling of failed allocs
        reschedule_now: List[Allocation] = []
        reschedule_later: List[Tuple[Allocation, float]] = []
        policy = tg.reschedule_policy
        still_untainted = []
        for a in untainted:
            if (a.client_status == AllocClientStatus.FAILED
                    or a.desired_transition.should_force_reschedule()):
                ok, wait_until = should_reschedule_now(a, policy, self.now, self.batch)
                if ok and wait_until == 0.0:
                    reschedule_now.append(a)
                    continue
                if ok:
                    reschedule_later.append((a, wait_until))
            still_untainted.append(a)
        untainted = still_untainted

        # client-terminal failed allocs (desired run, not yet replaced) are
        # reschedule candidates for both service and batch
        for a in terminal:
            if (a.client_status == AllocClientStatus.FAILED
                    and a.desired_status == AllocDesiredStatus.RUN
                    and not a.next_allocation and not a.followup_eval_id
                    and a.node_id not in self.tainted):
                ok, wait_until = should_reschedule_now(a, policy, self.now, self.batch)
                if ok and wait_until == 0.0:
                    reschedule_now.append(a)
                elif ok:
                    reschedule_later.append((a, wait_until))

        # --- delayed reschedule followup evals
        for a, wait_until in reschedule_later:
            ev = Evaluation(
                id=generate_uuid(), namespace=a.namespace,
                priority=self.eval_priority, type=self.job.type,
                triggered_by=EvalTrigger.RETRY_FAILED_ALLOC, job_id=self.job_id,
                status=EvalStatus.PENDING, wait_until=wait_until)
            res.desired_followup_evals.setdefault(tg.name, []).append(ev)
            u = a.copy()
            u.followup_eval_id = ev.id
            res.attribute_updates[a.id] = u
            upd["ignore"] += 1

        # --- canary bookkeeping
        canaries = [a for a in untainted if a.is_canary()]
        dstate = (self.deployment.task_groups.get(tg.name)
                  if self.deployment else None)
        requires_canaries = (
            is_service and tg.update is not None and tg.update.canary > 0
            and (dstate is None or not dstate.promoted)
            and any(a.job and a.job.version != self.job.version for a in untainted))
        promoted = bool(dstate and dstate.promoted)

        if promoted:
            # after promotion, non-canary old-version allocs are replaced
            # below; canaries become regular allocs
            canaries = []

        # --- split current vs old job version
        current_version, old_version = [], []
        for a in untainted:
            if a in reschedule_now:
                continue
            same = (a.job is not None and a.job.version == self.job.version
                    and not tasks_updated(
                        _group_of(a.job, tg.name) or tg, tg))
            (current_version if same else old_version).append(a)

        # in-place-updatable old-version allocs
        inplace, destructive = [], []
        for a in old_version:
            old_tg = _group_of(a.job, tg.name) if a.job else None
            if old_tg is not None and not tasks_updated(old_tg, tg):
                inplace.append(a)
            else:
                destructive.append(a)

        inplace_copies = []
        for a in inplace:
            u = a.copy()
            u.job = self.job
            res.inplace_update.append(u)
            inplace_copies.append(u)
            upd["in_place_update"] += 1
        current_version += inplace

        # --- duplicate names: two live allocs holding the same index
        # (racing plans under node churn can both place the same name)
        # leave the group permanently wedged — live == count means no
        # surplus stop, and slots_left == 0 means a lost sibling is never
        # replaced.  Stop every holder but one; keep a current-version,
        # healthy, newest alloc by preference (the reference computeStop
        # stops duplicate-name allocs before anything else).
        by_index: Dict[int, List[Allocation]] = {}
        for a in current_version + destructive:
            idx = a.index()
            if idx >= 0:
                by_index.setdefault(idx, []).append(a)
        for dupes in by_index.values():
            if len(dupes) <= 1:
                continue
            dupes.sort(key=lambda a: (a in current_version, a.is_healthy(),
                                      a.create_index, a.id), reverse=True)
            for a in dupes[1:]:
                res.stop.append(StopRequest(a, ALLOC_DUPLICATE))
                if a in destructive:
                    destructive.remove(a)
                else:
                    current_version.remove(a)
                for u in inplace_copies:
                    if u.id == a.id:
                        inplace_copies.remove(u)
                        res.inplace_update.remove(u)
                        upd["in_place_update"] -= 1
                        break
                upd["stop"] += 1

        # --- canary placements for updates
        want_canaries = 0
        if requires_canaries and destructive and not self.deployment_paused \
                and not self.deployment_failed:
            placed_canaries = len(canaries)
            want_canaries = max(tg.update.canary - placed_canaries, 0)

        # --- figure out how many we need
        count = tg.count
        have_names: Set[int] = set()
        for a in current_version + destructive + migrate + canaries:
            idx = a.index()
            if idx >= 0:
                have_names.add(idx)

        total_have = len(current_version) + len(destructive)
        # migrations: stop + replacement placement (drain follow-ups are the
        # drainer's job, not the reconciler's)
        for a in migrate:
            res.stop.append(StopRequest(a, ALLOC_MIGRATING))
            res.place.append(PlacementRequest(
                task_group=tg.name, name=a.name, previous_alloc=a,
                min_job_version=self.job.version))
            upd["migrate"] += 1

        # replacements for lost allocs, bounded by the group count (a lost
        # alloc past a scale-down must not resurrect).  A lost CANARY is
        # excluded: it is re-placed through the canary path below
        # (want_canaries counts only surviving canaries), so a generic
        # replacement here would double-place it and burn a count slot.
        lost_countable = [a for a in lost if not a.is_canary()]
        slots_left = max(0, count - total_have - len(migrate) - len(reschedule_now))
        lost_replaced = lost_countable[:slots_left]
        for a in lost_replaced:
            res.place.append(PlacementRequest(
                task_group=tg.name, name=a.name, previous_alloc=a))
            upd["place"] += 1

        # reschedule placements
        for a in reschedule_now:
            res.place.append(PlacementRequest(
                task_group=tg.name, name=a.name, previous_alloc=a,
                is_rescheduling=True))
            if not a.terminal_status():
                res.stop.append(StopRequest(a, ALLOC_RESCHEDULED))
            upd["place"] += 1

        # lost / rescheduled replacements reuse their predecessor's name:
        # those indexes are taken, and the scale-up and canary naming
        # below must not hand them out again (a storm that loses a node
        # mid-canary otherwise names the canary after a lost alloc's
        # in-flight replacement — two live allocs, one name)
        for a in lost_replaced + reschedule_now:
            idx = a.index()
            if idx >= 0:
                have_names.add(idx)

        # scale up: new placements for missing names (replacements for
        # migrating / lost / rescheduled allocs already hold their names)
        missing = count - (total_have + len(migrate) + len(lost_replaced)
                           + len(reschedule_now))
        if missing > 0:
            free_idx = (i for i in range(count + missing + len(have_names))
                        if i not in have_names)
            for _ in range(missing):
                idx = next(free_idx)
                have_names.add(idx)
                res.place.append(PlacementRequest(
                    task_group=tg.name,
                    name=alloc_name(self.job_id, tg.name, idx)))
                upd["place"] += 1

        # scale down: stop surplus (highest indices first, reference
        # computeStop removes from the end of the name space)
        surplus = total_have + len(migrate) - count
        if surplus > 0:
            candidates = sorted(current_version + destructive,
                                key=lambda a: (a.index(), a.id), reverse=True)
            for a in candidates[:surplus]:
                res.stop.append(StopRequest(a, ALLOC_NOT_NEEDED))
                if a in destructive:
                    destructive.remove(a)
                else:
                    current_version.remove(a)
                upd["stop"] += 1

        # --- canaries: place up to want_canaries; don't touch destructive yet
        if want_canaries > 0:
            for i in range(want_canaries):
                res.place.append(PlacementRequest(
                    task_group=tg.name,
                    name=alloc_name(self.job_id, tg.name, _next_free(have_names)),
                    is_canary=True))
                upd["canary"] += 1
            # unpromoted canaries pending: no destructive updates yet
            destructive_allowed = 0
        elif requires_canaries and not promoted:
            destructive_allowed = 0
        else:
            if is_service and tg.update:
                # rolling pace: max_parallel minus in-flight not-yet-healthy
                # replacements of the current version
                in_flight = sum(
                    1 for a in current_version
                    if a.job is not None and a.job.version == self.job.version
                    and not a.terminal_status() and not a.is_healthy())
                limit = max(0, tg.update.max_parallel - in_flight)
            else:
                limit = len(destructive)
            if self.deployment_paused or self.deployment_failed:
                limit = 0
            destructive_allowed = min(limit, len(destructive))

        # --- destructive updates under max_parallel
        for a in destructive[:destructive_allowed]:
            res.destructive_stop.append(StopRequest(a, ALLOC_NOT_NEEDED))
            res.place.append(PlacementRequest(
                task_group=tg.name, name=a.name, previous_alloc=a,
                is_destructive=True, min_job_version=self.job.version))
            upd["destructive_update"] += 1
        upd["ignore"] += len(current_version) + max(
            len(destructive) - destructive_allowed, 0)

        # --- deployment bookkeeping.  hadRunning (reference
        # reconcile.go computeGroup): a deployment is also created the
        # first time a job version places allocs — not only for
        # destructive updates — so initial registrations of service jobs
        # with an update stanza are health-gated too.
        had_current = any(
            a.job is not None and a.job.version == self.job.version
            and a.job.create_index == self.job.create_index
            for a in all_allocs)
        if is_service and tg.update is not None:
            self._ensure_deployment_state(tg, destructive, want_canaries,
                                          count, had_current)
            # in-place updates join the new deployment and re-prove
            # health (reference allocUpdateFnInplace sets DeploymentID;
            # the client's health tracker re-arms on the change) —
            # without this the watcher counts them as never-healthy and
            # fails a healthy rollout at the progress deadline
            d = res.deployment or self.deployment
            if (d is not None and d.job_version == self.job.version
                    and not self.deployment_failed
                    and not self.deployment_paused
                    and tg.name in d.task_groups):
                for u in inplace_copies:
                    if u.deployment_id != d.id:
                        u.deployment_id = d.id
                        u.deployment_status = None
                # current-version allocs outside the deployment join it
                # too: a lost-alloc replacement placed from a snapshot
                # predating the deployment carries no deployment_id, and
                # the watcher would wait on its health forever (the
                # rollout wedges RUNNING until the progress deadline)
                inplace_ids = {u.id for u in inplace_copies}
                for a in current_version:
                    if a.deployment_id != d.id and not a.is_canary() \
                            and a.id not in inplace_ids \
                            and a.id not in res.attribute_updates:
                        u = a.copy()
                        u.deployment_id = d.id
                        u.deployment_status = None
                        res.attribute_updates[a.id] = u

        # group is deployment-complete when nothing is pending
        complete = not destructive and not want_canaries and missing <= 0 \
            and not migrate and not reschedule_now
        return complete

    # -------------------------------------------------------- deployments

    def _ensure_deployment_state(self, tg: TaskGroup, destructive, want_canaries,
                                 count, had_current: bool) -> None:
        if self.deployment_failed or self.deployment_paused:
            return
        needs = bool(destructive or want_canaries or not had_current)
        d = self.results.deployment or self.deployment
        if d is None:
            if not needs or count == 0:
                return
            d = Deployment(
                namespace=self.job.namespace, job_id=self.job_id,
                job_version=self.job.version,
                job_modify_index=self.job.job_modify_index,
                job_create_index=self.job.create_index,
                is_multiregion=self.job.multiregion is not None,
                status=DeploymentStatus.RUNNING,
                status_description=DeploymentStatus.DESC_RUNNING,
                eval_priority=self.eval_priority)
            self.results.deployment = d
        if d.job_version != self.job.version:
            return
        if tg.name not in d.task_groups:
            u = tg.update
            d.task_groups[tg.name] = DeploymentState(
                auto_revert=u.auto_revert, auto_promote=u.auto_promote,
                desired_canaries=u.canary if want_canaries else 0,
                desired_total=count,
                progress_deadline_s=u.progress_deadline_s,
                require_progress_by=self.now + u.progress_deadline_s)

    def _finalize_deployment(self, deployment_complete: bool) -> None:
        d = self.deployment
        if d is None or not deployment_complete:
            return
        # isDeploymentComplete (reference reconcile.go): structural
        # completeness is not enough — every group must have reached its
        # desired healthy count, else success is the watcher's call later.
        if any(s.healthy_allocs < s.desired_total
               for s in d.task_groups.values()):
            return
        if d.status == DeploymentStatus.RUNNING and not d.requires_promotion():
            self.results.deployment_updates.append({
                "deployment_id": d.id,
                "status": DeploymentStatus.SUCCESSFUL,
                "description": DeploymentStatus.DESC_SUCCESSFUL})


def _group_of(job: Optional[Job], name: str) -> Optional[TaskGroup]:
    if job is None:
        return None
    return job.lookup_task_group(name)


def _next_free(have: Set[int]) -> int:
    i = 0
    while i in have:
        i += 1
    have.add(i)
    return i
