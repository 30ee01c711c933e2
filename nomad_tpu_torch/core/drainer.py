"""Node drainer (reference: nomad/drainer/ — drainer.go:130 NodeDrainer,
run:225, handleDeadlinedNodes:243, watch_jobs.go migration batching).

Migrates allocations off draining nodes honoring each task group's
migrate.max_parallel, force-stops at the drain deadline, and marks the
node's drain complete when no migratable allocs remain.
"""
from __future__ import annotations

import logging
import threading
import time as _time
from typing import Dict, List, Optional

from nomad_tpu_torch.raft import MessageType
from nomad_tpu_torch.structs import Allocation, Evaluation, EvalStatus, JobType
from nomad_tpu_torch.structs.alloc import DesiredTransition
from nomad_tpu_torch.structs.evaluation import EvalTrigger
from nomad_tpu_torch.structs.node import DrainStrategy

log = logging.getLogger(__name__)


class NodeDrainer:
    def __init__(self, server, interval: float = 0.1):
        self.server = server
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dirty = threading.Event()
        server.store.watch(self._on_change)

    def start(self) -> None:
        self._stop = threading.Event()   # fresh per leadership tenure
        self._thread = threading.Thread(target=self._run, name="drainer",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._dirty.set()
        if self._thread:
            self._thread.join(60.0)

    def _on_change(self, table: str, obj) -> None:
        if table in ("nodes", "allocs"):
            self._dirty.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._dirty.wait(timeout=self.interval)
            self._dirty.clear()
            if self._stop.is_set():
                return
            try:
                self.tick()
            except Exception:               # noqa: BLE001
                log.exception("drainer")

    # ------------------------------------------------------------- API

    def drain_node(self, node_id: str, deadline_s: float = 3600.0,
                   ignore_system_jobs: bool = False) -> None:
        """Node.UpdateDrain RPC: set the drain strategy."""
        server = self.server
        strategy = DrainStrategy(
            deadline_s=deadline_s,
            ignore_system_jobs=ignore_system_jobs,
            force_deadline=_time.time() + deadline_s if deadline_s > 0 else 0.0,
            started_at=_time.time())
        server.apply(MessageType.NODE_UPDATE_DRAIN,
                     {"node_id": node_id, "drain_strategy": strategy})
        self._dirty.set()

    def cancel_drain(self, node_id: str) -> None:
        """Node.UpdateDrain with a nil spec: stop draining and restore
        eligibility (reference Node.UpdateDrain cancel form)."""
        self.server.apply(MessageType.NODE_UPDATE_DRAIN,
                          {"node_id": node_id, "drain_strategy": None,
                           "mark_eligible": True})

    # ------------------------------------------------------------- logic

    def tick(self, now: Optional[float] = None) -> None:
        now = now if now is not None else _time.time()
        server = self.server
        for node in server.store.nodes():
            if node.drain_strategy is None:
                continue
            self._process_node(node, now)

    def _drain_eval(self, a: Allocation, node_id: str) -> Evaluation:
        ev = Evaluation(
            namespace=a.namespace, priority=a.job.priority,
            type=a.job.type, job_id=a.job_id,
            triggered_by=EvalTrigger.NODE_DRAIN, node_id=node_id,
            status=EvalStatus.PENDING)
        # propose-time stamp (the FSM cone must stay deterministic)
        ev.create_time = ev.modify_time = _time.time()
        return ev

    def _process_node(self, node, now: float) -> None:
        server = self.server
        strategy = node.drain_strategy
        allocs = [a for a in server.store.allocs_by_node(node.id)
                  if not a.terminal_status()]
        migratable: List[Allocation] = []
        for a in allocs:
            if a.job is None:
                continue
            if a.job.type in (JobType.SYSTEM, JobType.SYSBATCH):
                if strategy.ignore_system_jobs:
                    continue
                migratable.append(a)   # stopped at deadline/completion
                continue
            migratable.append(a)

        if not migratable:
            # drain complete: clear strategy, node stays ineligible
            server.apply(MessageType.NODE_UPDATE_DRAIN,
                         {"node_id": node.id, "drain_strategy": None})
            return

        if node.status in ("down", "disconnected"):
            # hard-killed (or partitioned away) mid-drain: the node-update
            # eval path owns these allocs now — the reconciler marks them
            # lost and places replacements exactly once.  Migrate-marking
            # or force-stopping here would race that and double-handle.
            return

        deadlined = strategy.force_deadline and now >= strategy.force_deadline

        if deadlined:
            # handleDeadlinedNodes (drainer.go:243): force-stop remaining
            # allocs ONCE — the stop makes them server-terminal, so they
            # drop out of `migratable` and this branch does not re-fire.
            # Stops and their follow-up evals ride ONE raft entry: a
            # partition between two entries could commit the stops but
            # lose the evals, stranding the job under count with nothing
            # left to trigger replacement.
            updates = []
            evals: Dict[str, Evaluation] = {}
            for a in migratable:
                u = a.copy()
                u.desired_status = "stop"
                u.desired_description = "alloc stopped because drain deadline reached"
                updates.append(u)
                key = (a.namespace, a.job_id)
                if key not in evals and a.job is not None:
                    evals[key] = self._drain_eval(a, node.id)
            if updates:
                server.apply(MessageType.ALLOC_UPDATE_DESIRED_TRANSITION,
                             {"allocs": updates,
                              "evals": list(evals.values())})
            return

        # group migrate marks per job so each job's transitions and its
        # NODE_DRAIN eval commit in one raft entry (same strand hazard as
        # the deadline branch: a mark without its eval never reschedules)
        by_job: Dict[str, List[Allocation]] = {}
        eval_for: Dict[str, Evaluation] = {}
        marked: Dict[tuple, int] = {}
        for a in migratable:
            if a.desired_transition.should_migrate():
                continue   # already in flight
            tg = a.job.lookup_task_group(a.task_group)
            max_parallel = tg.migrate.max_parallel if tg is not None else 1
            # respect per-group migrate.max_parallel: count of this
            # group's allocs already migrating across the cluster, plus
            # the marks batched this tick but not yet applied
            group_key = (a.namespace, a.job_id, a.task_group)
            in_flight = marked.get(group_key, 0) + sum(
                1 for other in server.store.allocs_by_job(a.namespace, a.job_id)
                if other.task_group == a.task_group
                and not other.terminal_status()
                and other.desired_transition.should_migrate())
            if in_flight >= max_parallel:
                continue
            marked[group_key] = marked.get(group_key, 0) + 1
            u = a.copy()
            u.desired_transition = DesiredTransition(migrate=True)
            key = (a.namespace, a.job_id)
            by_job.setdefault(key, []).append(u)
            if key not in eval_for and a.job is not None:
                eval_for[key] = self._drain_eval(a, node.id)
        for key, updates in by_job.items():
            ev = eval_for.get(key)
            server.apply(MessageType.ALLOC_UPDATE_DESIRED_TRANSITION,
                         {"allocs": updates,
                          "evals": [ev] if ev is not None else []})
