"""Scheduler test harness (reference: scheduler/testing.go:45-302).

A real StateStore + a fake Planner that records submitted plans and created
evals, and self-applies plans through the real PlanApplier (the reference
harness applies via UpsertPlanResults).  `reject_plan` forces the
state-refresh / partial-commit path like the reference's RejectPlan hook.
`device` (default "cuda") is where every scheduler it builds runs its
kernels, and the plan applier releases engine tickets on that device's
engine; tests pass device="cpu" to run the plain PyTorch versions.
"""
from __future__ import annotations

import itertools
from typing import List, Optional

from nomad_tpu_torch.core.plan_apply import PlanApplier
from nomad_tpu_torch.device import resolve_device
from nomad_tpu_torch.scheduler import factory
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import Evaluation
from nomad_tpu_torch.structs.plan import Plan, PlanResult

factory._register_builtins()


class Harness:
    def __init__(self, store: Optional[StateStore] = None, device=None):
        self.device = resolve_device(device)
        self.store = store or StateStore()
        self.applier = PlanApplier(self.store, device=self.device)
        self.applier.on_preempted = self._preemption_evals
        self.plans: List[Plan] = []
        self.results: List[PlanResult] = []
        self.create_evals_list: List[Evaluation] = []
        self.reblock_evals: List[Evaluation] = []
        self.eval_updates: List[Evaluation] = []
        self.reject_plan = False
        self._index = itertools.count(1000)

    # ------------------------------------------------------------- planner

    def submit_plan(self, plan: Plan) -> PlanResult:
        self.plans.append(plan)
        if self.reject_plan:
            result = PlanResult()
            result.refresh_index = self.store.latest_index
            self.results.append(result)
            return result
        result = self.applier.apply(plan)
        self.results.append(result)
        return result

    def create_evals(self, evals: List[Evaluation]) -> None:
        self.create_evals_list.extend(evals)
        self.store.upsert_evals(self.next_index(), [e.copy() for e in evals])

    def update_eval(self, ev: Evaluation) -> None:
        self.eval_updates.append(ev)

    def reblock_eval(self, ev: Evaluation) -> None:
        self.reblock_evals.append(ev)

    def refresh_snapshot(self, min_index: int = 0):
        return self.store.snapshot()

    # ------------------------------------------------------------- helpers

    def _preemption_evals(self, preempted) -> None:
        seen = set()
        for a in preempted:
            key = (a.namespace, a.job_id)
            if key in seen:
                continue
            seen.add(key)
            from nomad_tpu_torch.structs import Evaluation
            self.create_evals([Evaluation(
                namespace=a.namespace, job_id=a.job_id,
                type=a.job.type if a.job else "service",
                triggered_by="preemption", status="pending")])

    def next_index(self) -> int:
        return next(self._index)

    def process(self, scheduler_type: str, ev: Evaluation) -> None:
        snap = self.store.snapshot()
        sched = factory.new_scheduler(scheduler_type, snap, self,
                                      device=self.device)
        sched.process(ev)
        self.last_scheduler = sched
