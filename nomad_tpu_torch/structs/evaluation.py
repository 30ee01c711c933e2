"""Evaluation model (reference: nomad/structs/structs.go Evaluation:10737)."""
from __future__ import annotations

import uuid

from nomad_tpu_torch.utils import generate_uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class EvalStatus:
    BLOCKED = "blocked"
    PENDING = "pending"
    COMPLETE = "complete"
    FAILED = "failed"
    CANCELLED = "canceled"

    @staticmethod
    def terminal(status: str) -> bool:
        return status in (EvalStatus.COMPLETE, EvalStatus.FAILED, EvalStatus.CANCELLED)


class EvalTrigger:
    JOB_REGISTER = "job-register"
    JOB_DEREGISTER = "job-deregister"
    PERIODIC_JOB = "periodic-job"
    NODE_DRAIN = "node-drain"
    NODE_UPDATE = "node-update"
    ALLOC_STOP = "alloc-stop"
    SCHEDULED = "scheduled"
    ROLLING_UPDATE = "rolling-update"
    DEPLOYMENT_WATCHER = "deployment-watcher"
    FAILED_FOLLOW_UP = "failed-follow-up"
    MAX_DISCONNECT_TIMEOUT = "max-disconnect-timeout"
    RECONNECT = "reconnect"
    MAX_PLANS = "max-plan-attempts"
    RETRY_FAILED_ALLOC = "alloc-failure"
    QUEUED_ALLOCS = "queued-allocs"
    PREEMPTION = "preemption"
    JOB_SCALING = "job-scaling"


@dataclass
class Evaluation:
    id: str = field(default_factory=generate_uuid)
    namespace: str = "default"
    priority: int = 50
    type: str = "service"             # scheduler type
    triggered_by: str = EvalTrigger.JOB_REGISTER
    job_id: str = ""
    job_modify_index: int = 0
    node_id: str = ""
    node_modify_index: int = 0
    deployment_id: str = ""
    status: str = EvalStatus.PENDING
    status_description: str = ""
    wait_until: float = 0.0           # absolute time for delayed evals
    next_eval: str = ""
    previous_eval: str = ""
    blocked_eval: str = ""
    related_evals: List[str] = field(default_factory=list)
    class_eligibility: Dict[str, bool] = field(default_factory=dict)
    escaped_computed_class: bool = False
    quota_limit_reached: str = ""
    annotate_plan: bool = False
    queued_allocations: Dict[str, int] = field(default_factory=dict)  # tg -> queued count
    leader_ack: str = ""              # broker token, not persisted
    snapshot_index: int = 0
    create_index: int = 0
    modify_index: int = 0
    create_time: float = 0.0
    modify_time: float = 0.0

    def terminal(self) -> bool:
        return EvalStatus.terminal(self.status)

    def should_enqueue(self) -> bool:
        return self.status == EvalStatus.PENDING

    def should_block(self) -> bool:
        return self.status == EvalStatus.BLOCKED

    def make_plan(self, job) -> "Plan":
        from nomad_tpu_torch.structs.plan import Plan
        return Plan(
            eval_id=self.id,
            priority=self.priority if job is None else job.priority,
            job=job,
            all_at_once=False if job is None else job.all_at_once,
        )

    def copy(self) -> "Evaluation":
        import copy as _copy
        return _copy.deepcopy(self)


def new_eval(**kw) -> Evaluation:
    return Evaluation(**kw)
