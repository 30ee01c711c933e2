"""Deployment model (reference: nomad/structs/structs.go Deployment/
DeploymentState, used by scheduler/reconcile.go and deploymentwatcher/).
"""
from __future__ import annotations

import uuid

from nomad_tpu_torch.utils import generate_uuid
from dataclasses import dataclass, field
from typing import Dict, Optional


class DeploymentStatus:
    RUNNING = "running"
    PAUSED = "paused"
    FAILED = "failed"
    SUCCESSFUL = "successful"
    CANCELLED = "cancelled"
    PENDING = "pending"
    BLOCKED = "blocked"
    UNBLOCKING = "unblocking"

    TERMINAL = (FAILED, SUCCESSFUL, CANCELLED)

    # status descriptions (subset used by reconciler/watcher)
    DESC_RUNNING = "Deployment is running"
    DESC_RUNNING_NEEDS_PROMOTION = "Deployment is running but requires manual promotion"
    DESC_RUNNING_AUTO_PROMOTION = "Deployment is running pending automatic promotion"
    DESC_FAILED_ALLOCATIONS = "Failed due to unhealthy allocations"
    DESC_PROGRESS_DEADLINE = "Failed due to progress deadline"
    DESC_NEWER_JOB = "Cancelled due to newer version of job"
    DESC_SUCCESSFUL = "Deployment completed successfully"
    DESC_MULTIREGION_FAIL = \
        "Failed due to a failed deployment in a peer region"


@dataclass
class DeploymentState:
    """Per-task-group rollout state."""
    auto_revert: bool = False
    auto_promote: bool = False
    promoted: bool = False
    placed_canaries: list = field(default_factory=list)   # alloc ids
    desired_canaries: int = 0
    desired_total: int = 0
    placed_allocs: int = 0
    healthy_allocs: int = 0
    unhealthy_allocs: int = 0
    progress_deadline_s: float = 0.0
    require_progress_by: float = 0.0


@dataclass
class Deployment:
    id: str = field(default_factory=generate_uuid)
    namespace: str = "default"
    job_id: str = ""
    job_version: int = 0
    job_modify_index: int = 0
    job_spec_modify_index: int = 0
    job_create_index: int = 0
    is_multiregion: bool = False
    # set once this region's SUCCESSFUL multiregion deployment has
    # started the NEXT region's rollout (replicated, so a new leader
    # doesn't double-kick)
    multiregion_kicked: bool = False
    task_groups: Dict[str, DeploymentState] = field(default_factory=dict)
    status: str = DeploymentStatus.RUNNING
    status_description: str = DeploymentStatus.DESC_RUNNING
    eval_priority: int = 50
    create_index: int = 0
    modify_index: int = 0
    create_time: float = 0.0
    modify_time: float = 0.0

    def active(self) -> bool:
        return self.status in (DeploymentStatus.RUNNING, DeploymentStatus.PAUSED,
                               DeploymentStatus.PENDING, DeploymentStatus.BLOCKED,
                               DeploymentStatus.UNBLOCKING)

    def requires_promotion(self) -> bool:
        return any(s.desired_canaries > 0 and not s.promoted
                   for s in self.task_groups.values())

    def has_auto_promote(self) -> bool:
        return (bool(self.task_groups)
                and all(s.auto_promote for s in self.task_groups.values()
                        if s.desired_canaries > 0)
                and any(s.desired_canaries > 0 for s in self.task_groups.values()))

    def has_placed_canaries(self) -> bool:
        return any(s.placed_canaries for s in self.task_groups.values())

    def copy(self) -> "Deployment":
        import copy as _copy
        return _copy.deepcopy(self)
