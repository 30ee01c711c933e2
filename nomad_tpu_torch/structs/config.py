"""Cluster-wide scheduler configuration (reference: nomad/structs/operator.go:144-169
SchedulerConfiguration), settable live via the operator API and read at
stack-build time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


SCHEDULER_ALGORITHM_BINPACK = "binpack"
SCHEDULER_ALGORITHM_SPREAD = "spread"


@dataclass
class PreemptionConfig:
    system_scheduler_enabled: bool = True
    sysbatch_scheduler_enabled: bool = False
    batch_scheduler_enabled: bool = False
    service_scheduler_enabled: bool = False


@dataclass
class SchedulerConfiguration:
    scheduler_algorithm: str = SCHEDULER_ALGORITHM_BINPACK
    preemption_config: PreemptionConfig = field(default_factory=PreemptionConfig)
    memory_oversubscription_enabled: bool = False
    reject_job_registration: bool = False
    pause_eval_broker: bool = False
    # weighted fair-share dequeue in the eval broker: per-namespace
    # stride scheduling over `namespace_weights` (unlisted namespaces
    # get `default_namespace_weight`).  With a single namespace (or
    # uniform weights) the dequeue order is indistinguishable from the
    # global (-priority, seq) order, so enabled-by-default is safe.
    fair_dequeue_enabled: bool = True
    default_namespace_weight: int = 1
    namespace_weights: Dict[str, int] = field(default_factory=dict)
    create_index: int = 0
    modify_index: int = 0

    def effective_scheduler_algorithm(self) -> str:
        return self.scheduler_algorithm or SCHEDULER_ALGORITHM_BINPACK

    def preemption_enabled(self, scheduler_type: str) -> bool:
        p = self.preemption_config
        return {
            "system": p.system_scheduler_enabled,
            "sysbatch": p.sysbatch_scheduler_enabled,
            "batch": p.batch_scheduler_enabled,
            "service": p.service_scheduler_enabled,
        }.get(scheduler_type, False)
