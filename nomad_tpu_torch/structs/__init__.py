"""Shared data model (reference: nomad/structs/).

Plain Python dataclasses for the control-plane objects; the dense device
encoding lives in `nomad_tpu_torch.encode`.
"""

from nomad_tpu_torch.structs.resources import (
    ComparableResources,
    DeviceRequest,
    NetworkPort,
    NetworkResource,
    NodeDevice,
    Resources,
    allocs_fit_host,
    score_fit_binpack_host,
    score_fit_spread_host,
)
from nomad_tpu_torch.structs.job import (
    Affinity,
    Constraint,
    DispatchPayloadConfig,
    EphemeralDisk,
    Job,
    JobStatus,
    JobType,
    MigrateStrategy,
    Multiregion,
    MultiregionRegion,
    MultiregionStrategy,
    PeriodicConfig,
    ReschedulePolicy,
    RestartPolicy,
    Spread,
    SpreadTarget,
    Task,
    TaskGroup,
    UpdateStrategy,
)
from nomad_tpu_torch.structs.node import (
    DrainStrategy,
    Node,
    NodeReservedResources,
    NodeResources,
    NodeSchedulingEligibility,
    NodeStatus,
    compute_node_class,
)
from nomad_tpu_torch.structs.alloc import (
    AllocClientStatus,
    AllocDesiredStatus,
    Allocation,
    AllocMetric,
    DesiredTransition,
    RescheduleEvent,
    RescheduleTracker,
    TaskState,
)
from nomad_tpu_torch.structs.evaluation import (
    EvalStatus,
    EvalTrigger,
    Evaluation,
)
from nomad_tpu_torch.structs.plan import (
    Plan,
    PlanAnnotations,
    PlanResult,
    DesiredUpdates,
)
from nomad_tpu_torch.structs.deployment import (
    Deployment,
    DeploymentState,
    DeploymentStatus,
)
from nomad_tpu_torch.structs.config import SchedulerConfiguration
from nomad_tpu_torch.structs.namespace import (
    Namespace,
    QuotaSpec,
    alloc_quota_usage,
)

__all__ = [k for k in dir() if not k.startswith("_")]
