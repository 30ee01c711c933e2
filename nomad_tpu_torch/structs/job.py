"""Job specification model (reference: nomad/structs/structs.go Job:4065,
TaskGroup:6116, Task:6898, Constraint/Affinity/Spread).
"""
from __future__ import annotations


from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

from nomad_tpu_torch.structs.resources import NetworkResource, Resources


class JobType:
    SERVICE = "service"
    BATCH = "batch"
    SYSTEM = "system"
    SYSBATCH = "sysbatch"
    CORE = "_core"          # internal GC job (reference nomad/core_sched.go)


class JobStatus:
    PENDING = "pending"
    RUNNING = "running"
    DEAD = "dead"


# Constraint operands (reference structs.Constraint, feasible.go:806-841)
class Operand:
    EQ = "="
    NEQ = "!="
    LT = "<"
    LTE = "<="
    GT = ">"
    GTE = ">="
    REGEX = "regexp"
    VERSION = "version"
    SEMVER = "semver"
    SET_CONTAINS = "set_contains"
    SET_CONTAINS_ALL = "set_contains_all"
    SET_CONTAINS_ANY = "set_contains_any"
    ATTRIBUTE_IS_SET = "is_set"
    ATTRIBUTE_IS_NOT_SET = "is_not_set"
    DISTINCT_HOSTS = "distinct_hosts"
    DISTINCT_PROPERTY = "distinct_property"


@dataclass(frozen=True)
class Constraint:
    ltarget: str = ""        # usually "${attr.x}" / "${node.class}" / "${meta.y}"
    rtarget: str = ""
    operand: str = Operand.EQ

    def __str__(self) -> str:
        return f"{self.ltarget} {self.operand} {self.rtarget}"


@dataclass(frozen=True)
class Affinity:
    ltarget: str = ""
    rtarget: str = ""
    operand: str = Operand.EQ
    weight: int = 50         # in [-100, 100]


@dataclass(frozen=True)
class SpreadTarget:
    value: str = ""
    percent: int = 0


@dataclass(frozen=True)
class Spread:
    attribute: str = ""       # interpolation target, e.g. "${node.datacenter}"
    weight: int = 50          # in (0, 100]
    targets: tuple = ()       # Tuple[SpreadTarget, ...]


@dataclass
class RestartPolicy:
    attempts: int = 2
    interval_s: float = 1800.0
    delay_s: float = 15.0
    mode: str = "fail"        # "fail" | "delay"


@dataclass
class ReschedulePolicy:
    """Reference structs.ReschedulePolicy (defaults per job type)."""
    attempts: int = 0
    interval_s: float = 0.0
    delay_s: float = 30.0
    delay_function: str = "exponential"   # "constant" | "exponential" | "fibonacci"
    max_delay_s: float = 3600.0
    unlimited: bool = True

    @staticmethod
    def default_service() -> "ReschedulePolicy":
        return ReschedulePolicy(delay_s=30.0, delay_function="exponential",
                                max_delay_s=3600.0, unlimited=True)

    @staticmethod
    def default_batch() -> "ReschedulePolicy":
        return ReschedulePolicy(attempts=1, interval_s=86400.0, delay_s=5.0,
                                delay_function="constant", unlimited=False)


@dataclass
class MigrateStrategy:
    max_parallel: int = 1
    health_check: str = "checks"
    min_healthy_time_s: float = 10.0
    healthy_deadline_s: float = 300.0


@dataclass
class UpdateStrategy:
    """Rolling-update / canary configuration (reference structs.UpdateStrategy)."""
    stagger_s: float = 30.0
    max_parallel: int = 1
    health_check: str = "checks"
    min_healthy_time_s: float = 10.0
    healthy_deadline_s: float = 300.0
    progress_deadline_s: float = 600.0
    auto_revert: bool = False
    auto_promote: bool = False
    canary: int = 0

    def rolling(self) -> bool:
        return self.max_parallel > 0


@dataclass
class MultiregionStrategy:
    """Rollout pacing across regions (reference structs.MultiregionStrategy).
    `on_failure="fail_all"` reverts already-promoted regions when any
    region's deployment fails; `"fail_local"` contains the failure."""
    max_parallel: int = 1
    on_failure: str = "fail_all"   # "fail_all" | "fail_local"


@dataclass
class MultiregionRegion:
    """One region's slice of a multiregion job: optional count override
    applied to every task group, optional datacenter override."""
    name: str = ""
    count: Optional[int] = None
    datacenters: List[str] = field(default_factory=list)
    meta: Dict[str, str] = field(default_factory=dict)

    def copy(self) -> "MultiregionRegion":
        return replace(self, datacenters=list(self.datacenters),
                       meta=dict(self.meta))


@dataclass
class Multiregion:
    """The `multiregion` jobspec block (reference structs.Multiregion):
    the ordered region list drives a sequential rollout — region N+1's
    deployment starts only once region N's is healthy."""
    strategy: MultiregionStrategy = field(default_factory=MultiregionStrategy)
    regions: List[MultiregionRegion] = field(default_factory=list)

    def region_names(self) -> List[str]:
        return [r.name for r in self.regions]

    def lookup(self, name: str) -> Optional[MultiregionRegion]:
        for r in self.regions:
            if r.name == name:
                return r
        return None

    def copy(self) -> "Multiregion":
        return replace(self, strategy=replace(self.strategy),
                       regions=[r.copy() for r in self.regions])


@dataclass
class EphemeralDisk:
    sticky: bool = False
    size_mb: int = 300
    migrate: bool = False


@dataclass
class PeriodicConfig:
    enabled: bool = True
    spec: str = ""            # cron spec
    spec_type: str = "cron"
    prohibit_overlap: bool = False
    timezone: str = "UTC"


@dataclass
class DispatchPayloadConfig:
    file: str = ""


@dataclass
class ParameterizedJobConfig:
    payload: str = "optional"      # "optional" | "required" | "forbidden"
    meta_required: List[str] = field(default_factory=list)
    meta_optional: List[str] = field(default_factory=list)


@dataclass
class Lifecycle:
    hook: str = ""                 # "prestart" | "poststart" | "poststop"
    sidecar: bool = False


@dataclass
class Service:
    name: str = ""
    provider: str = "consul"       # "consul" | "nomad"
    port_label: str = ""
    tags: List[str] = field(default_factory=list)
    checks: List[dict] = field(default_factory=list)


@dataclass
class ScalingPolicy:
    """Task-group scaling bounds + external-autoscaler policy document
    (reference nomad/structs/structs.go ScalingPolicy / TaskGroup.Scaling:
    the server enforces min/max on Job.Scale; the policy body is opaque
    to the scheduler and consumed by the autoscaler)."""
    min: int = 0
    max: int = 0
    enabled: bool = True
    policy: Dict[str, object] = field(default_factory=dict)


@dataclass
class ScalingEvent:
    """One scale action recorded against a (job, group) — the audit log
    behind `nomad job scale-status` (structs.go ScalingEvent)."""
    time: float = 0.0
    previous_count: int = 0
    count: Optional[int] = None
    message: str = ""
    error: bool = False
    eval_id: str = ""
    meta: Dict[str, object] = field(default_factory=dict)


@dataclass
class Task:
    name: str = "task"
    driver: str = "mock"
    config: Dict[str, object] = field(default_factory=dict)
    env: Dict[str, str] = field(default_factory=dict)
    resources: Resources = field(default_factory=Resources)
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    lifecycle: Optional[Lifecycle] = None
    kill_timeout_s: float = 5.0
    leader: bool = False
    services: List[Service] = field(default_factory=list)
    meta: Dict[str, str] = field(default_factory=dict)
    dispatch_payload: Optional[DispatchPayloadConfig] = None
    artifacts: List[dict] = field(default_factory=list)
    templates: List[dict] = field(default_factory=list)
    vault: Optional[dict] = None

    def copy(self) -> "Task":
        return replace(self, config=dict(self.config), env=dict(self.env),
                       resources=self.resources.copy(),
                       constraints=list(self.constraints),
                       affinities=list(self.affinities),
                       services=list(self.services), meta=dict(self.meta))


@dataclass
class VolumeRequest:
    name: str = ""
    type: str = "host"            # "host" | "csi"
    source: str = ""
    read_only: bool = False
    access_mode: str = ""
    attachment_mode: str = ""
    per_alloc: bool = False


@dataclass
class TaskGroup:
    name: str = "group"
    count: int = 1
    tasks: List[Task] = field(default_factory=list)
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    spreads: List[Spread] = field(default_factory=list)
    restart_policy: RestartPolicy = field(default_factory=RestartPolicy)
    reschedule_policy: Optional[ReschedulePolicy] = None
    migrate: MigrateStrategy = field(default_factory=MigrateStrategy)
    update: Optional[UpdateStrategy] = None
    ephemeral_disk: EphemeralDisk = field(default_factory=EphemeralDisk)
    networks: List[NetworkResource] = field(default_factory=list)
    services: List[Service] = field(default_factory=list)
    volumes: Dict[str, VolumeRequest] = field(default_factory=dict)
    max_client_disconnect_s: Optional[float] = None
    stop_after_client_disconnect_s: Optional[float] = None
    meta: Dict[str, str] = field(default_factory=dict)
    scaling: Optional[ScalingPolicy] = None

    def copy(self) -> "TaskGroup":
        return replace(self, tasks=[t.copy() for t in self.tasks],
                       constraints=list(self.constraints),
                       affinities=list(self.affinities),
                       spreads=list(self.spreads),
                       networks=[n.copy() for n in self.networks],
                       services=list(self.services), volumes=dict(self.volumes),
                       meta=dict(self.meta))


@dataclass
class Job:
    id: str = ""
    namespace: str = "default"
    region: str = "global"
    name: str = ""
    type: str = JobType.SERVICE
    priority: int = 50
    all_at_once: bool = False
    datacenters: List[str] = field(default_factory=lambda: ["dc1"])
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    spreads: List[Spread] = field(default_factory=list)
    task_groups: List[TaskGroup] = field(default_factory=list)
    update: Optional[UpdateStrategy] = None
    multiregion: Optional[Multiregion] = None
    periodic: Optional[PeriodicConfig] = None
    parameterized: Optional[ParameterizedJobConfig] = None
    payload: bytes = b""
    meta: Dict[str, str] = field(default_factory=dict)
    status: str = JobStatus.PENDING
    stop: bool = False
    version: int = 0
    stable: bool = False
    parent_id: str = ""
    create_index: int = 0
    modify_index: int = 0
    job_modify_index: int = 0
    submit_time: float = 0.0

    @property
    def namespaced_id(self) -> str:
        return f"{self.namespace}/{self.id}"

    def lookup_task_group(self, name: str) -> Optional[TaskGroup]:
        for tg in self.task_groups:
            if tg.name == name:
                return tg
        return None

    def is_periodic(self) -> bool:
        return self.periodic is not None

    def is_parameterized(self) -> bool:
        return self.parameterized is not None

    def stopped(self) -> bool:
        return self.stop

    def canonicalize(self) -> None:
        """Merge job-level blocks into task groups and fill defaults
        (reference api/jobs.go Canonicalize + structs Job.Canonicalize:
        the job update block is copied into groups lacking one, reschedule
        policies default per job type)."""
        for tg in self.task_groups:
            if tg.update is None and self.update is not None \
                    and self.type == JobType.SERVICE:
                tg.update = replace(self.update)
            if tg.reschedule_policy is None:
                if self.type == JobType.SERVICE:
                    tg.reschedule_policy = ReschedulePolicy.default_service()
                elif self.type == JobType.BATCH:
                    tg.reschedule_policy = ReschedulePolicy.default_batch()

    def copy(self) -> "Job":
        return replace(self, datacenters=list(self.datacenters),
                       constraints=list(self.constraints),
                       affinities=list(self.affinities),
                       spreads=list(self.spreads),
                       task_groups=[tg.copy() for tg in self.task_groups],
                       multiregion=(self.multiregion.copy()
                                    if self.multiregion else None),
                       meta=dict(self.meta))

    def multiregion_copy(self, region: str, rollout_id: str) -> "Job":
        """The per-region slice of a multiregion job: region set, count
        and datacenter overrides applied, the multiregion block retained
        (the deployment watcher reads it to kick the NEXT region), and
        the rollout id stamped in meta so re-registration is detectable
        and the copy is never re-expanded."""
        c = self.copy()
        c.region = region
        c.meta["multiregion.rollout"] = rollout_id
        mr = c.multiregion.lookup(region) if c.multiregion else None
        if mr is not None:
            if mr.count is not None:
                for tg in c.task_groups:
                    tg.count = mr.count
            if mr.datacenters:
                c.datacenters = list(mr.datacenters)
            if mr.meta:
                c.meta.update(mr.meta)
        return c
