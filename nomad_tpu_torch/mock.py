"""Canonical test fixtures (reference: nomad/mock/mock.go — mock.Node:15,
mock.Job:233, mock.Alloc:1540, mock.Eval:1479 and variants).
"""
from __future__ import annotations

import itertools
import uuid

from nomad_tpu_torch.utils import generate_uuid

from nomad_tpu_torch.structs import (
    Allocation,
    AllocClientStatus,
    AllocDesiredStatus,
    Evaluation,
    Job,
    JobStatus,
    JobType,
    Node,
    NodeStatus,
    ReschedulePolicy,
    Task,
    TaskGroup,
    UpdateStrategy,
)
from nomad_tpu_torch.structs.alloc import AllocatedResources, AllocatedTaskResources, alloc_name
from nomad_tpu_torch.structs.job import Constraint, Operand
from nomad_tpu_torch.structs.resources import NetworkResource
from nomad_tpu_torch.structs.node import NodeCpuResources, NodeResources, compute_node_class
from nomad_tpu_torch.structs.resources import Resources

_seq = itertools.count(1)


def _uuid() -> str:
    return generate_uuid()


def node(**overrides) -> Node:
    i = next(_seq)
    n = Node(
        id=_uuid(),
        name=f"node-{i}",
        datacenter="dc1",
        node_class="",
        attributes={
            "kernel.name": "linux",
            "arch": "x86",
            "nomad.version": "0.5.0",
            "driver.exec": "1",
            "driver.mock_driver": "1",
            "unique.hostname": f"node-{i}",
        },
        node_resources=NodeResources(
            cpu=NodeCpuResources(cpu_shares=4000, total_core_count=4,
                                 reservable_cores=[0, 1, 2, 3]),
            memory_mb=8192,
            disk_mb=100 * 1024,
            # reference mock.Node: one eth0 device with 1000 MBits
            networks=[NetworkResource(device="eth0", cidr="192.168.0.100/32",
                                      mbits=1000)],
        ),
        drivers={"exec": {"detected": True, "healthy": True},
                 "mock_driver": {"detected": True, "healthy": True}},
        status=NodeStatus.READY,
    )
    for k, v in overrides.items():
        setattr(n, k, v)
    n.computed_class = compute_node_class(n)
    return n


def job(**overrides) -> Job:
    j = Job(
        id=f"mock-service-{_uuid()}",
        name="my-job",
        type=JobType.SERVICE,
        priority=50,
        all_at_once=False,
        datacenters=["dc1"],
        constraints=[Constraint("${attr.kernel.name}", "linux", Operand.EQ)],
        task_groups=[TaskGroup(
            name="web",
            count=10,
            tasks=[Task(
                name="web",
                driver="exec",
                config={"command": "/bin/date"},
                resources=Resources(cpu=500, memory_mb=256),
            )],
            reschedule_policy=ReschedulePolicy.default_service(),
        )],
        update=UpdateStrategy(max_parallel=1, health_check="checks"),
        status=JobStatus.PENDING,
        version=0,
        create_index=42,
        modify_index=99,
        job_modify_index=99,
    )
    for k, v in overrides.items():
        setattr(j, k, v)
    return j


def batch_job(**overrides) -> Job:
    j = job(**overrides)
    j.type = JobType.BATCH
    if "id" not in overrides:
        j.id = f"mock-batch-{_uuid()}"
    for tg in j.task_groups:
        if tg.reschedule_policy is not None:
            tg.reschedule_policy = ReschedulePolicy.default_batch()
    return j


def csi_node(plugin_id: str = "ebs-plugin", healthy: bool = True,
             max_volumes: int = 3, controller: bool = False, **overrides):
    """Node fingerprinting a CSI node plugin (reference mock.Node +
    CSINodePlugins fixtures in csi_endpoint_test.go)."""
    n = node(**overrides)
    n.csi_node_plugins = {plugin_id: {
        "healthy": healthy, "max_volumes": max_volumes,
        "provider": "com.test.csi"}}
    if controller:
        n.csi_controller_plugins = {plugin_id: {"healthy": healthy}}
    return n


def csi_volume(vol_id: str = "", plugin_id: str = "ebs-plugin",
               access_mode: str = "", **overrides):
    from nomad_tpu_torch.structs.csi import CSIVolume
    v = CSIVolume(id=vol_id or f"vol-{_uuid()[:8]}", namespace="default",
                  name="test-volume", plugin_id=plugin_id,
                  access_mode=access_mode)
    for k, val in overrides.items():
        setattr(v, k, val)
    return v


def system_job(**overrides) -> Job:
    j = job(**overrides)
    j.type = JobType.SYSTEM
    j.priority = 100
    if "id" not in overrides:
        j.id = f"mock-system-{_uuid()}"
    j.task_groups[0].count = 1
    return j


def sysbatch_job(**overrides) -> Job:
    j = system_job(**overrides)
    j.type = JobType.SYSBATCH
    j.priority = 50
    if "id" not in overrides:
        j.id = f"mock-sysbatch-{_uuid()}"
    return j


def eval(**overrides) -> Evaluation:
    e = Evaluation(
        id=_uuid(),
        namespace="default",
        priority=50,
        type=JobType.SERVICE,
        job_id=_uuid(),
        status="pending",
    )
    for k, v in overrides.items():
        setattr(e, k, v)
    return e


def alloc_for(j: Job, node_id: str, index: int = 0, **overrides) -> Allocation:
    tg = j.task_groups[0]
    tasks = {}
    for t in tg.tasks:
        tasks[t.name] = AllocatedTaskResources(
            cpu_shares=t.resources.cpu,
            memory_mb=t.resources.memory_mb,
        )
    a = Allocation(
        id=_uuid(),
        eval_id=_uuid(),
        node_id=node_id,
        name=alloc_name(j.id, tg.name, index),
        job_id=j.id,
        job=j,
        task_group=tg.name,
        allocated_resources=AllocatedResources(
            tasks=tasks, shared_disk_mb=tg.ephemeral_disk.size_mb),
        desired_status=AllocDesiredStatus.RUN,
        client_status=AllocClientStatus.PENDING,
    )
    for k, v in overrides.items():
        setattr(a, k, v)
    return a


def alloc(**overrides) -> Allocation:
    j = job()
    a = alloc_for(j, node_id=_uuid())
    for k, v in overrides.items():
        setattr(a, k, v)
    return a
