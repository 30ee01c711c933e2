"""Node model (reference: nomad/structs/structs.go Node:1851,
node_class.go:27-37 ComputeClass).
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from nomad_tpu_torch.structs.resources import (
    ComparableResources,
    NetworkResource,
    NodeDevice,
)
from nomad_tpu_torch.utils import generate_uuid


class NodeStatus:
    INIT = "initializing"
    READY = "ready"
    DOWN = "down"
    DISCONNECTED = "disconnected"


class NodeSchedulingEligibility:
    ELIGIBLE = "eligible"
    INELIGIBLE = "ineligible"


@dataclass
class DrainStrategy:
    deadline_s: float = 3600.0
    ignore_system_jobs: bool = False
    force_deadline: float = 0.0        # absolute time when drain forces
    started_at: float = 0.0


@dataclass
class NodeCpuResources:
    cpu_shares: int = 4000             # total MHz
    total_core_count: int = 4
    reservable_cores: List[int] = field(default_factory=list)

    def shares_per_core(self) -> int:
        if self.total_core_count == 0:
            return 0
        return self.cpu_shares // self.total_core_count


@dataclass
class NodeResources:
    cpu: NodeCpuResources = field(default_factory=NodeCpuResources)
    memory_mb: int = 8192
    disk_mb: int = 100 * 1024
    networks: List[NetworkResource] = field(default_factory=list)
    devices: List[NodeDevice] = field(default_factory=list)
    # min/max port of the dynamic port range on this node
    min_dynamic_port: int = 20000
    max_dynamic_port: int = 32000


@dataclass
class NodeReservedResources:
    cpu_shares: int = 0
    memory_mb: int = 0
    disk_mb: int = 0
    reserved_ports: List[int] = field(default_factory=list)
    cores: List[int] = field(default_factory=list)


@dataclass
class Node:
    id: str = ""
    name: str = ""
    datacenter: str = "dc1"
    node_class: str = ""
    attributes: Dict[str, str] = field(default_factory=dict)
    meta: Dict[str, str] = field(default_factory=dict)
    node_resources: NodeResources = field(default_factory=NodeResources)
    reserved_resources: NodeReservedResources = field(default_factory=NodeReservedResources)
    links: Dict[str, str] = field(default_factory=dict)
    drivers: Dict[str, dict] = field(default_factory=dict)   # driver -> {detected, healthy}
    status: str = NodeStatus.INIT
    scheduling_eligibility: str = NodeSchedulingEligibility.ELIGIBLE
    drain_strategy: Optional[DrainStrategy] = None
    status_updated_at: float = 0.0
    last_drain: Optional[dict] = None
    host_volumes: Dict[str, dict] = field(default_factory=dict)  # name -> {path, read_only}
    csi_node_plugins: Dict[str, dict] = field(default_factory=dict)
    csi_controller_plugins: Dict[str, dict] = field(default_factory=dict)
    computed_class: str = ""
    # advertised agent HTTP address ("host:port") — the server-side fs
    # endpoints forward alloc fs/log reads here (reference Node.HTTPAddr,
    # client/fs_endpoint.go forwarding)
    http_addr: str = ""
    # per-node shared secret, proven back to the servers on Secrets.Derive
    # (reference Node.SecretID, node_endpoint.go deriveTokenInternal); never
    # returned by Node.GetNode/Node.List
    secret_id: str = field(default_factory=generate_uuid)
    create_index: int = 0
    modify_index: int = 0

    def ready(self) -> bool:
        """Reference Node.Ready: status ready, not draining, eligible."""
        return (self.status == NodeStatus.READY
                and self.drain_strategy is None
                and self.scheduling_eligibility == NodeSchedulingEligibility.ELIGIBLE)

    @property
    def draining(self) -> bool:
        return self.drain_strategy is not None

    def comparable_resources(self) -> ComparableResources:
        return ComparableResources(
            cpu_shares=self.node_resources.cpu.cpu_shares,
            memory_mb=self.node_resources.memory_mb,
            disk_mb=self.node_resources.disk_mb,
        )

    def comparable_reserved_resources(self) -> ComparableResources:
        return ComparableResources(
            cpu_shares=self.reserved_resources.cpu_shares,
            memory_mb=self.reserved_resources.memory_mb,
            disk_mb=self.reserved_resources.disk_mb,
        )

    def terminal_status(self) -> bool:
        return self.status == NodeStatus.DOWN


def compute_node_class(node: Node) -> str:
    """Hash of the class-relevant fields of a node (reference
    structs/node_class.go:27-37 ComputeClass).  Nodes with the same computed
    class are interchangeable for class-capturable constraints, enabling
    per-class feasibility memoization and blocked-eval ClassEligibility.

    Attributes/metadata with the "unique." prefix are excluded, mirroring
    the reference's EscapedConstraints semantics.
    """
    payload = {
        "datacenter": node.datacenter,
        "node_class": node.node_class,
        "attributes": {k: v for k, v in sorted(node.attributes.items())
                       if not k.startswith("unique.")},
        "meta": {k: v for k, v in sorted(node.meta.items())
                 if not k.startswith("unique.")},
        "drivers": sorted(d for d, info in node.drivers.items()
                          if info.get("detected")),
        "resources": [node.node_resources.cpu.cpu_shares,
                      node.node_resources.memory_mb,
                      node.node_resources.disk_mb],
        "devices": sorted(d.id for d in node.node_resources.devices),
        "host_volumes": sorted(self_k for self_k in node.host_volumes),
    }
    digest = hashlib.blake2b(
        json.dumps(payload, sort_keys=True).encode(), digest_size=8
    ).hexdigest()
    return f"v1:{digest}"
