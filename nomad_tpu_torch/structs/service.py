"""Nomad-native service registrations (reference
nomad/structs/service_registration.go + client/serviceregistration/nsd —
the built-in service discovery backend that replaces Consul for
`provider = "nomad"` services: clients register the services of running
allocations with the servers, deregister them on stop, and the registry
is queryable at /v1/services).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class ServiceRegistration:
    """One service instance bound to one allocation (reference
    service_registration.go ServiceRegistration)."""
    id: str = ""                    # _nomad-task-<alloc>-<task>-<svc>-<port>
    service_name: str = ""
    namespace: str = "default"
    node_id: str = ""
    datacenter: str = ""
    job_id: str = ""
    alloc_id: str = ""
    tags: List[str] = field(default_factory=list)
    address: str = ""
    port: int = 0
    # check-driven health: "passing" | "critical" | "pending" — fed by the
    # client's check runner (nsd keeps checks client-side; health rides
    # the registration so /v1/services and the deployment watcher see it)
    health: str = "passing"
    create_index: int = 0
    modify_index: int = 0


def registration_id(alloc_id: str, task: str, service: str,
                    port_label: str) -> str:
    return f"_nomad-task-{alloc_id}-{task or 'group'}-{service}-{port_label or 'none'}"
