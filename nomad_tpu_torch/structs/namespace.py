"""Namespaces and resource quotas (reference: nomad/structs/structs.go
Namespace:5353, nomad/structs/quota.ent.go QuotaSpec/QuotaLimit/QuotaUsage).

Namespaces partition the job space; a namespace may reference a
``QuotaSpec`` by name, and every namespace referencing a spec gets its
own budget of that spec's limits (per-namespace budget semantics — the
spec is a template, not an aggregate pool).  Quota usage accounting is
replicated state maintained inside the FSM apply cone (see
``state/store.py``) so enforcement is deterministic across survivors.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class Namespace:
    """A first-class replicated namespace (CRUD through FSM entries)."""
    name: str = "default"
    description: str = ""
    # name of the QuotaSpec governing this namespace ("" = unlimited)
    quota: str = ""
    create_index: int = 0
    modify_index: int = 0


@dataclass
class QuotaSpec:
    """Resource ceiling template.  ``None`` limits are unlimited; the
    check is dimension-wise (cpu shares, memory MB, device count,
    alloc count) against the namespace's live usage."""
    name: str = ""
    description: str = ""
    cpu: Optional[int] = None           # MHz shares
    memory_mb: Optional[int] = None
    devices: Optional[int] = None       # accelerator device count
    allocs: Optional[int] = None        # live (non-terminal) alloc count
    create_index: int = 0
    modify_index: int = 0

    def admits(self, usage: Dict[str, int]) -> bool:
        """True when `usage` (a would-be post-placement total) fits."""
        for dim, limit in (("cpu", self.cpu), ("memory_mb", self.memory_mb),
                           ("devices", self.devices), ("allocs", self.allocs)):
            if limit is not None and usage.get(dim, 0) > limit:
                return False
        return True

    def exceeded_dims(self, usage: Dict[str, int]) -> list:
        out = []
        for dim, limit in (("cpu", self.cpu), ("memory_mb", self.memory_mb),
                           ("devices", self.devices), ("allocs", self.allocs)):
            if limit is not None and usage.get(dim, 0) > limit:
                out.append(dim)
        return out


def alloc_quota_usage(alloc) -> Dict[str, int]:
    """The quota-relevant resource vector of one allocation.

    Derived purely from the alloc's own fields (no clock, no store reads
    beyond the alloc) so the FSM-side usage accounting stays replica
    deterministic."""
    cmp = alloc.comparable_resources()
    devices = 0
    ar = alloc.allocated_resources
    for tres in (ar.tasks.values() if ar is not None else ()):
        for dev in tres.devices:
            devices += len(dev.get("device_ids", []) or [])
    return {"cpu": int(cmp.cpu_shares), "memory_mb": int(cmp.memory_mb),
            "devices": devices, "allocs": 1}


def usage_add(usage: Dict[str, int], delta: Dict[str, int],
              sign: int = 1) -> None:
    for k, v in delta.items():
        usage[k] = usage.get(k, 0) + sign * v
