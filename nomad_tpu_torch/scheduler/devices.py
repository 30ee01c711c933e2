"""Host-side device accounting (reference: nomad/structs/devices.go
DeviceAccounter, scheduler/device.go AllocateDevice).

Used for the check-devices path of AllocsFit and for assigning device
instance IDs to placements.  The *scoring/feasibility* of device-constrained
placement is done densely on device (ops/feasibility.py); instance-ID
assignment is inherently host-side bookkeeping.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def _collect_node_devices(node) -> Dict[str, Tuple[object, set]]:
    """device-group id -> (NodeDevice, set(free instance ids))."""
    out = {}
    for dev in node.node_resources.devices:
        out[dev.id] = (dev, set(dev.instance_ids))
    return out


def _used_instances(allocs) -> Dict[str, set]:
    used: Dict[str, set] = {}
    for alloc in allocs:
        if alloc.terminal_status():
            continue
        for tr in alloc.allocated_resources.tasks.values():
            for d in tr.devices:
                gid = f"{d['vendor']}/{d['type']}/{d['name']}"
                used.setdefault(gid, set()).update(d.get("device_ids", []))
    return used


def device_accounter_fits(node, allocs) -> bool:
    """True iff no device instance is claimed twice and all claimed
    instances exist on the node (reference DeviceAccounter.AddAllocs
    returning collision=false)."""
    groups = _collect_node_devices(node)
    claimed: Dict[str, set] = {}
    for alloc in allocs:
        if alloc.terminal_status():
            continue
        for tr in alloc.allocated_resources.tasks.values():
            for d in tr.devices:
                gid = f"{d['vendor']}/{d['type']}/{d['name']}"
                if gid not in groups:
                    return False
                have = groups[gid][1]
                got = claimed.setdefault(gid, set())
                for inst in d.get("device_ids", []):
                    if inst in got or inst not in have:
                        return False
                    got.add(inst)
    return True


def assign_device_instances(node, allocs, request,
                            extra_used=None) -> Optional[dict]:
    """Pick `request.count` free instance ids from a matching, constraint-
    satisfying device group (reference scheduler/device.go:32-131
    AllocateDevice).  Returns {vendor,type,name,device_ids} or None.
    `extra_used` ({group id -> set(instance ids)}) carries grants already
    made to other requests of the same in-flight allocation, so two tasks
    in one group never share an instance.  Constraint/affinity evaluation
    over device attributes is handled by the caller via
    nomad_tpu_torch.scheduler.feasible.check_operand on dev.attributes.
    """
    import random as _random
    used = _used_instances(allocs)
    for gid, ids in (extra_used or {}).items():
        used.setdefault(gid, set()).update(ids)
    for dev in node.node_resources.devices:
        if not dev.matches(request.name):
            continue
        free = [i for i in dev.healthy_ids()
                if i not in used.get(dev.id, set())]
        if len(free) >= request.count:
            # random choice among free instances: concurrent evals that
            # cannot see each other's in-flight assignments would all
            # deterministically take the first-free ids and collide at
            # the applier; random picks make them disjoint with high
            # probability (the applier still enforces exclusivity)
            picked = _random.sample(free, request.count)
            return {"vendor": dev.vendor, "type": dev.type, "name": dev.name,
                    "device_ids": picked}
    return None
