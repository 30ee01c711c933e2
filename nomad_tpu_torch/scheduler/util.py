"""Scheduler utilities (reference: scheduler/util.go — taintedNodes:427,
readyNodesInDCs:351, progressMade:417, adjustQueuedAllocations:1049).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set

from nomad_tpu_torch.structs import Allocation, Evaluation, Node
from nomad_tpu_torch.structs.node import NodeStatus
from nomad_tpu_torch.structs.plan import PlanResult


def tainted_nodes(snapshot, allocs: Iterable[Allocation]) -> Dict[str, Optional[Node]]:
    """Nodes referenced by allocs that are down / draining / disconnected
    (or gone).  Missing nodes map to None (treated as down)."""
    out: Dict[str, Optional[Node]] = {}
    seen: Set[str] = set()
    for a in allocs:
        if a.node_id in seen:
            continue
        seen.add(a.node_id)
        node = snapshot.node_by_id(a.node_id)
        if node is None:
            out[a.node_id] = None
        elif node.terminal_status() or node.draining or \
                node.status == NodeStatus.DISCONNECTED:
            out[a.node_id] = node
    return out


def progress_made(result: Optional[PlanResult]) -> bool:
    """Did the plan commit anything (reference progressMade:417)?"""
    return result is not None and bool(
        result.node_update or result.node_allocation or result.deployment
        or result.deployment_updates or result.node_preemptions)


def adjust_queued_allocations(result: Optional[PlanResult],
                              queued: Dict[str, int]) -> None:
    """Decrement queued counts by what actually committed
    (reference adjustQueuedAllocations:1049)."""
    if result is None:
        return
    for allocs in result.node_allocation.values():
        for a in allocs:
            if a.task_group in queued:
                queued[a.task_group] -= 1


def update_non_terminal_allocs_to_lost(plan, tainted: Dict[str, Optional[Node]],
                                       allocs: Iterable[Allocation]) -> None:
    """On job stop/deregister, mark non-terminal allocs on down nodes lost
    (reference updateNonTerminalAllocsToLost:1078)."""
    for a in allocs:
        if a.node_id not in tainted:
            continue
        node = tainted[a.node_id]
        if node is not None and (node.draining or node.status not in
                                 (NodeStatus.DOWN, NodeStatus.DISCONNECTED)):
            continue
        if a.desired_status in ("stop", "evict") and \
                a.client_status in ("running", "pending"):
            plan.append_stopped_alloc(a, "alloc was lost since its node is down",
                                      client_status="lost")
