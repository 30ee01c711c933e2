"""Host-side preemption ranking (reference: scheduler/preemption.go —
PreemptForTaskGroup:198-265, basicResourceDistance:606-624,
scoreForTaskGroup:663-680).

Only the numpy parts live here: the scheduler's host path ranks
evictions with `preempt_for_task_group_np` (scheduler/preemption.py).
The device kernel of the same selection is still to be ported.
"""
from __future__ import annotations

import math

import numpy as np


def net_priority(prios) -> float:
    """netPriority heuristic (rank preemption options; preemption.go:745-760):
    max priority + sum/max penalty."""
    if not prios:
        return 0.0
    mx = float(max(prios))
    if mx <= 0:
        return 0.0
    return mx + (float(sum(prios)) / mx)


def preemption_score(net_prio: float) -> float:
    """Logistic preemption score in (0,1), inflection at 2048
    (preemption.go:768-780)."""
    rate, origin = 0.0048, 2048.0
    return 1.0 / (1.0 + math.exp(rate * (net_prio - origin)))


def preempt_for_task_group_np(cand_res, cand_prio, cand_valid, remaining,
                              ask, max_steps: int = 16):
    """Greedy per-node eviction selection over every node at once: lowest
    priority tier first, closest normalized resource distance within a
    tier, until the freed + remaining resources cover the ask.
    -> (met bool[N], picked bool[N, A], avail_after f32[N, R])."""
    N, A, R = cand_res.shape
    picked = np.zeros((N, A), bool)
    needed = np.broadcast_to(ask, (N, R)).copy()
    avail = remaining.astype(np.float32).copy()
    met = np.all(avail >= ask, axis=-1)
    INT_MAX = np.int32(2**31 - 1)
    BIGF = np.float32(3.4e38)
    for _ in range(max_steps):
        open_ = cand_valid & ~picked
        prio_masked = np.where(open_, cand_prio, INT_MAX)
        min_prio = prio_masked.min(axis=1)                    # [N]
        tier = open_ & (cand_prio == min_prio[:, None])
        askp = needed[:, None, :]                             # [N,1,R]
        coord = np.where(askp > 0.0,
                         (askp - cand_res) / np.maximum(askp, 1e-9), 0.0)
        dist = np.sqrt((coord * coord).sum(axis=-1))          # [N, A]
        dist = np.where(tier, dist, BIGF)
        pick = dist.argmin(axis=1)                            # [N]
        can_pick = tier.any(axis=1) & ~met
        onehot = (np.arange(A)[None, :] == pick[:, None]) & can_pick[:, None]
        picked |= onehot
        freed = (cand_res * onehot[:, :, None]).sum(axis=1)
        avail += freed
        needed -= freed
        met |= np.all(avail >= ask, axis=-1)
    return met, picked, avail
