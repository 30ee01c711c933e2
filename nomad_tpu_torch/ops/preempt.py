"""Preemption selection (K6) and the host ranking helpers (reference:
scheduler/preemption.go — PreemptForTaskGroup:198-265,
basicResourceDistance:606-624, scoreForTaskGroup:663-680).

For every candidate node at once: given the node's preemptible
allocations (padded candidate axis A), greedily pick evictions — lowest
priority tier first, closest normalized resource distance within the
tier, distances recomputed as the remaining ask shrinks — until the
freed + remaining resources cover the ask.

Torch port of the reference's ops/preempt.py `preempt_for_task_group`:

* `preempt_for_task_group_plain`, written from the JAX function step
  for step (a Python loop over the pick steps, tensor ops over nodes and
  candidates), is the specification, the CPU path, and what the CUDA
  kernel is held against on the card;
* `preempt_for_task_group` launches the hand-written kernel
  (csrc/preempt.cu) for CUDA tensors, takes the plain version for CPU
  tensors, and raises for anything else.  `launches` counts kernel
  launches only.

The kernel runs on the calling thread's current stream; the scheduler's
workers call it while the placement engine's dispatcher launches on a
stream of its own.
"""
from __future__ import annotations

import math

import torch

from nomad_tpu_torch.ops import _build
from nomad_tpu_torch.ops.place import _check, _on_card, _ptr, _stream

BIG = 3.4e38
INT32_MAX = 2**31 - 1
# the kernel gives a node at most one warp, 32 slots a lane (a bit mask),
# and instantiates its register state for R = 1..MAX_DIMS
MAX_CANDIDATES = 32 * 32
MAX_DIMS = 8

# kernel launches (the plain version never counts)
launches = {"preempt": 0}


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


def preempt_for_task_group_plain(cand_res, cand_prio, cand_valid, remaining,
                                 ask, max_steps: int = 16):
    """cand_res f32[N, A, R], cand_prio i32[N, A], cand_valid bool[N, A],
    remaining f32[N, R] (capacity minus all current usage), ask f32[R]
    -> (met bool[N], picked bool[N, A], avail f32[N, R]).

    The squares are summed in dimension order, written out, so that the
    kernel can repeat the order; the divisor is a tensor on the inputs'
    device (CUDA PyTorch turns division by a host scalar into a
    reciprocal multiply)."""
    N, A, R = cand_res.shape
    dev = cand_res.device
    rows = torch.arange(N, device=dev)
    tiny = torch.tensor(1e-9, dtype=torch.float32, device=dev)
    picked = torch.zeros((N, A), dtype=torch.bool, device=dev)
    needed = ask.expand(N, R).clone()
    avail = remaining.clone()
    met = (avail >= ask).all(dim=1)
    for _ in range(max_steps):
        open_ = cand_valid & ~picked
        prio_masked = torch.where(open_, cand_prio, INT32_MAX)
        min_prio = prio_masked.min(dim=1).values
        tier = open_ & (cand_prio == min_prio[:, None])
        askp = needed[:, None, :]
        coord = torch.where(askp > 0.0,
                            (askp - cand_res) / torch.maximum(askp, tiny),
                            0.0)
        acc = coord[..., 0] * coord[..., 0]
        for r in range(1, R):
            acc = acc + coord[..., r] * coord[..., r]
        dist = torch.where(tier, torch.sqrt(acc), BIG)
        pick = dist.argmin(dim=1)
        can_pick = tier.any(dim=1) & ~met
        picked[rows, pick] = picked[rows, pick] | can_pick
        freed = torch.where(can_pick[:, None], cand_res[rows, pick], 0.0)
        avail = avail + freed
        needed = needed - freed
        met = met | (avail >= ask).all(dim=1)
    return met, picked, avail


def preempt_for_task_group(cand_res, cand_prio, cand_valid, remaining, ask,
                           max_steps: int = 16):
    """K6 wrapper, same arguments and outputs as
    `preempt_for_task_group_plain`.  CUDA tensors launch csrc/preempt.cu
    on their card's current stream, with that card current; CPU tensors
    take the plain version."""
    dev = cand_res.device
    if dev.type == "cpu":
        return preempt_for_task_group_plain(cand_res, cand_prio, cand_valid,
                                            remaining, ask, max_steps)
    if dev.type != "cuda":
        raise ValueError(
            f"nomad_tpu_torch.ops.preempt: unsupported device {dev}")
    N, A, R = cand_res.shape
    if not 1 <= A <= MAX_CANDIDATES:
        raise ValueError(f"preempt_for_task_group: A={A}, the kernel takes "
                         f"1..{MAX_CANDIDATES}")
    if not 1 <= R <= MAX_DIMS:
        raise ValueError(f"preempt_for_task_group: R={R}, the kernel takes "
                         f"1..{MAX_DIMS}")
    if max_steps < 0:
        raise ValueError(f"preempt_for_task_group: max_steps={max_steps}")
    f32 = torch.float32
    _check("preempt.cand_res", cand_res, dev, f32, (N, A, R))
    _check("preempt.cand_prio", cand_prio, dev, torch.int32, (N, A))
    _check("preempt.cand_valid", cand_valid, dev, torch.bool, (N, A))
    _check("preempt.remaining", remaining, dev, f32, (N, R))
    _check("preempt.ask", ask, dev, f32, (R,))
    lib = _build.load("preempt")
    met = torch.empty((N,), dtype=torch.bool, device=dev)
    picked = torch.empty((N, A), dtype=torch.bool, device=dev)
    avail = torch.empty((N, R), dtype=f32, device=dev)
    rc = _on_card(
        dev.index, lib.preempt_launch,
        _ptr(cand_res), _ptr(cand_prio), _ptr(cand_valid), _ptr(remaining),
        _ptr(ask), N, A, R, int(max_steps), _ptr(met), _ptr(picked),
        _ptr(avail), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"preempt kernel launch failed: CUDA error {rc}")
    launches["preempt"] += 1
    return met, picked, avail
