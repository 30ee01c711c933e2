"""Vectorized fit + scoring primitives over the node axis.

Torch counterparts of the reference's ops/fit.py (structs/funcs.go:166-297
lifted over nodes): every function takes [..., R] matrices and returns
[...] vectors.  They are the plain-version building blocks of the
placement kernels in ops/place.py; the CUDA kernels in csrc/ repeat the
same arithmetic, in the same order, per row.
"""
from __future__ import annotations

import torch

from nomad_tpu_torch.encode.matrixizer import RES_CPU, RES_MEM

MAX_FIT_SCORE = 18.0
_FIT_DIMS = [RES_CPU, RES_MEM]


def fits_after(capacity: torch.Tensor, used: torch.Tensor,
               demand: torch.Tensor) -> torch.Tensor:
    """bool[N]: does `demand` (f32[R]) fit on each node given current usage?
    The resource superset check of AllocsFit (funcs.go:197-203)."""
    return torch.all(used + demand <= capacity, dim=-1)


def validate_capacity(capacity: torch.Tensor, used: torch.Tensor) -> torch.Tensor:
    """bool[N]: per-node totals within capacity (evaluateNodePlan ->
    AllocsFit, nomad/plan_apply.go:640)."""
    return torch.all(used <= capacity, dim=-1)


def free_fractions(capacity: torch.Tensor, util: torch.Tensor) -> torch.Tensor:
    """f32[..., 2]: free cpu/mem fractions after `util`, with the
    zero-capacity convention of structs.resources._free_ratio (used>0 on
    cap<=0 -> -inf, 0 on 0 -> 1).  Broadcasts over leading axes."""
    cap = capacity[..., _FIT_DIMS]
    use = util[..., _FIT_DIMS]
    frac = 1.0 - use / cap
    zero_cap = cap <= 0.0
    frac = torch.where(zero_cap & (use > 0.0),
                       torch.full_like(frac, float("-inf")), frac)
    frac = torch.where(zero_cap & (use <= 0.0), torch.ones_like(frac), frac)
    return frac


def score_fit(capacity: torch.Tensor, util: torch.Tensor,
              spread: bool) -> torch.Tensor:
    """f32[...] in [0, 18]: BestFit v3 (binpack) or Worst Fit (spread)
    score (funcs.go:259-297)."""
    frac = free_fractions(capacity, util)
    total = torch.sum(torch.pow(10.0, frac), dim=-1)
    raw = (total - 2.0) if spread else (20.0 - total)
    return torch.clamp(raw, 0.0, MAX_FIT_SCORE)
