"""Host helpers of the scheduler's hot path, in numpy.

The reference binds these to a C++ library (native/nomad_native.cpp)
and keeps numpy versions beside them for hosts without a compiler; the
port carries those numpy versions only.  Their semantics are the
reference's: same outputs, same in-place updates.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def ports_check(port_words: np.ndarray, row: int,
                ports: Sequence[int],
                freed: Sequence[int] = ()) -> bool:
    """All `ports` free on `row` (ports in `freed` count as free)?"""
    freed_set = set(int(x) for x in freed)
    seen = set()
    for p in ports:
        p = int(p)
        if p in seen:
            return False
        seen.add(p)
        if p < 0 or (p >> 5) >= port_words.shape[1]:
            return False
        if (port_words[row, p >> 5] >> np.uint32(p & 31)) & 1:
            if p not in freed_set:
                return False
    return True


def ports_set(port_words: np.ndarray, row: int,
              ports: Sequence[int], value: bool) -> None:
    """Set (value=True) or clear the bits of `ports` on `row` in place."""
    for p in ports:
        p = int(p)
        if p < 0 or (p >> 5) >= port_words.shape[1]:
            continue
        if value:
            port_words[row, p >> 5] |= np.uint32(1 << (p & 31))
        else:
            port_words[row, p >> 5] &= ~np.uint32(1 << (p & 31))


def validate_plan(capacity: np.ndarray, used: np.ndarray,
                  port_words: np.ndarray,
                  rows: Sequence[int],
                  demand: np.ndarray, freed: np.ndarray,
                  group_ports: List[Sequence[int]],
                  group_freed_ports: List[Sequence[int]]) -> np.ndarray:
    """bool[G]: per placement-group validation (fit + ports), the
    plan applier's EvaluatePool fan-out (plan_apply_pool.go)."""
    rows_a = np.asarray(list(rows), np.int32)
    demand = np.ascontiguousarray(demand, np.float32)
    freed = np.ascontiguousarray(freed, np.float32)
    out = np.zeros(len(rows_a), bool)
    for i in range(len(rows_a)):
        r = int(rows_a[i])
        if r < 0:
            continue
        fits = np.all(used[r] + demand[i] - freed[i]
                      <= capacity[r] + 1e-6)
        out[i] = fits and ports_check(
            port_words, r, group_ports[i], group_freed_ports[i])
    return out


def expand_pairs(rows: np.ndarray, counts: np.ndarray,
                 scores: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten (row, count, score) triples into per-alloc (rows i32[K],
    scores f32[K]) arrays in placement order; K = counts.clip(0).sum()."""
    rows_a = np.ascontiguousarray(rows, np.int32)
    counts_a = np.ascontiguousarray(counts, np.int32)
    if scores is None:
        scores_a = np.zeros(rows_a.shape[0], np.float32)
    else:
        scores_a = np.ascontiguousarray(scores, np.float32)
    keep = counts_a > 0
    return (np.repeat(rows_a[keep], counts_a[keep]),
            np.repeat(scores_a[keep], counts_a[keep]))


def format_uuids(n: int) -> List[str]:
    """n fresh uuid strings in one call, byte-identical in format to
    utils.generate_uuid (hex of os.urandom(16), 8-4-4-4-12)."""
    if n <= 0:
        return []
    h = os.urandom(16 * n).hex()
    return [f"{s[:8]}-{s[8:12]}-{s[12:16]}-{s[16:20]}-{s[20:]}"
            for s in (h[i * 32:(i + 1) * 32] for i in range(n))]


def scatter_add_rank1(used: np.ndarray, rows: np.ndarray,
                      counts: np.ndarray, demand: np.ndarray) -> None:
    """used[rows[k]] += counts[k] * demand in place."""
    rows_a = np.ascontiguousarray(rows, np.int32)
    counts_a = np.ascontiguousarray(counts, np.int32)
    demand_a = np.ascontiguousarray(demand, np.float32)
    np.add.at(used, rows_a,
              counts_a[:, None].astype(used.dtype) * demand_a)
