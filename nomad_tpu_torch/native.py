"""The native host library: csrc/nomad_native.cpp, bound with ctypes.

The library is built with g++ at first use (ops/_build.py `load_host`)
and every public function here calls it:

  allocs_fit(capacity, used, demand) -> bool[N]
  score_fit(capacity, used, demand, spread=False) -> f32[N]
  ports_check(port_words, row, ports, freed) -> bool
  ports_set(port_words, row, ports, value)
  scatter_add(used, rows, deltas)
  scatter_add_rank1(used, rows, counts, demand)
  validate_plan(...) -> bool[G]     (the plan applier's EvaluatePool)
  expand_pairs(rows, counts, scores) -> (i32[K], f32[K])
  format_uuids(n) -> list[str]      (batch generate_uuid)

Beside each stands its plain numpy version, `<name>_plain`: the spec
the tests hold the library to, bit for bit (score_fit's floats within
the tolerance its test states: glibc's powf against numpy's float32
power).  Nothing on the program's path calls a plain version.  The
specs follow the library where the reference's own numpy fallback parts
from it: a fit test that meets a NaN passes (`not (x > y)`, as
nomad_native.cpp tests `x > y` and breaks), and a rank-1 row of count 0
is skipped (0 * inf would add a NaN).

No fallback: a missing compiler, a failed build and an array the
library cannot take raise.  An array the library writes into (`used`,
`port_words`) must already be C-contiguous and of the library's type;
arrays it only reads are converted, as the reference converts them.
Rows outside the array raise IndexError before the library is called.
"""
from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from nomad_tpu_torch.ops import _build

_lib: Optional[ctypes.CDLL] = None
_EPS = np.float32(1e-6)          # nomad_native.cpp's 1e-6f
_EMPTY_I32 = np.zeros(0, np.int32)


def _native() -> ctypes.CDLL:
    """The library, built and loaded at first use."""
    global _lib
    lib = _lib
    if lib is None:
        lib = _lib = _build.load_host()
    return lib


def _addr(a: np.ndarray) -> int:
    """The address of a C-contiguous array's data (through a ctypes
    view where the array is writeable and not empty: cheaper than
    `a.ctypes.data`)."""
    if a.flags.writeable and a.nbytes:
        return ctypes.addressof(ctypes.c_char.from_buffer(a))
    return a.ctypes.data


def _target(a, dtype, what: str) -> np.ndarray:
    """An array the library writes into: 2-D, C-contiguous, writeable,
    of `dtype`; anything else raises."""
    if not (isinstance(a, np.ndarray) and a.dtype == dtype and a.ndim == 2
            and a.flags.c_contiguous and a.flags.writeable):
        got = (f"{a.dtype}{list(a.shape)}, C-contiguous "
               f"{a.flags.c_contiguous}, writeable {a.flags.writeable}"
               if isinstance(a, np.ndarray) else type(a).__name__)
        raise TypeError(f"nomad_native: {what} must be a writeable "
                        f"C-contiguous {np.dtype(dtype)} [N, D] array "
                        f"(got {got})")
    return a


def _rows_in(rows: np.ndarray, n: int, lo: int = 0) -> None:
    """Every row in [lo, n) (a short array's bounds taken in Python:
    a numpy reduction costs more there)."""
    if rows.size:
        r = rows.tolist() if rows.size <= 64 else (rows.min(), rows.max())
        if min(r) < lo or max(r) >= n:
            raise IndexError(f"nomad_native: a row outside [{lo}, {n})")


def _row_in(row: int, n: int) -> int:
    if not 0 <= row < n:
        raise IndexError(f"nomad_native: row {row} outside [0, {n})")
    return int(row)


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def _dense(capacity, used, demand):
    capacity, used, demand = _f32(capacity), _f32(used), _f32(demand)
    if capacity.ndim != 2 or used.shape != capacity.shape \
            or demand.shape != capacity.shape[1:]:
        raise ValueError(f"nomad_native: capacity {capacity.shape}, used "
                         f"{used.shape}, demand {demand.shape}")
    return capacity, used, demand


# ------------------------------------------------------------ fit, score

def allocs_fit(capacity: np.ndarray, used: np.ndarray,
               demand: np.ndarray) -> np.ndarray:
    """bool[N]: demand fits in capacity-used per row
    (structs.AllocsFit over the node axis)."""
    capacity, used, demand = _dense(capacity, used, demand)
    out = np.empty(capacity.shape[0], np.uint8)
    _native().allocs_fit_dense(_addr(capacity), _addr(used), _addr(demand),
                               capacity.shape[0], capacity.shape[1],
                               _addr(out))
    return out.astype(bool)


def allocs_fit_plain(capacity: np.ndarray, used: np.ndarray,
                     demand: np.ndarray) -> np.ndarray:
    capacity, used, demand = _dense(capacity, used, demand)
    return ~np.any(used + demand > capacity + _EPS, axis=1)


def score_fit(capacity: np.ndarray, used: np.ndarray,
              demand: np.ndarray, spread: bool = False) -> np.ndarray:
    """f32[N] binpack/spread score (structs.ScoreFitBinPack/Spread) over
    cpu and memory."""
    capacity, used, demand = _dense(capacity, used, demand)
    if capacity.shape[1] < 2:
        raise ValueError("nomad_native: score_fit needs cpu and memory")
    out = np.empty(capacity.shape[0], np.float32)
    _native().score_fit_dense(_addr(capacity), _addr(used), _addr(demand),
                              capacity.shape[0], capacity.shape[1],
                              int(spread), _addr(out))
    return out


def score_fit_plain(capacity: np.ndarray, used: np.ndarray,
                    demand: np.ndarray, spread: bool = False) -> np.ndarray:
    capacity, used, demand = _dense(capacity, used, demand)
    cap = capacity[:, :2]
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        free = np.clip((cap - (used[:, :2] + demand[:2])) / cap,
                       np.float32(0), np.float32(1))
        exp = np.float32(1) - free if spread else free
        total = np.power(np.float32(10), exp).sum(axis=1)
    total = np.where((cap <= 0).any(axis=1), np.float32(40), total)
    return np.clip((np.float32(20) - total) / np.float32(18),
                   np.float32(0), np.float32(1)).astype(np.float32)


# ------------------------------------------------------------ ports

def ports_check(port_words: np.ndarray, row: int,
                ports: Sequence[int],
                freed: Sequence[int] = ()) -> bool:
    """All `ports` free on `row` (ports in `freed` count as free)?  A
    port out of range or repeated within the request is not."""
    pw = np.ascontiguousarray(port_words, np.uint32)
    row = _row_in(row, pw.shape[0])
    ports_a, freed_a = _i32(list(ports)), _i32(list(freed))
    return bool(_native().ports_check(
        _addr(pw), pw.shape[1], row, _addr(ports_a), len(ports_a),
        _addr(freed_a), len(freed_a)))


def ports_check_plain(port_words: np.ndarray, row: int,
                      ports: Sequence[int],
                      freed: Sequence[int] = ()) -> bool:
    freed_set = set(int(x) for x in freed)
    seen = set()
    for p in ports:
        p = int(p)
        if p < 0 or (p >> 5) >= port_words.shape[1] or p in seen:
            return False
        seen.add(p)
        if (port_words[row, p >> 5] >> np.uint32(p & 31)) & 1:
            if p not in freed_set:
                return False
    return True


def ports_set(port_words: np.ndarray, row: int,
              ports: Sequence[int], value: bool) -> None:
    """Set (value=True) or clear the bits of `ports` on `row` in place;
    ports out of range are skipped."""
    pw = _target(port_words, np.uint32, "port_words")
    row = _row_in(row, pw.shape[0])
    ports_a = _i32(list(ports))
    _native().ports_set(_addr(pw), pw.shape[1], row, _addr(ports_a),
                        len(ports_a), int(bool(value)))


def ports_set_plain(port_words: np.ndarray, row: int,
                    ports: Sequence[int], value: bool) -> None:
    for p in ports:
        p = int(p)
        if p < 0 or (p >> 5) >= port_words.shape[1]:
            continue
        if value:
            port_words[row, p >> 5] |= np.uint32(1 << (p & 31))
        else:
            port_words[row, p >> 5] &= ~np.uint32(1 << (p & 31))


# ------------------------------------------------------------ scatters

def scatter_add(used: np.ndarray, rows: Sequence[int],
                deltas: np.ndarray) -> None:
    """used[rows[k]] += deltas[k] in place, k in order."""
    used = _target(used, np.float32, "used")
    rows_a, deltas = _i32(rows), _f32(deltas)
    if deltas.shape != (len(rows_a), used.shape[1]):
        raise ValueError(f"nomad_native: deltas {deltas.shape} for "
                         f"{len(rows_a)} rows of {used.shape[1]}")
    _rows_in(rows_a, used.shape[0])
    _native().scatter_add(_addr(used), used.shape[1], _addr(rows_a),
                          _addr(deltas), len(rows_a))


def scatter_add_plain(used: np.ndarray, rows: Sequence[int],
                      deltas: np.ndarray) -> None:
    np.add.at(used, _i32(rows), _f32(deltas))


def scatter_add_rank1(used: np.ndarray, rows: np.ndarray,
                      counts: np.ndarray, demand: np.ndarray) -> None:
    """used[rows[k]] += counts[k] * demand in place, without building
    the [K, dims] delta matrix; rows of count 0 are skipped."""
    used = _target(used, np.float32, "used")
    rows_a, counts_a, demand_a = _i32(rows), _i32(counts), _f32(demand)
    if counts_a.shape != rows_a.shape or demand_a.shape != used.shape[1:]:
        raise ValueError(f"nomad_native: rows {rows_a.shape}, counts "
                         f"{counts_a.shape}, demand {demand_a.shape} for "
                         f"used {used.shape}")
    _rows_in(rows_a, used.shape[0])
    _native().scatter_add_rank1(_addr(used), used.shape[1], _addr(rows_a),
                                _addr(counts_a), _addr(demand_a),
                                len(rows_a))


def scatter_add_rank1_plain(used: np.ndarray, rows: np.ndarray,
                            counts: np.ndarray, demand: np.ndarray) -> None:
    rows_a, counts_a, demand_a = _i32(rows), _i32(counts), _f32(demand)
    keep = counts_a != 0
    with np.errstate(invalid="ignore", over="ignore"):
        np.add.at(used, rows_a[keep],
                  counts_a[keep, None].astype(np.float32) * demand_a)


# ------------------------------------------------------------ the plan

def _plan_ports(group_ports, group_freed_ports):
    g = len(group_ports)
    ports_off = np.zeros(g + 1, np.int32)
    freed_off = np.zeros(g + 1, np.int32)
    flat_ports: List[int] = []
    flat_freed: List[int] = []
    for i in range(g):
        flat_ports.extend(int(p) for p in group_ports[i])
        flat_freed.extend(int(p) for p in group_freed_ports[i])
        ports_off[i + 1] = len(flat_ports)
        freed_off[i + 1] = len(flat_freed)
    ports_a = _i32(flat_ports) if flat_ports else _EMPTY_I32
    freed_a = _i32(flat_freed) if flat_freed else _EMPTY_I32
    return ports_a, ports_off, freed_a, freed_off


def validate_plan(capacity: np.ndarray, used: np.ndarray,
                  port_words: np.ndarray,
                  rows: Sequence[int],
                  demand: np.ndarray, freed: np.ndarray,
                  group_ports: List[Sequence[int]],
                  group_freed_ports: List[Sequence[int]]) -> np.ndarray:
    """bool[G]: per placement-group validation (fit + ports), the
    plan applier's EvaluatePool fan-out (plan_apply_pool.go) as one
    call.  Row -1 is an unknown node (rejected)."""
    capacity, used = _f32(capacity), _f32(used)
    pw = np.ascontiguousarray(port_words, np.uint32)
    rows_a = _i32(list(rows))
    g, dims = len(rows_a), capacity.shape[1]
    demand, freed = _f32(demand), _f32(freed)
    if used.shape != capacity.shape or pw.shape[0] != capacity.shape[0] \
            or demand.shape != (g, dims) or freed.shape != (g, dims) \
            or len(group_ports) != g or len(group_freed_ports) != g:
        raise ValueError(f"nomad_native: validate_plan shapes: capacity "
                         f"{capacity.shape}, used {used.shape}, port_words "
                         f"{pw.shape}, {g} rows, demand {demand.shape}, "
                         f"freed {freed.shape}")
    _rows_in(rows_a, capacity.shape[0], lo=-1)
    ports_a, ports_off, freed_a, freed_off = _plan_ports(
        group_ports, group_freed_ports)
    out = np.empty(g, np.uint8)
    _native().validate_plan(
        _addr(capacity), _addr(used), _addr(pw), pw.shape[1], dims,
        _addr(rows_a), _addr(demand), _addr(freed), _addr(ports_a),
        _addr(ports_off), _addr(freed_a), _addr(freed_off), g, _addr(out))
    return out.astype(bool)


def validate_plan_plain(capacity: np.ndarray, used: np.ndarray,
                        port_words: np.ndarray,
                        rows: Sequence[int],
                        demand: np.ndarray, freed: np.ndarray,
                        group_ports: List[Sequence[int]],
                        group_freed_ports: List[Sequence[int]]
                        ) -> np.ndarray:
    capacity, used = _f32(capacity), _f32(used)
    rows_a = _i32(list(rows))
    demand, freed = _f32(demand), _f32(freed)
    out = np.zeros(len(rows_a), bool)
    for i in range(len(rows_a)):
        r = int(rows_a[i])
        if r < 0:
            continue
        fits = not np.any(used[r] + demand[i] - freed[i]
                          > capacity[r] + _EPS)
        out[i] = fits and ports_check_plain(
            port_words, r, group_ports[i], group_freed_ports[i])
    return out


# ------------------------------------------------------------ materialize

def expand_pairs(rows: np.ndarray, counts: np.ndarray,
                 scores: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten (row, count, score) triples into per-alloc (rows i32[K],
    scores f32[K]) arrays in placement order; K = counts.clip(0).sum()."""
    rows_a, counts_a = _i32(rows), _i32(counts)
    scores_a = np.zeros(rows_a.shape[0], np.float32) if scores is None \
        else _f32(scores)
    if counts_a.shape != rows_a.shape or scores_a.shape != rows_a.shape:
        raise ValueError(f"nomad_native: rows {rows_a.shape}, counts "
                         f"{counts_a.shape}, scores {scores_a.shape}")
    total = (sum(c for c in counts_a.tolist() if c > 0)
             if counts_a.size <= 64
             else int(np.maximum(counts_a, 0).sum(dtype=np.int64)))
    out_rows = np.empty(total, np.int32)
    out_scores = np.empty(total, np.float32)
    w = _native().expand_pairs(_addr(rows_a), _addr(counts_a),
                               _addr(scores_a), rows_a.shape[0],
                               _addr(out_rows), _addr(out_scores), total)
    if w != total:
        raise RuntimeError(f"nomad_native: expand_pairs wrote {w} of "
                           f"{total} allocs")
    return out_rows, out_scores


def expand_pairs_plain(rows: np.ndarray, counts: np.ndarray,
                       scores: Optional[np.ndarray] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    rows_a, counts_a = _i32(rows), _i32(counts)
    scores_a = np.zeros(rows_a.shape[0], np.float32) if scores is None \
        else _f32(scores)
    keep = counts_a > 0
    return (np.repeat(rows_a[keep], counts_a[keep]),
            np.repeat(scores_a[keep], counts_a[keep]))


def format_uuids(n: int) -> List[str]:
    """n fresh uuid strings in one call, byte-identical in format to
    utils.generate_uuid (hex of os.urandom(16), 8-4-4-4-12)."""
    if n <= 0:
        return []
    rnd = os.urandom(16 * n)
    out = ctypes.create_string_buffer(36 * n)
    _native().format_uuids(rnd, n, out)
    s = out.raw.decode("ascii")
    return [s[i:i + 36] for i in range(0, 36 * n, 36)]


def format_uuids_plain(n: int) -> List[str]:
    if n <= 0:
        return []
    h = os.urandom(16 * n).hex()
    return [f"{s[:8]}-{s[8:12]}-{s[12:16]}-{s[16:20]}-{s[20:]}"
            for s in (h[i * 32:(i + 1) * 32] for i in range(n))]
