"""The stage probe's units (K8a-K8f): the wave pipeline cut into its
stages, each a kernel of its own, and the same wave fused into one.

Torch port of the reference's parallel/stage_probe.py `_stage_fns`
(`feasibility`, `fit`, `score`, `argmax`, `scatter`) and `probe_fused`'s
`fused_wave`.  Each unit has two forms here:

* a plain PyTorch version (`*_plain`), written from the JAX function step
  for step: the specification, the CPU path, and what the CUDA kernel is
  held against on the card;
* a wrapper that launches the hand-written kernel (csrc/stage_probe.cu)
  for CUDA tensors, on their card's current stream with that card
  current (`_on_card`), takes the plain version for CPU tensors, and
  raises for anything else.  `launches` counts kernel launches only.

K8d and K8f sort nothing: their order is a stable partition of the rows
(the wave rows, then the others, each in row order), which
`argmax_model` and `fused_wave_model` write out in PyTorch for the tests.
K8e is one cluster over the greedy positions, each position's prefix
from one scan and each row written by the thread of its position;
`scatter_model` writes that out.

These compute what the reference's probe computes, which is not
production's wave (ops/place.py `_bulk_loop`): there is no strict set,
and the scatter does not mask the run lengths by the wave set, so rows
outside the wave take instances after the wave rows, in row order.
"""
from __future__ import annotations

from typing import Tuple

import torch

from nomad_tpu_torch.encode.matrixizer import NUM_RESOURCE_DIMS
from nomad_tpu_torch.ops import _build
from nomad_tpu_torch.ops.fit import score_fit
from nomad_tpu_torch.ops.place import (
    FIT_NORM, _check, _device_of, _on_card, _ptr, _stream, bulk_run_lengths,
    _lax_top_k, bulk_wave_grid)

# kernel launches per wrapper (the plain versions never count)
launches = {"stage_feasibility": 0, "stage_fit": 0, "stage_score": 0,
            "stage_argmax": 0, "stage_scatter": 0, "stage_fused_wave": 0}

_F32, _I32 = torch.float32, torch.int32


# --------------------------------------------------------------- plain

def feasibility_plain(capacity, used, demand, feasible, ms):
    """(util_m f32[N, M, R], fits_m bool[N, M]): the usage and the fit
    check of every row with m more instances placed on it."""
    util_m = used[:, None, :] + ms[None, :, None] * demand
    fits_m = (torch.all(util_m <= capacity[:, None, :], dim=-1)
              & feasible[:, None])
    return util_m, fits_m


def fit_plain(capacity, util_m):
    """f32[N, M]: the binpack fit score of each cell over 18."""
    return score_fit(capacity[:, None, :], util_m, False) * FIT_NORM


def score_plain(fit_m, coll, ms, desired_f: float, penalty, affinity,
                has_affinity: bool):
    """f32[N, M]: the scoring stack (anti-affinity, penalty, affinity)
    normalized by the number of scorers."""
    coll_1 = coll[:, None].to(_F32) + ms[None, :]
    coll_m = coll_1 - 1.0
    total_m = fit_m
    n_sc = torch.ones_like(fit_m)
    # a tensor divisor keeps this a true division on every device (CUDA
    # PyTorch turns division by a host scalar into a reciprocal multiply);
    # Python's max keeps a NaN desired_f, as the reference's jnp.maximum
    div = torch.tensor(max(float(desired_f), 1.0), dtype=_F32,
                       device=fit_m.device)
    # the reference's -(coll_m + 1.0) / div as XLA compiles it: it folds
    # (x - 1) + 1 to x, which differs once coll + m passes 2^24
    anti_m = -coll_1 / div
    has_coll_m = coll_m > 0.0
    total_m = total_m + torch.where(has_coll_m, anti_m,
                                    torch.zeros_like(anti_m))
    n_sc = n_sc + has_coll_m.to(_F32)
    total_m = total_m - penalty[:, None]
    n_sc = n_sc + penalty[:, None]
    aff_on = (affinity != 0.0) & bool(has_affinity)
    total_m = total_m + torch.where(aff_on[:, None], affinity[:, None],
                                    torch.zeros_like(affinity[:, None]))
    n_sc = n_sc + aff_on[:, None].to(_F32)
    return total_m / n_sc


def _order(wave, cur):
    """Stable argsort of where(wave, -cur, +inf), as i32."""
    key = torch.where(wave, -cur, torch.full_like(cur, float("inf")))
    return torch.argsort(key, stable=True).to(_I32)


def _wave_start(fits_m, score_m):
    """(cur, top1, second, wave) of the wave, its top-2 of cur as
    `lax.top_k` ranks it (a NaN by its sign)."""
    fits = fits_m[:, 0]
    cur = torch.where(fits, score_m[:, 0],
                      torch.full_like(score_m[:, 0], float("-inf")))
    top1, top2 = _lax_top_k(cur, 2)[0]
    second = torch.where(cur == top1, top2, top1)
    return cur, top1, second, fits & (cur == top1)


def argmax_plain(fits_m, score_m, ms):
    """(run i32[N], order i32[N]): each row's greedy fill run against the
    best wave-start score among the others (m = 1 forced), and the
    greedy order (wave rows by score desc, then the rest, row asc)."""
    cur, _, second, wave = _wave_start(fits_m, score_m)
    run = bulk_run_lengths(ms, fits_m, score_m, second).to(_I32)
    return run, _order(wave, cur)


def scatter_plain(run, order, count: int, used, demand, coll):
    """(used2 f32[N, R], coll2 i32[N], placed i32): the runs in greedy
    order, capped cumulatively at `count`, scattered back to their rows."""
    o = order.long()
    base_sorted = run[o].to(torch.int64)
    prefix = torch.cumsum(base_sorted, dim=0) - base_sorted
    alloc_sorted = torch.minimum(torch.clamp(int(count) - prefix, min=0),
                                 base_sorted)
    per_node = torch.zeros(run.shape[0], dtype=_I32, device=run.device)
    per_node[o] = alloc_sorted.to(_I32)
    used2 = used + per_node[:, None].to(_F32) * demand
    return used2, coll + per_node, torch.sum(per_node).to(_I32)


def fused_wave_plain(capacity, used, demand, feasible, affinity,
                     has_affinity: bool, desired_f: float, penalty, coll,
                     count: int, fill_grid: int):
    """(used2, coll2, placed): one wave of the probe, the composition of
    the five units through the shared wave grid (ops/place.py
    `bulk_wave_grid`, `bulk_run_lengths`)."""
    ms, fits_m, score_m = bulk_wave_grid(
        capacity, used, demand, feasible, affinity, has_affinity,
        float(desired_f), penalty, coll, False, fill_grid)
    run, order = argmax_plain(fits_m, score_m, ms)
    return scatter_plain(run, order, count, used, demand, coll)


# --------------------------------------------------------------- models

def _first_fail_runs(ms, fits_m, score_m, second):
    """i64[N]: K8d's and K8f's run, the first m whose cell fails less one
    (M where none fails); a cell fails where the row does not fit m more
    or, past m = 1, its score does not beat `second`."""
    ok = fits_m & ((score_m > second[:, None]) | (ms[None, :] == 1.0))
    fail = ~ok
    M = fits_m.shape[1]
    return torch.where(torch.any(fail, dim=1),
                       torch.argmax(fail.to(_I32), dim=1),
                       torch.full_like(fail[:, 0], M, dtype=torch.int64))


# blocks of K8d's, K8e's and K8f's cluster (csrc/stage_probe.cu
# PROBE_CLUSTER)
PROBE_CLUSTER = 16


def scatter_model(run, order, count: int, used, demand, coll,
                  blocks: int = PROBE_CLUSTER):
    """K8e's algorithm (csrc/stage_probe.cu) in PyTorch, which the tests
    hold equal to `scatter_plain` and the reference: the greedy positions
    k split into `blocks` contiguous ranges as the cluster splits them,
    each block's inclusive prefix of run[order[k]] in position order,
    then the exclusive sum of the blocks' totals added; each position's
    instances clip(count - prefix, 0, run) written straight to its row
    order[k] (a permutation: every row once).  placed is clip(count, 0,
    all runs), the sum of the clipped runs (runs >= 0, K8d's)."""
    n = run.shape[0]
    o = order.long()
    base = run[o].to(torch.int64)
    rpb = -(-n // blocks)
    prefix = torch.empty_like(base)
    totals = 0
    for b in range(blocks):
        lo, hi = min(b * rpb, n), min((b + 1) * rpb, n)
        part = base[lo:hi]
        prefix[lo:hi] = totals + torch.cumsum(part, 0) - part
        totals += int(torch.sum(part))
    per_node = torch.empty(n, dtype=_I32, device=run.device)
    per_node[o] = torch.minimum(torch.clamp(int(count) - prefix, min=0),
                                base).to(_I32)
    used2 = used + per_node[:, None].to(_F32) * demand
    placed = min(max(int(count), 0), totals)
    return used2, coll + per_node, torch.tensor(placed, dtype=_I32,
                                                device=used.device)


def _partition(wave, val):
    """K8d's and K8f's pair scan: (px, py, X, Y), the exclusive row-order
    prefixes of the pair (val of a wave row, val of any other row) and
    its totals; val is 1 a row for K8d's order, the run for K8f."""
    x = torch.where(wave, val, torch.zeros_like(val))
    y = torch.where(wave, torch.zeros_like(val), val)
    px, py = torch.cumsum(x, 0) - x, torch.cumsum(y, 0) - y
    return px, py, int(torch.sum(x)), int(torch.sum(y))


def argmax_model(fits_m, score_m, ms):
    """K8d's algorithm (csrc/stage_probe.cu) in PyTorch, which the tests
    hold equal to `argmax_plain` and the reference: no sort.  Every wave
    row has cur == top1, so `where(wave, -cur, +inf)` takes two values and
    its stable argsort is a stable partition: a wave row's place is the
    wave rows before it in row order, any other row's the wave's size
    plus the other rows before it.  Where top1 is -inf the wave rows' key
    is +inf too and the order is the rows' own."""
    _, top1, second, wave = _wave_start(fits_m, score_m)
    run = _first_fail_runs(ms, fits_m, score_m, second)
    rows = torch.arange(run.shape[0], device=run.device)
    if float(top1) == float("-inf"):
        return run.to(_I32), rows.to(_I32)
    px, py, nx, _ = _partition(wave, torch.ones_like(run))
    order = torch.empty_like(rows)
    order[torch.where(wave, px, nx + py)] = rows
    return run.to(_I32), order.to(_I32)


def fused_wave_model(capacity, used, demand, feasible, affinity,
                     has_affinity: bool, desired_f: float, penalty, coll,
                     count: int, fill_grid: int):
    """K8f's algorithm in PyTorch, held to `fused_wave_plain`: no order.
    A row's prefix in the greedy order comes from one row-order scan of
    the pair (run if in the wave, run if not): a wave row's is the wave
    runs before it, any other row's the wave's total plus the other runs
    before it (all runs before it where top1 is -inf).  placed is
    clip(count, 0, all runs), the sum of the clipped runs."""
    ms, fits_m, score_m = bulk_wave_grid(
        capacity, used, demand, feasible, affinity, has_affinity,
        float(desired_f), penalty, coll, False, fill_grid)
    _, top1, second, wave = _wave_start(fits_m, score_m)
    run = _first_fail_runs(ms, fits_m, score_m, second)
    px, py, nx, ny = _partition(wave, run)
    if float(top1) == float("-inf"):
        prefix = px + py
    else:
        prefix = torch.where(wave, px, nx + py)
    per_node = torch.minimum(torch.clamp(int(count) - prefix, min=0),
                             run).to(_I32)
    used2 = used + per_node[:, None].to(_F32) * demand
    placed = min(max(int(count), 0), nx + ny)
    return used2, coll + per_node, torch.tensor(placed, dtype=_I32,
                                                device=used.device)


# --------------------------------------------------------------- wrappers

def _rows(x) -> Tuple[int, torch.device]:
    """(rows, device) of a wrapper's leading input."""
    return x.shape[0], _device_of(x)


def _launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1


def _check_r(name: str, R: int) -> None:
    if R != NUM_RESOURCE_DIMS:
        raise ValueError(f"{name}: R={R}, kernel takes {NUM_RESOURCE_DIMS}")


def _check_rows16(name: str, *ts) -> None:
    """The kernel reads an [N, R] row as one aligned float4."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads a row as one "
                             f"aligned float4")


def feasibility(capacity, used, demand, feasible, ms):
    """K8a wrapper, as `feasibility_plain`."""
    N, dev = _rows(capacity)
    if dev.type == "cpu":
        return feasibility_plain(capacity, used, demand, feasible, ms)
    R, M = capacity.shape[1], ms.shape[0]
    _check_r("stage_feasibility", R)
    _check("feasibility.capacity", capacity, dev, _F32, (N, R))
    _check("feasibility.used", used, dev, _F32, (N, R))
    _check("feasibility.demand", demand, dev, _F32, (R,))
    _check("feasibility.feasible", feasible, dev, torch.bool, (N,))
    _check("feasibility.ms", ms, dev, _F32, (M,))
    _check_rows16("stage_feasibility", capacity, used)
    util_m = torch.empty((N, M, R), dtype=_F32, device=dev)
    fits_m = torch.empty((N, M), dtype=torch.bool, device=dev)
    rc = _on_card(
        dev.index, _build.load("stage_probe").feasibility_launch,
        _ptr(capacity), _ptr(used), _ptr(demand), _ptr(feasible), _ptr(ms),
        N, M, _ptr(util_m), _ptr(fits_m), _stream(dev))
    _launch("stage_feasibility", rc)
    return util_m, fits_m


def fit(capacity, util_m):
    """K8b wrapper, as `fit_plain`."""
    N, dev = _rows(capacity)
    if dev.type == "cpu":
        return fit_plain(capacity, util_m)
    R, M = capacity.shape[1], util_m.shape[1]
    _check_r("stage_fit", R)
    _check("fit.capacity", capacity, dev, _F32, (N, R))
    _check("fit.util_m", util_m, dev, _F32, (N, M, R))
    _check_rows16("stage_fit", capacity, util_m)
    fit_m = torch.empty((N, M), dtype=_F32, device=dev)
    rc = _on_card(
        dev.index, _build.load("stage_probe").fit_launch,
        _ptr(capacity), _ptr(util_m), N, M, _ptr(fit_m), _stream(dev))
    _launch("stage_fit", rc)
    return fit_m


def score(fit_m, coll, ms, desired_f: float, penalty, affinity,
          has_affinity: bool):
    """K8c wrapper, as `score_plain`."""
    N, dev = _rows(fit_m)
    if dev.type == "cpu":
        return score_plain(fit_m, coll, ms, desired_f, penalty, affinity,
                           has_affinity)
    M = fit_m.shape[1]
    _check("score.fit_m", fit_m, dev, _F32, (N, M))
    _check("score.coll", coll, dev, _I32, (N,))
    _check("score.ms", ms, dev, _F32, (M,))
    _check("score.penalty", penalty, dev, _F32, (N,))
    _check("score.affinity", affinity, dev, _F32, (N,))
    score_m = torch.empty((N, M), dtype=_F32, device=dev)
    rc = _on_card(
        dev.index, _build.load("stage_probe").score_launch,
        _ptr(fit_m), _ptr(coll), _ptr(ms), float(desired_f), _ptr(penalty),
        _ptr(affinity), int(bool(has_affinity)), N, M, _ptr(score_m),
        _stream(dev))
    _launch("stage_score", rc)
    return score_m


def argmax(fits_m, score_m, ms):
    """K8d wrapper, as `argmax_plain`."""
    N, dev = _rows(fits_m)
    if dev.type == "cpu":
        return argmax_plain(fits_m, score_m, ms)
    M = fits_m.shape[1]
    if N < 2:
        raise ValueError(f"stage_argmax: N={N}; the top-2 needs 2 rows")
    _check("argmax.fits_m", fits_m, dev, torch.bool, (N, M))
    _check("argmax.score_m", score_m, dev, _F32, (N, M))
    _check("argmax.ms", ms, dev, _F32, (M,))
    run = torch.empty(N, dtype=_I32, device=dev)
    order = torch.empty(N, dtype=_I32, device=dev)
    rc = _on_card(
        dev.index, _build.load("stage_probe").argmax_launch,
        _ptr(fits_m), _ptr(score_m), _ptr(ms), N, M, _ptr(run), _ptr(order),
        _stream(dev))
    _launch("stage_argmax", rc)
    return run, order


def scatter(run, order, count: int, used, demand, coll):
    """K8e wrapper, as `scatter_plain`; `order` must be a permutation of
    the rows and the runs >= 0 (K8d's outputs)."""
    N, dev = _rows(used)
    if dev.type == "cpu":
        return scatter_plain(run, order, count, used, demand, coll)
    R = used.shape[1]
    _check_r("stage_scatter", R)
    if N < 1:
        raise ValueError("stage_scatter: N=0")
    _check("scatter.run", run, dev, _I32, (N,))
    _check("scatter.order", order, dev, _I32, (N,))
    _check("scatter.used", used, dev, _F32, (N, R))
    _check("scatter.demand", demand, dev, _F32, (R,))
    _check("scatter.coll", coll, dev, _I32, (N,))
    _check_rows16("stage_scatter", used)
    used2 = torch.empty((N, R), dtype=_F32, device=dev)
    coll2 = torch.empty(N, dtype=_I32, device=dev)
    placed = torch.empty((), dtype=_I32, device=dev)
    rc = _on_card(
        dev.index, _build.load("stage_probe").scatter_launch,
        _ptr(run), _ptr(order), int(count), _ptr(used), _ptr(demand),
        _ptr(coll), N, _ptr(used2), _ptr(coll2), _ptr(placed),
        _stream(dev))
    _launch("stage_scatter", rc)
    return used2, coll2, placed


def fused_wave(capacity, used, demand, feasible, affinity,
               has_affinity: bool, desired_f: float, penalty, coll,
               count: int, fill_grid: int):
    """K8f wrapper, as `fused_wave_plain`."""
    N, dev = _rows(capacity)
    if dev.type == "cpu":
        return fused_wave_plain(capacity, used, demand, feasible, affinity,
                                has_affinity, desired_f, penalty, coll,
                                count, fill_grid)
    R = capacity.shape[1]
    _check_r("stage_fused_wave", R)
    if N < 2 or fill_grid < 1:
        raise ValueError(f"stage_fused_wave: N={N}, fill_grid={fill_grid}; "
                         f"the top-2 needs 2 rows and the grid a column")
    _check("fused_wave.capacity", capacity, dev, _F32, (N, R))
    _check("fused_wave.used", used, dev, _F32, (N, R))
    _check("fused_wave.demand", demand, dev, _F32, (R,))
    _check("fused_wave.feasible", feasible, dev, torch.bool, (N,))
    _check("fused_wave.affinity", affinity, dev, _F32, (N,))
    _check("fused_wave.penalty", penalty, dev, _F32, (N,))
    _check("fused_wave.coll", coll, dev, _I32, (N,))
    used2 = torch.empty((N, R), dtype=_F32, device=dev)
    coll2 = torch.empty(N, dtype=_I32, device=dev)
    placed = torch.empty((), dtype=_I32, device=dev)
    rc = _on_card(
        dev.index, _build.load("stage_probe").fused_wave_launch,
        _ptr(capacity), _ptr(used), _ptr(demand), _ptr(feasible),
        _ptr(affinity), int(bool(has_affinity)), float(desired_f),
        _ptr(penalty), _ptr(coll), int(count), int(fill_grid), N,
        _ptr(used2), _ptr(coll2), _ptr(placed), _stream(dev))
    _launch("stage_fused_wave", rc)
    return used2, coll2, placed
