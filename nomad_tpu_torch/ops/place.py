"""The dense placement kernels: sequential scan (K2), bulk wavefront
(K1), and their chained batches over the packed transport (K3, K4).

Torch port of the reference's ops/place.py kernels
(`place_eval_packed_jit` / `place_eval_jit`, `place_bulk_jit`,
`place_batch_packed_jit`, `_place_bulk_batch`).  Each kernel has two
forms here:

* a plain PyTorch version (`place_eval_plain`, `place_bulk_plain`,
  `place_batch_packed_plain`, `place_bulk_batch_plain`), written from
  the JAX functions step for step: Python loops over evals, slots or
  waves with tensor ops inside.  It is the specification, the CPU path,
  and what the CUDA kernel is held against on the card;
* a wrapper (`place_eval_packed` / `place_eval`, `place_bulk`,
  `place_batch_packed`, `place_bulk_batch`) that launches the
  hand-written CUDA kernel (csrc/place_scan.cu, csrc/place_bulk.cu) for
  CUDA tensors, takes the plain version for CPU tensors, and raises for
  anything else.  `launches` counts kernel launches only.

The packed transports (`pack_heavy`/`pack_light`,
`pack_bulk_heavy`/`pack_bulk_light`) are host (numpy) functions with the
reference's layouts: integers value-encoded as f32 (exact below 2^24),
booleans as 0/1.

Semantics (tie-breaking, packed layouts, value-encoded integers) are the
reference's: argmax takes the lowest node row among equal maxima, top-K
is ordered like `lax.top_k` (descending, lower index first on ties), the
bulk wave set is ordered by a stable argsort (score desc, row asc).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, fields
from typing import Optional, Tuple

import numpy as np
import torch

from nomad_tpu_torch.encode.matrixizer import NUM_RESOURCE_DIMS
from nomad_tpu_torch.ops import _build
from nomad_tpu_torch.ops.fit import score_fit

TOP_K = 5  # score_meta entries kept per placement (structs.go:10341 kheap)
# m-grid bound for the bulk kernel's per-node fill-run length: a run
# longer than the grid just continues next wave
_FILL_GRID = 64
# grid width buckets: a wave whose eval places `count` instances never
# fills a run past count, so the grid beyond M = count is wasted work
FILL_GRID_BUCKETS = (16, _FILL_GRID)
PACKED_WIDTH = 5 + 2 * TOP_K
# the scoring stack normalizes the fit score by 18; XLA folds the
# reference's division by that constant into a multiply by its f32
# reciprocal, so the port multiplies by the same f32 constant (the CUDA
# kernels use 1.0f / 18.0f, the identical value)
FIT_NORM = float(np.float32(1.0) / np.float32(18.0))
# the bulk kernel sorts its wave set in shared memory, 8 bytes a row
BULK_MAX_ROWS = 16384
# the scan kernel keeps per-spread statistics in shared memory
SCAN_MAX_SPREADS = 64

# kernel launches per wrapper (the plain versions never count)
launches = {"place_bulk": 0, "place_scan": 0, "place_batch": 0,
            "place_bulk_batch": 0}


def fill_grid_for(max_count: int) -> int:
    """Smallest fill-grid bucket that lets the wave's longest possible
    run complete in one wave (capped at _FILL_GRID)."""
    for m in FILL_GRID_BUCKETS:
        if max_count <= m:
            return m
    return _FILL_GRID


@dataclass
class PlaceInputs:
    """Dense inputs for one evaluation's placement pass (torch tensors on
    one device).

    Axes: N nodes, G task groups, S placement slots, K spread attributes,
    V spread attribute values (all padded).
    """
    capacity: torch.Tensor        # f32[N, R]
    used: torch.Tensor            # f32[N, R]  proposed-usage basis
    feasible: torch.Tensor        # bool[G, N]
    affinity: torch.Tensor        # f32[G, N]
    has_affinity: torch.Tensor    # bool[G]
    desired_count: torch.Tensor   # i32[G]
    penalty: torch.Tensor         # bool[G, N]
    tg_count: torch.Tensor        # i32[G, N] existing co-placed (job, tg) allocs
    spread_vidx: torch.Tensor     # i32[G, K, N] value index per node (V = missing)
    spread_desired: torch.Tensor  # f32[G, K, V+1] desired counts, -1 = no target
    spread_targeted: torch.Tensor # bool[G, K] targets specified vs even-spread
    spread_wfrac: torch.Tensor    # f32[G, K] weight / sum(|weights|)
    spread_counts: torch.Tensor   # f32[G, K, V+1] initial per-value counts
    spread_active: torch.Tensor   # bool[G, K]
    place_cap: torch.Tensor       # i32[G, N] per-node instance budget (-1 = unlimited)
    demand: torch.Tensor          # f32[S, R]
    slot_tg: torch.Tensor         # i32[S]
    slot_active: torch.Tensor     # bool[S]


# dtype of every PlaceInputs field, in declaration order
PLACE_INPUT_DTYPES = {
    "capacity": torch.float32, "used": torch.float32,
    "feasible": torch.bool, "affinity": torch.float32,
    "has_affinity": torch.bool, "desired_count": torch.int32,
    "penalty": torch.bool, "tg_count": torch.int32,
    "spread_vidx": torch.int32, "spread_desired": torch.float32,
    "spread_targeted": torch.bool, "spread_wfrac": torch.float32,
    "spread_counts": torch.float32, "spread_active": torch.bool,
    "place_cap": torch.int32, "demand": torch.float32,
    "slot_tg": torch.int32, "slot_active": torch.bool,
}


@dataclass
class PlaceResult:
    node: np.ndarray              # i32[S] selected node row, -1 = no placement
    score: np.ndarray             # f32[S] final normalized score of the pick
    fit_score: np.ndarray         # f32[S] raw binpack/spread component of the pick
    nodes_evaluated: np.ndarray   # i32[S] feasible nodes considered
    nodes_exhausted: np.ndarray   # i32[S] feasible but resource-exhausted nodes
    top_nodes: np.ndarray         # i32[S, TOP_K]
    top_scores: np.ndarray        # f32[S, TOP_K]
    used: torch.Tensor            # f32[N, R] final proposed usage (on the device)


def _lax_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` order: descending values, lower index first on ties."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


# --------------------------------------------------------------------------
# K2: the sequential scan over placement slots
# --------------------------------------------------------------------------

def _spread_boost(inp: PlaceInputs, g: int, counts: torch.Tensor) -> torch.Tensor:
    """f32[N]: total spread score per node for task group `g` given current
    per-value counts f32[K, V+1] (reference scheduler/spread.go:116-272)."""
    vidx = inp.spread_vidx[g].long()     # [K, N]
    desired = inp.spread_desired[g]      # [K, V+1]
    targeted = inp.spread_targeted[g]    # [K]
    wfrac = inp.spread_wfrac[g]          # [K]
    active = inp.spread_active[g]        # [K]
    V = desired.shape[1] - 1             # last slot = "missing attribute"

    missing = vidx >= V
    safe_idx = torch.clamp(vidx, max=V)
    cur = torch.gather(counts, 1, safe_idx)
    des = torch.gather(desired, 1, safe_idx)
    neg1 = torch.full_like(cur, -1.0)

    # targeted spread: ((desired - (used+1)) / desired) * weight_frac
    has_target = des >= 0.0
    t_boost = torch.where(
        missing, neg1,
        torch.where(has_target,
                    (des - (cur + 1.0)) / torch.clamp(des, min=1e-9)
                    * wfrac[:, None],
                    neg1))

    # even spread: boost from delta vs min/max of *placed* values
    placed = counts[:, :V] > 0.0
    any_placed = torch.any(placed, dim=1)
    big = torch.tensor(3.4e38, dtype=torch.float32, device=counts.device)
    minc = torch.min(torch.where(placed, counts[:, :V], big), dim=1).values
    maxc = torch.max(torch.where(placed, counts[:, :V], -big), dim=1).values
    minc_ = torch.clamp(minc, min=1e-9)
    at_min = cur == minc[:, None]
    e_boost = torch.where(
        ~at_min, (minc[:, None] - cur) / minc_[:, None],
        torch.where((minc == maxc)[:, None], neg1,
                    ((maxc - minc) / minc_)[:, None].expand_as(cur)))
    e_boost = torch.where(missing, neg1, e_boost)
    e_boost = torch.where(any_placed[:, None], e_boost, torch.zeros_like(cur))

    boost = torch.where(targeted[:, None], t_boost, e_boost)
    return torch.sum(torch.where(active[:, None], boost,
                                 torch.zeros_like(boost)), dim=0)


def place_eval_plain(inp: PlaceInputs, spread_algorithm: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2 (`place_eval_packed_jit`): returns (packed
    f32[S, 5 + 2*TOP_K], final used f32[N, R]), on the inputs' device."""
    dev = inp.capacity.device
    f32 = torch.float32
    N = inp.capacity.shape[0]
    S = inp.demand.shape[0]
    used = inp.used.clone()
    tg_count = inp.tg_count.clone()
    spread_counts = inp.spread_counts.clone()
    place_cap = inp.place_cap.clone()
    Vp1 = spread_counts.shape[-1]
    rows = torch.arange(N, device=dev)
    out = torch.empty((S, PACKED_WIDTH), dtype=f32, device=dev)
    for s in range(S):
        g = int(inp.slot_tg[s])
        d = inp.demand[s]
        active = inp.slot_active[s]

        feas = inp.feasible[g] & (place_cap[g] != 0)
        util = used + d
        fits = torch.all(util <= inp.capacity, dim=-1) & feas

        # scoring stack (normalization = mean over appended scorers only,
        # reference rank.go ScoreNormalizationIterator)
        fit_score = score_fit(inp.capacity, util, spread_algorithm) * FIT_NORM
        total = fit_score
        n_scorers = torch.ones_like(fit_score)

        coll = tg_count[g].to(f32)
        anti = -(coll + 1.0) / torch.clamp(inp.desired_count[g].to(f32), min=1.0)
        has_coll = coll > 0.0
        total = total + torch.where(has_coll, anti, torch.zeros_like(anti))
        n_scorers = n_scorers + has_coll.to(f32)

        pen = inp.penalty[g].to(f32)
        total = total - pen
        n_scorers = n_scorers + pen

        aff = inp.affinity[g]
        aff_on = inp.has_affinity[g] & (aff != 0.0)
        total = total + torch.where(aff_on, aff, torch.zeros_like(aff))
        n_scorers = n_scorers + aff_on.to(f32)

        sboost = _spread_boost(inp, g, spread_counts[g])
        sb_on = torch.any(inp.spread_active[g]) & (sboost != 0.0)
        total = total + torch.where(sb_on, sboost, torch.zeros_like(sboost))
        n_scorers = n_scorers + sb_on.to(f32)

        final = total / n_scorers
        masked = torch.where(fits & active, final,
                             torch.full_like(final, float("-inf")))

        top_scores, top_nodes = _lax_top_k(masked, TOP_K)
        sel = top_nodes[0]                     # argmax, lowest row on ties
        ok = masked[sel] > float("-inf")

        # carry updates
        sel_onehot = (rows == sel) & ok
        used = used + torch.where(sel_onehot[:, None], d, torch.zeros_like(used))
        tg_count[g, sel] += ok.to(torch.int32)
        place_cap[g, sel] += torch.where(ok & (place_cap[g, sel] > 0), -1, 0) \
            .to(torch.int32)
        v = inp.spread_vidx[g, :, sel].long()                  # [K]
        upd = torch.nn.functional.one_hot(torch.clamp(v, max=Vp1 - 1),
                                          Vp1).to(f32)
        upd = upd * (inp.spread_active[g] & (v < Vp1 - 1))[:, None].to(f32) \
            * ok.to(f32)
        spread_counts[g] = spread_counts[g] + upd

        out[s, 0] = torch.where(ok, sel, -1).to(f32)
        out[s, 1] = torch.where(ok, masked[sel], 0.0)
        out[s, 2] = torch.where(ok, fit_score[sel], 0.0)
        out[s, 3] = torch.sum(feas & active).to(f32)
        out[s, 4] = torch.sum(feas & ~fits & active).to(f32)
        out[s, 5:5 + TOP_K] = top_nodes.to(f32)
        out[s, 5 + TOP_K:] = top_scores
    return out, used


def unpack_outputs(packed: np.ndarray):
    """Host-side inverse of the packed scan output.
    packed: f32[..., S, 5 + 2*TOP_K]."""
    as_i = lambda x: np.rint(x).astype(np.int32)
    node = as_i(packed[..., 0])
    score = packed[..., 1]
    fit_s = packed[..., 2]
    n_eval = as_i(packed[..., 3])
    n_exh = as_i(packed[..., 4])
    top_n = as_i(packed[..., 5:5 + TOP_K])
    top_s = packed[..., 5 + TOP_K:5 + 2 * TOP_K]
    return node, score, fit_s, n_eval, n_exh, top_n, top_s


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _check(name: str, t: torch.Tensor, dev: torch.device, dtype,
           shape: Tuple[int, ...]) -> None:
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _device_of(t: torch.Tensor) -> torch.device:
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"nomad_tpu_torch.ops.place: unsupported device {dev}")
    return dev


def place_eval_packed(inp: PlaceInputs, spread_algorithm: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 wrapper: (packed f32[S, 5 + 2*TOP_K], used f32[N, R]).  CUDA
    tensors launch csrc/place_scan.cu; CPU tensors take the plain version."""
    dev = _device_of(inp.capacity)
    if dev.type == "cpu":
        return place_eval_plain(inp, spread_algorithm)
    N, R = inp.capacity.shape
    G = inp.feasible.shape[0]
    K = inp.spread_wfrac.shape[1]
    Vp1 = inp.spread_desired.shape[2]
    S = inp.demand.shape[0]
    if R != NUM_RESOURCE_DIMS:
        raise ValueError(f"place_eval: R={R}, kernel takes {NUM_RESOURCE_DIMS}")
    if N < TOP_K:
        raise ValueError(f"place_eval: N={N} < TOP_K={TOP_K}")
    if not 1 <= K <= SCAN_MAX_SPREADS:
        raise ValueError(f"place_eval: K={K}, kernel takes 1..{SCAN_MAX_SPREADS}")
    shapes = {
        "capacity": (N, R), "used": (N, R), "feasible": (G, N),
        "affinity": (G, N), "has_affinity": (G,), "desired_count": (G,),
        "penalty": (G, N), "tg_count": (G, N), "spread_vidx": (G, K, N),
        "spread_desired": (G, K, Vp1), "spread_targeted": (G, K),
        "spread_wfrac": (G, K), "spread_counts": (G, K, Vp1),
        "spread_active": (G, K), "place_cap": (G, N), "demand": (S, R),
        "slot_tg": (S,), "slot_active": (S,),
    }
    for f in fields(PlaceInputs):
        _check(f"place_eval.{f.name}", getattr(inp, f.name), dev,
               PLACE_INPUT_DTYPES[f.name], shapes[f.name])
    lib = _build.load("place_scan")
    packed = torch.empty((S, PACKED_WIDTH), dtype=torch.float32, device=dev)
    used = torch.empty((N, R), dtype=torch.float32, device=dev)
    tg_count = torch.empty((G, N), dtype=torch.int32, device=dev)
    place_cap = torch.empty((G, N), dtype=torch.int32, device=dev)
    counts = torch.empty((G, K, Vp1), dtype=torch.float32, device=dev)
    rc = lib.place_scan_launch(
        _ptr(inp.capacity), _ptr(inp.used), _ptr(inp.feasible),
        _ptr(inp.affinity), _ptr(inp.has_affinity), _ptr(inp.desired_count),
        _ptr(inp.penalty), _ptr(inp.tg_count), _ptr(inp.spread_vidx),
        _ptr(inp.spread_desired), _ptr(inp.spread_targeted),
        _ptr(inp.spread_wfrac), _ptr(inp.spread_counts),
        _ptr(inp.spread_active), _ptr(inp.place_cap), _ptr(inp.demand),
        _ptr(inp.slot_tg), _ptr(inp.slot_active),
        G, N, K, Vp1, S, int(bool(spread_algorithm)),
        _ptr(packed), _ptr(used), _ptr(tg_count), _ptr(place_cap),
        _ptr(counts), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"place_scan kernel launch failed: CUDA error {rc}")
    launches["place_scan"] += 1
    return packed, used


def place_eval(inp: PlaceInputs, spread_algorithm: bool = False) -> PlaceResult:
    """Place all slots of one evaluation; host (numpy) per-slot results,
    fetched in one device-to-host copy of the packed output.  The final
    `used` matrix stays on the device."""
    packed, used = place_eval_packed(inp, spread_algorithm)
    node, score, fit_s, n_eval, n_exh, top_n, top_s = unpack_outputs(
        packed.cpu().numpy())
    return PlaceResult(node=node, score=score, fit_score=fit_s,
                       nodes_evaluated=n_eval, nodes_exhausted=n_exh,
                       top_nodes=top_n, top_scores=top_s, used=used)


# --------------------------------------------------------------------------
# K1: the bulk wavefront
# --------------------------------------------------------------------------

def bulk_wave_grid(capacity, used, demand, feasible, affinity, has_affinity,
                   desired_f: float, penalty, coll, spread_algorithm: bool,
                   fill_grid: int = _FILL_GRID):
    """The [N, M] per-wave fill/scoring grid: column m is every node's
    score/fitness with m more instances placed on it.  Returns
    (ms f32[M], fits_m bool[N, M], score_m f32[N, M])."""
    f32 = torch.float32
    ms = torch.arange(1, fill_grid + 1, dtype=f32, device=capacity.device)
    util_m = used[:, None, :] + ms[None, :, None] * demand      # [N, M, R]
    fits_m = (torch.all(util_m <= capacity[:, None, :], dim=-1)
              & feasible[:, None])
    fit_m = score_fit(capacity[:, None, :], util_m, spread_algorithm) * FIT_NORM
    coll_m = coll[:, None].to(f32) + ms[None, :] - 1.0
    total_m = fit_m
    n_sc = torch.ones_like(fit_m)
    # a tensor divisor keeps this a true division on every device (CUDA
    # PyTorch turns division by a host scalar into a reciprocal multiply)
    div = torch.tensor(max(desired_f, 1.0), dtype=f32, device=capacity.device)
    anti_m = -(coll_m + 1.0) / div
    has_coll_m = coll_m > 0.0
    total_m = total_m + torch.where(has_coll_m, anti_m, torch.zeros_like(anti_m))
    n_sc = n_sc + has_coll_m.to(f32)
    pen = penalty.to(f32)[:, None]
    total_m = total_m - pen
    n_sc = n_sc + pen
    aff_on = (affinity != 0.0) & bool(has_affinity)               # [N]
    total_m = total_m + torch.where(aff_on[:, None], affinity[:, None],
                                    torch.zeros_like(affinity[:, None]))
    n_sc = n_sc + aff_on[:, None].to(f32)
    return ms, fits_m, total_m / n_sc


def bulk_run_lengths(ms, fits_m, score_m, second):
    """Per-node greedy fill runs from the wave grid: leading m's where the
    node still fits and score_m strictly beats `second`; m=1 is forced."""
    ok_m = fits_m & ((score_m > second[:, None]) | (ms[None, :] == 1.0))
    return torch.sum(torch.cumprod(ok_m.to(torch.int32), dim=1), dim=1)


def place_bulk_plain(capacity, used0, feasible, affinity, has_affinity: bool,
                     desired: int, penalty, coll0, demand, count: int,
                     spread_algorithm: bool = False, max_waves: int = 65536,
                     fill_grid: int = _FILL_GRID) -> torch.Tensor:
    """Plain version of K1 (`place_bulk_jit`): wavefront placement of
    `count` identical slots of one group.  Returns the packed f32[N, R+3]
    leaf: cols [0,R) used, col R assign, col R+1 scores, col R+2 rows 0-3
    placed/n_eval/n_exh/waves."""
    dev = capacity.device
    f32 = torch.float32
    N, R = capacity.shape
    desired_f = float(desired)
    count = int(count)
    neg_inf = float("-inf")
    used = used0.clone()
    coll = coll0.clone()
    assign = torch.zeros(N, dtype=torch.int32, device=dev)
    placed, waves, stuck = 0, 0, False
    while placed < count and not stuck and waves < max_waves:
        ms, fits_m, score_m = bulk_wave_grid(
            capacity, used, demand, feasible, affinity, has_affinity,
            desired_f, penalty, coll, spread_algorithm, fill_grid)
        fits = fits_m[:, 0]
        cur = torch.where(fits, score_m[:, 0], torch.full_like(score_m[:, 0], neg_inf))
        any_fit = bool(torch.any(fits))
        s_star = torch.max(torch.where(fits_m[:, 1], score_m[:, 1],
                                       torch.full_like(cur, neg_inf)))
        strict = fits & (cur > s_star)
        top2 = torch.topk(cur, 2).values
        tie = fits & (cur == top2[0])
        wave = strict if bool(torch.any(strict)) else tie
        second = torch.where(cur == top2[0], top2[1], top2[0])
        run = bulk_run_lengths(ms, fits_m, score_m, second)

        # greedy-order the wave's runs (score desc, stable -> row asc among
        # ties) and cap cumulatively at the remaining count
        base = torch.where(wave, run, torch.zeros_like(run))
        remaining = count - placed
        order = torch.argsort(torch.where(wave, -cur,
                                          torch.full_like(cur, float("inf"))),
                              stable=True)
        base_sorted = base[order]
        prefix = torch.cumsum(base_sorted, dim=0) - base_sorted
        alloc_sorted = torch.minimum(torch.clamp(remaining - prefix, min=0),
                                     base_sorted)
        per_node = torch.zeros(N, dtype=torch.int64, device=dev)
        per_node[order] = alloc_sorted.to(torch.int64)

        used = used + per_node[:, None].to(f32) * demand
        coll = coll + per_node.to(coll.dtype)
        assign = assign + per_node.to(torch.int32)
        placed += int(torch.sum(per_node))
        stuck = not any_fit
        waves += 1

    # final scores + eval/exhaustion counts (the grid's m=1 column is
    # exactly the reference's _bulk_scores)
    _, fits_f, score_f = bulk_wave_grid(
        capacity, used, demand, feasible, affinity, has_affinity,
        desired_f, penalty, coll, spread_algorithm, 1)
    final_scores = torch.where(fits_f[:, 0], score_f[:, 0],
                               torch.full_like(score_f[:, 0], neg_inf))
    n_eval = int(torch.sum(feasible))
    n_exh = int(torch.sum(feasible & ~fits_f[:, 0]))
    scalars = torch.zeros(N, dtype=f32, device=dev)
    scalars[:4] = torch.tensor([placed, n_eval, n_exh, waves], dtype=f32)
    return torch.cat([used, assign.to(f32)[:, None], final_scores[:, None],
                      scalars[:, None]], dim=-1)


def place_bulk(capacity, used0, feasible, affinity, has_affinity: bool,
               desired: int, penalty, coll0, demand, count: int,
               spread_algorithm: bool = False, max_waves: int = 65536,
               fill_grid: int = _FILL_GRID) -> torch.Tensor:
    """K1 wrapper, same arguments and packed f32[N, R+3] output as
    `place_bulk_plain`.  CUDA tensors launch csrc/place_bulk.cu; CPU
    tensors take the plain version."""
    dev = _device_of(capacity)
    if dev.type == "cpu":
        return place_bulk_plain(capacity, used0, feasible, affinity,
                                has_affinity, desired, penalty, coll0, demand,
                                count, spread_algorithm, max_waves, fill_grid)
    N, R = capacity.shape
    if R != NUM_RESOURCE_DIMS:
        raise ValueError(f"place_bulk: R={R}, kernel takes {NUM_RESOURCE_DIMS}")
    if not 4 <= N <= BULK_MAX_ROWS:
        raise ValueError(
            f"place_bulk: N={N}; the kernel sorts each wave in shared memory "
            f"and takes 4..{BULK_MAX_ROWS} rows")
    if fill_grid not in FILL_GRID_BUCKETS:
        # the kernel packs each row's run (<= fill_grid) into 8 key bits
        raise ValueError(f"place_bulk: fill_grid={fill_grid}; the kernel "
                         f"takes one of {FILL_GRID_BUCKETS}")
    f32, i32 = torch.float32, torch.int32
    _check("place_bulk.capacity", capacity, dev, f32, (N, R))
    _check("place_bulk.used0", used0, dev, f32, (N, R))
    _check("place_bulk.feasible", feasible, dev, torch.bool, (N,))
    _check("place_bulk.affinity", affinity, dev, f32, (N,))
    _check("place_bulk.penalty", penalty, dev, torch.bool, (N,))
    _check("place_bulk.coll0", coll0, dev, i32, (N,))
    _check("place_bulk.demand", demand, dev, f32, (R,))
    lib = _build.load("place_bulk")
    out = torch.empty((N, R + 3), dtype=f32, device=dev)
    scratch = torch.empty((3, N), dtype=i32, device=dev)
    rc = lib.place_bulk_launch(
        _ptr(capacity), _ptr(used0), _ptr(feasible), _ptr(affinity),
        int(bool(has_affinity)), int(desired), _ptr(penalty), _ptr(coll0),
        _ptr(demand), int(count), int(bool(spread_algorithm)),
        int(max_waves), int(fill_grid), N, _ptr(out), _ptr(scratch),
        _stream(dev))
    if rc != 0:
        raise RuntimeError(f"place_bulk kernel launch failed: CUDA error {rc}")
    launches["place_bulk"] += 1
    return out


def unpack_bulk(packed: np.ndarray):
    """Host inverse of the packed bulk leaf: returns (assign i32[N],
    placed, n_eval, n_exh, scores f32[N], waves, used f32[N,R])."""
    R = packed.shape[1] - 3
    used = packed[:, :R]
    assign = np.rint(packed[:, R]).astype(np.int32)
    scores = packed[:, R + 1]
    s = np.rint(packed[:4, R + 2]).astype(np.int32)
    return assign, int(s[0]), int(s[1]), int(s[2]), scores, int(s[3]), used


# --------------------------------------------------------------------------
# The packed transports (host side, numpy; the reference's layouts)
# --------------------------------------------------------------------------

def heavy_dims(inp: PlaceInputs):
    """(G, N, K, Vp1) of one eval's inputs."""
    G, N = inp.feasible.shape
    K = inp.spread_wfrac.shape[1]
    Vp1 = inp.spread_desired.shape[2]
    return G, N, K, Vp1


_HEAVY_FIELDS = ("feasible", "affinity", "penalty", "tg_count", "place_cap",
                 "spread_vidx", "spread_desired", "spread_counts",
                 "has_affinity", "desired_count", "spread_targeted",
                 "spread_wfrac", "spread_active")


def heavy_len(G: int, N: int, K: int, Vp1: int) -> int:
    return 5 * G * N + G * K * N + 2 * G * K * Vp1 + 2 * G + 3 * G * K


def pack_heavy(inp: PlaceInputs) -> np.ndarray:
    """Flatten one eval's G x N-scale tensors (numpy-backed inputs) into
    one f32 vector."""
    return np.concatenate(
        [np.asarray(getattr(inp, f), np.float32).ravel()
         for f in _HEAVY_FIELDS])


def heavy_digest(inp: PlaceInputs) -> bytes:
    """Content fingerprint of the heavy block without materializing the
    packed array (the common case is a cache hit)."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    for f in _HEAVY_FIELDS:
        h.update(np.ascontiguousarray(getattr(inp, f)).tobytes())
    return h.digest()


def light_len(S: int, R: int, D: int) -> int:
    return S * (R + 2) + D * (R + 1)


def pack_light(inp: PlaceInputs, deltas, D: int,
               S: Optional[int] = None) -> np.ndarray:
    """Flatten one eval's slot tensors + sparse usage deltas.  `deltas` is
    [(row, f32[R])]; inactive delta slots encode row = N (dropped by the
    kernel).  `S` pads the slot axis to a canonical bucket (padded slots
    are inactive)."""
    S_in, R = inp.demand.shape
    S = S_in if S is None else S
    N = inp.feasible.shape[1]
    out = np.zeros(light_len(S, R, D), np.float32)
    o = 0
    out[o:o + S_in * R] = np.asarray(inp.demand, np.float32).ravel()
    o += S * R
    out[o:o + S_in] = np.asarray(inp.slot_tg, np.float32)
    o += S
    out[o:o + S_in] = np.asarray(inp.slot_active, np.float32)
    o += S
    rows = np.full(D, N, np.float32)
    vals = np.zeros((D, R), np.float32)
    for d, (row, vec) in enumerate(deltas[:D]):
        rows[d] = row
        vals[d] = vec
    out[o:o + D] = rows
    o += D
    out[o:o + D * R] = vals.ravel()
    return out


def pack_bulk_heavy(feasible, affinity, penalty, coll0) -> np.ndarray:
    """f32[4N]: one bulk eval's node-axis tensors."""
    return np.concatenate([
        np.asarray(feasible, np.float32),
        np.asarray(affinity, np.float32),
        np.asarray(penalty, np.float32),
        np.asarray(coll0, np.float32)])


def bulk_heavy_digest(feasible, affinity, penalty, coll0) -> bytes:
    """Content fingerprint of one bulk request's node-axis tensors.
    All-zero fields hash as a 1-byte marker and bools hash bit-packed;
    tag bytes frame each variable-length segment so (full||marker) and
    (marker||full) streams cannot collide."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    h.update(np.packbits(np.asarray(feasible, bool)).tobytes())
    for tag, a in ((b"\x01", affinity), (b"\x02", coll0)):
        if np.any(a):
            h.update(tag + b"F")
            h.update(np.ascontiguousarray(a).tobytes())
        else:
            h.update(tag + b"0")
    if np.any(penalty):
        h.update(b"\x03F")
        h.update(np.packbits(np.asarray(penalty, bool)).tobytes())
    else:
        h.update(b"\x030")
    return h.digest()


def bulk_light_len(R: int, D: int) -> int:
    return 3 + R + D * (R + 1)


def pack_bulk_light(has_affinity, desired, count, demand, deltas,
                    N: int, D: int) -> np.ndarray:
    R = demand.shape[0]
    out = np.empty(bulk_light_len(R, D), np.float32)
    out[0] = float(bool(has_affinity))
    out[1] = float(desired)
    out[2] = float(count)
    out[3:3 + R] = np.asarray(demand, np.float32)
    rows = np.full(D, N, np.float32)
    vals = np.zeros((D, R), np.float32)
    for d, (row, vec) in enumerate(deltas[:D]):
        rows[d] = row
        vals[d] = vec
    out[3 + R:3 + R + D] = rows
    out[3 + R + D:] = vals.ravel()
    return out


# sparse bulk output: the assignments of a count <= SPARSE_CAP eval fit in
# SPARSE_CAP (row, count) pairs + the scores at those rows
SPARSE_CAP = 128


def unpack_bulk_batch(packed: np.ndarray, n_rows: int,
                      sparse: bool = False):
    """Host inverse of the batched bulk kernel's per-eval rows (both
    formats; sparse rows densify here): returns (assign i32[E, N],
    scores f32[E, N], placed i32[E], n_eval i32[E], n_exh i32[E],
    waves i32[E]).  Sparse scores are -inf at unassigned rows."""
    E, W = packed.shape
    s = np.rint(packed[:, -4:]).astype(np.int32)
    if sparse:
        rows = np.rint(packed[:, :SPARSE_CAP]).astype(np.int64)
        counts = np.rint(
            packed[:, SPARSE_CAP:2 * SPARSE_CAP]).astype(np.int32)
        rscores = packed[:, 2 * SPARSE_CAP:3 * SPARSE_CAP]
        assign = np.zeros((E, n_rows), np.int32)
        scores = np.full((E, n_rows), -np.inf, np.float32)
        e_idx = np.repeat(np.arange(E), SPARSE_CAP)
        r_idx = rows.ravel()
        c = counts.ravel()
        keep = c > 0
        assign[e_idx[keep], r_idx[keep]] = c[keep]
        scores[e_idx[keep], r_idx[keep]] = rscores.ravel()[keep]
        return assign, scores, s[:, 0], s[:, 1], s[:, 2], s[:, 3]
    N = (W - 4) // 2
    assign = np.rint(packed[:, :N]).astype(np.int32)
    scores = packed[:, N:2 * N]
    return assign, scores, s[:, 0], s[:, 1], s[:, 2], s[:, 3]


# --------------------------------------------------------------------------
# K3: the chained scan batch over the packed transport
# --------------------------------------------------------------------------

def _unpack_heavy(h: torch.Tensor, G: int, N: int, K: int, Vp1: int):
    """Inverse of pack_heavy on a device row; returns a field dict."""
    o = 0

    def take(n, shape):
        nonlocal o
        v = h[o:o + n].reshape(shape)
        o += n
        return v
    i32 = torch.int32
    return dict(
        feasible=take(G * N, (G, N)) > 0.5,
        affinity=take(G * N, (G, N)),
        penalty=take(G * N, (G, N)) > 0.5,
        tg_count=take(G * N, (G, N)).to(i32),
        place_cap=take(G * N, (G, N)).to(i32),
        spread_vidx=take(G * K * N, (G, K, N)).to(i32),
        spread_desired=take(G * K * Vp1, (G, K, Vp1)),
        spread_counts=take(G * K * Vp1, (G, K, Vp1)),
        has_affinity=take(G, (G,)) > 0.5,
        desired_count=take(G, (G,)).to(i32),
        spread_targeted=take(G * K, (G, K)) > 0.5,
        spread_wfrac=take(G * K, (G, K)),
        spread_active=take(G * K, (G, K)) > 0.5,
    )


def _unpack_light(l: torch.Tensor, S: int, R: int, D: int):
    o = 0

    def take(n, shape):
        nonlocal o
        v = l[o:o + n].reshape(shape)
        o += n
        return v
    demand = take(S * R, (S, R))
    slot_tg = take(S, (S,)).to(torch.int32)
    slot_active = take(S, (S,)) > 0.5
    delta_rows = take(D, (D,)).to(torch.int64)
    delta_vals = take(D * R, (D, R))
    return demand, slot_tg, slot_active, delta_rows, delta_vals


def _scatter_add_rows(x: torch.Tensor, rows: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
    """x.at[rows].add(vals, mode="drop"), deltas added one after another
    in their order (rows outside [0, N) dropped); returns a new tensor."""
    x = x.clone()
    N = x.shape[0]
    for k in torch.nonzero((rows >= 0) & (rows < N)).flatten().tolist():
        r = int(rows[k])
        x[r] = x[r] + vals[k]
    return x


def place_batch_packed_plain(capacity: torch.Tensor, used0: torch.Tensor,
                             heavy: torch.Tensor, dyn: torch.Tensor,
                             dims: Tuple[int, ...],
                             spread_algorithm: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3 (`place_batch_packed_jit`): E chained evals,
    each scanning its S slots against the usage its predecessors left.
    heavy f32[E, Lh] (pack_heavy rows), dyn f32[E * Ll] (pack_light
    blocks), dims (G, N, K, Vp1, S, D).  Each eval's deltas are added
    into the carry and stay there for the later evals.  Returns (packed
    f32[E, S, 5 + 2*TOP_K], final used f32[N, R])."""
    G, N, K, Vp1, S, D = dims
    R = capacity.shape[1]
    E = heavy.shape[0]
    light = dyn.reshape(E, -1)
    used = used0
    outs = []
    for e in range(E):
        f = _unpack_heavy(heavy[e], G, N, K, Vp1)
        demand, slot_tg, slot_active, delta_rows, delta_vals = \
            _unpack_light(light[e], S, R, D)
        used = _scatter_add_rows(used, delta_rows, delta_vals)
        inp = PlaceInputs(capacity=capacity, used=used, demand=demand,
                          slot_tg=slot_tg, slot_active=slot_active, **f)
        packed, used = place_eval_plain(inp, spread_algorithm)
        outs.append(packed)
    return torch.stack(outs), used


def place_batch_packed(capacity: torch.Tensor, used0: torch.Tensor,
                       heavy: torch.Tensor, dyn: torch.Tensor,
                       dims: Tuple[int, ...], spread_algorithm: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 wrapper, same arguments and outputs as
    `place_batch_packed_plain`.  CUDA tensors launch csrc/place_scan.cu
    (`place_batch_launch`); CPU tensors take the plain version."""
    dev = _device_of(capacity)
    if dev.type == "cpu":
        return place_batch_packed_plain(capacity, used0, heavy, dyn, dims,
                                        spread_algorithm)
    G, N, K, Vp1, S, D = (int(x) for x in dims)
    R = capacity.shape[1]
    E = heavy.shape[0]
    if R != NUM_RESOURCE_DIMS:
        raise ValueError(f"place_batch: R={R}, kernel takes {NUM_RESOURCE_DIMS}")
    if N < TOP_K:
        raise ValueError(f"place_batch: N={N} < TOP_K={TOP_K}")
    if not 1 <= K <= SCAN_MAX_SPREADS:
        raise ValueError(f"place_batch: K={K}, kernel takes 1..{SCAN_MAX_SPREADS}")
    if E < 1:
        raise ValueError("place_batch: empty batch")
    f32 = torch.float32
    _check("place_batch.capacity", capacity, dev, f32, (N, R))
    _check("place_batch.used0", used0, dev, f32, (N, R))
    _check("place_batch.heavy", heavy, dev, f32, (E, heavy_len(G, N, K, Vp1)))
    _check("place_batch.dyn", dyn, dev, f32, (E * light_len(S, R, D),))
    lib = _build.load("place_scan")
    packed = torch.empty((E, S, PACKED_WIDTH), dtype=f32, device=dev)
    used = torch.empty((N, R), dtype=f32, device=dev)
    tg_count = torch.empty((G, N), dtype=torch.int32, device=dev)
    place_cap = torch.empty((G, N), dtype=torch.int32, device=dev)
    counts = torch.empty((G, K, Vp1), dtype=f32, device=dev)
    rc = lib.place_batch_launch(
        _ptr(capacity), _ptr(used0), _ptr(heavy), _ptr(dyn), E, G, N, K,
        Vp1, S, D, int(bool(spread_algorithm)), _ptr(packed), _ptr(used),
        _ptr(tg_count), _ptr(place_cap), _ptr(counts), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"place_batch kernel launch failed: CUDA error {rc}")
    launches["place_batch"] += 1
    return packed, used


# --------------------------------------------------------------------------
# K4: the chained bulk batch over the packed transport
# --------------------------------------------------------------------------

def place_bulk_batch_plain(capacity: torch.Tensor, used0: torch.Tensor,
                           heavy: torch.Tensor, dyn: torch.Tensor, D: int,
                           sparse_out: bool = False,
                           spread_algorithm: bool = False,
                           max_waves: int = 65536,
                           fill_grid: int = _FILL_GRID,
                           exact_out: bool = False):
    """Plain version of K4 (`_place_bulk_batch`): E chained wavefront
    bulk evals.  heavy f32[E, 4N] (pack_bulk_heavy rows), dyn f32[E * Ll]
    (pack_bulk_light blocks).  Each eval's deltas are scoped to it: the
    carry gets `+ delta_mat` before its wavefront and `- delta_mat`
    after, so only placements chain forward.

    Returns (packed, used_final) — packed per eval dense [2N+4] (assign,
    scores, placed/n_eval/n_exh/waves) or, with sparse_out, [3*SPARSE_CAP
    + 4] (rows, counts, scores, scalars; count <= SPARSE_CAP only).  With
    exact_out it returns (packed, used_final, used_exact): used_exact is
    used0 + sum_e f32(assign_e) * demand_e, written into `used0` itself
    (the donated basis, updated in place)."""
    N, R = capacity.shape
    E = heavy.shape[0]
    light = dyn.reshape(E, -1)
    f32 = torch.float32
    used = used0.clone()
    exact = used0
    outs = []
    for e in range(E):
        h, l = heavy[e], light[e]
        feasible = h[:N] > 0.5
        affinity = h[N:2 * N]
        penalty = h[2 * N:3 * N] > 0.5
        coll0 = h[3 * N:].to(torch.int32)
        has_aff = bool(l[0] > 0.5)
        desired = int(l[1].to(torch.int32))
        count = int(l[2].to(torch.int32))
        demand = l[3:3 + R]
        delta_rows = l[3 + R:3 + R + D].to(torch.int64)
        delta_vals = l[3 + R + D:].reshape(D, R)
        delta_mat = _scatter_add_rows(torch.zeros_like(used), delta_rows,
                                      delta_vals)
        leaf = place_bulk_plain(capacity, used + delta_mat, feasible,
                                affinity, has_aff, desired, penalty, coll0,
                                demand, count, spread_algorithm, max_waves,
                                fill_grid)
        used_f = leaf[:, :R]
        assign_f = leaf[:, R]
        scores = leaf[:, R + 1]
        scalars = leaf[:4, R + 2]
        if sparse_out:
            mask = assign_f > 0
            rows = torch.nonzero(mask).flatten()[:SPARSE_CAP]
            k = rows.shape[0]
            rows_o = torch.full((SPARSE_CAP,), float(N), dtype=f32,
                                device=used.device)
            counts_o = torch.zeros(SPARSE_CAP, dtype=f32, device=used.device)
            scores_o = torch.zeros(SPARSE_CAP, dtype=f32, device=used.device)
            rows_o[:k] = rows.to(f32)
            counts_o[:k] = assign_f[rows]
            scores_o[:k] = scores[rows]
            out = torch.cat([rows_o, counts_o, scores_o, scalars])
        else:
            out = torch.cat([assign_f, scores, scalars])
        outs.append(out)
        used = used_f - delta_mat
        if exact_out:
            exact.add_(assign_f[:, None] * demand)
    packed = torch.stack(outs)
    if exact_out:
        return packed, used, exact
    return packed, used


def place_bulk_batch(capacity: torch.Tensor, used0: torch.Tensor,
                     heavy: torch.Tensor, dyn: torch.Tensor, D: int,
                     sparse_out: bool = False, spread_algorithm: bool = False,
                     max_waves: int = 65536, fill_grid: int = _FILL_GRID,
                     exact_out: bool = False):
    """K4 wrapper, same arguments and outputs as `place_bulk_batch_plain`
    (with exact_out, `used0` is the donated basis and receives the exact
    carry in place).  CUDA tensors launch csrc/place_bulk.cu
    (`place_bulk_batch_launch`); CPU tensors take the plain version."""
    dev = _device_of(capacity)
    if dev.type == "cpu":
        return place_bulk_batch_plain(capacity, used0, heavy, dyn, D,
                                      sparse_out, spread_algorithm,
                                      max_waves, fill_grid, exact_out)
    N, R = capacity.shape
    E = heavy.shape[0]
    if R != NUM_RESOURCE_DIMS:
        raise ValueError(f"place_bulk_batch: R={R}, kernel takes "
                         f"{NUM_RESOURCE_DIMS}")
    if not 4 <= N <= BULK_MAX_ROWS:
        raise ValueError(
            f"place_bulk_batch: N={N}; the kernel sorts each wave in shared "
            f"memory and takes 4..{BULK_MAX_ROWS} rows")
    if fill_grid not in FILL_GRID_BUCKETS:
        raise ValueError(f"place_bulk_batch: fill_grid={fill_grid}; the "
                         f"kernel takes one of {FILL_GRID_BUCKETS}")
    if E < 1:
        raise ValueError("place_bulk_batch: empty batch")
    f32 = torch.float32
    _check("place_bulk_batch.capacity", capacity, dev, f32, (N, R))
    _check("place_bulk_batch.used0", used0, dev, f32, (N, R))
    _check("place_bulk_batch.heavy", heavy, dev, f32, (E, 4 * N))
    _check("place_bulk_batch.dyn", dyn, dev, f32, (E * bulk_light_len(R, D),))
    lib = _build.load("place_bulk")
    width = 3 * SPARSE_CAP + 4 if sparse_out else 2 * N + 4
    packed = torch.empty((E, width), dtype=f32, device=dev)
    used = torch.empty((N, R), dtype=f32, device=dev)
    scratch = torch.empty((3, N), dtype=torch.int32, device=dev)
    delta = torch.empty((N if D else 1, R), dtype=f32, device=dev)
    rc = lib.place_bulk_batch_launch(
        _ptr(capacity), _ptr(used0), _ptr(heavy), _ptr(dyn), E, N, int(D),
        int(bool(sparse_out)), int(bool(spread_algorithm)), int(max_waves),
        int(fill_grid), int(bool(exact_out)), _ptr(used), _ptr(packed),
        _ptr(scratch), _ptr(delta), _stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"place_bulk_batch kernel launch failed: CUDA error {rc}")
    launches["place_bulk_batch"] += 1
    if exact_out:
        return packed, used, used0
    return packed, used
