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
# the bulk kernels' keys hold a row in 24 bits
BULK_MAX_ROWS = 1 << 24
# keys one selection round of K1/K4 takes (csrc/place_bulk.cu KMAX)
BULK_KMAX = 2048
# the scan kernel lists a group's active spreads in shared memory
# (csrc/place_scan.cu MAXK)
SCAN_MAX_SPREADS = 64
# rows a K2/K3 cluster block caches in shared memory; past them the cache
# is in the global scratch (csrc/place_scan.cu SMEM_ROWS)
SCAN_SMEM_ROWS = 16384

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
    """`lax.top_k(x, k)` for f32[n]: the k largest values in XLA's total
    order (-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN), the
    lower index first among equal bits, each value with its bits.  A
    NaN's sign decides where it ranks: the CPU's 0 / 0 and inf / inf
    give -NaN (lowest), the card's +NaN (highest)."""
    i = x.contiguous().view(torch.int32)
    key = torch.where(i < 0, i ^ 0x7FFFFFFF, i)
    idx = torch.sort(key, descending=True, stable=True).indices[:k]
    return x[idx], idx


def _argmax(x: torch.Tensor) -> torch.Tensor:
    """`jnp.argmax(x)` for f32[n]: the first NaN of either sign, else the
    lowest index of the maximum (+0.0 and -0.0 equal)."""
    return torch.sort(x, descending=True, stable=True).indices[0]


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
        sel = _argmax(masked)
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


def _ptr(t: torch.Tensor) -> int:
    """A tensor's address for a C entry point: ctypes converts the int by
    the entry point's c_void_p argtype, without a c_void_p object a
    pointer (the K7 wrappers pass ints too)."""
    return t.data_ptr()


def _stream(dev) -> int:
    """The handle of the current stream on a card (its index, as
    `Tensor.get_device()` gives it, or its torch.device), as
    torch.cuda.current_stream(dev).cuda_stream gives it, without building
    a Stream object (6 us of host time a launch on the H100, PERF.md)."""
    idx = dev if isinstance(dev, int) else dev.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if idx is None else idx)


def _on_card(idx: int, entry, *args) -> int:
    """`entry(*args)`, a kernel's C entry point, with card `idx` (as
    `Tensor.get_device()` or `torch.device.index` gives it) current for
    the call, the caller's card current again after it.  Every wrapper
    launches through it, for its operands' card: a launch into another
    card's stream with card 0 current faulted on a four-card H100
    machine (an illegal address, PERF.md), and a cluster launch sets its
    size attribute for the current card only."""
    prev = torch.cuda._exchange_device(idx)
    try:
        return entry(*args)
    finally:
        torch.cuda._maybe_exchange_device(prev)


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


def _scan_scratch(lib, G: int, N: int, K: int, Vp1: int,
                  dev: torch.device) -> Tuple[torch.Tensor, ...]:
    """K2/K3's device scratch: the eval's tg_count and place_cap
    (i32[G, N]); each cluster block's spread state (its copy of the
    counts and desired counts, one group's boost tables, the spreads'
    weights and flags) and the rows' cached scores, both used where the
    block's shared memory does not hold them (csrc/place_scan.cu
    spread_floats, SMEM_SPREAD, SMEM_ROWS)."""
    i32, f32 = torch.int32, torch.float32
    blocks = lib.place_scan_cluster_size()
    spread = (2 * G + 1) * K * Vp1 + 2 * G * K
    return (torch.empty((G, N), dtype=i32, device=dev),
            torch.empty((G, N), dtype=i32, device=dev),
            torch.empty((blocks, spread), dtype=f32, device=dev),
            torch.empty((3, N), dtype=f32, device=dev))


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
    tg_count, place_cap, spread, rows = _scan_scratch(lib, G, N, K, Vp1, dev)
    rc = _on_card(
        dev.index, lib.place_scan_launch,
        _ptr(inp.capacity), _ptr(inp.used), _ptr(inp.feasible),
        _ptr(inp.affinity), _ptr(inp.has_affinity), _ptr(inp.desired_count),
        _ptr(inp.penalty), _ptr(inp.tg_count), _ptr(inp.spread_vidx),
        _ptr(inp.spread_desired), _ptr(inp.spread_targeted),
        _ptr(inp.spread_wfrac), _ptr(inp.spread_counts),
        _ptr(inp.spread_active), _ptr(inp.place_cap), _ptr(inp.demand),
        _ptr(inp.slot_tg), _ptr(inp.slot_active),
        G, N, K, Vp1, S, int(bool(spread_algorithm)),
        _ptr(packed), _ptr(used), _ptr(tg_count), _ptr(place_cap),
        _ptr(spread), _ptr(rows), _stream(dev))
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
    coll_1 = coll[:, None].to(f32) + ms[None, :]
    coll_m = coll_1 - 1.0
    total_m = fit_m
    n_sc = torch.ones_like(fit_m)
    # a tensor divisor keeps this a true division on every device (CUDA
    # PyTorch turns division by a host scalar into a reciprocal multiply)
    div = torch.tensor(max(desired_f, 1.0), dtype=f32, device=capacity.device)
    # the reference's -(coll_m + 1.0) / div as XLA compiles it: it folds
    # (x - 1) + 1 to x, which differs once coll + m passes 2^24
    anti_m = -coll_1 / div
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


def bulk_wave_allocs(ms, fits_m, score_m, remaining: int):
    """One wave of `_bulk_loop` on its grid: the wave set (strict rows,
    cur > s*, if any, else the rows tied at the top score), its runs in
    greedy order (score desc, stable argsort -> row asc among ties),
    capped cumulatively at `remaining`.  s* propagates a NaN (jnp.max),
    which empties the strict set; the top-2 ranks as `lax.top_k` (a NaN by
    its sign: the CPU's -NaN lowest, the card's +NaN highest, where the
    tie set is then empty).  Returns (per-node instances i64[N],
    any_fit)."""
    neg_inf = float("-inf")
    fits = fits_m[:, 0]
    cur = torch.where(fits, score_m[:, 0], torch.full_like(score_m[:, 0], neg_inf))
    any_fit = bool(torch.any(fits))
    s_star = torch.max(torch.where(fits_m[:, 1], score_m[:, 1],
                                   torch.full_like(cur, neg_inf)))
    strict = fits & (cur > s_star)
    top2 = _lax_top_k(cur, 2)[0]
    tie = fits & (cur == top2[0])
    wave = strict if bool(torch.any(strict)) else tie
    second = torch.where(cur == top2[0], top2[1], top2[0])
    run = bulk_run_lengths(ms, fits_m, score_m, second)
    base = torch.where(wave, run, torch.zeros_like(run))
    order = torch.argsort(torch.where(wave, -cur,
                                      torch.full_like(cur, float("inf"))),
                          stable=True)
    base_sorted = base[order]
    prefix = torch.cumsum(base_sorted, dim=0) - base_sorted
    alloc_sorted = torch.minimum(torch.clamp(remaining - prefix, min=0),
                                 base_sorted)
    per_node = torch.zeros(cur.shape[0], dtype=torch.int64, device=cur.device)
    per_node[order] = alloc_sorted.to(torch.int64)
    return per_node, any_fit


def _score_words(cur: np.ndarray) -> np.ndarray:
    """u32 words whose unsigned order is the order of -cur (the kernel's
    `orderable(-cur + 0.0f)`: +0.0 and -0.0 give one word)."""
    u = (-cur.astype(np.float32) + np.float32(0.0)).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u,
                    u | np.uint32(0x80000000)).astype(np.uint32)


def bulk_wave_select_model(ms, fits_m, score_m, remaining: int,
                           kmax: int = BULK_KMAX):
    """Model of one wave of csrc/place_bulk.cu (K1/K4), used only by the
    tests, which hold it equal to `bulk_wave_allocs` (the plain version's
    full argsort).  Only the first k = min(remaining, |wave|) keys of the
    greedy order (score desc, row asc) can take instances, so the kernel
    selects them: the first rows at the top score in row order when
    there are k of them ("top", in rounds of at most `kmax` keys); else
    a radix select (8
    bits a pass over the 32-bit score word) for the threshold, the rows
    above it and the first rows at it in row order, in rounds of at most
    `kmax` keys ("radix").  It sorts only the selected keys, computes
    runs for the selected rows only (capped at min(M, remaining)) and
    caps them cumulatively.  Returns (per-node instances i64[N], any_fit,
    {"path", "rounds"})."""
    neg_inf = np.float32(-np.inf)
    fits_m = fits_m.cpu().numpy()
    score_m = score_m.cpu().numpy()
    ms = ms.cpu().numpy()
    N, M = fits_m.shape
    per_node = np.zeros(N, np.int64)
    info = {"path": None, "rounds": 0}
    fits = fits_m[:, 0]
    cur = np.where(fits, score_m[:, 0], neg_inf).astype(np.float32)
    if not fits.any():
        return torch.from_numpy(per_node), False, info
    s_star = np.max(np.where(fits_m[:, 1], score_m[:, 1], neg_inf))
    # lax.top_k's order (a NaN by its sign; duplicates count)
    top1, top2 = _lax_top_k(torch.from_numpy(cur), 2)[0].numpy()
    # the fitting rows at the top score (where it is -inf, every fitting
    # row: the kernel's rows that do not fit hold NOFIT, not -inf)
    top = fits & (cur == top1)
    n_top = int(np.count_nonzero(top))
    # some row beats s* where the largest cur that is not NaN does (a NaN
    # s* is beaten by none)
    strict = np.max(np.where(np.isnan(cur), neg_inf, cur)) > s_star
    wave = (cur > s_star) if strict else top
    run_cap = min(M, remaining)
    words = _score_words(cur)
    rows = np.arange(N)

    def take(sel, run_base):
        """Runs of the selected rows (in key order), capped cumulatively."""
        second = np.where(cur[sel] == top1, top2, top1)
        ok = fits_m[sel] & ((score_m[sel] > second[:, None]) | (ms == 1.0))
        run = np.minimum(np.cumprod(ok, axis=1).sum(axis=1), run_cap)
        pre = run_base + np.cumsum(run) - run
        per_node[sel] = np.minimum(np.maximum(remaining - pre, 0), run)
        info["rounds"] += 1
        return run_base + int(run.sum())

    def first_keys(mask, q):
        idx = np.flatnonzero(mask)
        return idx[np.lexsort((idx, words[idx]))][:q]

    k = min(remaining, int(np.count_nonzero(wave)))
    run_base = 0
    if n_top >= k:
        info["path"] = "top"
        at_top = np.flatnonzero(top)
        for base in range(0, k, kmax):
            if run_base >= remaining:
                break
            run_base = take(at_top[base:min(base + kmax, k)], run_base)
    else:
        info["path"] = "radix"
        taken, lo = 0, None                # lo: (word, row) last taken
        while taken < k and run_base < remaining:
            q = min(kmax, k - taken)
            elig = wave.copy()
            if lo is not None:
                elig &= (words > lo[0]) | ((words == lo[0]) & (rows > lo[1]))
            prefix, need = 0, q
            for shift in (24, 16, 8, 0):
                m = elig if shift == 24 else \
                    elig & ((words >> np.uint32(shift + 8)) == prefix)
                hist = np.bincount((words[m] >> np.uint32(shift)) & 255,
                                   minlength=256)
                cum = np.cumsum(hist)
                b = int(np.argmax(cum >= need))
                need -= int(cum[b] - hist[b])
                prefix = (prefix << 8) | b
            thr = np.uint32(prefix)
            sel = np.concatenate([
                first_keys(elig & (words < thr), q),
                np.flatnonzero(elig & (words == thr))[:need]])
            run_base = take(sel, run_base)
            taken += q
            lo = (words[sel[-1]], int(sel[-1]))
    return torch.from_numpy(per_node), True, info


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
        per_node, any_fit = bulk_wave_allocs(ms, fits_m, score_m,
                                             count - placed)
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
            f"place_bulk: N={N}; the kernel's key holds a row in 24 bits "
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
    scratch = torch.empty((2, N), dtype=i32, device=dev)
    rc = _on_card(
        dev.index, lib.place_bulk_launch,
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
    in their order; a row in [-N, 0) lands on row + N, as JAX indexes,
    other rows outside [0, N) drop.  Returns a new tensor."""
    x = x.clone()
    N = x.shape[0]
    rows = torch.where((rows < 0) & (rows >= -N), rows + N, rows)
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
    tg_count, place_cap, spread, rows = _scan_scratch(lib, G, N, K, Vp1, dev)
    rc = _on_card(
        dev.index, lib.place_batch_launch,
        _ptr(capacity), _ptr(used0), _ptr(heavy), _ptr(dyn), E, G, N, K,
        Vp1, S, D, int(bool(spread_algorithm)), _ptr(packed), _ptr(used),
        _ptr(tg_count), _ptr(place_cap), _ptr(spread), _ptr(rows),
        _stream(dev))
    if rc != 0:
        raise RuntimeError(f"place_batch kernel launch failed: CUDA error {rc}")
    launches["place_batch"] += 1
    return packed, used


# --------------------------------------------------------------------------
# K2/K3's cached step: a model for the tests
# --------------------------------------------------------------------------

def _partial_scores(inp: PlaceInputs, g: int, d: torch.Tensor,
                    used: torch.Tensor, tg_count: torch.Tensor,
                    place_cap: torch.Tensor, spread_algorithm: bool):
    """The scoring stack of `place_eval_plain` up to the spread term, on
    every row, in its order: (partial f32[N], fit f32[N], feasible
    bool[N], fits bool[N], scorers f32[N])."""
    f32 = torch.float32
    feas = inp.feasible[g] & (place_cap[g] != 0)
    util = used + d
    fits = torch.all(util <= inp.capacity, dim=-1) & feas
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
    return total, fit_score, feas, fits, n_scorers


def _boost_tables(inp: PlaceInputs, g: int, counts: torch.Tensor):
    """[(k, f32[V+1])]: for each active spread of group `g`, in order, the
    boost `_spread_boost` gives a row of each value index (V = missing),
    from the counts f32[K, V+1]."""
    Vp1 = counts.shape[1]
    V = Vp1 - 1
    big = torch.tensor(3.4e38, dtype=torch.float32)
    missing = torch.arange(Vp1) >= V
    out = []
    for k in torch.nonzero(inp.spread_active[g]).flatten().tolist():
        cur = counts[k]
        des = inp.spread_desired[g, k]
        neg1 = torch.full_like(cur, -1.0)
        t = torch.where(missing, neg1, torch.where(
            des >= 0.0, (des - (cur + 1.0)) / torch.clamp(des, min=1e-9)
            * inp.spread_wfrac[g, k], neg1))
        placed = cur[:V] > 0.0
        minc = torch.min(torch.where(placed, cur[:V], big))
        maxc = torch.max(torch.where(placed, cur[:V], -big))
        minc_ = torch.clamp(minc, min=1e-9)
        e = torch.where(cur != minc, (minc - cur) / minc_,
                        torch.where(minc == maxc, neg1,
                                    ((maxc - minc) / minc_).expand_as(cur)))
        e = torch.where(missing, neg1, e)
        e = torch.where(torch.any(placed), e, torch.zeros_like(cur))
        out.append((k, torch.where(inp.spread_targeted[g, k], t, e)))
    return out


def _cluster_top_k(masked: torch.Tensor, blocks: int):
    """lax.top_k(masked, TOP_K) as the kernel forms it: each block's
    top-5 of its contiguous rows, then the top-5 of those lists."""
    N = masked.shape[0]
    rb = -(-N // blocks)
    vals, rows = [], []
    for b in range(blocks):
        lo, hi = min(N, b * rb), min(N, (b + 1) * rb)
        if hi > lo:
            v, i = _lax_top_k(masked[lo:hi], min(TOP_K, hi - lo))
            vals.append(v)
            rows.append(i + lo)
    vals, rows = torch.cat(vals), torch.cat(rows)
    by_row = torch.argsort(rows)
    vals, rows = vals[by_row], rows[by_row]
    top, order = _lax_top_k(vals, TOP_K)
    return top, rows[order]


def _scan_eval_model(inp: PlaceInputs, used: torch.Tensor,
                     spread_algorithm: bool, blocks: int, stats: dict):
    """One eval of the cached step (csrc/place_scan.cu `scan_eval`) on
    CPU tensors; returns (packed f32[S, PACKED_WIDTH], used)."""
    f32 = torch.float32
    N = inp.capacity.shape[0]
    S = inp.demand.shape[0]
    V = inp.spread_counts.shape[-1] - 1
    used = used.clone()
    tg_count = inp.tg_count.clone()
    place_cap = inp.place_cap.clone()
    counts = inp.spread_counts.clone()
    out = torch.empty((S, PACKED_WIDTH), dtype=f32)
    cache_key, cache, prev = None, None, -1
    for s in range(S):
        if not bool(inp.slot_active[s]):
            out[s, :5] = torch.tensor([-1.0, 0.0, 0.0, 0.0, 0.0])
            out[s, 5:5 + TOP_K] = torch.arange(TOP_K, dtype=f32)
            out[s, 5 + TOP_K:] = float("-inf")
            prev = -1
            continue
        g = int(inp.slot_tg[s])
        d = inp.demand[s]
        key = (g, d.numpy().tobytes())
        if key != cache_key:
            # a new eval, group or demand: every row
            cache = list(_partial_scores(inp, g, d, used, tg_count,
                                         place_cap, spread_algorithm))
            cache_key = key
            stats["full"] = stats.get("full", 0) + 1
        part, fit, feas, fits, n_sc = cache
        sb = torch.zeros(N, dtype=f32)
        tables = _boost_tables(inp, g, counts[g])
        for k, tab in tables:
            sb = sb + tab[torch.clamp(inp.spread_vidx[g, k].long(), max=V)]
        sb_on = sb != 0.0
        total = part + torch.where(sb_on, sb, torch.zeros_like(sb))
        masked = torch.where(fits, total / (n_sc + sb_on.to(f32)),
                             torch.full_like(total, float("-inf")))
        top_s, top_n = _cluster_top_k(masked, blocks)
        # the kernel's pick is its first key, the row of the card's +NaN
        # where there is one: jnp.argmax's row
        sel = int(_argmax(masked))
        ok = bool(masked[sel] > float("-inf"))
        out[s, 0] = float(sel) if ok else -1.0
        out[s, 1] = masked[sel] if ok else 0.0
        out[s, 2] = fit[sel] if ok else 0.0
        out[s, 3] = float(torch.sum(feas))
        out[s, 4] = float(torch.sum(feas & ~fits))
        out[s, 5:5 + TOP_K] = top_n.to(f32)
        out[s, 5 + TOP_K:] = top_s
        if ok:
            for k, _ in tables:
                v = int(inp.spread_vidx[g, k, sel])
                if v < V:
                    counts[g, k, v] += 1.0
            # the reference adds 0 to the row at every slot but the one
            # that picked it: once before this update unless it was the
            # previous slot's pick
            base = used[sel] + 0.0 if s > 0 and prev != sel else used[sel]
            used[sel] = base + d
            tg_count[g, sel] += 1
            if place_cap[g, sel] > 0:
                place_cap[g, sel] -= 1
            # the picked row alone takes its new partial (computed with the
            # vector arithmetic: torch's CPU pow rounds a one-element
            # tensor differently from a long one)
            new = _partial_scores(inp, g, d, used, tg_count, place_cap,
                                  spread_algorithm)
            for c, x in zip(cache, new):
                c[sel] = x[sel]
            stats["rows"] = stats.get("rows", 0) + 1
        prev = sel if ok else -1
    if S > 0:
        # the last slot's `+ 0` on every row but its pick
        keep = torch.arange(N) == prev
        used = torch.where(keep[:, None], used, used + 0.0)
    return out, used


def place_eval_cached_model(inp: PlaceInputs, spread_algorithm: bool = False,
                            blocks: int = 8, stats: Optional[dict] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model of K2's cached step (csrc/place_scan.cu), used only by the
    tests, which hold it bit-equal to `place_eval_plain`.  Each row keeps
    its partial score (the stack up to the spread term), fit, scorer
    count and flags; every row is rescored at the eval's first active
    slot and when a slot's group or demand differs from the last active
    slot's, otherwise only the picked row after its carry update; the
    spread term comes from per-value boost tables; the top-5 is merged
    from `blocks` blocks' lists; the `+ 0` the reference adds to every
    row is applied only where it changes a bit.  `stats` counts full
    rescores ("full") and single-row rescores ("rows")."""
    return _scan_eval_model(inp, inp.used, spread_algorithm, blocks,
                            {} if stats is None else stats)


def place_batch_cached_model(capacity: torch.Tensor, used0: torch.Tensor,
                             heavy: torch.Tensor, dyn: torch.Tensor,
                             dims: Tuple[int, ...],
                             spread_algorithm: bool = False, blocks: int = 8,
                             stats: Optional[dict] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model of K3 (csrc/place_scan.cu) for the tests, which hold it
    bit-equal to `place_batch_packed_plain`: each eval's deltas added by
    row, at the row's first delta, in list order (a row in [-N, 0) taken
    as row + N, other rows outside [0, N) dropped), then
    `place_eval_cached_model`'s scan."""
    G, N, K, Vp1, S, D = dims
    R = capacity.shape[1]
    E = heavy.shape[0]
    light = dyn.reshape(E, -1)
    stats = {} if stats is None else stats
    used = used0.clone()
    outs = []
    for e in range(E):
        f = _unpack_heavy(heavy[e], G, N, K, Vp1)
        demand, slot_tg, slot_active, rows, vals = \
            _unpack_light(light[e], S, R, D)
        rl = [r + N if -N <= r < 0 else r for r in rows.tolist()]
        for k, r in enumerate(rl):
            if 0 <= r < N and r not in rl[:k]:
                for j in range(k, D):
                    if rl[j] == r:
                        used[r] = used[r] + vals[j]
        inp = PlaceInputs(capacity=capacity, used=used, demand=demand,
                          slot_tg=slot_tg, slot_active=slot_active, **f)
        packed, used = _scan_eval_model(inp, used, spread_algorithm, blocks,
                                        stats)
        outs.append(packed)
    return torch.stack(outs), used


def _case_world(rng, n: int):
    """Capacity and usage of n rows (integer sizes, as real nodes have)."""
    cap = np.zeros((n, 4), np.float32)
    cap[:, 0] = rng.choice([2000, 4000, 8000], n)
    cap[:, 1] = rng.choice([4096, 8192, 16384], n)
    cap[:, 2:] = [100000, 1000]
    used = np.zeros((n, 4), np.float32)
    used[:, 0] = rng.integers(0, 8, n) * 100
    used[:, 1] = rng.integers(0, 8, n) * 256
    return cap, used


def _case_eval(rng, cap, used, g: int, s: int, k: int, v: int) -> dict:
    """One eval's fields (numpy) with every scoring feature on."""
    n = cap.shape[0]
    desired = np.full((g, k, v + 1), -1.0, np.float32)
    counts = np.zeros((g, k, v + 1), np.float32)
    counts[..., :v] = rng.integers(0, 3, (g, k, v))
    demand = np.zeros((s, 4), np.float32)
    demand[:, :2] = [300, 512]
    return dict(
        capacity=cap, used=used, feasible=rng.random((g, n)) < 0.9,
        affinity=rng.choice(np.array([-1.0, -0.5, 0.0, 0.0, 0.5, 1.0],
                                     np.float32), (g, n)),
        has_affinity=rng.random(g) < 0.5,
        desired_count=rng.integers(1, 20, g).astype(np.int32),
        penalty=rng.random((g, n)) < 0.05,
        tg_count=(rng.random((g, n)) < 0.1).astype(np.int32),
        spread_vidx=rng.integers(0, v + 1, (g, k, n)).astype(np.int32),
        spread_desired=desired, spread_targeted=np.zeros((g, k), bool),
        spread_wfrac=rng.choice(np.array([0.25, 0.5, 1.0], np.float32),
                                (g, k)),
        spread_counts=counts, spread_active=np.ones((g, k), bool),
        place_cap=np.full((g, n), -1, np.int32), demand=demand,
        slot_tg=np.zeros(s, np.int32), slot_active=np.ones(s, bool))


def scan_model_cases(seed: int = 0) -> list:
    """The edge cases of K2/K3's cached step, which the tests and
    chip_smoke.py hold the model and the kernels to: [(label, evals,
    deltas)], `evals` one chain's fields (numpy, one world; K2 takes the
    first), `deltas` each eval's [(row, f32[R])].  Most share one shape
    (3 groups, 3 spreads over 6 values, 24 slots, 61 rows: not a
    multiple of the cluster's 8 blocks), so that the reference compiles
    them once."""
    rng = np.random.default_rng(seed)
    cases = []
    n, g3, s24, k3, v6 = 61, 3, 24, 3, 6

    def add(label, evals, deltas=None):
        cases.append((label, evals, deltas or [[] for _ in evals]))

    def one_spread(f):
        f["spread_active"][:, 1:] = False
        return f

    cap, used = _case_world(rng, n)
    new = lambda c=cap, u=used: _case_eval(rng, c, u, g3, s24, k3, v6)  # noqa

    f = one_spread(new())
    f["slot_tg"][:] = [0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 1, 1] * 2
    f["demand"][2:4, :2] = [500, 256]          # demand changes, group 0
    f["demand"][4:7, :2] = [100, 1024]
    f["demand"][10:15, 0] = 200
    add("group and demand change mid-scan", [f, f])

    f = new()
    f["slot_active"][:] = [1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 1] * 2
    f["slot_tg"][:] = [0, 0, 1, 0, 1, 1, 0, 0, 1, 0, 0, 2] * 2
    add("inactive slots between active ones", [f, f])

    # four row classes, identical within a class, spread over the blocks:
    # the fifth place always ties with rows past it
    cls = rng.permutation(np.repeat(np.arange(4), [3, 4, 25, n - 32]))
    cc = np.array([[4000, 8192], [8000, 16384], [4000, 4096],
                   [2000, 8192]], np.float32)
    cu = np.array([[1200, 2048], [800, 512], [0, 0], [400, 1024]],
                  np.float32)
    tcap, tused = cap.copy(), used.copy()
    tcap[:, :2], tused[:, :2] = cc[cls], cu[cls]
    f = one_spread(new(tcap, tused))
    f["feasible"][:] = True
    f["affinity"][0] = np.array([0.5, 0.0, -0.5, 1.0], np.float32)[cls]
    f["penalty"][:] = False
    f["tg_count"][:] = 0
    f["spread_vidx"][0, 0] = cls % 3
    add("ties at the top-5 boundary", [f, f])

    f = one_spread(new())
    f["feasible"][:] = False
    f["feasible"][0, [7, 30, 58]] = True
    f["place_cap"][0, [7, 30, 58]] = 1
    add("fewer than 5 rows fit", [f, f])

    f = one_spread(new())
    f["place_cap"][0] = rng.choice(np.array([-1, 0, 1, 2], np.int32), n,
                                   p=[0.4, 0.1, 0.3, 0.2])
    f["demand"][:, :2] = [100, 256]
    add("place_cap reaching 0", [f, f])

    f = new()
    f["spread_counts"][0, 0, :v6] = 2.0        # even spread, min == max
    f["spread_counts"][1] = 0.0                # nothing placed yet
    f["spread_targeted"][:, 1] = True
    f["spread_desired"][:, 1, :v6] = rng.integers(0, 6, (g3, v6))
    f["spread_active"][:, 2] = False
    f["spread_vidx"][:, :, ::4] = v6           # missing attribute
    f["slot_tg"][:] = [0, 1] * 12
    add("spreads: min == max, targeted, missing attribute", [f, f])

    f = new()
    f["spread_targeted"][1] = [True, False, True]
    f["spread_desired"][1, :, :v6] = rng.integers(0, 6, (k3, v6))
    f["spread_active"][2, 1] = False
    f["slot_tg"][:] = rng.integers(0, g3, s24)
    f["demand"][:, :2] = rng.integers(1, 6, (s24, 2)) * [100, 256]
    add("mixed: three groups, three spreads", [f, f])

    f = one_spread(new())
    f["feasible"][:] = True
    f["spread_vidx"][0, 0] = np.arange(n) % 5
    f["demand"][:, :2] = [100, 256]
    add("rack spread (one group, one demand)", [f, f])

    # deltas on a repeated row, on rows past N, and ones that cancel, on
    # rows whose cpu usage is -0.0
    du = used.copy()
    du[::3, 0] = -0.0
    evals, deltas = [], []
    for e in range(3):
        evals.append(new(cap, du))
        r = 3 * int(rng.integers(0, n // 3))
        v = np.array([100, 256, 0, 0], np.float32)
        deltas.append([(r, v), (n, v), (r, 2 * v), (n + 5, v),
                       ((r + 1) % n, v), ((r + 1) % n, -v), (r, -v)])
    add("deltas: repeated rows, rows past N", evals, deltas)

    # -0.0 usages, and -0.0 demands on the dims they leave at 0
    zu = used.copy()
    zu[:, 2:] = -0.0
    zu[::3, 0] = -0.0
    for s in (1, s24):
        f = one_spread(_case_eval(rng, cap, zu, g3, s, k3, v6))
        f["demand"][:, 2:] = -0.0
        f["demand"][:, :2] = [0, 2048]
        f["penalty"][:] = False
        add(f"-0.0 usages, S = {s}", [f, f])

    f = _case_eval(rng, cap, used, 2, 8, 2, 1500)
    f["slot_tg"][:] = [0, 0, 1, 1, 0, 1, 1, 0]
    add("1,500 spread values (the state past shared memory)", [f, f])

    cap5, used5 = _case_world(rng, 5)
    used5[1] = -0.0
    add("N = 5 rows", [_case_eval(rng, cap5, used5, 1, 7, 1, 3)] * 2)

    # negative delta rows (no caller packs one): the reference takes a row
    # in [-N, 0) as row + N, as JAX indexes, and drops -N - 1 and N; -1
    # and N - 1 are one row, as are r - N and r
    evals, deltas = [], []
    v = np.array([100, 256, 0, 0], np.float32)
    for e in range(2):
        evals.append(new())
        r = int(rng.integers(1, n - 1))
        deltas.append([(-1, v), (-n, 2 * v), (-n - 1, v), (n, v),
                       (n - 1, -v), (r - n, v), (r, 3 * v)])
    add("deltas: negative rows", evals, deltas)

    # scores of NaN and -inf on fitting rows.  Each touches group 0 only
    # and the slots alternate groups 0 and 1, so group 1's slots place:
    # where a fitting row of the slot's group scores NaN, jnp.argmax picks
    # it and `masked[sel] > -inf` places nothing; a NaN ranks in the
    # top-5 by its sign (lax.top_k: +NaN first, -NaN last).  On the card
    # every NaN the arithmetic gives is +NaN.
    def nan_group0(f, row=None):
        f["slot_tg"][:] = [0, 1] * 12
        if row is not None:
            f["feasible"][0, row] = True
            f["feasible"][1, row] = False
            f["place_cap"][0, row] = -1
        return f

    # +inf capacity and usage on one row: 1 - inf / inf
    icap, iused, r_inf = cap.copy(), used.copy(), 17
    icap[r_inf, 0] = iused[r_inf, 0] = np.inf
    add("a fitting row scoring NaN (+inf capacity and usage)",
        [nan_group0(one_spread(new(icap, iused)), r_inf)] * 2)

    # every fitting row of group 0 at an affinity of -inf: the top score
    # is -inf, as are the rows that do not fit (every fifth row full)
    full = used.copy()
    full[::5] = cap[::5]
    f = nan_group0(one_spread(new(cap, full)))
    f["affinity"][0] = -np.inf
    f["has_affinity"][0] = True
    add("every fitting row scoring -inf beside rows that do not fit",
        [f, f])

    # an affinity of +NaN on one row (the CPU's add keeps its sign): a
    # NaN ranked first in the top-5, finite fitting rows after it
    nan_bits = lambda b: np.array([b], np.uint32).view(np.float32)[0]  # noqa
    f = nan_group0(one_spread(new()), 40)
    f["affinity"][0, 40] = nan_bits(0x7FC00000)
    f["has_affinity"][0] = True
    add("a NaN row in the top-5 beside finite fitting rows", [f, f])

    # an affinity of -NaN on one row: the score is -NaN on the CPU (last
    # in lax.top_k's order, still jnp.argmax's pick), +NaN on the card
    f = nan_group0(one_spread(new()), 9)
    f["affinity"][0, 9] = nan_bits(0xFFC00000)
    f["has_affinity"][0] = True
    add("a row scoring -NaN", [f, f])
    return cases


def scan_case_batch(evals, deltas, D: int = 8):
    """One case's K3 inputs (numpy): (capacity, used0, heavy, dyn, dims)."""
    inps = [PlaceInputs(**f) for f in evals]
    heavy = np.stack([pack_heavy(i) for i in inps])
    dyn = np.concatenate([pack_light(i, d, D) for i, d in zip(inps, deltas)])
    G, N, K, Vp1 = heavy_dims(inps[0])
    return (evals[0]["capacity"], evals[0]["used"], heavy, dyn,
            (G, N, K, Vp1, inps[0].demand.shape[0], D))


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
            f"place_bulk_batch: N={N}; the kernel's key holds a row in 24 "
            f"bits and takes 4..{BULK_MAX_ROWS} rows")
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
    scratch = torch.empty((2, N), dtype=torch.int32, device=dev)
    rc = _on_card(
        dev.index, lib.place_bulk_batch_launch,
        _ptr(capacity), _ptr(used0), _ptr(heavy), _ptr(dyn), E, N, int(D),
        int(bool(sparse_out)), int(bool(spread_algorithm)), int(max_waves),
        int(fill_grid), int(bool(exact_out)), _ptr(used), _ptr(packed),
        _ptr(scratch), _stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"place_bulk_batch kernel launch failed: CUDA error {rc}")
    launches["place_bulk_batch"] += 1
    if exact_out:
        return packed, used, used0
    return packed, used
