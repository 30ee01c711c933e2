"""The shard-local kernels of the sharded serving path (K7a-K7g).

Torch port of the device work inside the reference's
parallel/sharded.py shard_map bodies (`_place_step_sharded`,
`place_batch_sharded`'s eval scan, `place_bulk_batch_sharded`'s wave
loop and basis merge).  One call of each wrapper works on ONE node shard
(rows [off, off + n) of an N-row world) on that shard's device; the
collectives between them are explicit gathers of the small records the
kernels write (parallel/sharded.py sequences them).

- K7a `scan_local`: one scan slot on one shard: scores the local rows and
  writes the shard's record (local best and its global row, the fit
  score and spread value indices at that row, local n_eval/n_exh, the
  local top-K) into its slot of the gathered record buffer.  The kernel
  keeps each row's partial score in the shard's cache across slots and
  rescores only the row in the shard's pick word between slots of one
  group and demand (`scan_local_cached_model` is its model).
- K7b `scan_apply`: from the gathered records, the global selection
  (pmax score, pmin row, stable merge of the top-K lists); the owning
  shard updates used/tg_count/place_cap at the picked row (and names it
  in its pick word, -1 elsewhere), every shard its replica of the spread
  counts; shard 0 writes the slot's packed row.  The kernel is one warp
  with a lane a shard and the merge over lanes (`scan_apply_model`).
- K7c `bulk_stats`: one bulk wave's statistics on one shard (any fit, the
  m = 2 column's best, the local top-2 of the wave-start scores, which go
  to the gathered score vector); with `begin` it first starts the eval
  (its deltas, coll0, the lane state).  One thread-block cluster a
  launch.
- K7d `bulk_run`: every local row's fill run length (capped at the
  remaining count) in the wave set the gathered statistics give; the
  kernel scores a row's cells in parallel and takes the first failure
  (`bulk_run_model`).
- K7e `bulk_order`: the greedy order over the gathered [N] vectors
  (identical on every shard) and this shard's share of it; the lane
  state, and the eval's tail (final scores, local counts, exact carry,
  deltas backed out) when the stop test ends the eval.  The kernel
  selects the order's first min(remaining, |wave|) rows instead of
  sorting the wave (no global scratch).
- K7f `bulk_counts`: the psum of the shards' n_eval/n_exh partials.  It
  has no launch of its own: node shard 0's K7g launch carries it.
- K7g `basis_merge`: `used_tot = u0 + psum_wave(exact - u0)` on one shard.

Each has a plain PyTorch version here, which the wrapper takes for CPU
tensors; CUDA tensors launch csrc/sharded.cu.  Records are i32 words
(floats stored as their bits).  `launches` counts kernel launches only.
K7a's (which K7b shares) and K7c-K7e's operands are packed into a
`ctypes.Structure` at a shard's first launch and passed by address
after; a shard's tensors are therefore never replaced, only written in
place.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field, fields
from types import SimpleNamespace
from typing import Optional

import torch

from nomad_tpu_torch.ops import _build
from nomad_tpu_torch.ops.fit import score_fit
from nomad_tpu_torch.ops.place import (
    FIT_NORM,
    PACKED_WIDTH,
    SCAN_MAX_SPREADS,
    TOP_K,
    _argmax,
    _boost_tables,
    _lax_top_k,
    _partial_scores,
    _spread_boost,
    _on_card,
    _stream,
    bulk_run_lengths,
    bulk_wave_grid,
)

BIG = 2 ** 31 - 1
# the scan record: i32 words, floats as bits
REC_BEST, REC_ROW, REC_FIT, REC_NEVAL, REC_NEXH = 0, 1, 2, 3, 4
REC_TOPS = 5                        # TOP_K scores
REC_TOPI = REC_TOPS + TOP_K         # TOP_K global rows
REC_V = REC_TOPI + TOP_K            # spread value indices at the best row
SCAN_REC = REC_V + SCAN_MAX_SPREADS
# the bulk wave's per-shard statistics: top-2 of cur, the shard's part of
# s* (max m=2 score), any fit, max non-NaN cur
STATS_W = 5
# the lane state of one bulk eval, per shard: placed, waves, stuck, done
ST_PLACED, ST_WAVES, ST_STUCK, ST_DONE = 0, 1, 2, 3
STATE_W = 4
# per-eval partial counts: placed, n_eval (local), n_exh (local), waves
COUNTS_W = 4
# K7a's cache (csrc/sharded.cu): partial totals, fits and flag words [n]
# each, then the key: the group (-1: none) and the demand's f32 bits
SCAN_CACHE_META = 8
F_FEAS, F_FITS = 1, 2               # flag word bits; the scorer count << 2

launches = {"scan_local": 0, "scan_apply": 0, "bulk_stats": 0,
            "bulk_run": 0, "bulk_order": 0, "basis_merge": 0}


def _f(t: torch.Tensor) -> torch.Tensor:
    """The f32 view of i32 record words."""
    return t.view(torch.float32)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's address for a c_void_p argument (None: NULL)."""
    return None if t is None else t.data_ptr()


def _packed(cls, values) -> tuple:
    """A `cls` (ctypes.Structure) of `values` and its address, which the
    entry points take: (the structure, kept alive by the caller; the
    address as c_void_p)."""
    st = cls(*values)
    return st, ctypes.c_void_p(ctypes.addressof(st))


def _kind(t: torch.Tensor, name: str) -> str:
    if t.is_cuda:
        return "cuda"
    if t.is_cpu:
        return "cpu"
    raise ValueError(f"{name}: unsupported device {t.device}")


def shard_max(xs) -> torch.Tensor:
    """The reference's pmax over the shards' values `xs` (0-d tensors on
    one device, in shard order), as XLA's all-reduce takes it: a value
    kept only where it beats the running maximum, so a NaN never wins
    (all NaN: -inf) and of equal values (+0.0 and -0.0) the first
    shard's stays."""
    acc = xs[0]
    if acc.is_floating_point():
        acc = torch.where(torch.isnan(acc), torch.full_like(acc, -torch.inf),
                          acc)
    for x in xs[1:]:
        acc = torch.where(x > acc, x, acc)
    return acc


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1


def _check_same_device(name: str, obj) -> None:
    dev = None
    for f in fields(obj):
        t = getattr(obj, f.name)
        if not isinstance(t, torch.Tensor):
            continue
        if dev is None:
            dev = t.device
        if t.device != dev:
            raise ValueError(f"{name}.{f.name}: on {t.device}, shard on {dev}")


# --------------------------------------------------------------------------
# K7a / K7b: the scan path
# --------------------------------------------------------------------------

@dataclass
class ScanShard:
    """One node shard of one scan eval: rows [off, off + n) of the
    node-axis fields, the replicated fields, and the carries it updates
    in place (the usage carry, and tg_count/place_cap/spread counts that
    each eval restarts from its own fields), with K7a's cache and the
    pick word K7b writes for it.  `packed`: K7a's operands, packed at the
    shard's first launch."""
    off: int
    capacity: torch.Tensor        # f32[n, R]
    used: torch.Tensor            # f32[n, R] usage carry
    feasible: torch.Tensor        # bool[G, n]
    affinity: torch.Tensor        # f32[G, n]
    penalty: torch.Tensor         # bool[G, n]
    tg0: torch.Tensor             # i32[G, n] the eval's tg_count
    cap0: torch.Tensor            # i32[G, n] the eval's place_cap
    vidx: torch.Tensor            # i32[G, K, n]
    has_affinity: torch.Tensor    # bool[G]
    desired_count: torch.Tensor   # i32[G]
    spread_desired: torch.Tensor  # f32[G, K, V1]
    spread_targeted: torch.Tensor  # bool[G, K]
    spread_wfrac: torch.Tensor    # f32[G, K]
    counts0: torch.Tensor         # f32[G, K, V1] the eval's spread counts
    spread_active: torch.Tensor   # bool[G, K]
    demand: torch.Tensor          # f32[S, R]
    slot_tg: torch.Tensor         # i32[S]
    slot_active: torch.Tensor     # bool[S]
    tg_count: torch.Tensor        # i32[G, n] carry
    place_cap: torch.Tensor       # i32[G, n] carry
    counts: torch.Tensor          # f32[G, K, V1] carry (this shard's replica)
    cache: torch.Tensor           # i32[...] K7a's row cache (scan_cache)
    pick: torch.Tensor            # i32[1] the local row K7b changed, -1 none
    packed: Optional[tuple] = field(default=None, init=False, repr=False,
                                    compare=False)

    def check(self) -> "ScanShard":
        _check_same_device("ScanShard", self)
        n, R = self.capacity.shape
        G, K = self.spread_wfrac.shape
        if not 1 <= K <= SCAN_MAX_SPREADS:
            raise ValueError(f"ScanShard: K={K}, the kernels take "
                             f"1..{SCAN_MAX_SPREADS}")
        if R != 4 or self.feasible.shape != (G, n) \
                or self.vidx.shape != (G, K, n):
            raise ValueError("ScanShard: inconsistent shapes")
        f32, i32 = torch.float32, torch.int32
        if not (self.capacity.dtype == self.used.dtype == self.counts.dtype
                == self.demand.dtype == f32) or not (
                    self.tg_count.dtype == self.place_cap.dtype == i32):
            raise ValueError("ScanShard: f32 capacity, usage, demand and "
                             "spread counts; i32 tg_count and place_cap")
        if self.cache.dtype != torch.int32 \
                or self.cache.numel() < 3 * n + SCAN_CACHE_META \
                or self.pick.dtype != torch.int32 or self.pick.numel() != 1:
            raise ValueError("ScanShard: cache i32[>= 3n + "
                             f"{SCAN_CACHE_META}] and pick i32[1]")
        for f in fields(self):
            t = getattr(self, f.name)
            if isinstance(t, torch.Tensor) and not t.is_contiguous():
                raise ValueError(f"ScanShard.{f.name}: not contiguous")
        return self


def scan_cache(n: int, K: int, V1: int, device) -> torch.Tensor:
    """K7a's cache for a shard of n rows, K spreads over V1 - 1 values:
    partial totals, fits (f32 bits) and flag words [n] each, the key
    (SCAN_CACHE_META words), and on the card, where the boost tables pass
    what a block keeps in shared memory, a table region
    (`scan_cache_words_of`).  An eval's first slot sets its contents."""
    device = torch.device(device)
    words = 3 * n + SCAN_CACHE_META
    if device.type == "cuda":
        words = int(_build.load("sharded").scan_cache_words_of(n, K, V1))
    return torch.empty(words, dtype=torch.int32, device=device)


class ScanArgs(ctypes.Structure):
    """csrc/sharded.cu ScanArgs: one shard's K7a operands."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "cap", "used", "feas", "aff", "pen", "tg0", "cap0", "vidx",
        "has_aff", "desired", "sdes", "targeted", "wfrac", "counts0",
        "active", "demand", "slot_tg", "slot_active", "tg_count",
        "place_cap", "counts", "cache", "pick")] + \
        [(name, ctypes.c_int) for name in ("G", "n", "K", "V1", "off",
                                           "cache_words")]


def _scan_args(sh: ScanShard) -> ctypes.c_void_p:
    """The address of the shard's packed K7a operands (packed once)."""
    if sh.packed is None:
        n = sh.capacity.shape[0]
        G, K = sh.spread_wfrac.shape
        ts = (sh.capacity, sh.used, sh.feasible, sh.affinity, sh.penalty,
              sh.tg0, sh.cap0, sh.vidx, sh.has_affinity, sh.desired_count,
              sh.spread_desired, sh.spread_targeted, sh.spread_wfrac,
              sh.counts0, sh.spread_active, sh.demand, sh.slot_tg,
              sh.slot_active, sh.tg_count, sh.place_cap, sh.counts,
              sh.cache, sh.pick)
        sh.packed = _packed(ScanArgs, [t.data_ptr() for t in ts] + [
            G, n, K, sh.spread_desired.shape[2], sh.off, sh.cache.numel()])
    return sh.packed[1]


def _add_deltas_local(used: torch.Tensor, off: int, rows: torch.Tensor,
                      vals: torch.Tensor) -> None:
    """used[rows[k] - off] += vals[k] in place, in order; rows outside
    this shard (pad rows among them) drop."""
    n = used.shape[0]
    lr = rows.to(torch.int64) - off
    for k in torch.nonzero((lr >= 0) & (lr < n)).flatten().tolist():
        r = int(lr[k])
        used[r] = used[r] + vals[k]


def _scan_start(sh: ScanShard, used_in: Optional[torch.Tensor],
                delta_rows: Optional[torch.Tensor],
                delta_vals: Optional[torch.Tensor]) -> None:
    """An eval's start on the shard (K7a's plain version and its cached
    model): the usage carry from `used_in` (when given), the eval's
    deltas added to it in order, the other carries from the eval's
    fields."""
    if used_in is not None:
        sh.used.copy_(used_in)
    if delta_rows is not None:
        _add_deltas_local(sh.used, sh.off, delta_rows, delta_vals)
    sh.tg_count.copy_(sh.tg0)
    sh.place_cap.copy_(sh.cap0)
    sh.counts.copy_(sh.counts0)


def _scan_record(sh: ScanShard, g: int, masked: torch.Tensor,
                 fit_score: torch.Tensor, n_eval, n_exh,
                 top_s: torch.Tensor, top_i: torch.Tensor) -> torch.Tensor:
    """A shard's scan record (K7a's plain version and its cached model)
    from its local top list (top_i local rows).  The best is jnp.max's
    and its row jnp.argmax's (a NaN of either sign first): the kernel's
    first key, where a NaN is the card's +NaN."""
    n = masked.shape[0]
    k = min(TOP_K, n)
    li = int(_argmax(masked))
    best = masked[li]
    rec = torch.zeros(SCAN_REC, dtype=torch.int32, device=masked.device)
    recf = _f(rec)
    recf[REC_BEST] = best
    rec[REC_ROW] = sh.off + li
    rec[REC_NEVAL] = n_eval
    rec[REC_NEXH] = n_exh
    recf[REC_TOPS:REC_TOPS + TOP_K] = float("-inf")
    recf[REC_TOPS:REC_TOPS + k] = top_s
    rec[REC_TOPI:REC_TOPI + TOP_K] = BIG
    rec[REC_TOPI:REC_TOPI + k] = (top_i + sh.off).to(torch.int32)
    if bool(best > float("-inf")):
        recf[REC_FIT] = fit_score[li]
        K = sh.vidx.shape[1]
        rec[REC_V:REC_V + K] = sh.vidx[g, :, li]
    return rec


def scan_local_plain(sh: ScanShard, s: int, init: bool,
                     used_in: Optional[torch.Tensor],
                     delta_rows: Optional[torch.Tensor],
                     delta_vals: Optional[torch.Tensor],
                     recs: torch.Tensor, shard: int,
                     spread_algorithm: bool) -> None:
    """Plain version of K7a: `_place_step_sharded`'s local half for slot
    `s` (lines 186-217 and the local reductions), written into
    recs[shard].  With `init` (an eval's first slot) it first starts the
    eval: the usage carry from `used_in` (when given), the eval's deltas
    added to it in order, the other carries from the eval's fields."""
    f32 = torch.float32
    n = sh.capacity.shape[0]
    if init:
        _scan_start(sh, used_in, delta_rows, delta_vals)
    g = int(sh.slot_tg[s])
    d = sh.demand[s]
    active = sh.slot_active[s]
    feas = sh.feasible[g] & (sh.place_cap[g] != 0)
    util = sh.used + d
    fits = torch.all(util <= sh.capacity, dim=-1) & feas
    fit_score = score_fit(sh.capacity, util, spread_algorithm) * FIT_NORM
    total = fit_score
    n_scorers = torch.ones_like(fit_score)
    coll = sh.tg_count[g].to(f32)
    anti = -(coll + 1.0) / torch.clamp(sh.desired_count[g].to(f32), min=1.0)
    has_coll = coll > 0.0
    total = total + torch.where(has_coll, anti, torch.zeros_like(anti))
    n_scorers = n_scorers + has_coll.to(f32)
    pen = sh.penalty[g].to(f32)
    total = total - pen
    n_scorers = n_scorers + pen
    aff = sh.affinity[g]
    aff_on = sh.has_affinity[g] & (aff != 0.0)
    total = total + torch.where(aff_on, aff, torch.zeros_like(aff))
    n_scorers = n_scorers + aff_on.to(f32)
    view = SimpleNamespace(spread_vidx=sh.vidx, spread_desired=sh.spread_desired,
                           spread_targeted=sh.spread_targeted,
                           spread_wfrac=sh.spread_wfrac,
                           spread_active=sh.spread_active)
    sboost = _spread_boost(view, g, sh.counts[g])
    sb_on = torch.any(sh.spread_active[g]) & (sboost != 0.0)
    total = total + torch.where(sb_on, sboost, torch.zeros_like(sboost))
    n_scorers = n_scorers + sb_on.to(f32)
    final = total / n_scorers
    masked = torch.where(fits & active, final,
                         torch.full_like(final, float("-inf")))

    top_s, top_i = _lax_top_k(masked, min(TOP_K, n))
    recs[shard] = _scan_record(
        sh, g, masked, fit_score, torch.sum(feas & active).to(torch.int32),
        torch.sum(feas & ~fits & active).to(torch.int32), top_s, top_i)


def _orderable(x: torch.Tensor) -> torch.Tensor:
    """csrc/bulk_common.cuh orderable() as int64 (the f32 bits, sign
    flipped for positives and inverted for negatives)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)


def _key_top(masked: torch.Tensor, off: int, k: int):
    """K7a's top-k by its 64-bit keys: the orderable score of v + 0.0
    (+0.0 and -0.0 one score; a NaN by its sign, the card's +NaN above
    +inf), then the lower row.  Returns (scores, local rows)."""
    v = masked + 0.0
    rows = torch.arange(masked.shape[0], dtype=torch.int64) + off
    key = _orderable(v) * (1 << 31) + (0x7FFFFFFF - rows)
    top = torch.argsort(key, descending=True)[:k]
    return masked[top], top


def _rescore(sh: ScanShard, g: int, dem: torch.Tensor,
             spread_algorithm: bool, row: Optional[int]) -> None:
    """K7a's cache entries of every row (row None) or one row under group
    g and demand dem: the stack up to the spread term in the reference's
    order, from the current carries (computed over every row, as the
    plain version computes it, and kept where asked)."""
    n = sh.capacity.shape[0]
    part, fit, feas, fits, n_sc = _partial_scores(
        sh, g, dem, sh.used, sh.tg_count, sh.place_cap, spread_algorithm)
    flag = feas.to(torch.int32) * F_FEAS + fits.to(torch.int32) * F_FITS \
        + n_sc.to(torch.int32) * 4
    sel = slice(None) if row is None else slice(row, row + 1)
    sh.cache[0:n].view(torch.float32)[sel] = part[sel]
    sh.cache[n:2 * n].view(torch.float32)[sel] = fit[sel]
    sh.cache[2 * n:3 * n][sel] = flag[sel]


def scan_local_cached_model(sh: ScanShard, s: int, init: bool,
                            used_in: Optional[torch.Tensor],
                            delta_rows: Optional[torch.Tensor],
                            delta_vals: Optional[torch.Tensor],
                            recs: torch.Tensor, shard: int,
                            spread_algorithm: bool) -> None:
    """Model of K7a's cached step (csrc/sharded.cu), on CPU tensors, for
    the tests, which hold its records and carries bit-equal to
    `scan_local_plain`'s slot by slot.  The cache holds each row's
    partial total (fit + anti - penalty + affinity), fit and flag word
    (feasible, fits, scorer count) for its key (group, demand); every row
    is rescored at the eval's first slot and when the slot's key differs,
    otherwise only the row in the pick word (K7b's); an inactive slot
    keeps the key and rescores the pending pick under it.  The spread
    term comes from per-value boost tables added in spread order; the
    top-5 from the kernel's keys."""
    f32, i32 = torch.float32, torch.int32
    n = sh.capacity.shape[0]
    V = sh.spread_desired.shape[2] - 1
    key = sh.cache[3 * n:3 * n + SCAN_CACHE_META]
    if init:
        _scan_start(sh, used_in, delta_rows, delta_vals)
        kg, kd, pick = -1, torch.zeros(4, dtype=f32), -1
    else:
        kg, kd, pick = int(key[0]), key[1:5].view(f32).clone(), int(sh.pick[0])
    if not bool(sh.slot_active[s]):
        if kg >= 0 and 0 <= pick < n:
            _rescore(sh, kg, kd, spread_algorithm, pick)
        if init:
            key[0] = -1
        k = min(TOP_K, n)
        recs[shard] = _scan_record(
            sh, 0, torch.full((n,), float("-inf")), None, 0, 0,
            torch.full((k,), float("-inf")), torch.arange(k))
        return
    g = int(sh.slot_tg[s])
    d = sh.demand[s]
    rescore_all = kg != g or not torch.equal(d.view(i32), kd.view(i32))
    if rescore_all:
        _rescore(sh, g, d, spread_algorithm, None)
    elif 0 <= pick < n:
        _rescore(sh, g, d, spread_algorithm, pick)
    part = sh.cache[0:n].view(f32)
    fit = sh.cache[n:2 * n].view(f32)
    flag = sh.cache[2 * n:3 * n]
    sb = torch.zeros(n, dtype=f32)
    for k, tab in _boost_tables(sh, g, sh.counts[g]):
        sb = sb + tab[torch.clamp(sh.vidx[g, k].long(), max=V)]
    sb_on = sb != 0.0
    total = part + torch.where(sb_on, sb, torch.zeros_like(sb))
    n_sc = ((flag >> 2) + sb_on.to(i32)).to(f32)
    fits = (flag & F_FITS) != 0
    feas = (flag & F_FEAS) != 0
    masked = torch.where(fits, total / n_sc,
                         torch.full_like(total, float("-inf")))
    top_s, top_i = _key_top(masked, sh.off, min(TOP_K, n))
    recs[shard] = _scan_record(sh, g, masked, fit,
                               torch.sum(feas).to(i32),
                               torch.sum(feas & ~fits).to(i32), top_s, top_i)
    if rescore_all:
        key[0] = g
        key[1:5] = d.view(i32)


def scan_local(sh: ScanShard, s: int, init: bool,
               used_in: Optional[torch.Tensor],
               delta_rows: Optional[torch.Tensor],
               delta_vals: Optional[torch.Tensor],
               recs: torch.Tensor, shard: int,
               spread_algorithm: bool) -> None:
    """K7a wrapper (see scan_local_plain).  CUDA shards launch
    csrc/sharded.cu with the shard's packed operands; CPU shards take the
    plain version."""
    if _kind(sh.used, "scan_local") == "cpu":
        return scan_local_plain(sh, s, init, used_in, delta_rows, delta_vals,
                                recs, shard, spread_algorithm)
    lib = _build.load("sharded")
    dev = sh.used.get_device()
    rc = _on_card(
        dev, lib.scan_local_launch,
        _scan_args(sh), _ptr(used_in), _ptr(delta_rows), _ptr(delta_vals),
        0 if delta_rows is None else delta_rows.shape[0], int(s),
        int(bool(init)), _ptr(recs), int(shard), int(bool(spread_algorithm)),
        _stream(dev))
    _launched("scan_local", rc)


def scan_apply_plain(sh: ScanShard, s: int, recs: torch.Tensor,
                     out: Optional[torch.Tensor]) -> None:
    """Plain version of K7b: the global selection from the gathered
    records (pmax score as the reference takes it, `shard_max`; pmin
    global row among the shards holding it),
    the carry updates of `_place_step_sharded` (lines 229-244) on this
    shard, the pick word (the local row updated here, -1 where the pick
    is another shard's or there is none), and, where `out` (f32[S,
    PACKED_WIDTH]) is given, the slot's packed row: the psums of the
    counts and the fit score, and the stable merge of the shards' top-K
    lists (`argsort(-top_s)[:TOP_K]` over them in shard order)."""
    n = sh.capacity.shape[0]
    n_shard = recs.shape[0]
    k = min(TOP_K, n)
    g = int(sh.slot_tg[s])
    d = sh.demand[s]
    recf = _f(recs)
    bests = recf[:, REC_BEST]
    gb = shard_max(list(bests))
    ok_any = bool(gb > float("-inf"))
    cand = torch.where((bests == gb) & ok_any, recs[:, REC_ROW],
                       torch.full_like(recs[:, REC_ROW], BIG))
    sel = int(torch.min(cand))
    ok = sel < BIG
    changed = -1
    if ok:
        w = int(torch.nonzero(cand == sel).flatten()[0])
        lr = sel - sh.off
        if 0 <= lr < n:
            sh.used[lr] = sh.used[lr] + d
            sh.tg_count[g, lr] += 1
            if int(sh.place_cap[g, lr]) > 0:
                sh.place_cap[g, lr] -= 1
            changed = lr
        V1 = sh.counts.shape[2]
        K = sh.vidx.shape[1]
        v = recs[w, REC_V:REC_V + K].to(torch.int64)
        upd = (sh.spread_active[g] & (v < V1 - 1)).tolist()
        for kk in range(K):
            if upd[kk]:
                sh.counts[g, kk, int(v[kk])] += 1.0
    sh.pick[0] = changed
    if out is None:
        return
    row = torch.zeros(PACKED_WIDTH, dtype=torch.float32, device=out.device)
    row[0] = float(sel) if ok else -1.0
    row[1] = gb if ok else 0.0
    row[2] = recf[w, REC_FIT] + 0.0 if ok else 0.0
    row[3] = float(int(torch.sum(recs[:, REC_NEVAL])))
    row[4] = float(int(torch.sum(recs[:, REC_NEXH])))
    tops = recf[:, REC_TOPS:REC_TOPS + k].reshape(-1)
    topi = recs[:, REC_TOPI:REC_TOPI + k].reshape(-1)
    order = torch.argsort(-tops, stable=True)[:TOP_K]
    row[5:5 + TOP_K] = topi[order].to(torch.float32)
    row[5 + TOP_K:] = tops[order]
    out[s] = row


def _apply_pick(recs: torch.Tensor):
    """K7b's global selection from the gathered records, as the kernel's
    warp takes it: (ok, the selected global row, the winning shard, the
    best score's bits as f32).  The maximum of the orderable bests (-0.0
    read as +0.0) over the shards whose best is not NaN (none: no pick),
    its bits those of the first shard holding it (the reference's pmax),
    and the lowest row among the shards holding it, the first such shard
    the winner."""
    bests = _f(recs[:, REC_BEST])
    ob = _orderable(bests + 0.0).tolist()
    real = [j for j in range(len(ob)) if not bool(torch.isnan(bests[j]))]
    if not real:
        return False, BIG, -1, bests[0]
    mx = max(ob[j] for j in real)
    at = [j for j in real if ob[j] == mx]
    gb = bests[at[0]]
    if mx <= int(_orderable(torch.tensor([float("-inf")]))[0]):
        return False, BIG, -1, gb
    rows = recs[:, REC_ROW].tolist()
    sel = min(rows[j] for j in at)
    win = next(j for j in at if rows[j] == sel)
    return sel < BIG, sel, win, gb


def scan_apply_model(sh: ScanShard, s: int, recs: torch.Tensor,
                     out: Optional[torch.Tensor]) -> None:
    """Model of K7b's warp (csrc/sharded.cu), on CPU tensors, for the
    tests, which hold it bit-equal to `scan_apply_plain`: the selection
    of `_apply_pick`; the carry updates split as the lanes take them (R
    usage cells, one spread count a spread, tg_count, place_cap and the
    pick word); the top-K merge as five rounds of the maximum of 64-bit
    keys (the orderable score, -0.0 read as +0.0 and NaN below every
    score; then the position in the lists concatenated in shard order,
    lower first) below the previous winner, the entries' own bits
    written."""
    n = sh.capacity.shape[0]
    K = sh.vidx.shape[1]
    V1 = sh.counts.shape[2]
    g = int(sh.slot_tg[s])
    ok, sel, win, gb = _apply_pick(recs)
    lr = sel - sh.off
    here = ok and 0 <= lr < n
    if here:
        for d in range(sh.used.shape[1]):
            sh.used[lr, d] = sh.used[lr, d] + sh.demand[s, d]
    if ok:
        for k in range(K):
            v = int(recs[win, REC_V + k])
            if bool(sh.spread_active[g, k]) and v < V1 - 1:
                sh.counts[g, k, v] += 1.0
    if here:
        sh.tg_count[g, lr] += 1
        if int(sh.place_cap[g, lr]) > 0:
            sh.place_cap[g, lr] -= 1
    sh.pick[0] = lr if here else -1
    if out is None:
        return
    recf = _f(recs)
    kloc = min(TOP_K, n)
    tops = recf[:, REC_TOPS:REC_TOPS + kloc].reshape(-1)
    topi = recs[:, REC_TOPI:REC_TOPI + kloc].reshape(-1)
    folded = _orderable(tops + 0.0)
    keys = [(0 if bool(torch.isnan(tops[p])) else int(folded[p])) << 32
            | (0xFFFFFFFF - p) for p in range(tops.shape[0])]
    row = out[s]
    row[0] = float(sel) if ok else -1.0
    row[1] = gb if ok else 0.0
    row[2] = recf[win, REC_FIT] + 0.0 if ok else 0.0
    row[3] = float(int(torch.sum(recs[:, REC_NEVAL])))
    row[4] = float(int(torch.sum(recs[:, REC_NEXH])))
    prev = 1 << 64
    for k in range(TOP_K):
        prev = max(key for key in keys if key < prev)
        p = 0xFFFFFFFF - (prev & 0xFFFFFFFF)
        row[5 + k] = float(int(topi[p]))
        row[5 + TOP_K + k] = tops[p]


def scan_apply(sh: ScanShard, s: int, recs: torch.Tensor,
               out: Optional[torch.Tensor]) -> None:
    """K7b wrapper (see scan_apply_plain).  CUDA shards launch
    csrc/sharded.cu with the shard's packed operands (K7a's); CPU shards
    take the plain version."""
    if _kind(sh.used, "scan_apply") == "cpu":
        return scan_apply_plain(sh, s, recs, out)
    lib = _build.load("sharded")
    dev = sh.used.get_device()
    rc = _on_card(dev, lib.scan_apply_launch, _scan_args(sh), int(s),
                  _ptr(recs), recs.shape[0], _ptr(out), _stream(dev))
    _launched("scan_apply", rc)


# --------------------------------------------------------------------------
# K7c-K7g: the bulk wave
# --------------------------------------------------------------------------

@dataclass
class BulkShard:
    """One node shard of one lane of a bulk dispatch: rows [off, off + n)
    of the lane's E chained evals, the lane's carries on this shard, and
    its outputs (views into the assembled [E, N] outputs or local
    buffers; rows contiguous, any eval stride)."""
    off: int
    n_rows: int                   # N, the whole world's rows
    capacity: torch.Tensor        # f32[n, R]
    used: torch.Tensor            # f32[n, R] lane chain carry
    exact: torch.Tensor           # f32[n, R] lane exact carry
    delta: torch.Tensor           # f32[n, R] scratch: the eval's local deltas
    coll: torch.Tensor            # i32[n] scratch: co-placements
    feasible: torch.Tensor        # bool[E, n]
    affinity: torch.Tensor        # f32[E, n]
    penalty: torch.Tensor         # bool[E, n]
    coll0: torch.Tensor           # i32[E, n]
    has_affinity: torch.Tensor    # bool[E]
    desired: torch.Tensor         # i32[E]
    demand: torch.Tensor          # f32[E, R]
    count: torch.Tensor           # i32[E]
    delta_rows: Optional[torch.Tensor]   # i32[E, D] global rows, or None
    delta_vals: Optional[torch.Tensor]   # f32[E, D, R]
    assign: torch.Tensor          # i32[E, n] output view
    scores: torch.Tensor          # f32[E, n] output view
    partial: torch.Tensor         # i32[E, COUNTS_W]
    state: torch.Tensor           # i32[STATE_W]
    # scratch: each row's wave-start fit (K7c writes it, K7d and K7e's
    # tail read it: a fitting row may score -inf); check() makes it
    fits: Optional[torch.Tensor] = None   # bool[n]
    packed: Optional[tuple] = field(default=None, init=False, repr=False,
                                    compare=False)   # K7c-K7e's operands

    def check(self) -> "BulkShard":
        n = self.capacity.shape[0]
        if self.fits is None:
            self.fits = torch.zeros(n, dtype=torch.bool,
                                    device=self.capacity.device)
        _check_same_device("BulkShard", self)
        if self.fits.shape != (n,) or self.fits.dtype != torch.bool:
            raise ValueError("BulkShard.fits: bool[n]")
        E = self.feasible.shape[0]
        if self.assign.shape != (E, n) or self.scores.shape != (E, n) \
                or self.assign.stride(1) != 1 or self.scores.stride(1) != 1 \
                or self.assign.stride(0) != self.scores.stride(0):
            raise ValueError("BulkShard: outputs must be [E, n] row views "
                             "with one eval stride")
        if self.n_rows > (1 << 24):
            raise ValueError("BulkShard: the order key holds a row in 24 bits")
        for name in ("used", "exact", "delta"):
            t = getattr(self, name)
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"BulkShard.{name}: the kernels read a row "
                                 f"as one aligned float4")
        return self

    @property
    def D(self) -> int:
        return 0 if self.delta_rows is None else self.delta_rows.shape[1]


def _grid(sh: BulkShard, e: int, fill_grid: int, spread: bool):
    return bulk_wave_grid(sh.capacity, sh.used, sh.demand[e], sh.feasible[e],
                          sh.affinity[e], bool(sh.has_affinity[e]),
                          float(sh.desired[e]), sh.penalty[e], sh.coll,
                          spread, fill_grid)


def _bulk_tail_plain(sh: BulkShard, e: int, spread: bool) -> None:
    """The eval's tail on this shard: `_bulk_scores` of its rows, the
    local n_eval/n_exh, the exact carry += assign * demand, the deltas
    backed out of the chain carry (lines 611-625)."""
    _, fits_f, score_f = _grid(sh, e, 1, spread)
    fits = fits_f[:, 0]
    sh.scores[e] = torch.where(fits, score_f[:, 0],
                               torch.full_like(score_f[:, 0], float("-inf")))
    feas = sh.feasible[e]
    st = sh.state
    sh.partial[e] = torch.stack([
        st[ST_PLACED], torch.sum(feas).to(torch.int32),
        torch.sum(feas & ~fits).to(torch.int32), st[ST_WAVES]])
    sh.exact.copy_(sh.exact + sh.assign[e].to(torch.float32)[:, None]
                   * sh.demand[e])
    if sh.delta_rows is not None:
        sh.used.copy_(sh.used - sh.delta)


def _stop(sh: BulkShard, e: int, max_waves: int) -> bool:
    st = sh.state
    go = (int(st[ST_PLACED]) < int(sh.count[e]) and not int(st[ST_STUCK])
          and int(st[ST_WAVES]) < max_waves)
    st[ST_DONE] = 0 if go else 1
    return not go


def bulk_stats_plain(sh: BulkShard, e: int, begin: bool, stats: torch.Tensor,
                     cur_g: torch.Tensor, shard: int, spread: bool,
                     max_waves: int) -> None:
    """Plain version of K7c.  With `begin` it starts eval `e` first: its
    deltas go into the chain carry (`_apply_deltas_local`) and `delta`
    keeps `used - used_in`; coll restarts from coll0, assign from 0, the
    lane state from (0 placed, 0 waves); an eval that the stop test ends
    at once runs its tail.  Then, unless the eval is done, the wave's
    local statistics (lines 551-567): cur (the m = 1 score where the row
    fits, else -inf) into cur_g[off:off+n], the fit itself into
    `sh.fits` (a fitting row may score -inf), and stats[shard] = (top-2 of
    cur as `lax.top_k` ranks it, the shard's part of s*, any fit, the
    largest cur that is not NaN).  The reference takes s* as the pmax of
    each shard's `jnp.max` of its m = 2 scores where they fit: a NaN
    there makes the shard's max NaN, which the pmax passes over, so the
    shard's part is -inf.  Both maxima fold -0.0 into +0.0 (only their
    order matters)."""
    if begin:
        if sh.delta_rows is not None:
            sh.delta.copy_(sh.used)
            _add_deltas_local(sh.used, sh.off, sh.delta_rows[e],
                              sh.delta_vals[e])
            sh.delta.copy_(sh.used - sh.delta)
        sh.coll.copy_(sh.coll0[e])
        sh.assign[e] = 0
        sh.state.zero_()
        if _stop(sh, e, max_waves):
            _bulk_tail_plain(sh, e, spread)
    if int(sh.state[ST_DONE]):
        return
    _, fits_m, score_m = _grid(sh, e, 2, spread)
    ninf = torch.full_like(score_m[:, 0], float("-inf"))
    fits = fits_m[:, 0]
    cur = torch.where(fits, score_m[:, 0], ninf)
    n = cur.shape[0]
    cur_g[sh.off:sh.off + n] = cur
    sh.fits.copy_(fits)
    top2 = _lax_top_k(cur, 2)[0]
    smax = torch.max(torch.where(fits_m[:, 1], score_m[:, 1], ninf))
    smax = torch.where(torch.isnan(smax), ninf[0], smax) + 0.0
    cmax = torch.max(torch.where(torch.isnan(cur), ninf, cur)) + 0.0
    stats[shard] = torch.stack([top2[0], top2[1], smax,
                                torch.any(fits).to(torch.float32), cmax])


def _wave_globals(stats: torch.Tensor):
    """(any_fit, s_star, use_strict, gmax, gsecond) from the gathered
    statistics: the pmax of any-fit and of the shards' parts of s*;
    whether some row beats s* (the reference's pmax of `any(fits & (cur
    > s*))`: a NaN beats nothing); the global top-2 of cur as
    `top_k(all_gather(local top-2), 2)`."""
    any_fit = bool(torch.any(stats[:, 3] > 0))
    s_star = torch.max(stats[:, 2])
    use_strict = bool(torch.max(stats[:, 4]) > s_star)
    g2 = _lax_top_k(stats[:, :2].reshape(-1), 2)[0]
    return any_fit, s_star, use_strict, g2[0], g2[1]


def bulk_run_plain(sh: BulkShard, e: int, stats: torch.Tensor,
                   cur_g: torch.Tensor, base_g: torch.Tensor, spread: bool,
                   fill_grid: int) -> None:
    """Plain version of K7d: base_g[off:off+n] = each local row's fill run
    (`bulk_run_lengths` against `second`) where the row is in the wave
    set, else 0.  The wave set is the strict set (cur > s*) when any row
    beats s* (the largest cur that is not NaN does: a NaN beats nothing),
    else the tie set (the fitting rows, `sh.fits` from K7c, at cur ==
    gmax: where gmax is -inf, every fitting row); a run is capped at the
    eval's remaining count (a longer run is only ever used up to it)."""
    if int(sh.state[ST_DONE]):
        return
    any_fit, s_star, use_strict, gmax, gsecond = _wave_globals(stats)
    n = sh.capacity.shape[0]
    cur = cur_g[sh.off:sh.off + n]
    if not any_fit:
        base_g[sh.off:sh.off + n] = 0
        return
    wave = (cur > s_star) if use_strict else (sh.fits & (cur == gmax))
    second = torch.where(cur == gmax, gsecond, gmax)
    ms, fits_m, score_m = _grid(sh, e, fill_grid, spread)
    run = bulk_run_lengths(ms, fits_m, score_m, second)
    remaining = int(sh.count[e]) - int(sh.state[ST_PLACED])
    run = torch.clamp(run, max=remaining)
    base_g[sh.off:sh.off + n] = torch.where(wave, run,
                                            torch.zeros_like(run)).to(torch.int32)


def bulk_run_model(sh: BulkShard, e: int, stats: torch.Tensor,
                   cur_g: torch.Tensor, base_g: torch.Tensor, spread: bool,
                   fill_grid: int) -> None:
    """Model of K7d's rule (csrc/sharded.cu), for the tests, which hold it
    bit-equal to `bulk_run_plain`: a wave row's cells m = 1..run_cap
    (run_cap = min(fill_grid, remaining)) all at once, a cell failing
    where the row does not fit with m more or its score does not beat
    `second` (m = 1 exempt from the second test); the run is the first
    failing m - 1, or run_cap where none fails."""
    if int(sh.state[ST_DONE]):
        return
    any_fit, s_star, use_strict, gmax, gsecond = _wave_globals(stats)
    n = sh.capacity.shape[0]
    cur = cur_g[sh.off:sh.off + n]
    run_cap = max(min(fill_grid, int(sh.count[e]) - int(sh.state[ST_PLACED])),
                  0)
    if use_strict:
        wave = cur > s_star
    else:
        wave = sh.fits & (cur == gmax)
    wave = wave & any_fit & (run_cap > 0)
    second = torch.where(cur == gmax, gsecond, gmax)
    ms, fits_m, score_m = _grid(sh, e, fill_grid, spread)
    ok = fits_m[:, :run_cap] & ((score_m[:, :run_cap] > second[:, None])
                                | (ms[:run_cap] == 1.0))
    fail = ~ok
    first = torch.where(torch.any(fail, dim=1),
                        torch.argmax(fail.to(torch.int32), dim=1) + 1,
                        torch.full((n,), run_cap + 1))
    base_g[sh.off:sh.off + n] = torch.where(
        wave, first - 1, torch.zeros_like(first)).to(torch.int32)


def bulk_order_plain(sh: BulkShard, e: int, stats: torch.Tensor,
                     cur_g: torch.Tensor, base_g: torch.Tensor, spread: bool,
                     max_waves: int) -> None:
    """Plain version of K7e: the global greedy order (lines 578-601),
    `argsort(where(base > 0, -cur, inf))` stable over the gathered
    vectors, capped cumulatively at the remaining count; this shard adds
    its rows' share to used/coll/assign.  Then the lane state (placed,
    waves, stuck = not any_fit) and the stop test; the eval's tail when
    it ends."""
    if int(sh.state[ST_DONE]):
        return
    any_fit = bool(torch.any(stats[:, 3] > 0))
    n = sh.capacity.shape[0]
    remaining = int(sh.count[e]) - int(sh.state[ST_PLACED])
    wave_g = base_g > 0
    order = torch.argsort(torch.where(wave_g, -cur_g,
                                      torch.full_like(cur_g, float("inf"))),
                          stable=True)
    base_sorted = base_g[order].to(torch.int64)
    prefix = torch.cumsum(base_sorted, dim=0) - base_sorted
    alloc_sorted = torch.minimum(torch.clamp(remaining - prefix, min=0),
                                 base_sorted)
    per_node_g = torch.zeros(cur_g.shape[0], dtype=torch.int64,
                             device=cur_g.device)
    per_node_g[order] = alloc_sorted
    per_node = per_node_g[sh.off:sh.off + n]
    sh.used.copy_(sh.used + per_node[:, None].to(torch.float32) * sh.demand[e])
    sh.coll.copy_(sh.coll + per_node.to(torch.int32))
    sh.assign[e] = sh.assign[e] + per_node.to(torch.int32)
    st = sh.state
    st[ST_PLACED] += int(torch.sum(per_node_g))
    st[ST_WAVES] += 1
    st[ST_STUCK] = 0 if any_fit else 1
    if _stop(sh, e, max_waves):
        _bulk_tail_plain(sh, e, spread)


class BulkArgs(ctypes.Structure):
    """csrc/sharded.cu BulkArgs: one bulk shard's K7c-K7e operands."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "cap", "used", "exact", "delta", "coll", "feas", "aff", "pen",
        "coll0", "has_aff", "desired", "demand", "count", "drows", "dvals",
        "assign", "scores", "partial", "state", "fits")] + \
        [(name, ctypes.c_int) for name in ("n", "N", "off", "D", "ostride")]


def _bulk_args(sh: BulkShard) -> ctypes.c_void_p:
    """The address of the shard's packed K7c-K7e operands (packed once)."""
    if sh.packed is None:
        ts = (sh.capacity, sh.used, sh.exact, sh.delta, sh.coll,
              sh.feasible, sh.affinity, sh.penalty, sh.coll0,
              sh.has_affinity, sh.desired, sh.demand, sh.count,
              sh.delta_rows, sh.delta_vals, sh.assign, sh.scores,
              sh.partial, sh.state, sh.fits)
        sh.packed = _packed(BulkArgs, [
            None if t is None else t.data_ptr() for t in ts] + [
            sh.capacity.shape[0], sh.n_rows, sh.off, sh.D,
            sh.assign.stride(0)])
    return sh.packed[1]


def bulk_stats(sh: BulkShard, e: int, begin: bool, stats: torch.Tensor,
               cur_g: torch.Tensor, shard: int, spread: bool,
               max_waves: int) -> None:
    """K7c wrapper (see bulk_stats_plain)."""
    if _kind(sh.used, "bulk_stats") == "cpu":
        return bulk_stats_plain(sh, e, begin, stats, cur_g, shard, spread,
                                max_waves)
    lib = _build.load("sharded")
    dev = sh.used.get_device()
    rc = _on_card(dev, lib.bulk_stats_launch, _bulk_args(sh), int(e),
                  int(bool(begin)), _ptr(stats), _ptr(cur_g), int(shard),
                  int(bool(spread)), int(max_waves), _stream(dev))
    _launched("bulk_stats", rc)


def bulk_stats_cluster_size() -> int:
    """The blocks of K7c's cluster (csrc/sharded.cu STATS_CLUSTER)."""
    return int(_build.load("sharded").bulk_stats_cluster_size())


def bulk_run(sh: BulkShard, e: int, stats: torch.Tensor, cur_g: torch.Tensor,
             base_g: torch.Tensor, spread: bool, fill_grid: int) -> None:
    """K7d wrapper (see bulk_run_plain)."""
    if _kind(sh.used, "bulk_run") == "cpu":
        return bulk_run_plain(sh, e, stats, cur_g, base_g, spread, fill_grid)
    lib = _build.load("sharded")
    dev = sh.used.get_device()
    rc = _on_card(dev, lib.bulk_run_launch, _bulk_args(sh), int(e),
                  _ptr(stats), stats.shape[0], _ptr(cur_g), _ptr(base_g),
                  int(bool(spread)), int(fill_grid), _stream(dev))
    _launched("bulk_run", rc)


def bulk_order(sh: BulkShard, e: int, stats: torch.Tensor, cur_g: torch.Tensor,
               base_g: torch.Tensor, spread: bool, max_waves: int) -> None:
    """K7e wrapper (see bulk_order_plain)."""
    if _kind(sh.used, "bulk_order") == "cpu":
        return bulk_order_plain(sh, e, stats, cur_g, base_g, spread, max_waves)
    if cur_g.data_ptr() % 16 or base_g.data_ptr() % 16 or \
            not (cur_g.is_contiguous() and base_g.is_contiguous()):
        raise ValueError("bulk_order: the kernel reads the gathered vectors "
                         "16 bytes at a time")
    lib = _build.load("sharded")
    dev = sh.used.get_device()
    rc = _on_card(dev, lib.bulk_order_launch, _bulk_args(sh), int(e),
                  _ptr(stats), stats.shape[0], _ptr(cur_g), _ptr(base_g),
                  int(bool(spread)), int(max_waves), _stream(dev))
    _launched("bulk_order", rc)


def bulk_counts_plain(partials: torch.Tensor, out: torch.Tensor) -> None:
    """Plain version of K7f: out[..., e, :] = (placed, psum n_eval, psum
    n_exh, waves) from the shards' partials i32[..., n_shard, E, 4]
    (placed and waves are the same on every shard); the leading axes,
    where there are any, are the lanes."""
    out[..., 0] = partials[..., 0, :, 0]
    out[..., 1] = torch.sum(partials[..., 1], dim=-2).to(torch.int32)
    out[..., 2] = torch.sum(partials[..., 2], dim=-2).to(torch.int32)
    out[..., 3] = partials[..., 0, :, 3]


def basis_merge_plain(u0: torch.Tensor, exacts: torch.Tensor,
                      out: torch.Tensor,
                      partials: Optional[torch.Tensor] = None,
                      counts: Optional[torch.Tensor] = None) -> None:
    """Plain version of K7g: out = u0 + psum_w(exacts[w] - u0), the lanes'
    deltas summed in lane order (line 636).  `out` may be `u0` itself
    (the donated basis).  With `partials` i32[W, n_shard, E, 4] (node
    shard 0's call, where the kernel's launch carries K7f) it then
    writes `bulk_counts_plain(partials, counts)`, counts i32[W, E, 4]."""
    acc = exacts[0] - u0
    for w in range(1, exacts.shape[0]):
        acc = acc + (exacts[w] - u0)
    out.copy_(u0 + acc)
    if partials is not None:
        bulk_counts_plain(partials, counts)


def basis_merge(u0: torch.Tensor, exacts: torch.Tensor, out: torch.Tensor,
                partials: Optional[torch.Tensor] = None,
                counts: Optional[torch.Tensor] = None) -> None:
    """K7g wrapper (see basis_merge_plain); with `partials` the same
    launch also writes K7f's counts (thread j its counts[j]).  The
    kernel reads a row's 4 floats, and a count record's 4 ints, as one
    16-byte load, so it refuses unaligned operands."""
    if _kind(out, "basis_merge") == "cpu":
        return basis_merge_plain(u0, exacts, out, partials, counts)
    n, R = u0.shape
    W = exacts.shape[0]
    f32 = torch.float32
    if R != 4 or exacts.shape[1:] != (n, R) or out.shape != (n, R) or \
            not (u0.dtype == exacts.dtype == out.dtype == f32) or \
            not (u0.get_device() == exacts.get_device() == out.get_device())\
            or not (u0.is_contiguous() and exacts.is_contiguous()
                    and out.is_contiguous()):
        raise ValueError("basis_merge: f32[n, 4], f32[W, n, 4], f32[n, 4] "
                         "contiguous on one card")
    ops = [u0, exacts, out]
    nsh = E = 0
    if partials is not None:
        _, nsh, E, _ = partials.shape
        if partials.shape != (W, nsh, E, COUNTS_W) or counts is None or \
                counts.shape != (W, E, COUNTS_W) or \
                not (partials.dtype == counts.dtype == torch.int32) or \
                not (partials.get_device() == counts.get_device()
                     == out.get_device()) or \
                not (partials.is_contiguous() and counts.is_contiguous()):
            raise ValueError("basis_merge: partials i32[W, n_shard, E, 4] "
                             "and counts i32[W, E, 4] contiguous on the "
                             "card of the basis")
        ops += [partials, counts]
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError("basis_merge: the kernel reads rows 16 bytes at a "
                         "time; an operand is not 16-byte aligned")
    lib = _build.load("sharded")
    dev = out.get_device()
    rc = _on_card(dev, lib.basis_merge_launch, _ptr(u0), _ptr(exacts),
                  _ptr(out), W, n, _ptr(partials), _ptr(counts), nsh, E,
                  _stream(dev))
    _launched("basis_merge", rc)
