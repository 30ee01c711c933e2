"""Sharded placement: the dense engine over a ('node_shard', 'wave') mesh.

Torch port of the reference's parallel/sharded.py.  The reference runs
one controller with `shard_map` over a device mesh; so does the port.  A
mesh here is a 2-D grid of `torch.device`s (a device may repeat), a
sharded array is a list of per-shard tensors, each on its grid device,
and a collective is an explicit reduction or gather over the shards'
small partial results.  The same code runs on CPU entries, on one card
repeated (`cuda:0` eight times: the shards are separate tensors on one
stream) and on `cuda:0..k`.

Along `node_shard` each grid row owns a contiguous row shard [off,
off + n) of the [N, R] world: inside one scan step every shard scores
its local rows, the global best is the pmax of the shards' best scores
with the pmin of their global rows among ties (the single-chip argmax
tie-break), and each shard updates only the rows it owns.  Along `wave`,
independent bulk waves (the engine bins requests by wave_key) chain in
their own lanes against the shared basis, and the merged basis is
`u0 + psum_wave(exact - u0)`.  The world, and the scan path, live on the
mesh's first wave column (the reference replicates them across the
columns; every copy is identical).

Every K7 function has three forms here:
- `*_plain`: the reference's function written as explicit loops over the
  shards with `_pmax`/`_pmin`/`_psum`/`_all_gather` over the shard list;
  the specification, and what a CPU mesh runs;
- `*_staged`: the same function sequenced over the hand-written
  shard-local kernels of ops/sharded.py (K7a-K7g), with one gather a
  scan slot and two a bulk wave; what a CUDA mesh runs (on CPU shards
  each kernel wrapper takes its own plain version, which the tests use);
- the dispatcher (`place_eval_batch_sharded`, `place_batch_sharded`,
  `place_bulk_batch_sharded`), which picks by the mesh's device type.

The bulk wave loop's stop test (`placed < count & ~stuck & waves <
max_waves`) is data-dependent: the kernels keep a per-shard lane state
whose `done` flag turns every later launch for that eval into a no-op,
and the host reads the lanes' flags once a round (one sync for all
lanes), because the host loop must learn the trip count to launch the
next wave or the next eval.

`wave_mesh_shape` factors a device count into the (node_shard, wave)
grid; `NOMAD_TPU_WAVE_SHARDS` pins the wave extent.
"""
from __future__ import annotations

import math
from dataclasses import fields as dc_fields
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nomad_tpu_torch import knobs
from nomad_tpu_torch.ops import sharded as _k7
from nomad_tpu_torch.ops.fit import score_fit
from nomad_tpu_torch.ops.place import (
    FIT_NORM,
    PACKED_WIDTH,
    PLACE_INPUT_DTYPES,
    TOP_K,
    PlaceInputs,
    _lax_top_k,
    _spread_boost,
    bulk_run_lengths,
    bulk_wave_grid,
)

BIG = 2 ** 31 - 1

NODE_AXIS_NAME = "node_shard"
WAVE_AXIS_NAME = "wave"


class Mesh:
    """A named 2-D ('node_shard', 'wave') grid of torch devices, all of one
    type (cpu or cuda); a device may appear more than once."""

    axis_names = (NODE_AXIS_NAME, WAVE_AXIS_NAME)

    def __init__(self, grid: Sequence[Sequence]):
        rows = [[_norm(d) for d in row] for row in grid]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("Mesh: a non-empty rectangular device grid")
        kinds = {d.type for r in rows for d in r}
        if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
            raise ValueError(f"Mesh: devices of one type, cpu or cuda; got "
                             f"{sorted(kinds)}")
        self.devices = rows
        self.type = kinds.pop()

    @property
    def shape(self) -> Dict[str, int]:
        return {NODE_AXIS_NAME: len(self.devices),
                WAVE_AXIS_NAME: len(self.devices[0])}

    def device(self, i: int, w: int = 0) -> torch.device:
        return self.devices[i][w]

    def column(self, w: int = 0) -> List[torch.device]:
        return [row[w] for row in self.devices]


def _norm(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def visible_devices(kind: str = "cuda") -> List[torch.device]:
    """Every visible device of one type: the cards (raises where there is
    none), or the one CPU device."""
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind != "cuda":
        raise ValueError(f"visible_devices: unsupported type {kind}")
    if not torch.cuda.is_available():
        raise RuntimeError("nomad_tpu_torch: no CUDA device visible; pass "
                           "devices (e.g. ['cpu'] * 8) for a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def mesh_key(mesh: Optional[Mesh]) -> Optional[tuple]:
    """Stable identity of a mesh: its axes and each grid position's
    device.  Two meshes over the same grid are interchangeable (they hit
    the same cache entries); `id(mesh)` is not an identity."""
    if mesh is None:
        return None
    return (tuple(mesh.shape.items()),
            tuple((i, w, str(d)) for i, row in enumerate(mesh.devices)
                  for w, d in enumerate(row)))


def wave_mesh_shape(n_devices: int,
                    wave_shards: Optional[int] = None) -> Tuple[int, int]:
    """Factor a device count into the (node_shard, wave) grid: the wave
    extent is the largest divisor of `n_devices` that is <= its square
    root (1 -> 1x1, 2 -> 2x1, 4 -> 2x2, 8 -> 4x2).  `wave_shards` (or
    NOMAD_TPU_WAVE_SHARDS) pins it; a value that does not divide the
    device count falls back to 1."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if wave_shards is None:
        wave_shards = knobs.get_int("NOMAD_TPU_WAVE_SHARDS")
    if wave_shards is not None:
        w = max(1, int(wave_shards))
        if n_devices % w != 0:
            w = 1
        return n_devices // w, w
    w = max(d for d in range(1, math.isqrt(n_devices) + 1)
            if n_devices % d == 0)
    return n_devices // w, w


def make_mesh(n_wave_shards: Optional[int] = None,
              n_node_shards: Optional[int] = None, devices=None) -> Mesh:
    """Named 2-D mesh over `devices` (default: every visible card).  With
    no explicit shape, `wave_mesh_shape` picks the factorization."""
    devices = list(devices if devices is not None else visible_devices())
    if n_wave_shards is None and n_node_shards is None:
        n_node_shards, n_wave_shards = wave_mesh_shape(len(devices))
    elif n_node_shards is None:
        n_node_shards = len(devices) // n_wave_shards
    elif n_wave_shards is None:
        n_wave_shards = len(devices) // n_node_shards
    take = devices[:n_wave_shards * n_node_shards]
    return Mesh([take[i * n_wave_shards:(i + 1) * n_wave_shards]
                 for i in range(n_node_shards)])


def make_serving_mesh(devices=None, wave_shards: Optional[int] = None) -> Mesh:
    """The engine's serving mesh: the (node_shard, wave) factorization of
    `devices` (default: every visible card)."""
    devices = list(devices if devices is not None else visible_devices())
    n_node, n_wave = wave_mesh_shape(len(devices), wave_shards)
    return make_mesh(n_wave, n_node, devices)


def stack_inputs(inputs: Sequence[PlaceInputs]) -> PlaceInputs:
    """Stack PlaceInputs (numpy-backed, same padded shapes) along a
    leading eval-batch axis."""
    return PlaceInputs(**{f.name: np.stack([np.asarray(getattr(i, f.name))
                                            for i in inputs])
                          for f in dc_fields(PlaceInputs)})


# --------------------------------------------------------------------------
# Placement of operands on the mesh
# --------------------------------------------------------------------------

# node axis of each PlaceInputs field (None: replicated)
NODE_AXIS = {
    "capacity": 0, "used": 0,
    "feasible": 1, "affinity": 1, "penalty": 1, "tg_count": 1,
    "spread_vidx": 2, "place_cap": 1,
    "has_affinity": None, "desired_count": None,
    "spread_desired": None, "spread_targeted": None, "spread_wfrac": None,
    "spread_counts": None, "spread_active": None,
    "demand": None, "slot_tg": None, "slot_active": None,
}


def _to(x, dev: torch.device, dtype=None) -> torch.Tensor:
    """x (numpy or tensor) as a tensor on `dev`; a numpy array is always
    copied (torch.from_numpy would alias it on the CPU)."""
    if isinstance(x, np.ndarray):
        t = torch.tensor(x, device=dev)
    else:
        t = torch.as_tensor(x).to(dev)
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t.contiguous()


def put(mesh: Mesh, x, node_axis: Optional[int], column: int = 0,
        dtype=None) -> List[torch.Tensor]:
    """Shard a host (or single-device) array over one wave column: shard
    i gets rows [i*n, (i+1)*n) of `node_axis` (the whole array when
    None) on mesh.device(i, column).  A list is taken as already
    sharded."""
    if isinstance(x, list):
        return x
    NS = mesh.shape[NODE_AXIS_NAME]
    out = []
    for i in range(NS):
        dev = mesh.device(i, column)
        if node_axis is None:
            out.append(_to(x, dev, dtype))
            continue
        n = x.shape[node_axis] // NS
        sl = [slice(None)] * x.ndim
        sl[node_axis] = slice(i * n, (i + 1) * n)
        out.append(_to(x[tuple(sl)], dev, dtype))
    return out


def put_lanes(mesh: Mesh, x, node_axis: Optional[int],
              dtype=None) -> List[List[torch.Tensor]]:
    """Shard a [W, ...] lane array: lane w's x[w] over column w (see
    `put`; `node_axis` counts x[w]'s axes).  A list is taken as already
    sharded."""
    if isinstance(x, list):
        return x
    return [put(mesh, x[w], node_axis, w, dtype)
            for w in range(mesh.shape[WAVE_AXIS_NAME])]


def _offsets(shards: Sequence[torch.Tensor]) -> List[int]:
    offs, o = [], 0
    for t in shards:
        offs.append(o)
        o += t.shape[0]
    return offs


# --------------------------------------------------------------------------
# Collectives over a shard list (the plain versions)
# --------------------------------------------------------------------------

def _all_gather(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """all_gather(tiled=True): the shards' vectors concatenated in shard
    order, on the first shard's device."""
    dev = xs[0].device
    return torch.cat([x.to(dev) for x in xs])


def _pmax(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return _k7.shard_max([x.to(xs[0].device) for x in xs])


def _pmin(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.min(torch.stack([x.to(xs[0].device) for x in xs]))


def _psum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x.to(acc.device)
    return acc


def _apply_deltas_local(used: torch.Tensor, rows: torch.Tensor,
                        vals: torch.Tensor, off: int) -> torch.Tensor:
    """used.at[rows - off].add(vals) for the rows this shard owns, in
    order (rows outside it, pads among them, drop); a new tensor."""
    used = used.clone()
    _k7._add_deltas_local(used, off, rows, vals)
    return used


# --------------------------------------------------------------------------
# The scan path: plain versions
# --------------------------------------------------------------------------

class _Local:
    """One shard's view of one eval's PlaceInputs fields."""

    def __init__(self, flds: dict):
        self.__dict__.update(flds)


def _place_step_plain(inps: List[_Local], offs: List[int], spread: bool,
                      carry, s: int):
    """One placement step over the node shards (`_place_step_sharded`),
    the collectives written out over the shard list."""
    used, tg_count, spread_counts, place_cap = carry
    f32 = torch.float32
    NS = len(inps)
    g = int(inps[0].slot_tg[s])
    d = [inp.demand[s] for inp in inps]
    active = [inp.slot_active[s] for inp in inps]
    masked, fit_score, feas, fits = [], [], [], []
    for i, inp in enumerate(inps):
        fe = inp.feasible[g] & (place_cap[i][g] != 0)
        util = used[i] + d[i]
        ft = torch.all(util <= inp.capacity, dim=-1) & fe
        fs = score_fit(inp.capacity, util, spread) * FIT_NORM
        total = fs
        n_sc = torch.ones_like(fs)
        coll = tg_count[i][g].to(f32)
        anti = -(coll + 1.0) / torch.clamp(inp.desired_count[g].to(f32),
                                           min=1.0)
        has_coll = coll > 0.0
        total = total + torch.where(has_coll, anti, torch.zeros_like(anti))
        n_sc = n_sc + has_coll.to(f32)
        pen = inp.penalty[g].to(f32)
        total = total - pen
        n_sc = n_sc + pen
        aff = inp.affinity[g]
        aff_on = inp.has_affinity[g] & (aff != 0.0)
        total = total + torch.where(aff_on, aff, torch.zeros_like(aff))
        n_sc = n_sc + aff_on.to(f32)
        sboost = _spread_boost(inp, g, spread_counts[i][g])
        sb_on = torch.any(inp.spread_active[g]) & (sboost != 0.0)
        total = total + torch.where(sb_on, sboost, torch.zeros_like(sboost))
        n_sc = n_sc + sb_on.to(f32)
        final = total / n_sc
        masked.append(torch.where(ft & active[i], final,
                                  torch.full_like(final, float("-inf"))))
        fit_score.append(fs)
        feas.append(fe)
        fits.append(ft)

    # global argmax over 'node_shard': pmax score, pmin row among ties
    local_best = [torch.max(m) for m in masked]
    global_best = _pmax(local_best)
    cand = []
    for i in range(NS):
        li = int(torch.argmax(masked[i]))
        hit = bool(local_best[i] == global_best) and \
            bool(global_best > float("-inf"))
        cand.append(torch.tensor(offs[i] + li if hit else BIG))
    sel = int(_pmin(cand))
    ok = sel < BIG

    new_used, new_tg, new_counts, new_cap = [], [], [], []
    v_local = []
    K = inps[0].spread_vidx.shape[1]
    for i, inp in enumerate(inps):
        n = used[i].shape[0]
        rows = offs[i] + torch.arange(n, device=used[i].device)
        sel_local = (rows == sel) & ok
        new_used.append(used[i] + torch.where(sel_local[:, None], d[i],
                                              torch.zeros_like(used[i])))
        tg = tg_count[i].clone()
        tg[g] = tg[g] + sel_local.to(tg.dtype)
        new_tg.append(tg)
        pc = place_cap[i].clone()
        pc[g] = pc[g] - (sel_local & (pc[g] > 0)).to(pc.dtype)
        new_cap.append(pc)
        v_local.append(torch.sum(torch.where(
            sel_local[None, :], inp.spread_vidx[g],
            torch.zeros_like(inp.spread_vidx[g])), dim=1))
    v = _psum(v_local).to(torch.int64)                    # i32[K]
    Vp1 = spread_counts[0].shape[-1]
    for i, inp in enumerate(inps):
        vi = v.to(spread_counts[i].device)
        upd = torch.nn.functional.one_hot(torch.clamp(vi, max=Vp1 - 1),
                                          Vp1).to(f32)
        upd = upd * (inp.spread_active[g] & (vi < Vp1 - 1))[:, None].to(f32) \
            * float(ok)
        sc = spread_counts[i].clone()
        sc[g] = sc[g] + upd
        new_counts.append(sc)

    # per-slot metrics (global)
    fit_sel = _psum([torch.sum(torch.where((offs[i] + torch.arange(
        masked[i].shape[0], device=masked[i].device) == sel) & ok,
        fit_score[i], torch.zeros_like(fit_score[i]))) for i in range(NS)])
    n_eval = _psum([torch.sum(feas[i] & active[i]) for i in range(NS)])
    n_exh = _psum([torch.sum(feas[i] & ~fits[i] & active[i])
                   for i in range(NS)])
    k_local = min(TOP_K, masked[0].shape[0])
    tops, topi = [], []
    for i in range(NS):
        ts, ti = _lax_top_k(masked[i], k_local)
        tops.append(ts)
        topi.append(ti + offs[i])
    top_s = _all_gather(tops)
    top_i = _all_gather(topi)
    order = torch.argsort(-top_s, stable=True)[:TOP_K]
    dev = masked[0].device
    row = torch.zeros(PACKED_WIDTH, dtype=f32, device=dev)
    row[0] = float(sel) if ok else -1.0
    row[1] = global_best if ok else 0.0
    row[2] = fit_sel.to(dev) if ok else 0.0
    row[3] = float(int(n_eval))
    row[4] = float(int(n_exh))
    row[5:5 + TOP_K] = top_i[order].to(f32)
    row[5 + TOP_K:] = top_s[order]
    return (new_used, new_tg, new_counts, new_cap), row


def _scan_eval_plain(inps: List[_Local], offs: List[int], used: list,
                     spread: bool):
    """One eval's slot scan over the shards: (packed f32[S, W], final
    per-shard usage)."""
    S = inps[0].demand.shape[0]
    carry = (used, [inp.tg_count.clone() for inp in inps],
             [inp.spread_counts.clone() for inp in inps],
             [inp.place_cap.clone() for inp in inps])
    rows = []
    for s in range(S):
        carry, row = _place_step_plain(inps, offs, spread, carry, s)
        rows.append(row)
    return torch.stack(rows), carry[0]


def _local_fields(flds: Dict[str, list], i: int, e: Optional[int]) -> _Local:
    return _Local({k: (v[i] if e is None else v[i][e])
                   for k, v in flds.items()})


def place_eval_batch_sharded_plain(mesh: Mesh, stacked: PlaceInputs,
                                   spread_algorithm: bool = False):
    """Plain version of `place_eval_batch_sharded`: a batch of B
    independent evals (B divisible by the wave extent; lane w takes evals
    [w*B/W, (w+1)*B/W)), each scanned over its lane's node shards.
    Returns (node i32[B, S], score f32[B, S], fit f32[B, S], n_eval
    i32[B, S], n_exh i32[B, S], top_nodes i32[B, S, K], top_scores
    f32[B, S, K], used f32[B, N, R]) on mesh.device(0, 0)."""
    W = mesh.shape[WAVE_AXIS_NAME]
    B = stacked.demand.shape[0]
    if B % W:
        raise ValueError(f"place_eval_batch_sharded: batch {B} does not "
                         f"split over {W} wave lanes")
    out_dev = mesh.device(0, 0)
    dt = PLACE_INPUT_DTYPES
    packs, useds = [], []
    for b in range(B):
        w = b // (B // W)
        flds = {f.name: put(mesh, getattr(stacked, f.name)[b],
                            NODE_AXIS[f.name], w, dt[f.name])
                for f in dc_fields(PlaceInputs)}
        offs = _offsets(flds["capacity"])
        inps = [_local_fields(flds, i, None) for i in range(len(offs))]
        packed, used = _scan_eval_plain(inps, offs, flds["used"],
                                        spread_algorithm)
        packs.append(packed.to(out_dev))
        useds.append(_all_gather(used).to(out_dev))
    return _unpack_scan(torch.stack(packs)) + (torch.stack(useds),)


def _unpack_scan(packed: torch.Tensor):
    i32 = torch.int32
    return (packed[..., 0].to(i32), packed[..., 1], packed[..., 2],
            packed[..., 3].to(i32), packed[..., 4].to(i32),
            packed[..., 5:5 + TOP_K].to(i32), packed[..., 5 + TOP_K:])


# per-eval fields of the engine's chained scan (PlaceInputs minus the
# batch-shared capacity/used basis)
SCAN_FIELDS = tuple(f for f in NODE_AXIS if f not in ("capacity", "used"))


def put_scan_fields(mesh: Mesh, fields: dict) -> Dict[str, list]:
    """The engine's stacked [E, ...] scan fields sharded over the first
    wave column (node axes shifted by the leading eval axis)."""
    dt = PLACE_INPUT_DTYPES
    return {k: put(mesh, fields[k],
                   None if NODE_AXIS[k] is None else NODE_AXIS[k] + 1, 0,
                   dt[k]) for k in SCAN_FIELDS}


def place_batch_sharded_plain(mesh: Mesh, capacity, used0, fields: dict,
                              delta_rows, delta_vals,
                              spread_algorithm: bool = False):
    """Plain version of `place_batch_sharded`: E chained evals over the
    first wave column's node shards; each eval's deltas are added into
    the carry and stay there.  Returns (packed f32[E, S, 5 + 2K] on
    mesh.device(0, 0), the per-shard final usage)."""
    cap = put(mesh, capacity, 0, 0, torch.float32)
    used = [u.clone() for u in put(mesh, used0, 0, 0, torch.float32)]
    flds = put_scan_fields(mesh, fields)
    drows = put(mesh, delta_rows, None, 0, torch.int32)
    dvals = put(mesh, delta_vals, None, 0, torch.float32)
    offs = _offsets(cap)
    E = flds["demand"][0].shape[0]
    packs = []
    for e in range(E):
        used = [_apply_deltas_local(used[i], drows[i][e], dvals[i][e], offs[i])
                for i in range(len(offs))]
        inps = [_local_fields(flds, i, e) for i in range(len(offs))]
        for i, inp in enumerate(inps):
            inp.capacity = cap[i]
        packed, used = _scan_eval_plain(inps, offs, used, spread_algorithm)
        packs.append(packed)
    return torch.stack(packs).to(mesh.device(0, 0)), used


# --------------------------------------------------------------------------
# The scan path: the kernels (K7a/K7b)
# --------------------------------------------------------------------------

class _Gathered:
    """An all_gather buffer of one lane: one copy on each distinct device
    among its shards.  Shard i writes slot i (rows slots[i]) of the copy
    on its own device; `gather()` copies every slot into the other
    copies (nothing to copy where all shards share one device)."""

    def __init__(self, devs: List[torch.device], shape, dtype,
                 slots: List[Tuple[int, int]]):
        self.devs = devs
        self.slots = slots
        self.bufs = {}
        for d in devs:
            if d not in self.bufs:
                self.bufs[d] = torch.zeros(shape, dtype=dtype, device=d)

    def buf(self, i: int) -> torch.Tensor:
        return self.bufs[self.devs[i]]

    def gather(self) -> None:
        if len(self.bufs) == 1:
            return
        for i, d in enumerate(self.devs):
            a, b = self.slots[i]
            for d2, buf in self.bufs.items():
                if d2 != d:
                    buf[a:b].copy_(self.bufs[d][a:b], non_blocking=True)


def _scan_shard(off, cap, used, fl: dict, carries) -> _k7.ScanShard:
    tg, pc, cn, cache, pick = carries
    return _k7.ScanShard(
        off=off, capacity=cap, used=used, feasible=fl["feasible"],
        affinity=fl["affinity"], penalty=fl["penalty"], tg0=fl["tg_count"],
        cap0=fl["place_cap"], vidx=fl["spread_vidx"],
        has_affinity=fl["has_affinity"], desired_count=fl["desired_count"],
        spread_desired=fl["spread_desired"],
        spread_targeted=fl["spread_targeted"],
        spread_wfrac=fl["spread_wfrac"], counts0=fl["spread_counts"],
        spread_active=fl["spread_active"], demand=fl["demand"],
        slot_tg=fl["slot_tg"], slot_active=fl["slot_active"],
        tg_count=tg, place_cap=pc, counts=cn, cache=cache, pick=pick).check()


def _scan_carries(fl: dict, used_like: torch.Tensor):
    """One shard's scan carries for evals shaped as `fl`: (tg_count,
    place_cap, spread counts, K7a's cache, the pick word), then the usage
    carry."""
    _, K, V1 = fl["spread_counts"].shape
    dev = used_like.device
    return (torch.empty_like(fl["tg_count"]), torch.empty_like(fl["place_cap"]),
            torch.empty_like(fl["spread_counts"]),
            _k7.scan_cache(used_like.shape[0], K, V1, dev),
            torch.empty(1, dtype=torch.int32, device=dev),
            torch.empty_like(used_like))


def _scan_eval_staged(shards: List[_k7.ScanShard], recs: _Gathered,
                      out: torch.Tensor, used_in: Optional[list],
                      drows: Optional[list], dvals: Optional[list],
                      spread: bool) -> None:
    """One eval's slot scan over the kernels: per slot, K7a on every
    shard, one gather of the records, K7b on every shard (shard 0 writes
    the packed row into `out` f32[S, W])."""
    S = shards[0].demand.shape[0]
    for s in range(S):
        for i, sh in enumerate(shards):
            init = s == 0
            _k7.scan_local(sh, s, init,
                           used_in[i] if (init and used_in) else None,
                           drows[i] if (init and drows) else None,
                           dvals[i] if (init and dvals) else None,
                           recs.buf(i), i, spread)
        recs.gather()
        for i, sh in enumerate(shards):
            _k7.scan_apply(sh, s, recs.buf(i), out if i == 0 else None)


def place_batch_sharded_staged(mesh: Mesh, capacity, used0, fields: dict,
                               delta_rows, delta_vals,
                               spread_algorithm: bool = False):
    """`place_batch_sharded` over the shard-local kernels (K7a/K7b)."""
    cap = put(mesh, capacity, 0, 0, torch.float32)
    u0 = put(mesh, used0, 0, 0, torch.float32)
    flds = put_scan_fields(mesh, fields)
    drows = put(mesh, delta_rows, None, 0, torch.int32)
    dvals = put(mesh, delta_vals, None, 0, torch.float32)
    offs = _offsets(cap)
    NS = len(offs)
    devs = mesh.column(0)
    E, S = flds["demand"][0].shape[:2]
    out = torch.empty((E, S, PACKED_WIDTH), dtype=torch.float32,
                      device=devs[0])
    carries = [_scan_carries({k: v[i][0] for k, v in flds.items()}, u0[i])
               for i in range(NS)]
    used = [c[5] for c in carries]
    recs = _Gathered(devs, (NS, _k7.SCAN_REC), torch.int32,
                     [(i, i + 1) for i in range(NS)])
    for e in range(E):
        shards = [_scan_shard(offs[i], cap[i], used[i],
                              {k: v[i][e] for k, v in flds.items()},
                              carries[i][:5]) for i in range(NS)]
        _scan_eval_staged(shards, recs, out[e], u0 if e == 0 else None,
                          [d[e] for d in drows], [d[e] for d in dvals],
                          spread_algorithm)
    return out, used


def place_eval_batch_sharded_staged(mesh: Mesh, stacked: PlaceInputs,
                                    spread_algorithm: bool = False):
    """`place_eval_batch_sharded` over the shard-local kernels."""
    W = mesh.shape[WAVE_AXIS_NAME]
    B = stacked.demand.shape[0]
    if B % W:
        raise ValueError(f"place_eval_batch_sharded: batch {B} does not "
                         f"split over {W} wave lanes")
    out_dev = mesh.device(0, 0)
    dt = PLACE_INPUT_DTYPES
    S = stacked.demand.shape[1]
    N, R = stacked.capacity.shape[1:]
    packed = torch.empty((B, S, PACKED_WIDTH), dtype=torch.float32,
                         device=out_dev)
    used_out = torch.empty((B, N, R), dtype=torch.float32, device=out_dev)
    for b in range(B):
        w = b // (B // W)
        devs = mesh.column(w)
        flds = {f.name: put(mesh, getattr(stacked, f.name)[b],
                            NODE_AXIS[f.name], w, dt[f.name])
                for f in dc_fields(PlaceInputs)}
        offs = _offsets(flds["capacity"])
        NS = len(offs)
        shards = []
        for i in range(NS):
            fl = {k: v[i] for k, v in flds.items()}
            *carries, used = _scan_carries(fl, fl["used"])
            shards.append(_scan_shard(offs[i], fl["capacity"], used, fl,
                                      carries))
        recs = _Gathered(devs, (NS, _k7.SCAN_REC), torch.int32,
                         [(i, i + 1) for i in range(NS)])
        dst = packed[b] if devs[0] == out_dev else torch.empty(
            (S, PACKED_WIDTH), dtype=torch.float32, device=devs[0])
        _scan_eval_staged(shards, recs, dst, flds["used"], None, None,
                          spread_algorithm)
        if dst.data_ptr() != packed[b].data_ptr():
            packed[b].copy_(dst)
        for i, sh in enumerate(shards):
            n = sh.used.shape[0]
            used_out[b, offs[i]:offs[i] + n].copy_(sh.used)
    return _unpack_scan(packed) + (used_out,)


# --------------------------------------------------------------------------
# The bulk path: plain version
# --------------------------------------------------------------------------

# lane-sharded bulk operands: (node axis of x[w] without the eval axis
# shifted in, dtype)
_BULK_ARGS = {
    "feasible": (1, torch.bool), "affinity": (1, torch.float32),
    "has_affinity": (None, torch.bool), "desired": (None, torch.int32),
    "penalty": (1, torch.bool), "coll0": (1, torch.int32),
    "demand": (None, torch.float32), "count": (None, torch.int32),
    "delta_rows": (None, torch.int32), "delta_vals": (None, torch.float32),
}


def put_bulk_lanes(mesh: Mesh, ops: dict) -> Dict[str, list]:
    """The [W, ...] operands of `place_bulk_batch_sharded` in `ops` (any
    subset, by its argument names) sharded over their lanes' columns."""
    return {k: put_lanes(mesh, v, *_BULK_ARGS[k]) for k, v in ops.items()}


def _bulk_scores_plain(cap, used, demand, feasible, affinity, has_aff,
                       desired: int, penalty, coll, spread):
    """`_bulk_scores` on one shard's rows (the m = 1 column of the grid)."""
    _, fits_m, score_m = bulk_wave_grid(cap, used, demand, feasible, affinity,
                                        has_aff, float(desired), penalty,
                                        coll, spread, 1)
    fits = fits_m[:, 0]
    return torch.where(fits, score_m[:, 0],
                       torch.full_like(score_m[:, 0], float("-inf"))), fits


def place_bulk_batch_sharded_plain(mesh: Mesh, capacity, used0, feasible,
                                   affinity, has_affinity, desired, penalty,
                                   coll0, demand, count, delta_rows,
                                   delta_vals, spread_algorithm: bool = False,
                                   max_waves: int = 65536,
                                   fill_grid: int = 64,
                                   donate: bool = False):
    """Plain version of `place_bulk_batch_sharded` (reference lines
    520-639): every lane chains its E evals over its column's node
    shards; the merged basis is u0 + psum_wave(exact - u0).  Returns
    (assign i32[W, E, N], scores f32[W, E, N], placed, n_eval, n_exh,
    waves i32[W, E] on mesh.device(0, 0), the per-shard merged basis on
    the first column; with `donate`, written into the used0 shards)."""
    f32 = torch.float32
    NS, W = mesh.shape[NODE_AXIS_NAME], mesh.shape[WAVE_AXIS_NAME]
    cap_home = put(mesh, capacity, 0, 0, f32)
    u0 = put(mesh, used0, 0, 0, f32)
    offs = _offsets(u0)
    N = sum(u.shape[0] for u in u0)
    lanes = put_bulk_lanes(mesh, dict(
        feasible=feasible, affinity=affinity, has_affinity=has_affinity,
        desired=desired, penalty=penalty, coll0=coll0, demand=demand,
        count=count, delta_rows=delta_rows, delta_vals=delta_vals))
    E = lanes["count"][0][0].shape[0]
    out_dev = mesh.device(0, 0)
    assign_o = torch.zeros((W, E, N), dtype=torch.int32, device=out_dev)
    scores_o = torch.zeros((W, E, N), dtype=f32, device=out_dev)
    counts_o = torch.zeros((W, E, 4), dtype=torch.int32, device=out_dev)
    exact_lanes = []
    ninf = float("-inf")
    for w in range(W):
        L = {k: v[w] for k, v in lanes.items()}
        devs = mesh.column(w)
        cap = [cap_home[i].to(devs[i]) for i in range(NS)]
        used_in = [u0[i].to(devs[i], copy=True) for i in range(NS)]
        exact = [u0[i].to(devs[i], copy=True) for i in range(NS)]
        for e in range(E):
            count_e = int(L["count"][0][e])
            has_aff = bool(L["has_affinity"][0][e])
            desired_e = int(L["desired"][0][e])
            dem = [L["demand"][i][e] for i in range(NS)]
            feas = [L["feasible"][i][e] for i in range(NS)]
            aff = [L["affinity"][i][e] for i in range(NS)]
            pen = [L["penalty"][i][e] for i in range(NS)]
            used = [_apply_deltas_local(used_in[i], L["delta_rows"][i][e],
                                        L["delta_vals"][i][e], offs[i])
                    for i in range(NS)]
            delta_local = [used[i] - used_in[i] for i in range(NS)]
            u = used
            coll = [L["coll0"][i][e].clone() for i in range(NS)]
            assign = [torch.zeros_like(c) for c in coll]
            placed, stuck, waves = 0, False, 0
            while placed < count_e and not stuck and waves < max_waves:
                grids = [bulk_wave_grid(cap[i], u[i], dem[i], feas[i], aff[i],
                                        has_aff, float(desired_e), pen[i],
                                        coll[i], spread_algorithm, fill_grid)
                         for i in range(NS)]
                fits = [gr[1][:, 0] for gr in grids]
                cur = [torch.where(fits[i], grids[i][2][:, 0],
                                   torch.full_like(grids[i][2][:, 0], ninf))
                       for i in range(NS)]
                any_fit = bool(_pmax([torch.any(f).to(torch.int32)
                                      for f in fits]) > 0)
                s_star = _pmax([torch.max(torch.where(
                    gr[1][:, 1], gr[2][:, 1],
                    torch.full_like(gr[2][:, 1], ninf))) for gr in grids])
                l2 = [_lax_top_k(c, 2)[0] for c in cur]
                g2 = _lax_top_k(_all_gather(l2), 2)[0]
                gmax, gsecond = g2[0], g2[1]
                strict = [fits[i] & (cur[i] > s_star.to(cur[i].device))
                          for i in range(NS)]
                use_strict = bool(_pmax([torch.any(s).to(torch.int32)
                                         for s in strict]) > 0)
                base = []
                for i in range(NS):
                    gm = gmax.to(cur[i].device)
                    tie = fits[i] & (cur[i] == gm)
                    wv = strict[i] if use_strict else tie
                    second = torch.where(cur[i] == gm,
                                         gsecond.to(cur[i].device), gm)
                    run = bulk_run_lengths(grids[i][0], grids[i][1],
                                           grids[i][2], second)
                    base.append(torch.where(wv, run,
                                            torch.zeros_like(run)))
                cur_g = _all_gather(cur)
                base_g = _all_gather(base).to(torch.int64)
                wave_g = base_g > 0
                order = torch.argsort(torch.where(
                    wave_g, -cur_g, torch.full_like(cur_g, float("inf"))),
                    stable=True)
                base_sorted = base_g[order]
                prefix = torch.cumsum(base_sorted, dim=0) - base_sorted
                remaining = count_e - placed
                alloc_sorted = torch.minimum(
                    torch.clamp(remaining - prefix, min=0), base_sorted)
                per_node_g = torch.zeros_like(base_g)
                per_node_g[order] = alloc_sorted
                for i in range(NS):
                    n = u[i].shape[0]
                    pn = per_node_g[offs[i]:offs[i] + n].to(u[i].device)
                    u[i] = u[i] + pn[:, None].to(f32) * dem[i]
                    coll[i] = coll[i] + pn.to(coll[i].dtype)
                    assign[i] = assign[i] + pn.to(assign[i].dtype)
                placed += int(torch.sum(per_node_g))
                stuck = not any_fit
                waves += 1
            sc = [_bulk_scores_plain(cap[i], u[i], dem[i], feas[i], aff[i],
                                     has_aff, max(desired_e, 1), pen[i],
                                     coll[i], spread_algorithm)
                  for i in range(NS)]
            n_eval = int(_psum([torch.sum(f) for f in feas]))
            n_exh = int(_psum([torch.sum(feas[i] & ~sc[i][1])
                               for i in range(NS)]))
            for i in range(NS):
                n = u[i].shape[0]
                assign_o[w, e, offs[i]:offs[i] + n] = assign[i].to(out_dev)
                scores_o[w, e, offs[i]:offs[i] + n] = sc[i][0].to(out_dev)
                exact[i] = exact[i] + assign[i][:, None].to(f32) * dem[i]
            counts_o[w, e] = torch.tensor([placed, n_eval, n_exh, waves],
                                          dtype=torch.int32)
            used_in = [u[i] - delta_local[i] for i in range(NS)]
        exact_lanes.append(exact)
    used_tot = []
    for i in range(NS):
        dsum = _psum([exact_lanes[w][i].to(u0[i].device) - u0[i]
                      for w in range(W)])
        tot = u0[i] + dsum
        if donate:
            u0[i].copy_(tot)
            tot = u0[i]
        used_tot.append(tot)
    return (assign_o, scores_o, counts_o[..., 0], counts_o[..., 1],
            counts_o[..., 2], counts_o[..., 3], used_tot)


# --------------------------------------------------------------------------
# The bulk path: the kernels (K7c-K7g)
# --------------------------------------------------------------------------

def _read_done(states: Dict[torch.device, torch.Tensor], lanes: List[int],
               home: List[torch.device]) -> List[bool]:
    """The lanes' done flags (shard 0's copy of each lane state): one
    copy a device, then one wait."""
    host = {}
    for d, t in states.items():
        if d.type == "cpu":
            host[d] = t
        else:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host[d] = h
    for d in states:
        if d.type == "cuda":
            torch.cuda.current_stream(d).synchronize()
    return [bool(host[home[w]][w, 0, _k7.ST_DONE]) for w in lanes]


def place_bulk_batch_sharded_staged(mesh: Mesh, capacity, used0, feasible,
                                    affinity, has_affinity, desired, penalty,
                                    coll0, demand, count, delta_rows,
                                    delta_vals, spread_algorithm: bool = False,
                                    max_waves: int = 65536,
                                    fill_grid: int = 64,
                                    donate: bool = False):
    """`place_bulk_batch_sharded` over the shard-local kernels: a round
    launches one wave of every unfinished lane (K7c on each shard, one
    gather of the statistics, K7d, one gather of the [N] score and run
    vectors, K7e), then reads the lanes' done flags once; K7g merges the
    basis at the end, and node shard 0's K7g launch also sums the lanes'
    counts (K7f, no launch of its own).  Evals with a
    count of 0 (lane pads) start and end inside one K7c launch without a
    round of their own."""
    f32, i32 = torch.float32, torch.int32
    NS, W = mesh.shape[NODE_AXIS_NAME], mesh.shape[WAVE_AXIS_NAME]
    cap_home = put(mesh, capacity, 0, 0, f32)
    u0 = put(mesh, used0, 0, 0, f32)
    offs = _offsets(u0)
    n = u0[0].shape[0]
    R = u0[0].shape[1]
    N = n * NS
    lanes = put_bulk_lanes(mesh, dict(
        feasible=feasible, affinity=affinity, has_affinity=has_affinity,
        desired=desired, penalty=penalty, coll0=coll0, demand=demand,
        count=count, delta_rows=delta_rows, delta_vals=delta_vals))
    count_host = [lanes["count"][w][0].cpu().tolist() for w in range(W)]
    E = len(count_host[0])
    out_dev = mesh.device(0, 0)
    assign_o = torch.zeros((W, E, N), dtype=i32, device=out_dev)
    scores_o = torch.zeros((W, E, N), dtype=f32, device=out_dev)
    counts_o = torch.zeros((W, E, _k7.COUNTS_W), dtype=i32, device=out_dev)
    home = mesh.column(0)
    exacts = [torch.empty((W, n, R), dtype=f32, device=home[i])
              for i in range(NS)]
    states = {}
    for row in mesh.devices:
        for d in row:
            states.setdefault(d, torch.zeros((W, NS, _k7.STATE_W), dtype=i32,
                                             device=d))
    lane0 = [mesh.device(0, w) for w in range(W)]
    # every lane's shards' counts, summed by node shard 0's K7g launch
    # (on home[0], which is out_dev); a lane whose shard 0 is on another
    # card gathers its shards' counts there and copies them over once
    partials = torch.zeros((W, NS, E, _k7.COUNTS_W), dtype=i32,
                           device=out_dev)
    ctx: List[List[_k7.BulkShard]] = []
    copies = []                     # (local output, its destination)
    for w in range(W):
        devs = mesh.column(w)
        gather = partials[w] if lane0[w] == out_dev else torch.zeros(
            (NS, E, _k7.COUNTS_W), dtype=i32, device=lane0[w])
        row = []
        for i in range(NS):
            d = devs[i]
            exact = exacts[i][w] if d == home[i] else torch.empty(
                (n, R), dtype=f32, device=d)
            exact.copy_(u0[i])
            sl = slice(offs[i], offs[i] + n)
            if d == out_dev:
                a_v, s_v = assign_o[w, :, sl], scores_o[w, :, sl]
            else:
                a_v = torch.zeros((E, n), dtype=i32, device=d)
                s_v = torch.zeros((E, n), dtype=f32, device=d)
                copies += [(a_v, assign_o[w, :, sl]), (s_v, scores_o[w, :, sl])]
            if d == lane0[w]:
                p_v = gather[i]
            else:
                p_v = torch.zeros((E, _k7.COUNTS_W), dtype=i32, device=d)
                copies.append((p_v, gather[i]))
            if d != home[i]:
                copies.append((exact, exacts[i][w]))
            L = {k: v[w][i] for k, v in lanes.items()}
            row.append(_k7.BulkShard(
                off=offs[i], n_rows=N, capacity=cap_home[i].to(d),
                used=u0[i].to(d, copy=True), exact=exact,
                delta=torch.zeros((n, R), dtype=f32, device=d),
                coll=torch.zeros(n, dtype=i32, device=d),
                feasible=L["feasible"], affinity=L["affinity"],
                penalty=L["penalty"], coll0=L["coll0"],
                has_affinity=L["has_affinity"], desired=L["desired"],
                demand=L["demand"], count=L["count"],
                delta_rows=L["delta_rows"], delta_vals=L["delta_vals"],
                assign=a_v, scores=s_v, partial=p_v,
                state=states[d][w, i],
            ).check())
        if lane0[w] != out_dev:
            copies.append((gather, partials[w]))
        ctx.append(row)
    slots1 = [(i, i + 1) for i in range(NS)]
    slotsn = [(offs[i], offs[i] + n) for i in range(NS)]
    stats = [_Gathered(mesh.column(w), (NS, _k7.STATS_W), f32, slots1)
             for w in range(W)]
    cur = [_Gathered(mesh.column(w), (N,), f32, slotsn) for w in range(W)]
    base = [_Gathered(mesh.column(w), (N,), i32, slotsn) for w in range(W)]

    def start(w: int, e: int) -> int:
        """Start lane w's eval e and the zero-count evals after it that
        end inside their K7c launch; returns the next eval to run."""
        while e < E:
            for i, sh in enumerate(ctx[w]):
                _k7.bulk_stats(sh, e, True, stats[w].buf(i), cur[w].buf(i),
                               i, spread_algorithm, max_waves)
            if count_host[w][e] > 0 and max_waves > 0:
                return e
            e += 1
        return e

    e_of = [start(w, 0) for w in range(W)]
    fresh = [True] * W
    live = [w for w in range(W) if e_of[w] < E]
    while live:
        for w in live:
            if not fresh[w]:
                for i, sh in enumerate(ctx[w]):
                    _k7.bulk_stats(sh, e_of[w], False, stats[w].buf(i),
                                   cur[w].buf(i), i, spread_algorithm,
                                   max_waves)
            stats[w].gather()
        for w in live:
            for i, sh in enumerate(ctx[w]):
                _k7.bulk_run(sh, e_of[w], stats[w].buf(i), cur[w].buf(i),
                             base[w].buf(i), spread_algorithm, fill_grid)
            cur[w].gather()
            base[w].gather()
        for w in live:
            for i, sh in enumerate(ctx[w]):
                _k7.bulk_order(sh, e_of[w], stats[w].buf(i), cur[w].buf(i),
                               base[w].buf(i), spread_algorithm, max_waves)
        done = _read_done(states, live, lane0)
        nxt = []
        for w, d in zip(live, done):
            fresh[w] = d
            if d:
                e_of[w] = start(w, e_of[w] + 1)
            if e_of[w] < E:
                nxt.append(w)
        live = nxt
    for src, dst in copies:
        dst.copy_(src)
    used_tot = []
    for i in range(NS):
        out = u0[i] if donate else torch.empty_like(u0[i])
        if i == 0:
            _k7.basis_merge(u0[i], exacts[i], out, partials, counts_o)
        else:
            _k7.basis_merge(u0[i], exacts[i], out)
        used_tot.append(out)
    return (assign_o, scores_o, counts_o[..., 0], counts_o[..., 1],
            counts_o[..., 2], counts_o[..., 3], used_tot)


# --------------------------------------------------------------------------
# Dispatchers: kernels on a CUDA mesh, the plain versions on a CPU mesh
# --------------------------------------------------------------------------

def _staged(mesh: Mesh) -> bool:
    return mesh.type == "cuda"


def place_eval_batch_sharded(mesh: Mesh, stacked: PlaceInputs,
                             spread_algorithm: bool = False):
    """Place a batch of independent evals over the mesh (the batch axis
    over 'wave', the node axis over 'node_shard').  `stacked`: numpy
    PlaceInputs with a leading batch axis (stack_inputs).  Returns per
    eval (node, score, fit_score, nodes_evaluated, nodes_exhausted,
    top_nodes, top_scores, used_final)."""
    fn = place_eval_batch_sharded_staged if _staged(mesh) \
        else place_eval_batch_sharded_plain
    return fn(mesh, stacked, spread_algorithm)


def place_batch_sharded(mesh: Mesh, capacity, used0, fields: dict,
                        delta_rows, delta_vals,
                        spread_algorithm: bool = False):
    """The engine's chained scan batch over the serving mesh.  `fields`:
    the per-eval PlaceInputs fields minus capacity/used, each with a
    leading E axis (numpy, or sharded by `put_scan_fields`);
    `capacity`/`used0` f32[N, R] or per-shard lists; `delta_rows`
    i32[E, D] / `delta_vals` f32[E, D, R] each eval's sparse usage
    adjustments (row == N drops).  Returns (packed f32[E, S, 5 + 2K], the
    per-shard final usage)."""
    fn = place_batch_sharded_staged if _staged(mesh) \
        else place_batch_sharded_plain
    return fn(mesh, capacity, used0, fields, delta_rows, delta_vals,
              spread_algorithm)


def place_bulk_batch_sharded(mesh: Mesh, capacity, used0, feasible, affinity,
                             has_affinity, desired, penalty, coll0, demand,
                             count, delta_rows, delta_vals,
                             spread_algorithm: bool = False,
                             max_waves: int = 65536, fill_grid: int = 64,
                             donate: bool = False):
    """The laned chained bulk wavefront batch over the 2-D mesh.  Every
    per-eval operand carries leading [W, E] axes (lane w chains its own
    evals; pads have count 0): node-axis fields [W, E, N], scalars
    [W, E], demand [W, E, R], deltas [W, E, D] / [W, E, D, R].  Returns
    (assign i32[W, E, N], scores f32[W, E, N], placed, n_eval, n_exh,
    waves i32[W, E], the merged basis per node shard).  With `donate` the
    used0 shards receive the merged basis in place (the caller loans its
    resident basis and adopts it back)."""
    fn = place_bulk_batch_sharded_staged if _staged(mesh) \
        else place_bulk_batch_sharded_plain
    return fn(mesh, capacity, used0, feasible, affinity, has_affinity,
              desired, penalty, coll0, demand, count, delta_rows, delta_vals,
              spread_algorithm, max_waves, fill_grid, donate)


def serving_update_fns(mesh: Mesh):
    """(set_rows, add_rank1) over a node-sharded resident matrix (a list
    of per-shard tensors): each shard scatters only the global rows it
    owns (K5' in world.py), and the shards of one device go in one
    launch (world.scatter_shards, as DeviceWorld's updates do).  Row and
    value operands come per shard (on the shard's device); the matrix
    shards are updated in place."""
    from nomad_tpu_torch.parallel.world import scatter_shards

    def set_fn(dev: list, rows: list, vals: list) -> list:
        scatter_shards("set_rows_local", [(dev, list(zip(rows, vals)))])
        return dev

    def add_fn(dev: list, rows: list, counts: list, dem: list) -> list:
        scatter_shards("add_rank1_local",
                       [(dev, list(zip(rows, counts, dem)))])
        return dev

    return set_fn, add_fn
