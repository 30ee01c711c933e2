"""Kernel-stage attribution probe for the bulk placement dispatch.

Torch port of the reference's parallel/stage_probe.py.  The bench's
measured `device_s` is the engine's wall time of whole bulk dispatches;
this probe re-times each stage of the wave pipeline (feasibility -> fit
-> score -> argmax -> scatter) as its own kernel (K8a-K8e,
ops/stage_probe.py) at the bench's shape ([N, M = fill grid, R]),
derives per-stage fractions, and attributes the measured `device_s`
across them, so the BENCH JSON's `"device_stages"` section names the
dominant stage by construction (stage sum == device_s).  The fused wave
(K8f) is timed as one more unit.

It runs only after the bench's measured window: its launches and
uploads are not part of the serving path.  The reference's tracer spans
are not ported (the port has no tracer).
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from nomad_tpu_torch.device import resolve_device
from nomad_tpu_torch.encode.matrixizer import NUM_RESOURCE_DIMS
from nomad_tpu_torch.ops import stage_probe as sp
from nomad_tpu_torch.ops.place import _FILL_GRID

# the canonical stage order of the wave pipeline
STAGES = ("feasibility", "fit", "score", "argmax", "scatter")


def interval_overlap_s(a, b) -> float:
    """Total seconds where two sets of (t0, t1) wall windows intersect:
    `pipeline_overlap_s` (the engine's upload windows against its device
    windows) and `commit_overlap_s` (device windows against the applier's
    commit windows)."""
    a, b = sorted(a), sorted(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def probe_inputs(n_nodes: int, r_dims: int = NUM_RESOURCE_DIMS,
                 fill_grid: Optional[int] = None, device=None) -> dict:
    """The probe's inputs, drawn from numpy's default_rng(0) in the
    reference's order and with its distributions, on `device`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    N, R = int(n_nodes), int(r_dims)
    M = int(fill_grid) if fill_grid else int(_FILL_GRID)
    t = lambda a: torch.from_numpy(a).to(dev)       # noqa: E731
    capacity = t(rng.uniform(100.0, 1000.0, (N, R)).astype(np.float32))
    used = t(rng.uniform(0.0, 50.0, (N, R)).astype(np.float32))
    demand = t(rng.uniform(1.0, 10.0, R).astype(np.float32))
    feasible = t(rng.random(N) < 0.9)
    ms = t(np.arange(1, M + 1, dtype=np.float32))
    coll = t(rng.integers(0, 3, N).astype(np.int32))
    penalty = t((rng.random(N) < 0.05).astype(np.float32))
    affinity = t(rng.uniform(-1.0, 1.0, N).astype(np.float32))
    return dict(capacity=capacity, used=used, demand=demand,
                feasible=feasible, ms=ms, coll=coll, penalty=penalty,
                affinity=affinity, count=256, desired_f=8.0,
                has_affinity=True, fill_grid=M)


def _stage_calls(x: dict) -> Dict[str, object]:
    """name -> a call of that stage's unit on the probe inputs `x` (each
    stage fed the outputs of the ones before it, computed once here)."""
    util_m, fits_m = sp.feasibility(x["capacity"], x["used"], x["demand"],
                                    x["feasible"], x["ms"])
    fit_m = sp.fit(x["capacity"], util_m)
    score_m = sp.score(fit_m, x["coll"], x["ms"], x["desired_f"],
                       x["penalty"], x["affinity"], x["has_affinity"])
    run, order = sp.argmax(fits_m, score_m, x["ms"])
    return {
        "feasibility": lambda: sp.feasibility(
            x["capacity"], x["used"], x["demand"], x["feasible"], x["ms"]),
        "fit": lambda: sp.fit(x["capacity"], util_m),
        "score": lambda: sp.score(fit_m, x["coll"], x["ms"], x["desired_f"],
                                  x["penalty"], x["affinity"],
                                  x["has_affinity"]),
        "argmax": lambda: sp.argmax(fits_m, score_m, x["ms"]),
        "scatter": lambda: sp.scatter(run, order, x["count"], x["used"],
                                      x["demand"], x["coll"]),
    }


def _best_of(call, dev: torch.device, iters: int, warmup: int) -> float:
    """Best-of-`iters` wall seconds of call() after `warmup` calls; each
    timed call ends in a device synchronize."""
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    for _ in range(warmup):
        call()
    sync()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def probe(n_nodes: int, r_dims: int = NUM_RESOURCE_DIMS,
          iters: int = 10, warmup: int = 2,
          fill_grid: Optional[int] = None, device=None) -> Dict[str, float]:
    """Raw per-stage wall seconds (best-of-`iters` after `warmup`) at
    shape [n_nodes, fill_grid, r_dims] (default the full _FILL_GRID).
    Best-of strips launch jitter, which fractions must not carry."""
    dev = resolve_device(device)
    x = probe_inputs(n_nodes, r_dims, fill_grid, dev)
    calls = _stage_calls(x)
    return {name: _best_of(calls[name], dev, iters, warmup)
            for name in STAGES}


def probe_fused(n_nodes: int, r_dims: int = NUM_RESOURCE_DIMS,
                iters: int = 10, warmup: int = 2,
                fill_grid: Optional[int] = None, device=None) -> float:
    """Best-of wall seconds of ONE fused wave (K8f) at the same shape and
    inputs as `probe`: against the per-stage sum, what fusing the five
    launches into one buys at this shape."""
    dev = resolve_device(device)
    x = probe_inputs(n_nodes, r_dims, fill_grid, dev)
    return _best_of(lambda: sp.fused_wave(
        x["capacity"], x["used"], x["demand"], x["feasible"], x["affinity"],
        x["has_affinity"], x["desired_f"], x["penalty"], x["coll"],
        x["count"], x["fill_grid"]), dev, iters, warmup)


def device_stages(engine_stats: dict, n_nodes: int,
                  r_dims: int = NUM_RESOURCE_DIMS,
                  iters: int = 10, fill_grid: Optional[int] = None,
                  pipeline_overlap_s: Optional[float] = None,
                  commit_overlap_s: Optional[float] = None,
                  wave: Optional[dict] = None, device=None
                  ) -> Optional[dict]:
    """The BENCH JSON `"device_stages"` section: the run's measured
    `device_s` attributed across the wave pipeline by probed per-stage
    fractions (stage sum == device_s), the engine's dirty-row upload
    time, the fused wave against the per-stage sum, the two overlap
    metrics and, with `wave`, the engine's lane/donation counters.
    None when the run recorded no device time."""
    device_s = float(engine_stats.get("device_s", 0.0))
    if device_s <= 0.0:
        return None
    raw = probe(n_nodes, r_dims=r_dims, iters=iters, fill_grid=fill_grid,
                device=device)
    total = sum(raw.values()) or 1.0
    fused_s = probe_fused(n_nodes, r_dims=r_dims, iters=iters,
                          fill_grid=fill_grid, device=device)
    stages = {name: device_s * (raw[name] / total) for name in STAGES}
    dominant = max(stages, key=stages.get)
    section = {
        "stages_s": {k: round(v, 6) for k, v in stages.items()},
        "fractions": {k: round(raw[k] / total, 4) for k in STAGES},
        "probe_raw_s": {k: round(raw[k], 6) for k in STAGES},
        "device_s": round(device_s, 6),
        "dirty_row_upload_s": round(
            float(engine_stats.get("put_basis_s", 0.0)), 6),
        "dominant_stage": dominant,
        "n_nodes": int(n_nodes),
        "fill_grid": int(fill_grid) if fill_grid else int(_FILL_GRID),
        "fused": {
            "wave_s": round(fused_s, 6),
            "phase_sum_s": round(total, 6),
            "fusion_speedup": round(total / fused_s, 3)
            if fused_s > 0 else None,
        },
        "pipeline_overlap_s": round(float(pipeline_overlap_s or 0.0), 6),
        "commit_overlap_s": round(float(commit_overlap_s or 0.0), 6),
    }
    if wave:
        lanes = int(wave.get("wave_lanes", 0))
        evals = int(wave.get("lane_evals", 0))
        slots = int(wave.get("lane_slots", 0))
        section["wave"] = {
            "wave_lanes": lanes,
            "lane_evals": evals,
            "lane_slots": slots,
            "lane_occupancy": round(evals / slots, 4) if slots else None,
            "donated_carries": int(wave.get("donated_carries", 0)),
            "overlap_chained": int(wave.get("overlap_chained", 0)),
        }
    return section
