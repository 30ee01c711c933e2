#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nomad_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, all run in this order:
  build    compile every CUDA kernel from nomad_tpu_torch/csrc (one nvcc
           per source, all started together) and print nvcc's register
           and spill report
  kernels  each kernel against its plain PyTorch version on the card, at
           the shapes the main path gives it (N = 16,384 node rows, the
           bucket of a 10,000-node cluster): integer outputs equal, float
           outputs within the tests' tolerances (K1, K2) or bit-equal
           (K3, K4, K5); CUDA-event times of the kernel, of the plain
           version and, for K5, of the one PyTorch call that computes the
           same function
  slice    the engine-off path (NOMAD_TPU_ENGINE=0): the scheduler's
           eval-to-commit path through the entry points a user calls
           (Harness(device="cuda") -> GenericScheduler -> DenseStack ->
           K1/K2 -> plan -> PlanApplier -> StateStore): first a small
           world on the card against the same world on the CPU (plain
           versions), then a 10,000-node world with 100 C2M-shaped batch
           jobs (10 groups x count 10 x 30 MHz/60 MB, the bulk kernel),
           5 rack-spread service jobs of count 50, 2 distinct_hosts jobs
           of count 20 and one node-affinity job (the scan kernel).
           Every alloc must be placed and committed, and both kernels'
           launch counters must move during that run.
  engine   the default, engine-on path: the same small world card vs
           CPU, then the slice's 10,000-node stream through the
           PlacementEngine (K4 chains each C2M eval's ten groups, K3 the
           scan evals, K5 set_rows keeps the resident world in sync);
           every alloc committed, the world's device basis bitwise equal
           to its host snapshot; then 8 concurrent callers (K3 chains
           E > 1) against a serial replay; 8 threads submitting C2M
           evals at once to an engine whose byte budget splits them into
           parts that chain behind an in-flight donated dispatch (the
           overlap pipeline), against a serial replay; and a short run
           of a fresh engine with donation off, on which K5 add_rank1
           launches.

Output: the card's name and power limit (nvidia-smi), per-phase lines, a
`{"kernels": [...]}` line, and as the last line
`{"ok": true, "device": {...}}`.  Any failing phase raises and exits
non-zero; without a CUDA card it exits non-zero before printing anything.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

N_ROWS = 16384            # ClusterMatrix bucket of a 10,000-node cluster
N_NODES = 10000
RACKS = 50
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations of one fill-grid cell / one scan row (the arithmetic
# of the scoring stack: fit check, two pows, normalization), counted
# from the kernels' source
OPS_PER_CELL = 40
OPS_PER_SCAN_ROW = 60
OPS_PER_SPREAD = 20
RTOL, ATOL = 1e-5, 1.2e-7
DELTA_BUCKET = 64         # engine._DELTA_BUCKET


def log(msg: str) -> None:
    print(msg, flush=True)


def time_cuda(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


# --------------------------------------------------------------- inputs

def bulk_inputs(seed: int, main_path: bool):
    """Seeded K1 inputs over N_ROWS rows; rows past N_NODES are padding
    (infeasible, zero capacity).  main_path: the C2M group on a partly
    loaded uniform cluster; otherwise heterogeneous nodes with
    affinities, penalties, co-placements and count 200."""
    rng = np.random.default_rng(seed)
    n = N_NODES
    cap = np.zeros((N_ROWS, 4), np.float32)
    used = np.zeros((N_ROWS, 4), np.float32)
    feas = np.zeros(N_ROWS, bool)
    aff = np.zeros(N_ROWS, np.float32)
    pen = np.zeros(N_ROWS, bool)
    coll = np.zeros(N_ROWS, np.int32)
    if main_path:
        cap[:n] = [4000, 8192, 102400, 1000]
        used[:n, 0] = rng.integers(0, 40, n) * 30
        used[:n, 1] = used[:n, 0] * 2
        feas[:n] = True
        demand = np.array([30, 60, 0, 0], np.float32)
        return dict(cap=cap, used=used, feas=feas, aff=aff, has_aff=False,
                    desired=10, pen=pen, coll=coll, demand=demand, count=10)
    cap[:n, 0] = rng.choice([2000, 4000, 8000], n)
    cap[:n, 1] = rng.choice([4096, 8192, 16384], n)
    cap[:n, 2:] = [102400, 1000]
    used[:n, 0] = rng.integers(0, 10, n) * 100
    used[:n, 1] = rng.integers(0, 10, n) * 256
    feas[:n] = rng.random(n) < 0.9
    aff[:n] = rng.choice(np.array([-1.0, -0.5, 0.0, 0.0, 0.5, 1.0],
                                  np.float32), n)
    pen[:n] = rng.random(n) < 0.05
    coll[:n] = (rng.random(n) < 0.1) * rng.integers(1, 3, n)
    demand = np.array([100, 256, 0, 0], np.float32)
    return dict(cap=cap, used=used, feas=feas, aff=aff, has_aff=True,
                desired=200, pen=pen, coll=coll, demand=demand, count=200)


def scan_inputs(seed: int, main_path: bool):
    """Seeded K2 inputs (PlaceInputs fields) over N_ROWS rows.  main_path:
    one rack-spread group of a 50-slot service job (S = 64, the slot
    bucket) on a partly loaded cluster; otherwise three groups with
    targeted and even spreads, affinities, penalties, co-placements and
    per-node instance budgets."""
    rng = np.random.default_rng(seed)
    n = N_NODES
    g, s, k, v = (1, 64, 1, RACKS) if main_path else (3, 64, 2, 16)
    cap = np.zeros((N_ROWS, 4), np.float32)
    cap[:n] = [4000, 8192, 102400, 1000]
    if not main_path:
        cap[:n, 0] = rng.choice([2000, 4000, 8000], n)
        cap[:n, 1] = rng.choice([4096, 8192, 16384], n)
    used = np.zeros((N_ROWS, 4), np.float32)
    used[:n, 0] = rng.integers(0, 8, n) * 100
    used[:n, 1] = rng.integers(0, 8, n) * 256
    feas = np.zeros((g, N_ROWS), bool)
    feas[:, :n] = rng.random((g, n)) < (1.0 if main_path else 0.9)
    vidx = np.full((g, k, N_ROWS), v, np.int32)
    vidx[:, :, :n] = np.arange(n) % v if main_path else \
        rng.integers(0, v + 1, (g, k, n))
    desired = np.full((g, k, v + 1), -1.0, np.float32)
    targeted = np.zeros((g, k), bool)
    counts = np.zeros((g, k, v + 1), np.float32)
    counts[..., :v] = rng.integers(0, 3, (g, k, v))
    active = np.ones((g, k), bool)
    wfrac = np.ones((g, k), np.float32)
    slot_active = np.zeros(s, bool)
    slot_active[:50] = True
    slot_tg = np.zeros(s, np.int32)
    demand = np.zeros((s, 4), np.float32)
    demand[:50] = [500, 256, 150, 0]
    fields = dict(
        capacity=cap, used=used, feasible=feas,
        affinity=np.zeros((g, N_ROWS), np.float32),
        has_affinity=np.zeros(g, bool),
        desired_count=np.full(g, 50, np.int32),
        penalty=np.zeros((g, N_ROWS), bool),
        tg_count=np.zeros((g, N_ROWS), np.int32),
        spread_vidx=vidx, spread_desired=desired, spread_targeted=targeted,
        spread_wfrac=wfrac, spread_counts=counts, spread_active=active,
        place_cap=np.full((g, N_ROWS), -1, np.int32),
        demand=demand, slot_tg=slot_tg, slot_active=slot_active)
    if not main_path:
        targeted[:] = rng.random((g, k)) < 0.5
        desired[..., :v] = np.where(targeted[..., None],
                                    rng.integers(0, 60, (g, k, v)), -1)
        fields["spread_desired"] = desired
        fields["spread_wfrac"] = rng.choice(
            np.array([0.25, 0.5, 1.0], np.float32), (g, k))
        fields["affinity"][:, :n] = rng.choice(
            np.array([-1.0, -0.5, 0.0, 0.0, 0.5, 1.0], np.float32), (g, n))
        fields["has_affinity"][:] = True
        fields["penalty"][:, :n] = rng.random((g, n)) < 0.05
        fields["tg_count"][:, :n] = rng.random((g, n)) < 0.1
        fields["place_cap"][:, :n] = np.where(
            rng.random((g, n)) < 0.2, rng.integers(0, 3, (g, n)), -1)
        fields["slot_tg"][:] = rng.integers(0, g, s)
        fields["demand"][:50, :2] = rng.integers(1, 6, (50, 2)) * [100, 256]
    return fields


def fractional(a):
    """The same inputs with non-integer sizes and weights, so that every
    product and sum rounds: the check that the kernels (built with
    -fmad=false) round each operation as the plain versions do."""
    rng = np.random.default_rng(99)
    n = N_NODES
    if "cap" in a:                                   # bulk inputs
        a["cap"][:n, :2] += rng.random((n, 2), dtype=np.float32) * 1000
        a["used"][:n, :2] += rng.random((n, 2), dtype=np.float32) * 50
        a["demand"] = np.array([33.3, 70.7, 0.1, 0], np.float32)
        a["count"] = a["desired"] = 500
        return a
    a["capacity"][:n, :2] += rng.random((n, 2), dtype=np.float32) * 1000
    a["used"][:n, :2] += rng.random((n, 2), dtype=np.float32) * 50
    a["demand"][:50, :2] = rng.uniform(50, 600, (50, 2))
    a["spread_wfrac"] = rng.uniform(0.1, 1.0, a["spread_wfrac"].shape) \
        .astype(np.float32)
    a["spread_desired"] = np.where(a["spread_desired"] >= 0,
                                   a["spread_desired"] + 0.37, -1.0) \
        .astype(np.float32)
    return a


# --------------------------------------------------------------- phases

def phase_build():
    from nomad_tpu_torch.ops import _build
    t0 = time.time()
    logs = _build.build_all()
    log(f"build: {len(logs)} kernels in {time.time() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def _bulk_call(fn, a, dev):
    import torch
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    args = (t(a["cap"]), t(a["used"]), t(a["feas"]), t(a["aff"]),
            a["has_aff"], a["desired"], t(a["pen"]), t(a["coll"]),
            t(a["demand"]), a["count"])
    return lambda: fn(*args)


def _compare_floats(name, got, ref):
    both_inf = np.isinf(got) & np.isinf(ref) & (np.sign(got) == np.sign(ref))
    fin = ~both_inf
    if not np.array_equal(np.isfinite(got), np.isfinite(ref)):
        raise AssertionError(f"{name}: finite masks differ")
    err = float(np.max(np.abs(got[fin] - ref[fin]))) if fin.any() else 0.0
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL, atol=ATOL,
                               err_msg=name)
    return err


def check_bulk(a, label, place_all):
    """Kernel vs plain on the card; returns (max_abs_err, waves, rows
    that took instances, kernel callable, plain callable)."""
    import torch
    from nomad_tpu_torch.ops import place as tp
    dev = torch.device("cuda")
    kern = _bulk_call(tp.place_bulk, a, dev)
    plain = _bulk_call(tp.place_bulk_plain, a, dev)
    k_out = kern()
    torch.cuda.synchronize()
    p_out = plain()
    torch.cuda.synchronize()
    kr = tp.unpack_bulk(k_out.cpu().numpy())
    pr = tp.unpack_bulk(p_out.cpu().numpy())
    np.testing.assert_array_equal(kr[0], pr[0], err_msg=f"{label} assign")
    if kr[1:4] + (kr[5],) != pr[1:4] + (pr[5],):
        raise AssertionError(f"{label}: (placed, n_eval, n_exh, waves) "
                             f"kernel {kr[1:4] + (kr[5],)} plain "
                             f"{pr[1:4] + (pr[5],)}")
    if kr[1] == 0 or (place_all and kr[1] != a["count"]):
        raise AssertionError(f"{label}: placed {kr[1]} of {a['count']}")
    err = max(_compare_floats(f"{label} used", kr[6], pr[6]),
              _compare_floats(f"{label} scores", kr[4], pr[4]))
    log(f"kernels: place_bulk {label}: placed {kr[1]}/{a['count']} in "
        f"{kr[5]} waves, integers equal, max |err| {err:.3g}")
    return err, kr[5], int(np.count_nonzero(kr[0])), kern, plain


def check_scan(fields, label):
    import torch
    from nomad_tpu_torch.convert import place_inputs_from_numpy
    from nomad_tpu_torch.ops import place as tp
    inp = place_inputs_from_numpy(fields, "cuda")
    kern = lambda: tp.place_eval_packed(inp)
    plain = lambda: tp.place_eval_plain(inp)
    k_packed, k_used = kern()
    torch.cuda.synchronize()
    p_packed, p_used = plain()
    torch.cuda.synchronize()
    kr = tp.unpack_outputs(k_packed.cpu().numpy())
    pr = tp.unpack_outputs(p_packed.cpu().numpy())
    for i, nm in ((0, "node"), (3, "n_eval"), (4, "n_exh"), (5, "top_nodes")):
        np.testing.assert_array_equal(kr[i], pr[i], err_msg=f"{label} {nm}")
    err = max(_compare_floats(f"{label} score", kr[1], pr[1]),
              _compare_floats(f"{label} fit", kr[2], pr[2]),
              _compare_floats(f"{label} top_scores", kr[6], pr[6]),
              _compare_floats(f"{label} used", k_used.cpu().numpy(),
                              p_used.cpu().numpy()))
    placed = int((kr[0] >= 0).sum())
    if placed == 0:
        raise AssertionError(f"{label}: nothing placed")
    log(f"kernels: place_scan {label}: placed {placed}/"
        f"{int(fields['slot_active'].sum())} slots, integers equal, "
        f"max |err| {err:.3g}")
    return err, kern, plain


def bulk_cells(n: int, waves: int, run_rows: int, fill_grid: int) -> int:
    """Fill-grid cells one bulk eval needs on this run's data: the m=1
    and m=2 cells of every row each wave, the run cells (fill_grid each)
    of the rows that took instances, and the final scoring pass.  Wave
    rows that took nothing are left out, so this is a floor."""
    return waves * n * 2 + run_rows * fill_grid + n


def bulk_bound_ms(a, waves: int, run_rows: int) -> tuple:
    n = a["cap"].shape[0]
    # inputs read once (capacity, used0, feasible, affinity, penalty,
    # coll0, demand) + the packed output written once
    nbytes = n * (16 + 16 + 1 + 4 + 1 + 4) + 16 + n * 7 * 4
    # K1's wrapper runs the default fill grid
    from nomad_tpu_torch.ops import place as tp
    ops = bulk_cells(n, waves, run_rows, tp._FILL_GRID) * OPS_PER_CELL
    return _bound(nbytes, ops)


def scan_bound_ms(f) -> tuple:
    g, n = f["feasible"].shape
    k = f["spread_wfrac"].shape[1]
    vp1 = f["spread_desired"].shape[2]
    s = f["demand"].shape[0]
    nbytes = (n * 16 * 2 + g * n * (1 + 4 + 1 + 4 + 4) + g * k * n * 4
              + g * k * vp1 * 8 + g * k * 6 + g * 5 + s * 21
              + s * 15 * 4 + n * 16)
    active = int(f["slot_active"].sum())
    ops = active * n * (OPS_PER_SCAN_ROW + k * OPS_PER_SPREAD)
    return _bound(nbytes, ops)


def _bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels():
    """-> {name: entry} of the kernels line (launches filled in later)."""
    entries = {}
    a_main = bulk_inputs(1, main_path=True)
    err_m, waves, run_rows, kern, plain = check_bulk(a_main, "C2M group",
                                                     True)
    err_h, *_ = check_bulk(bulk_inputs(2, main_path=False),
                           "heterogeneous", True)
    a_over = bulk_inputs(3, main_path=False)
    a_over["demand"] = np.array([1500, 3000, 0, 0], np.float32)
    a_over["count"] = 4 * N_NODES
    err_o, *_ = check_bulk(a_over, "beyond capacity", False)
    err_f, *_ = check_bulk(fractional(bulk_inputs(6, main_path=False)),
                           "fractional", True)
    ms = time_cuda(kern)
    plain_ms = time_cuda(plain)
    bound, by = bulk_bound_ms(a_main, waves, run_rows)
    entries["place_bulk"] = dict(
        name="place_bulk", route="cuda",
        source="nomad_tpu_torch/csrc/place_bulk.cu",
        replaces="nomad_tpu/ops/place.py:626",
        jax_function="place_bulk_jit",
        launches=0, max_abs_err=max(err_m, err_h, err_o, err_f), ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None)
    log(f"kernels: place_bulk C2M group N={N_ROWS}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({by})")

    f_main = scan_inputs(4, main_path=True)
    err_m, kern, plain = check_scan(f_main, "rack spread")
    err_h, _, _ = check_scan(scan_inputs(5, main_path=False), "mixed")
    err_f, _, _ = check_scan(fractional(scan_inputs(7, main_path=False)),
                             "fractional")
    ms = time_cuda(kern)
    plain_ms = time_cuda(plain)
    bound, by = scan_bound_ms(f_main)
    entries["place_scan"] = dict(
        name="place_scan", route="cuda",
        source="nomad_tpu_torch/csrc/place_scan.cu",
        replaces="nomad_tpu/ops/place.py:253",
        jax_function="place_eval_packed_jit",
        launches=0, max_abs_err=max(err_m, err_h, err_f), ms=ms,
        plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=None)
    log(f"kernels: place_scan rack spread N={N_ROWS} S=64: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({by})")

    entries["place_batch"] = check_batch_scan()
    entries["place_bulk_batch"] = check_batch_bulk()
    entries.update(check_world_scatter())
    return entries


def _bitwise(name, got, ref):
    """Bit-equal float arrays (equal NaN/inf positions included)."""
    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape or not np.array_equal(
            got.view(np.uint32), ref.view(np.uint32)):
        diff = np.abs(np.nan_to_num(got) - np.nan_to_num(ref))
        raise AssertionError(f"{name}: not bit-equal (max |diff| "
                             f"{float(diff.max()) if diff.size else 0})")


def _deltas(rng, k):
    """k usage deltas on distinct rows (a stop, a preplacement) plus one
    repeated row, integer sizes as real allocs have."""
    rows = rng.choice(N_NODES, k, replace=False)
    out = [(int(r), (rng.integers(-3, 4, 4) * np.array([100, 256, 0, 0]))
            .astype(np.float32)) for r in rows]
    out.append((out[0][0], np.array([100, 0, 0, 0], np.float32)))
    return out


def batch_scan_inputs(seed: int, E: int, S: int, with_deltas: bool):
    """K3 inputs: an E-eval chain of rack-spread evals (scan_inputs' main
    path, 64 slots of which 50 active) with the slot axis padded to S,
    each with deltas or none, packed as the engine packs them.  Returns
    (capacity, used0, heavy, dyn, dims)."""
    from nomad_tpu_torch.ops import place as tp
    rng = np.random.default_rng(seed)
    evals = [scan_inputs(seed + e, main_path=True) for e in range(E)]
    cap, used = evals[0]["capacity"], evals[0]["used"]
    inps = [tp.PlaceInputs(**f) for f in evals]
    heavy = np.stack([tp.pack_heavy(i) for i in inps])
    dyn = np.concatenate([
        tp.pack_light(i, _deltas(rng, 3) if with_deltas else [],
                      DELTA_BUCKET, S) for i in inps])
    g, n, k, vp1 = tp.heavy_dims(inps[0])
    return cap, used, heavy, dyn, (g, n, k, vp1, S, DELTA_BUCKET)


def _batch_scan_case(label, seed, E, S, with_deltas):
    """K3 kernel vs plain on the card, bit for bit; returns (kernel
    callable, plain callable, slots placed, inputs)."""
    import torch
    from nomad_tpu_torch.ops import place as tp
    cap, used, heavy, dyn, dims = batch_scan_inputs(seed, E, S, with_deltas)
    t = lambda x: torch.from_numpy(np.array(x)).cuda()
    args = (t(cap), t(used), t(heavy), t(dyn), dims)
    kern = lambda: tp.place_batch_packed(*args)
    plain = lambda: tp.place_batch_packed_plain(*args)
    k_packed, k_used = kern()
    p_packed, p_used = plain()
    torch.cuda.synchronize()
    kp, pp = k_packed.cpu().numpy(), p_packed.cpu().numpy()
    _bitwise(f"place_batch {label} packed", kp, pp)
    _bitwise(f"place_batch {label} used", k_used.cpu().numpy(),
             p_used.cpu().numpy())
    placed = int((tp.unpack_outputs(kp)[0] >= 0).sum())
    if placed != 50 * E:
        raise AssertionError(f"place_batch {label}: placed {placed} of "
                             f"{50 * E} slots")
    log(f"kernels: place_batch {label}, N={N_ROWS} S={S}: placed {placed} "
        f"slots, bit-equal")
    return kern, plain, placed, (heavy, dyn, dims)


def check_batch_scan():
    """K3 kernel vs plain on the card, bit for bit: an E = 8 chain with
    deltas at S = 64 (timed), and the main path's shape, one rack-spread
    eval alone with the engine's slot bucket (S = 128) and no deltas."""
    from nomad_tpu_torch.parallel.engine import _s_bucket
    s_main = _s_bucket(64)
    m_kern, m_plain, _, _ = _batch_scan_case(
        "E=1 rack-spread eval (main path)", 21, 1, s_main, False)
    kern, plain, placed, (heavy, dyn, dims) = _batch_scan_case(
        "E=8 rack-spread chain with deltas", 11, 8, 64, True)
    ms = time_cuda(kern)
    plain_ms = time_cuda(plain, reps=3, warmup=1)
    m_ms = time_cuda(m_kern)
    E = heavy.shape[0]
    g, n, k, vp1, S, D = dims
    nbytes = (n * 16 * 3 + heavy.nbytes + dyn.nbytes + E * S * 15 * 4)
    ops = placed * n * (OPS_PER_SCAN_ROW + k * OPS_PER_SPREAD)
    bound, by = _bound(nbytes, ops)
    log(f"kernels: place_batch E=8: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.6f} ms ({by}); E=1 S={s_main} "
        f"(main path): kernel {m_ms:.4f} ms")
    return dict(name="place_batch", route="cuda",
                source="nomad_tpu_torch/csrc/place_scan.cu",
                replaces="nomad_tpu/ops/place.py:403",
                jax_function="place_batch_packed_jit",
                launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)


def batch_bulk_inputs(seed: int, E: int = 16):
    """K4 inputs: an E-eval chain of C2M groups (count 10, 30 MHz/60 MB)
    on the partly loaded 10,000-node cluster, with random feasibility
    and co-placements, half of them with deltas, then one count-0 pad (a
    zero light block, as the reference engine pads a chain).  Returns
    (capacity, used0, heavy, dyn, D)."""
    from nomad_tpu_torch.ops import place as tp
    rng = np.random.default_rng(seed)
    a = bulk_inputs(seed, main_path=True)
    heavy, lights = [], []
    for e in range(E):
        feas = a["feas"].copy()
        feas[:N_NODES] = rng.random(N_NODES) < 0.95
        coll = np.zeros(N_ROWS, np.int32)
        coll[rng.choice(N_NODES, 20, replace=False)] = 1
        heavy.append(tp.pack_bulk_heavy(feas, a["aff"], a["pen"], coll))
        deltas = _deltas(rng, 3) if e % 2 else []
        lights.append(tp.pack_bulk_light(False, 10, 10, a["demand"], deltas,
                                          N_ROWS, DELTA_BUCKET))
    heavy.append(heavy[0])
    lights.append(np.zeros_like(lights[0]))
    return (a["cap"], a["used"], np.stack(heavy), np.concatenate(lights),
            DELTA_BUCKET)


def c2m_eval_inputs(seed: int):
    """K4 at the main path's shape: one C2M eval's ten groups as the
    engine ships them (every ready row feasible, no co-placements yet,
    no deltas, so D = 0).  Returns (capacity, used0, heavy, dyn, D)."""
    from nomad_tpu_torch.ops import place as tp
    a = bulk_inputs(seed, main_path=True)
    h = tp.pack_bulk_heavy(a["feas"], a["aff"], a["pen"], a["coll"])
    light = tp.pack_bulk_light(False, 10, 10, a["demand"], [], N_ROWS, 0)
    return (a["cap"], a["used"], np.stack([h] * 10),
            np.concatenate([light] * 10), 0)


def _batch_bulk_case(label, inputs, sparse, exact, fill_grid):
    """K4 kernel vs plain on the card, bit for bit (and, with the exact
    carry, against the host rank-1 update); returns unpack_bulk_batch of
    the kernel's output."""
    import torch
    from nomad_tpu_torch import native
    from nomad_tpu_torch.ops import place as tp
    cap, used, heavy, dyn, D = inputs
    t = lambda x: torch.from_numpy(np.array(x)).cuda()
    E, n = heavy.shape[0], cap.shape[0]
    outs = []
    for fn in (tp.place_bulk_batch, tp.place_bulk_batch_plain):
        outs.append([x.cpu().numpy() for x in fn(
            t(cap), t(used), t(heavy), t(dyn), D, sparse_out=sparse,
            fill_grid=fill_grid, exact_out=exact)])
    torch.cuda.synchronize()
    for i, part in enumerate(("packed", "used", "exact")[:len(outs[0])]):
        _bitwise(f"place_bulk_batch {label} {part}", outs[0][i], outs[1][i])
    res = tp.unpack_bulk_batch(outs[0][0], n, sparse=sparse)
    light = dyn.reshape(E, -1)
    want = np.rint(light[:, 2]).astype(np.int32)
    if not np.array_equal(res[2], want):
        raise AssertionError(f"place_bulk_batch {label}: placed "
                             f"{res[2].tolist()} of {want.tolist()}")
    if exact:
        host = used.copy()
        for e in range(E):
            rows = np.flatnonzero(res[0][e])
            native.scatter_add_rank1(host, rows, res[0][e][rows],
                                     light[e, 3:7])
        _bitwise(f"place_bulk_batch {label} exact vs host rank-1",
                 outs[0][2], host)
    log(f"kernels: place_bulk_batch {label}, N={N_ROWS}: placed "
        f"{int(res[2].sum())}, bit-equal")
    return res


def check_batch_bulk():
    """K4 kernel vs plain on the card, bit for bit: an E = 16 chain with
    deltas and a count-0 pad, sparse and dense output, exact carry off
    and on (the sparse, no-carry form timed); and the main path's shape,
    one C2M eval's ten groups with no deltas (D = 0), sparse, with the
    exact carry the donated dispatch adopts."""
    import torch
    from nomad_tpu_torch.ops import place as tp
    fill_grid = tp.fill_grid_for(10)
    main = c2m_eval_inputs(14)
    _batch_bulk_case("E=10 C2M eval, D=0, sparse, exact carry (main path)",
                     main, True, True, fill_grid)
    chain = batch_bulk_inputs(12)
    cap, used, heavy, dyn, D = chain
    E, n = heavy.shape[0], cap.shape[0]
    timed = None
    for sparse in (True, False):
        for exact in (False, True):
            label = (f"E={E} C2M chain with deltas and a count-0 pad, "
                     f"{'sparse' if sparse else 'dense'}"
                     f"{', exact carry' if exact else ''}")
            res = _batch_bulk_case(label, chain, sparse, exact, fill_grid)
            if sparse and not exact:
                timed = res
    t = lambda x: torch.from_numpy(np.array(x)).cuda()
    kw = dict(sparse_out=True, fill_grid=fill_grid)
    args = (t(cap), t(used), t(heavy), t(dyn), D)
    kern = lambda: tp.place_bulk_batch(*args, **kw)
    plain = lambda: tp.place_bulk_batch_plain(*args, **kw)
    m_args = tuple(t(x) for x in main[:4]) + (main[4],)
    m_kern = lambda: tp.place_bulk_batch(*m_args, **kw)
    ms = time_cuda(kern)
    plain_ms = time_cuda(plain, reps=5, warmup=1)
    m_ms = time_cuda(m_kern)
    assign, _, placed, _, _, waves = timed
    nbytes = (n * 16 * 3 + heavy.nbytes + dyn.nbytes
              + E * (3 * tp.SPARSE_CAP + 4) * 4)
    cells = sum(bulk_cells(n, int(waves[e]), int(np.count_nonzero(assign[e])),
                           fill_grid) for e in range(E) if placed[e] > 0)
    bound, by = _bound(nbytes, cells * OPS_PER_CELL)
    log(f"kernels: place_bulk_batch E={E} sparse: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({by}); E=10 D=0 "
        f"(main path, no exact carry): kernel {m_ms:.4f} ms")
    return dict(name="place_bulk_batch", route="cuda",
                source="nomad_tpu_torch/csrc/place_bulk.cu",
                replaces="nomad_tpu/ops/place.py:729",
                jax_function="_place_bulk_batch",
                launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)


def check_world_scatter():
    """K5 set_rows (64/512/4096-row buckets, pad rows dropped) and
    add_rank1 vs plain on the card, bit for bit; times at the largest
    bucket beside the one PyTorch call (index_copy_ / index_add_)."""
    import torch
    from nomad_tpu_torch.parallel import world as tw
    rng = np.random.default_rng(13)
    base = np.zeros((N_ROWS, 4), np.float32)
    base[:N_NODES, 0] = rng.integers(0, 40, N_NODES) * 30
    base[:N_NODES, 1] = base[:N_NODES, 0] * 2 + 0.5
    t = lambda x: torch.from_numpy(np.array(x)).cuda()
    entries = {}
    for b in tw.ROW_BUCKETS:
        live = b * 3 // 4
        rows = np.full(b, N_ROWS, np.int32)
        rows[:live] = rng.choice(N_NODES, live, replace=False)
        vals = (rng.random((b, 4)) * 5000).astype(np.float32)
        k = tw.set_rows(t(base), t(rows), t(vals))
        p = tw.set_rows_plain(t(base), t(rows), t(vals))
        torch.cuda.synchronize()
        _bitwise(f"set_rows B={b}", k.cpu().numpy(), p.cpu().numpy())
    log(f"kernels: set_rows B={tw.ROW_BUCKETS}, pad rows dropped: bit-equal")
    B = tw.ROW_BUCKETS[-1]
    rows = rng.choice(N_NODES, B, replace=False).astype(np.int32)
    counts = rng.integers(1, 40, B).astype(np.int32)
    dem = np.array([33.3, 70.7, 0.1, 5.0], np.float32)
    k = tw.add_rank1(t(base), t(rows), t(counts), t(dem))
    p = tw.add_rank1_plain(t(base), t(rows), t(counts), t(dem))
    torch.cuda.synchronize()
    _bitwise("add_rank1", k.cpu().numpy(), p.cpu().numpy())
    from nomad_tpu_torch import native
    host = base.copy()
    native.scatter_add_rank1(host, rows, counts, dem)
    _bitwise("add_rank1 vs host rank-1", k.cpu().numpy(), host)
    log(f"kernels: add_rank1 B={B}: bit-equal to plain and to the host "
        f"rank-1 update")
    d, r, v = t(base), t(rows), t(rng.random((B, 4)).astype(np.float32))
    rl, c, dm = r.long(), t(counts), t(dem)
    cf = c.float()
    timings = {
        "set_rows": (lambda: tw.set_rows(d, r, v),
                     lambda: tw.set_rows_plain(d, r, v),
                     lambda: d.index_copy_(0, rl, v),
                     B * (4 + 16 + 16), 0),
        "add_rank1": (lambda: tw.add_rank1(d, r, c, dm),
                      lambda: tw.add_rank1_plain(d, r, c, dm),
                      lambda: d.index_add_(0, rl, cf[:, None] * dm),
                      B * (4 + 4 + 16 + 16) + 16, 2 * B * 4),
    }
    for name, (kern, plain, lib, nbytes, ops) in timings.items():
        ms = time_cuda(kern, reps=50)
        plain_ms = time_cuda(plain)
        lib_ms = time_cuda(lib, reps=50)
        bound, by = _bound(nbytes, ops)
        log(f"kernels: {name} B={B}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
            f"{bound:.6f} ms ({by})")
        entries[name] = dict(
            name=name, route="cuda",
            source="nomad_tpu_torch/csrc/world_scatter.cu",
            replaces=("nomad_tpu/parallel/world.py:86" if name == "set_rows"
                      else "nomad_tpu/parallel/world.py:88"),
            jax_function=f"_single_device_fns ({name})",
            launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=lib_ms)
    return entries


# --------------------------------------------------------------- the slice

def _c2m_job(mock):
    j = mock.batch_job()
    base = j.task_groups[0]
    base.count = 10
    base.tasks[0].resources.cpu = 30
    base.tasks[0].resources.memory_mb = 60
    base.ephemeral_disk.size_mb = 0
    tgs = []
    for k in range(10):
        tg = base.copy() if k else base
        tg.name = f"g{k}"
        tgs.append(tg)
    j.task_groups = tgs
    return j


def _scan_jobs(mock, spread_count=50, n_spread=5, distinct_count=20,
               n_distinct=2):
    from nomad_tpu_torch.structs.job import Affinity, Constraint, Operand, Spread
    jobs = []
    for _ in range(n_spread):
        j = mock.job()
        j.task_groups[0].count = spread_count
        j.task_groups[0].spreads = [Spread("${attr.rack}", 100, ())]
        jobs.append(("service", j))
    for _ in range(n_distinct):
        j = mock.job()
        j.task_groups[0].count = distinct_count
        j.constraints.append(Constraint(operand=Operand.DISTINCT_HOSTS))
        jobs.append(("service", j))
    j = mock.job()
    j.task_groups[0].count = 1
    j.affinities.append(Affinity("${attr.rack}", "r7", Operand.EQ, weight=100))
    jobs.append(("service", j))
    return jobs


def _world(h, mock, n_nodes):
    for i in range(n_nodes):
        node = mock.node()
        node.id = f"node-{i:05d}"
        node.name = node.id
        node.attributes["rack"] = f"r{i % RACKS}"
        h.store.upsert_node(h.next_index(), node)


def _run(h, mock, kind, job):
    h.store.upsert_job(h.next_index(), job)
    ev = mock.eval(job_id=job.id, type=kind, priority=job.priority)
    h.store.upsert_evals(h.next_index(), [ev])
    t0 = time.perf_counter()
    h.process(kind, ev)
    return time.perf_counter() - t0


def _row_counts(h, job):
    out = {}
    for a in h.store.allocs_by_job(job.namespace, job.id):
        row = h.store.matrix.row_of[a.node_id]
        tg = out.setdefault(a.task_group, {})
        tg[row] = tg.get(row, 0) + 1
    return out


def phase_slice_small(label="slice"):
    """A 256-node world through Harness(device="cuda") and
    Harness(device="cpu"): identical per-job row/count maps."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.parallel.engine import stop_engines
    from nomad_tpu_torch.scheduler.testing import Harness
    maps = {}
    for dev in ("cuda", "cpu"):
        h = Harness(device=dev)
        _world(h, mock, 256)
        jobs = [("batch", _c2m_job(mock)) for _ in range(4)]
        jobs += _scan_jobs(mock, spread_count=12, n_spread=2,
                           distinct_count=8, n_distinct=1)
        for kind, job in jobs:
            job.id = f"job-{len(maps.get(dev, []))}"
            _run(h, mock, kind, job)
            maps.setdefault(dev, []).append(_row_counts(h, job))
    stop_engines()
    if maps["cuda"] != maps["cpu"]:
        raise AssertionError("small world: card and CPU placements differ")
    n = sum(c for m in maps["cuda"] for tg in m.values() for c in tg.values())
    log(f"{label}: 256-node world, {len(maps['cuda'])} jobs, {n} allocs: "
        f"card placements equal the CPU plain versions' placements")


def phase_slice():
    import torch
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import place as tp
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.structs.job import Operand

    phase_slice_small()
    h = Harness(device="cuda")
    t0 = time.time()
    _world(h, mock, N_NODES)
    cm = h.store.matrix
    log(f"slice: world of {N_NODES} nodes ({RACKS} racks, {cm.n_rows} "
        f"rows) built in {time.time() - t0:.1f} s")
    jobs = [("batch", _c2m_job(mock)) for _ in range(100)]
    jobs += _scan_jobs(mock)
    want = {j.id: sum(tg.count for tg in j.task_groups) for _, j in jobs}

    for k in tp.launches:
        tp.launches[k] = 0
    lat = []
    t0 = time.perf_counter()
    for kind, job in jobs:
        lat.append(_run(h, mock, kind, job))
        sched = h.last_scheduler
        if sched.failed_tg_allocs:
            raise AssertionError(f"{job.id}: failed groups "
                                 f"{sorted(sched.failed_tg_allocs)}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(tp.launches)

    total = 0
    for kind, job in jobs:
        allocs = h.store.allocs_by_job(job.namespace, job.id)
        if len(allocs) != want[job.id]:
            raise AssertionError(f"{job.id}: {len(allocs)} of "
                                 f"{want[job.id]} allocs committed")
        if any(a.terminal_status() for a in allocs):
            raise AssertionError(f"{job.id}: terminal alloc committed")
        total += len(allocs)
    for kind, job in jobs:
        if any(c.operand == Operand.DISTINCT_HOSTS for c in job.constraints):
            nodes = [a.node_id for a in h.store.allocs_by_job(job.namespace,
                                                              job.id)]
            if len(set(nodes)) != len(nodes):
                raise AssertionError(f"{job.id}: distinct_hosts violated")
    expect_used = np.zeros(4, np.float64)
    for kind, job in jobs:
        for a in h.store.allocs_by_job(job.namespace, job.id):
            cr = a.comparable_resources()
            expect_used += [cr.cpu_shares, cr.memory_mb, cr.disk_mb, 0]
    got_used = cm.used.astype(np.float64).sum(axis=0)
    if not np.allclose(got_used[:3], expect_used[:3]):
        raise AssertionError(f"committed usage {got_used} != allocs "
                             f"{expect_used}")
    if not (cm.used <= cm.capacity + 1e-3).all():
        raise AssertionError("committed usage exceeds capacity")
    if not all(launches[k] > 0 for k in ("place_bulk", "place_scan")):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    lat_ms = np.array(lat) * 1e3
    log(f"slice: {len(jobs)} evals, {total} allocs placed and committed in "
        f"{wall:.3f} s: {len(jobs) / wall:.2f} evals/s, "
        f"{total / wall:.1f} allocs/s, eval latency p50 "
        f"{np.percentile(lat_ms, 50):.2f} ms p99 "
        f"{np.percentile(lat_ms, 99):.2f} ms; launches {launches} "
        f"(scale: {N_NODES} nodes as in C2M-1M; 100 C2M-shaped jobs are "
        f"1% of C2M-1M's 10,000 jobs)")
    # where the time goes, on fresh jobs after the counted run
    profile_slice(h, mock, [("batch", _c2m_job(mock)) for _ in range(20)]
                  + _scan_jobs(mock))
    return launches


# host functions whose cumulative time splits an eval, by layer
_PROFILE_SPLIT = {
    "reconcile.py:compute": "reconcile",
    "stack.py:compile_group": "dense compile",
    "stack.py:build_host_inputs": "dense compile",
    "generic.py:_place_bulk": "K1 call (upload, kernel, fetch)",
    "stack.py:place": "K2 call (kernel, fetch)",
    "placement.py:materialize_bulk_allocs": "materialize",
    "placement.py:build_allocation": "materialize",
    "plan_apply.py:apply": "plan apply + commit",
}


def profile_slice(h, mock, jobs):
    """Run `jobs` under torch.profiler (device time of the two kernels)
    and cProfile (host split by layer); prints one line.  Both profilers
    add host overhead, so the shares describe a profiled run."""
    import cProfile
    import os
    import pstats
    import torch
    from torch.profiler import ProfilerActivity, profile
    prof_py = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prof_py.enable()
        for kind, job in jobs:
            _run(h, mock, kind, job)
        prof_py.disable()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = 0.0
    for ev in prof.key_averages():
        if "place_bulk_kernel" in ev.key or "place_scan_kernel" in ev.key:
            dev_us += (getattr(ev, "device_time_total", 0.0)
                       or getattr(ev, "cuda_time_total", 0.0))
    split = {}
    for (path, _line, fn), stat in pstats.Stats(prof_py).stats.items():
        layer = _PROFILE_SPLIT.get(f"{os.path.basename(path)}:{fn}")
        if layer is not None:
            split[layer] = split.get(layer, 0.0) + stat[3]
    busy = (f"{dev_us / 1e6 / wall:.4f}" if dev_us > 0
            else "not measured (the profiler recorded no device time)")
    parts = ", ".join(f"{k} {v / wall:.3f}" for k, v in
                      sorted(split.items(), key=lambda kv: -kv[1]))
    log(f"profile: {len(jobs)} evals in {wall:.3f} s with both profilers "
        f"on; kernels' device time {dev_us / 1e3:.3f} ms, device busy "
        f"share {busy}; host share by layer: {parts}")


# --------------------------------------------------------------- the engine

def _check_stream(h, jobs, want):
    """Every alloc of `jobs` placed and committed, usage equal to the
    allocs' sum and within capacity, distinct_hosts honoured; returns
    the alloc count."""
    from nomad_tpu_torch.structs.job import Operand
    cm = h.store.matrix
    total = 0
    expect_used = np.zeros(4, np.float64)
    for kind, job in jobs:
        allocs = h.store.allocs_by_job(job.namespace, job.id)
        if len(allocs) != want[job.id]:
            raise AssertionError(f"{job.id}: {len(allocs)} of "
                                 f"{want[job.id]} allocs committed")
        if any(a.terminal_status() for a in allocs):
            raise AssertionError(f"{job.id}: terminal alloc committed")
        if any(c.operand == Operand.DISTINCT_HOSTS for c in job.constraints):
            nodes = [a.node_id for a in allocs]
            if len(set(nodes)) != len(nodes):
                raise AssertionError(f"{job.id}: distinct_hosts violated")
        for a in allocs:
            cr = a.comparable_resources()
            expect_used += [cr.cpu_shares, cr.memory_mb, cr.disk_mb, 0]
        total += len(allocs)
    got_used = cm.used.astype(np.float64).sum(axis=0)
    if not np.allclose(got_used[:3], expect_used[:3]):
        raise AssertionError(f"committed usage {got_used} != allocs "
                             f"{expect_used}")
    if not (cm.used <= cm.capacity + 1e-3).all():
        raise AssertionError("committed usage exceeds capacity")
    return total


def _check_world(eng, label):
    """The resident world's device basis equals its host snapshot bit
    for bit, and no ticket is left open."""
    import torch
    torch.cuda.synchronize()
    worlds = list(eng._worlds.values())
    if not worlds:
        raise AssertionError(f"{label}: the engine holds no world")
    for w in worlds:
        _, basis = w.device_arrays()
        if basis is None:
            raise AssertionError(f"{label}: no resident basis")
        _bitwise(f"{label}: device basis vs host snapshot",
                 basis.cpu().numpy(), w.host_basis())
    if eng.stats["tickets_open"] != 0:
        raise AssertionError(f"{label}: {eng.stats['tickets_open']} "
                             f"tickets left open")


def _reset_counts():
    from nomad_tpu_torch.ops import place as tp
    from nomad_tpu_torch.parallel import world as tw
    for d in (tp.launches, tw.launches):
        for k in d:
            d[k] = 0


def _counts():
    from nomad_tpu_torch.ops import place as tp
    from nomad_tpu_torch.parallel import world as tw
    return {**tp.launches, **tw.launches}


def phase_engine():
    """The engine-on path (the default).  Returns the launch counts of
    K3, K4 and K5 set_rows on the main run and of K5 add_rank1 on the
    donation-off run."""
    import os
    import torch
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.parallel.engine import get_engine, stop_engines
    from nomad_tpu_torch.scheduler.testing import Harness

    phase_slice_small("engine")
    h = Harness(device="cuda")
    _world(h, mock, N_NODES)
    cm = h.store.matrix
    eng = get_engine("cuda")
    spec = dict(feasible=cm.ready.copy(),
                affinity=np.zeros(cm.n_rows, np.float32), has_affinity=False,
                desired=10, penalty=np.zeros(cm.n_rows, bool),
                coll0=np.zeros(cm.n_rows, np.int32),
                demand=np.array([30, 60, 0, 0], np.float32), count=10)
    t0 = time.time()
    eng.warmup(cm, bulk=spec)
    log(f"engine: warmup (K4 sparse/dense with and without deltas, the "
        f"row-scatter buckets, the world's epoch upload) "
        f"{time.time() - t0:.2f} s")
    c2m = [("batch", _c2m_job(mock)) for _ in range(100)]
    scan = _scan_jobs(mock)
    jobs = c2m + scan
    want = {j.id: sum(tg.count for tg in j.task_groups) for _, j in jobs}

    stats0 = dict(eng.stats)
    _reset_counts()
    lat = []
    t0 = time.perf_counter()
    for kind, job in jobs:
        lat.append(_run(h, mock, kind, job))
        if h.last_scheduler.failed_tg_allocs:
            raise AssertionError(f"{job.id}: failed groups "
                                 f"{sorted(h.last_scheduler.failed_tg_allocs)}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    total = _check_stream(h, jobs, want)
    st = {k: eng.stats[k] - stats0[k] for k in
          ("bulk_parts", "bulk_groups", "donated_carries", "bulk_evals",
           "batched_evals", "single_evals")}
    if launches["place_bulk_batch"] != len(c2m):
        raise AssertionError(f"K4 launched {launches['place_bulk_batch']} "
                             f"times for {len(c2m)} C2M evals")
    if launches["place_batch"] != len(scan):
        raise AssertionError(f"K3 launched {launches['place_batch']} times "
                             f"for {len(scan)} scan evals")
    if launches["set_rows"] == 0:
        raise AssertionError("K5 set_rows never launched")
    if launches["place_bulk"] or launches["place_scan"]:
        raise AssertionError(f"engine-off kernels ran on the engine path: "
                             f"{launches}")
    if st["donated_carries"] != st["bulk_parts"]:
        raise AssertionError(f"donated carries {st['donated_carries']} != "
                             f"bulk parts {st['bulk_parts']}")
    _check_world(eng, "engine")
    lat_ms = np.array(lat) * 1e3
    log(f"engine: {len(jobs)} evals, {total} allocs placed and committed "
        f"in {wall:.3f} s: {len(jobs) / wall:.2f} evals/s, "
        f"{total / wall:.1f} allocs/s, eval latency p50 "
        f"{np.percentile(lat_ms, 50):.2f} ms p99 "
        f"{np.percentile(lat_ms, 99):.2f} ms; launches {launches}; "
        f"engine {st}; world {eng.world_stats()}")
    concurrent_step(h, eng)
    profile_engine(h, mock, eng, [("batch", _c2m_job(mock))
                                  for _ in range(20)] + _scan_jobs(mock))
    out = {k: launches[k] for k in ("place_batch", "place_bulk_batch",
                                    "set_rows")}
    stop_engines()
    overlap_step(h)

    # a fresh engine with donation off: resolved placements scatter into
    # the resident basis through add_rank1
    os.environ["NOMAD_TPU_DONATE"] = "0"
    try:
        h2 = Harness(device="cuda")
        _world(h2, mock, N_NODES)
        eng2 = get_engine("cuda")
        if eng2.donate:
            raise AssertionError("NOMAD_TPU_DONATE=0 not honoured")
        jobs2 = [("batch", _c2m_job(mock)) for _ in range(10)]
        want2 = {j.id: 100 for _, j in jobs2}
        _reset_counts()
        for kind, job in jobs2:
            _run(h2, mock, kind, job)
        torch.cuda.synchronize()
        launches2 = _counts()
        _check_stream(h2, jobs2, want2)
        _check_world(eng2, "engine, donation off")
        if launches2["add_rank1"] == 0:
            raise AssertionError("K5 add_rank1 never launched with "
                                 "donation off")
        if eng2.stats["donated_carries"] != 0:
            raise AssertionError("a carry was donated with donation off")
        log(f"engine: donation off, {len(jobs2)} C2M evals: launches "
            f"{launches2}")
        out["add_rank1"] = launches2["add_rank1"]
    finally:
        os.environ.pop("NOMAD_TPU_DONATE", None)
        stop_engines()
    return out


def concurrent_step(h, eng):
    """8 threads call engine.place with the same rack-spread eval's inputs
    (DenseStack over the engine's world): the dispatcher chains what
    queued together through K3 (E > 1).  The multiset of results must
    equal a serial replay's (identical inputs: the k-th eval of any
    chain order gets the k-th serial result)."""
    import threading
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler.stack import DenseStack
    from nomad_tpu_torch.structs.job import Spread
    cm = h.store.matrix
    job = mock.job()
    job.task_groups[0].count = 20
    job.task_groups[0].spreads = [Spread("${attr.rack}", 100, ())]
    stack = DenseStack(cm, h.store.scheduler_config, device="cuda")
    groups = [stack.compile_group(job, tg) for tg in job.task_groups]

    def inputs():
        return stack.build_host_inputs(job, groups, [0] * 20, {},
                                       used_override=eng.basis_for(cm))

    def key(res):
        return tuple(int(x) for x in res.node)

    # serial replay first: tickets stay open so each sees the ones before
    serial, tickets = [], []
    for _ in range(8):
        res, ticket = eng.place(cm, inputs(), [], stack.spread_algorithm)
        serial.append(key(res))
        tickets.append(ticket)
    eng.complete_many(tickets)
    _reset_counts()
    before = dict(eng.stats)
    barrier = threading.Barrier(8)
    results, errors, tickets = [None] * 8, [], []
    inps = [inputs() for _ in range(8)]

    def call(i):
        try:
            barrier.wait()
            res, ticket = eng.place(cm, inps[i], [], stack.spread_algorithm)
            results[i] = key(res)
            tickets.append(ticket)
        except Exception as e:                  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    eng.complete_many(tickets)
    if errors or any(r is None for r in results):
        raise AssertionError(f"concurrent step failed: {errors}")
    launches = _counts()["place_batch"]
    chained = eng.stats["batched_evals"] - before["batched_evals"]
    if chained < 2:
        raise AssertionError("no K3 chain with E > 1 formed")
    if sorted(results) != sorted(serial):
        raise AssertionError("concurrent results differ from the serial "
                             "replay")
    log(f"engine: 8 concurrent callers: {launches} K3 launches, "
        f"{chained} evals chained (largest batch "
        f"{eng.stats['max_batch_seen']}); results equal the serial replay")


def overlap_step(h):
    """The overlap pipeline on the card.  8 threads each submit one C2M
    eval's ten groups at once to a fresh engine whose byte budget
    (NOMAD_TPU_BULK_BYTES) caps a bulk part at 8 groups, so every batch
    splits into parts and each later part is issued while the one before
    it is still in flight (overlap_chained): its world update scatters
    into the adopted basis that the in-flight kernel writes, ordered only
    by the engine's stream.  Each thread also adds usage on a row no
    group may use, before and after its eval, so those updates carry
    rows.  The groups' placements must equal a serial replay's
    (identical groups: the k-th group issued gets the k-th serial
    result), and the device basis its host snapshot, bit for bit."""
    import threading
    from nomad_tpu_torch.parallel.engine import get_engine, stop_engines
    cm = h.store.matrix
    n_threads, groups = 8, 10
    os.environ["NOMAD_TPU_BULK_BYTES"] = str(8 * 4 * cm.n_rows * 4)
    try:
        eng = get_engine("cuda")
    finally:
        os.environ.pop("NOMAD_TPU_BULK_BYTES", None)
    try:
        if not eng.overlap or eng._bulk_chunk(cm.n_rows) != 8:
            raise AssertionError("overlap step: engine not set up to chain")
        side = np.arange(2 * n_threads)
        feas = cm.ready.copy()
        feas[side] = False
        spec = dict(feasible=feas, affinity=np.zeros(cm.n_rows, np.float32),
                    has_affinity=False, desired=10,
                    penalty=np.zeros(cm.n_rows, bool),
                    coll0=np.zeros(cm.n_rows, np.int32),
                    demand=np.array([30, 60, 0, 0], np.float32), count=10)
        side_dem = np.array([10, 20, 0, 0], np.float32)

        def key(res):
            rows = np.flatnonzero(res[0])
            return tuple(rows.tolist()), tuple(res[0][rows].tolist())

        # serial replay first: tickets stay open so each sees the ones
        # before it
        serial = [eng.place_bulk(cm, **spec)
                  for _ in range(n_threads * groups)]
        eng.complete_many([r[5] for r in serial])
        serial = [key(r) for r in serial]
        before, w0 = dict(eng.stats), eng.world_stats()
        barrier = threading.Barrier(n_threads)
        got, tickets, errors = [], [], []
        lock = threading.Lock()

        def side_ticket(row):
            return eng.register_external_sparse(cm, np.array([row]),
                                                np.array([1]), side_dem)

        def call(i):
            try:
                barrier.wait()
                t_a = side_ticket(side[2 * i])
                futs = eng.place_bulk_begin_many(cm, [spec] * groups)
                res = [f.result(timeout=120) for f in futs]
                t_b = side_ticket(side[2 * i + 1])
                with lock:
                    got.extend(key(r) for r in res)
                    tickets.extend([r[5] for r in res] + [t_a, t_b])
            except Exception as e:              # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(n_threads)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        if errors or len(got) != n_threads * groups:
            raise AssertionError(f"overlap step failed: {errors}")
        st = {k: eng.stats[k] - before[k] for k in
              ("dispatches", "bulk_parts", "overlap_chained",
               "donated_carries")}
        ws = {k: eng.world_stats()[k] - w0[k] for k in
              ("rows_scattered", "full_uploads")}
        if st["overlap_chained"] == 0:
            raise AssertionError(f"overlap step: no part chained behind an "
                                 f"in-flight dispatch ({st})")
        if st["donated_carries"] != st["bulk_parts"]:
            raise AssertionError(f"overlap step: {st}")
        if sorted(got) != sorted(serial):
            raise AssertionError("overlap step: placements differ from the "
                                 "serial replay")
        eng.complete_many(tickets)
        _check_world(eng, "engine, overlap")
        log(f"engine: overlap, {n_threads} threads x one C2M eval "
            f"({groups} groups) in {wall:.3f} s: engine {st}, world {ws}; "
            f"placements equal the serial replay, device basis equals the "
            f"host snapshot")
    finally:
        stop_engines()


def profile_engine(h, mock, eng, jobs):
    """Run `jobs` under torch.profiler (device time of the engine's
    kernels) with the engine's own host timers; prints one line.  The
    scheduler thread waits while the engine thread prepares, launches
    and resolves, so the split is the engine thread's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    names = ("place_batch_kernel", "place_bulk_batch_kernel",
             "set_rows_kernel", "add_rank1_kernel")
    before = dict(eng.stats)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for kind, job in jobs:
            _run(h, mock, kind, job)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = 0.0
    for ev in prof.key_averages():
        if any(n in ev.key for n in names):
            dev_us += (getattr(ev, "device_time_total", 0.0)
                       or getattr(ev, "cuda_time_total", 0.0))
    busy = (f"{dev_us / 1e6 / wall:.4f}" if dev_us > 0
            else "not measured (the profiler recorded no device time)")
    split = {k: eng.stats.get(k, 0.0) - before.get(k, 0.0)
             for k in ("stack_s", "put_basis_s", "put_heavy_s",
                       "put_kernel_s", "device_s", "resolve_s")}
    parts = ", ".join(f"{k} {v / wall:.4f}" for k, v in split.items())
    log(f"profile: engine, {len(jobs)} evals in {wall:.3f} s with the "
        f"profiler on; kernels' device time {dev_us / 1e3:.3f} ms, device "
        f"busy share {busy}; engine-thread share of the window: {parts}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import nomad_tpu_torch  # noqa: F401  (fails outside the repository)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    phase_build()
    entries = phase_kernels()
    # the engine-off path (K1, K2), then the default engine-on path (K3,
    # K4, K5); each reads its kernels' counts, set to 0 just before it
    os.environ["NOMAD_TPU_ENGINE"] = "0"
    try:
        slice_launches = phase_slice()
    finally:
        os.environ.pop("NOMAD_TPU_ENGINE", None)
    for name in ("place_bulk", "place_scan"):
        entries[name]["launches"] = slice_launches[name]
    for name, n in phase_engine().items():
        entries[name]["launches"] = n
    log(json.dumps({"kernels": list(entries.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
