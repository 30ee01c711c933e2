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
           outputs within the tests' tolerances; CUDA-event times of the
           kernel and of the plain version (median of 20 after warm-up)
  slice    the scheduler's eval-to-commit path through the entry points
           a user calls (Harness(device="cuda") -> GenericScheduler ->
           DenseStack -> kernels -> plan -> PlanApplier -> StateStore):
           first a small world on the card against the same world on the
           CPU (plain versions), then a 10,000-node world with 100
           C2M-shaped batch jobs (10 groups x count 10 x 30 MHz/60 MB,
           the bulk kernel), 5 rack-spread service jobs of count 50, 2
           distinct_hosts jobs of count 20 and one node-affinity job (the
           scan kernel).  Every alloc must be placed and committed, and
           both kernels' launch counters must move during that run.

Output: the card's name and power limit (nvidia-smi), per-phase lines, a
`{"kernels": [...]}` line, and as the last line
`{"ok": true, "device": {...}}`.  Any failing phase raises and exits
non-zero; without a CUDA card it exits non-zero before printing anything.
"""
from __future__ import annotations

import json
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
    """Kernel vs plain on the card; returns (max_abs_err, waves, kernel
    callable, plain callable)."""
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
    return err, kr[5], kern, plain


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


def bulk_bound_ms(a, waves: int) -> tuple:
    n = a["cap"].shape[0]
    # inputs read once (capacity, used0, feasible, affinity, penalty,
    # coll0, demand) + the packed output written once
    nbytes = n * (16 + 16 + 1 + 4 + 1 + 4) + 16 + n * 7 * 4
    # per wave: the m=1 and m=2 grid cells of every row plus at most
    # min(count, 64) run cells of each wave row; the final scoring pass
    cells = waves * n * 2 + n * min(a["count"], 64) + n
    ops = cells * OPS_PER_CELL
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
    err_m, waves, kern, plain = check_bulk(a_main, "C2M group", True)
    err_h, _, _, _ = check_bulk(bulk_inputs(2, main_path=False),
                                "heterogeneous", True)
    a_over = bulk_inputs(3, main_path=False)
    a_over["demand"] = np.array([1500, 3000, 0, 0], np.float32)
    a_over["count"] = 4 * N_NODES
    err_o, _, _, _ = check_bulk(a_over, "beyond capacity", False)
    err_f, _, _, _ = check_bulk(fractional(bulk_inputs(6, main_path=False)),
                                "fractional", True)
    ms = time_cuda(kern)
    plain_ms = time_cuda(plain)
    bound, by = bulk_bound_ms(a_main, waves)
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


def phase_slice_small():
    """A 256-node world through Harness(device="cuda") and
    Harness(device="cpu"): identical per-job row/count maps."""
    from nomad_tpu_torch import mock
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
    if maps["cuda"] != maps["cpu"]:
        raise AssertionError("small world: card and CPU placements differ")
    n = sum(c for m in maps["cuda"] for tg in m.values() for c in tg.values())
    log(f"slice: 256-node world, {len(maps["cuda"])} jobs, {n} allocs: "
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
    "stack.py:build_inputs": "dense compile",
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
    for name, n in phase_slice().items():
        entries[name]["launches"] = n
    log(json.dumps({"kernels": list(entries.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
