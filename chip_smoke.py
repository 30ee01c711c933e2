#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nomad_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, all run in this order:
  build    compile every CUDA kernel from nomad_tpu_torch/csrc (one nvcc
           per source, all started together), print nvcc's register
           and spill report (K6's as one line, failing on a stack frame)
           and K1/K4's cluster size; build the native host library
           (csrc/nomad_native.cpp) with g++
  native   the host library on this machine's CPU: every entry point
           bit-equal to its plain numpy spec at the bench's shape
           (10,000 node rows, C2M's 10 groups x count 10, a plan of 64
           groups; score_fit within the stated tolerance), then each
           one's host time a call beside the spec's, in turns
  kernels  each kernel against its plain PyTorch version on the card, at
           the shapes the main path gives it (N = 16,384 node rows, the
           bucket of a 10,000-node cluster): integer outputs equal, float
           outputs within the tests' tolerances (K2) or bit-equal
           (K1, K3, K4, K5, K6), K4 also at the bench spine's longest chain
           (512 groups), K5 also as two segments of one launch at every
           bucket; CUDA-event times of the kernel, of the plain version
           and, for K5, of the one PyTorch call that computes the same
           function, one launch between an event pair and (K5) a burst
           of 50; the stall reading (DeviceWorld.update with dirty rows in
           both matrices behind a kernel of 70 ms in flight, on the host
           clock, beside blocking uploads of the same operands).  K1
           and K4 (one thread-block cluster each) bit-equal to their
           plain versions on each path of their selection (the rows at
           the top score, the radix select in one round and in several,
           with ties at its threshold, count 0; the path of each K1
           case's first wave is logged from the selection's model), with
           -0.0 usages and deltas that cancel, sparse and dense, with the
           exact carry, at 10,000, 16,384, 32,768 and 131,072 rows, each
           case also under random delays at every exchange phase (six
           seeds); K2 and K3 (one cluster each, rows' scores cached
           between slots) on the edge cases of their cached step
           (ops/place.py scan_model_cases, fitting rows scoring NaN
           and -inf and +NaN and -NaN affinities among them), K3
           bit-equal and K2 within the tolerances (NaN against NaN),
           each case again under three seeds of the
           delays, as are K3's main shape and E = 8 chain, and K3 at
           131,072 rows and past the rows its cluster caches in shared
           memory; then at 32,768 and 131,072 rows (20,000- and
           100,000-node clusters, K4 also on a fresh cluster where
           every ready row is in the wave), K6 on every shape of
           PREEMPT_SHAPES (A = 4 to 64, R = 3, +inf and NaN distances;
           its time there both as the wrapper call and as the kernel
           alone, from the profiler), and the stage probe's units
           K8a-K8f at the bench's shape (N = 10,000, M = 16, R = 4),
           each against its plain version, K8f also against the
           K8a->K8e kernel chain; then bit for bit at 20,000 and
           131,072 rows and M = 64 and on the probe's edge rows (a best
           row scoring -inf, NaN scores, no row fitting, ties, two
           rows, a count above every run), K8d/K8e/K8f also under
           three seeds of the delays at their cluster exchanges (K8a
           rerun under them too; K8a and K8b have no delay site);
           each K8 wrapper's host time with and without `_on_card`
           (the launch with the operands' card current), in turns; and
           K8c bit for bit on its own cases (tests/_stage_cases.py
           score_inputs: M = 1, 3, 7, 16 and 64, affinities of -0.0,
           NaN and +-inf, NaN penalties, desired counts of 0, 0.5 and
           NaN, collisions past 2^24) and K8f and K1 on the wave grid's
           score cases (wave_score_inputs).
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
  spine    the dev-mode Server (core/server.py: broker, wave feeder,
           workers, plan queue, pipelined applier) on the card: bench.py
           bench_e2e_spine's shape (1,000 nodes, 50 batch jobs of count
           100, 8 workers; all 5,000 allocs committed) and its snapshot
           (Server.save_snapshot), restored into a fresh server
           (Server.restore_snapshot) that saves to the same bytes and
           places 10 C2M jobs more (every alloc committed, usage equal
           to the allocs' sum, the device basis equal to the host
           snapshot), then
           bench_preemption_heavy's at full size (10,000 nodes filled to
           ~95% by 90,000 priority 20/30/40 batch allocs, then 10
           priority-90 service jobs of count 50 that land only by
           preempting; 16 workers): all 500 committed, every victim
           evicted and at least 10 priority below its preemptor, a
           preemption eval for each victim's job, K6 launched in that
           window, and the window's find split (FindSplit: each find's
           uploads, K6 launch and reads on the host clock); in both,
           every eval a worker failed failed at the
           scheduler's attempt limit and at nothing else (a kernel's
           launch error would count there); after each (idle, or
           stopped), committed usage equals the live allocs' sum within
           capacity and the engine's device basis equals its host
           snapshot.
  lifecycle  the dev-mode Server's control loops on the card at fleet
           size (NOMAD_TPU_FLEET_AGENTS, 10,000 nodes; 16 workers; the
           default 10 s heartbeat TTL): a FleetDriver thread keeps the
           nodes alive through Server.node_heartbeats (chunks of 1,000
           every 0.5 s; its largest gap between passes logged) under
           100 C2M batch jobs (K4) and 20 rack-spread service jobs of
           count 50 (K3), one with a canary, auto-promote, auto-revert
           update strategy; then expiry (100 nodes stop heartbeating:
           all down through fewer than 100 NODE_HEARTBEAT_BATCH entries,
           every lost alloc replaced), drain (100 other nodes, 30 s
           deadline: each empty, ineligible, strategy cleared), a
           rolling deploy (health reported through ALLOC_CLIENT_UPDATE:
           SUCCESSFUL, v1 stable), scale (50 -> 80 -> 40, agreeing with
           job_scale_status), periodic (two children through
           dispatch_due, placed), force-gc (the down nodes, terminal
           evals and jobs collected), one event subscription seeing
           every step with none dropped; each step's seconds logged.  It
           fails if a node the driver kept alive went down, usage is not
           the live allocs' sum within capacity, an alloc landed on a
           node down or ineligible when it was placed, the device basis
           differs from the host snapshot, K3, K4 or K5 did not launch in
           it, an eval failed but at the attempt limit, a loop logged an
           ERROR, or a loop thread outlived stop().
  bench    the port's bench entry point (nomad_tpu_torch/bench.py) on
           the card: bench_c2m_1m at 10,000 nodes with 1,000 jobs
           (100,000 allocs, 48 workers), whose stage probe launches
           K8a-K8f, in turns against the parent tree's numpy native
           functions where a tree is unpacked under smoke_archive/parent
           (parent, new, new, parent: resolve_s, put_s, the window,
           allocs/s, and the count and host time of scatter_add_rank1
           in the engine's resolve and elsewhere, and of expand_pairs);
           bench_scan_spread at full size (10,000 nodes, 60
           spread service jobs of count 100, K3, each launch's chain
           length E logged); and
           bench_kernel_100k_nodes (K4 over 131,072 rows).  Every alloc
           committed, device_stages present, the steady-state and fused
           checks clean, the device basis equal to its host snapshot.
  sharded  the sharded serving path (K7a-K7g, csrc/sharded.cu, and K5',
           the world scatters with a row offset) on meshes of the card
           repeated (cuda:0 eight times, (8, 1) and (4, 2)): every
           launch of each K7 kernel in scan chains and a batch of
           independent evals (N = 16,384) and in laned bulk chains
           (N = 16,384 and 131,072) checked bit for bit against its plain
           version, each function bit-equal to its plain form and equal
           to the unsharded K2/K3/K4 in rows, counts and waves; K7a's
           cache cases with every K7a/K7b call checked, also under the
           delays of K7a's cluster exchange (K7b's inputs follow it);
           K7b's merge cases (tests/_sharded_cases.py scan_apply_cases:
           hand-set records on 1, 2, 4 and 8 shards, ties, +0.0/-0.0,
           -inf tails, NaN, K = 1 and 64) and K7g at 32,768 rows a shard
           with W = 1, 2 and 4 lanes (out a fresh tensor and the donated
           basis), each bit-equal to its plain version; the staged path
           on meshes over several cards where there are several
           (check_fold_cards); K7e's
           selection cases (tests/_sharded_cases.py, at N =
           16,384, and count-512 evals at 131,072), every K7c-K7g call
           checked (K7g's with the counts it writes), each case again
           under six seeds of the delays of K7c's cluster exchange,
           and K7e alone on waves that tie +0.0
           and -0.0; K7c's time a launch by kind (a begin with a wave, a
           count-0 begin and tail, a wave), and every K7 time a launch;
           K5' on
           every shard, every shard of a mesh in one launch, and the
           stall reading on a mesh world; then the engine phase's
           10,000-node stream on a (4, 2)
           engine (the main path: K7's counts are read there; K7f has
           none of its own, node shard 0's K7g launch writing its
           counts) with
           per-job row maps equal to the single-device engine's, a
           donation-off run (K5' add_rank1_local), bench_e2e_spine's
           shape on (8, 1) with one worker against the single-device
           server, and C2M jobs through the spine with 48 workers on
           (4, 2) (LOAD_JOBS of C2M-1M's 10,000, for the time limit);
           each run with every alloc committed and the sharded device
           basis bit-equal to its host snapshot.

The engine and sharded streams also print K5's launches per dirty
update (launches over the world's staged operand buffers, one a card an
update touches) and fail past one.

Output: the card's name and power limit (nvidia-smi), per-phase lines, a
`{"kernels": [...]}` line, and as the last line
`{"ok": true, "device": {...}}`.  Any failing phase raises and exits
non-zero; without a CUDA card it exits non-zero before printing anything.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import statistics
import subprocess
import sys
import threading
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


def time_burst(fn, n: int = 50, reps: int = 5, warmup: int = 3) -> float:
    """Median over `reps` of one CUDA-event pair around n calls of fn(),
    divided by n, in ms: the launch rate once the host runs ahead."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / n)
    return statistics.median(times)


def kernel_device_ms(fn, name: str, n: int = 20) -> float:
    """Mean device time in ms of the CUDA kernels whose name holds
    `name`, over n calls of fn() under torch.profiler (CUDA activity):
    the kernel alone, without the host work between a CUDA-event pair
    around its wrapper.  NaN when the profiler records no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for ev in prof.key_averages():
        if name in ev.key:
            total += (getattr(ev, "device_time_total", 0.0)
                      or getattr(ev, "cuda_time_total", 0.0))
            count += ev.count
    return total / count / 1e3 if count else float("nan")


def host_us(fn, n: int = 2000, reps: int = 5) -> float:
    """Median over `reps` of the host time of n calls of fn() (queued
    work drained between reps), in microseconds a call."""
    import torch
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


# --------------------------------------------------------------- inputs

def bulk_inputs(seed: int, main_path: bool, n_rows: int = N_ROWS,
                n_nodes: int = N_NODES):
    """Seeded K1 inputs over n_rows rows; rows past n_nodes are padding
    (infeasible, zero capacity).  main_path: the C2M group on a partly
    loaded uniform cluster; otherwise heterogeneous nodes with
    affinities, penalties, co-placements and count 200."""
    rng = np.random.default_rng(seed)
    n = n_nodes
    cap = np.zeros((n_rows, 4), np.float32)
    used = np.zeros((n_rows, 4), np.float32)
    feas = np.zeros(n_rows, bool)
    aff = np.zeros(n_rows, np.float32)
    pen = np.zeros(n_rows, bool)
    coll = np.zeros(n_rows, np.int32)
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


def scan_inputs(seed: int, main_path: bool, n_rows: int = N_ROWS,
                n_nodes: int = N_NODES, values: int = RACKS):
    """Seeded K2 inputs (PlaceInputs fields) over n_rows rows.  main_path:
    one group of a 50-slot service job (S = 64, the slot bucket) spread
    over `values` values (the racks) on a partly loaded cluster;
    otherwise three groups with targeted and even spreads, affinities,
    penalties, co-placements and per-node instance budgets."""
    rng = np.random.default_rng(seed)
    n = n_nodes
    g, s, k, v = (1, 64, 1, values) if main_path else (3, 64, 2, 16)
    cap = np.zeros((n_rows, 4), np.float32)
    cap[:n] = [4000, 8192, 102400, 1000]
    if not main_path:
        cap[:n, 0] = rng.choice([2000, 4000, 8000], n)
        cap[:n, 1] = rng.choice([4096, 8192, 16384], n)
    used = np.zeros((n_rows, 4), np.float32)
    used[:n, 0] = rng.integers(0, 8, n) * 100
    used[:n, 1] = rng.integers(0, 8, n) * 256
    feas = np.zeros((g, n_rows), bool)
    feas[:, :n] = rng.random((g, n)) < (1.0 if main_path else 0.9)
    vidx = np.full((g, k, n_rows), v, np.int32)
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
        affinity=np.zeros((g, n_rows), np.float32),
        has_affinity=np.zeros(g, bool),
        desired_count=np.full(g, 50, np.int32),
        penalty=np.zeros((g, n_rows), bool),
        tg_count=np.zeros((g, n_rows), np.int32),
        spread_vidx=vidx, spread_desired=desired, spread_targeted=targeted,
        spread_wfrac=wfrac, spread_counts=counts, spread_active=active,
        place_cap=np.full((g, n_rows), -1, np.int32),
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
        if name == "preempt":
            preempt_ptxas(text)
            continue
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    from nomad_tpu_torch import native
    t0 = time.time()
    native._native()
    log(f"build: the native host library (csrc/nomad_native.cpp) in "
        f"{time.time() - t0:.1f} s (g++ {' '.join(_build.GXX_FLAGS)})")
    log(f"build: K1/K4 launch one cluster of "
        f"{_build.load('place_bulk').place_bulk_cluster_size()} blocks, "
        f"K2/K3 one of "
        f"{_build.load('place_scan').place_scan_cluster_size()}, "
        f"x 1024 threads; K7c one of "
        f"{_build.load('sharded').bulk_stats_cluster_size()} blocks, K8d/K8f "
        f"one of {_build.load('stage_probe').stage_probe_cluster_size()}")


# ------------------------------------------------------ the host library

NATIVE_PLAN_GROUPS = 64   # node groups of one plan the applier validates
# score_fit's library against its plain spec: glibc's powf against
# numpy's float32 power (tests/test_torch_native.py states the bound)
NATIVE_SCORE_ATOL = 4.3e-7


def native_inputs(seed: int = 11) -> dict:
    """The host library's inputs at the bench's shape: 10,000 node rows
    (a ClusterMatrix's dims and port words, some ports taken), C2M's 10
    groups x count 10 as one eval resolves them (each group's rows and
    counts, its triples to expand), and a plan of NATIVE_PLAN_GROUPS
    node groups with ports and freed resources."""
    from nomad_tpu_torch.encode.matrixizer import NUM_RESOURCE_DIMS, \
        _PORT_WORDS
    rng = np.random.default_rng(seed)
    cap = rng.integers(2000, 8000, (N_NODES, NUM_RESOURCE_DIMS)) \
        .astype(np.float32)
    used = (cap * rng.uniform(0, 0.9, cap.shape)).astype(np.float32)
    pw = np.zeros((N_NODES, _PORT_WORDS), np.uint32)
    taken = rng.integers(20000, 32000, (N_NODES, 4))
    for row in range(N_NODES):
        for p in taken[row]:
            pw[row, p >> 5] |= np.uint32(1 << (p & 31))
    demand = np.array([30, 60, 0, 0], np.float32)
    groups = []
    for _ in range(10):
        rows = np.sort(rng.choice(N_NODES, 10, replace=False)) \
            .astype(np.int32)
        counts = rng.multinomial(10, [0.1] * 10).astype(np.int32)
        groups.append((rows, counts, rng.uniform(0, 18, 10)
                       .astype(np.float32)))
    g = NATIVE_PLAN_GROUPS
    plan_rows = rng.choice(N_NODES, g, replace=False).astype(np.int32)
    plan_rows[::16] = -1
    plan_demand = (rng.integers(1, 11, (g, 1)) * demand).astype(np.float32)
    freed = np.zeros((g, NUM_RESOURCE_DIMS), np.float32)
    freed[::3] = demand
    ports = [[int(taken[r, 0])] if k % 5 == 0 and r >= 0 else
             [int(40000 + k)] for k, r in enumerate(plan_rows)]
    freed_ports = [[int(taken[r, 0])] if k % 10 == 0 and r >= 0 else []
                   for k, r in enumerate(plan_rows)]
    return dict(cap=cap, used=used, pw=pw, demand=demand, groups=groups,
                plan=(cap, used, pw, plan_rows, plan_demand, freed, ports,
                      freed_ports),
                row=int(plan_rows[1]), ports=[int(taken[plan_rows[1], 0]),
                                              45000, 45001],
                freed=[int(taken[plan_rows[1], 0])])


def cpu_us(fn, n: int = 2000, reps: int = 5) -> float:
    """Median over `reps` of the host time of n calls of fn(), in
    microseconds a call (no device work)."""
    for _ in range(50):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(times)


def phase_native() -> None:
    """The native host library (nomad_tpu_torch/native.py over
    csrc/nomad_native.cpp, built with g++ in phase_build) on this
    machine's CPU: every entry point bit-equal to its plain numpy spec
    at the bench's shape (native_inputs; score_fit within
    NATIVE_SCORE_ATOL), then each one's host time a call beside the
    plain spec's, in turns (library, plain, plain, library)."""
    from nomad_tpu_torch import native
    x = native_inputs()
    cap, used, demand, pw = x["cap"], x["used"], x["demand"], x["pw"]
    rows0, counts0, scores0 = x["groups"][0]

    def both(name, *args):
        return (getattr(native, name)(*args),
                getattr(native, f"{name}_plain")(*args))

    got, want = both("allocs_fit", cap, used, demand)
    _bitwise("native allocs_fit", got, want)
    err = 0.0
    for spread in (False, True):
        got, want = both("score_fit", cap, used, demand, spread)
        _bitwise("native score_fit NaN cells", np.isnan(got), np.isnan(want))
        err = max(err, float(np.nanmax(np.abs(got - want))))
    if err > NATIVE_SCORE_ATOL:
        raise AssertionError(f"native score_fit: {err} past "
                             f"{NATIVE_SCORE_ATOL}")
    got, want = both("ports_check", pw, x["row"], x["ports"], x["freed"])
    if got != want:
        raise AssertionError(f"native ports_check: {got} against {want}")
    a, b = pw.copy(), pw.copy()
    native.ports_set(a, x["row"], x["ports"], True)
    native.ports_set_plain(b, x["row"], x["ports"], True)
    _bitwise("native ports_set", a, b)
    a, b = used.copy(), used.copy()
    for rows, counts, _ in x["groups"]:
        native.scatter_add_rank1(a, rows, counts, demand)
        native.scatter_add_rank1_plain(b, rows, counts, demand)
    _bitwise("native scatter_add_rank1 (10 groups)", a, b)
    deltas = np.outer(np.arange(1, 11, dtype=np.float32), demand)
    a, b = used.copy(), used.copy()
    native.scatter_add(a, rows0, deltas)
    native.scatter_add_plain(b, rows0, deltas)
    _bitwise("native scatter_add", a, b)
    got, want = both("validate_plan", *x["plan"])
    _bitwise("native validate_plan", got, want)
    for rows, counts, scores in x["groups"]:
        for g, w in zip(*both("expand_pairs", rows, counts, scores)):
            _bitwise("native expand_pairs", g, w)
    rnd = np.random.default_rng(5).integers(0, 256, 1600, dtype=np.uint8) \
        .tobytes()
    urandom = os.urandom
    os.urandom = lambda k: rnd[:k]
    try:
        got, want = both("format_uuids", 100)
    finally:
        os.urandom = urandom
    if got != want:
        raise AssertionError("native format_uuids differs from its spec")
    log(f"native: every entry point bit-equal to its plain spec at "
        f"{N_NODES} rows, 10 groups x count 10 and a plan of "
        f"{NATIVE_PLAN_GROUPS} groups (score_fit within "
        f"{NATIVE_SCORE_ATOL}: max {err:.3g})")

    u = used.copy()
    calls = {
        "allocs_fit": (lambda f: f(cap, used, demand), 200),
        "score_fit": (lambda f: f(cap, used, demand), 200),
        "ports_check": (lambda f: f(pw, x["row"], x["ports"], x["freed"]),
                        2000),
        "ports_set": (lambda f: f(pw, x["row"], [45002], True), 2000),
        "scatter_add": (lambda f: f(u, rows0, deltas), 2000),
        "scatter_add_rank1": (lambda f: f(u, rows0, counts0, demand), 2000),
        "validate_plan": (lambda f: f(*x["plan"]), 500),
        "expand_pairs": (lambda f: f(rows0, counts0, scores0), 2000),
        "format_uuids": (lambda f: f(100), 500),
    }
    for name, (call, n) in calls.items():
        lib, plain = getattr(native, name), getattr(native, f"{name}_plain")
        t = {"library": [], "plain": []}
        for turn in ("library", "plain", "plain", "library"):
            f = lib if turn == "library" else plain
            t[turn].append(cpu_us(lambda: call(f), n=n))
        fmt = lambda v: "/".join(f"{v_:.2f}" for v_ in v)  # noqa: E731
        log(f"native: {name} host us a call (library, plain, plain, "
            f"library): library {fmt(t['library'])}, plain "
            f"{fmt(t['plain'])}; plain/library "
            f"{statistics.mean(t['plain']) / statistics.mean(t['library']):.2f}")


def preempt_ptxas(text):
    """K6's ptxas report, one line for its 48 instantiations (R = 1..8
    times 1..32 slots a lane): registers and stack frame of each, which
    must be 0 bytes (the node's state in registers)."""
    import re
    frames, regs = {}, {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name:
            frames[name] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
    kernels = {k: v for k, v in frames.items() if "preempt_kernel" in k}
    if not kernels:
        log("  preempt: no ptxas report (the library was built before)")
        return
    shape = lambda k: "R={}, SL={}".format(        # noqa: E731
        *re.search(r"ILi(\d+)ELi(\d+)E", k).groups())
    path = [regs.get(k) for k in kernels if shape(k) == "R=4, SL=1"]
    log(f"  preempt: {len(kernels)} kernels, stack frame "
        f"{min(kernels.values())}-{max(kernels.values())} bytes, registers "
        f"{min(regs[k] for k in kernels)}-{max(regs[k] for k in kernels)} "
        f"(R=4, SL=1, the path's: {path[0] if path else 'n/a'})")
    big = {shape(k): v for k, v in kernels.items() if v > 0}
    if big:
        raise AssertionError(f"preempt: stack frames {big} (the state must "
                             f"stay in registers)")


def _bulk_call(fn, a, dev):
    import torch
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    args = (t(a["cap"]), t(a["used"]), t(a["feas"]), t(a["aff"]),
            a["has_aff"], a["desired"], t(a["pen"]), t(a["coll"]),
            t(a["demand"]), a["count"])
    kw = dict(spread_algorithm=a.get("spread", False),
              max_waves=a.get("max_waves", 65536))
    return lambda: fn(*args, **kw)


def _compare_floats(name, got, ref):
    """Infinities of one sign and NaN (of either sign) where the plain
    version has them, finite values within RTOL/ATOL; returns the
    largest finite difference."""
    both_inf = np.isinf(got) & np.isinf(ref) & (np.sign(got) == np.sign(ref))
    fin = ~both_inf
    if not np.array_equal(np.isfinite(got), np.isfinite(ref)):
        raise AssertionError(f"{name}: finite masks differ")
    both = np.isfinite(got)
    err = float(np.max(np.abs(got[both] - ref[both]))) if both.any() else 0.0
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL, atol=ATOL,
                               err_msg=name)
    return err


# seeds of the cluster kernels' delays at every exchange phase
# (cluster.cuh `jitter`) under which the K1/K4 selection cases and the
# K2/K3 cases run again
JITTER_SEEDS = range(1, 7)
SCAN_JITTER_SEEDS = range(1, 4)


def jittered(label, fn, want, kernel="place_bulk", seeds=JITTER_SEEDS):
    """fn() (a call of `kernel`'s library: K1/K4, or K2/K3 with
    "place_scan") again under each of `seeds`, every output bit-equal to
    `want` (numpy arrays): a missing barrier in the cluster's exchanges
    shows here."""
    import torch
    from nomad_tpu_torch.ops import _build
    set_jitter = getattr(_build.load(kernel), f"{kernel}_set_jitter")
    stream = torch.cuda.current_stream().cuda_stream
    try:
        for seed in seeds:
            if set_jitter(seed, stream) != 0:
                raise RuntimeError(f"{kernel}_set_jitter failed")
            got = fn()
            got = got if isinstance(got, (tuple, list)) else (got,)
            for i, (g, w) in enumerate(zip(got, want)):
                _bitwise(f"{label} under delays (seed {seed}) output {i}",
                         g.cpu().numpy(), w)
    finally:
        set_jitter(0, stream)


def check_bulk(a, label, place_all, jitter=False, stall_ok=False):
    """Kernel vs plain on the card (and, with jitter, again under each of
    JITTER_SEEDS); returns (max_abs_err, waves, rows that took instances,
    kernel callable, plain callable).  A case with a count places some of
    it, unless stall_ok (a wave that the card's +NaN leaves empty)."""
    import torch
    from nomad_tpu_torch.ops import place as tp
    dev = torch.device("cuda")
    kern = _bulk_call(tp.place_bulk, a, dev)
    plain = _bulk_call(tp.place_bulk_plain, a, dev)
    k_out = kern()
    torch.cuda.synchronize()
    p_out = plain()
    torch.cuda.synchronize()
    _bitwise(f"place_bulk {label}", k_out.cpu().numpy(), p_out.cpu().numpy())
    if jitter:
        jittered(f"place_bulk {label}", kern, (p_out.cpu().numpy(),))
    kr = tp.unpack_bulk(k_out.cpu().numpy())
    pr = tp.unpack_bulk(p_out.cpu().numpy())
    np.testing.assert_array_equal(kr[0], pr[0], err_msg=f"{label} assign")
    if kr[1:4] + (kr[5],) != pr[1:4] + (pr[5],):
        raise AssertionError(f"{label}: (placed, n_eval, n_exh, waves) "
                             f"kernel {kr[1:4] + (kr[5],)} plain "
                             f"{pr[1:4] + (pr[5],)}")
    if (a["count"] > 0 and kr[1] == 0 and not stall_ok) or \
            (place_all and kr[1] != a["count"]):
        raise AssertionError(f"{label}: placed {kr[1]} of {a['count']}")
    err = max(_compare_floats(f"{label} used", kr[6], pr[6]),
              _compare_floats(f"{label} scores", kr[4], pr[4]))
    log(f"kernels: place_bulk {label}: placed {kr[1]}/{a['count']} in "
        f"{kr[5]} waves, bit-equal{' under every seed' if jitter else ''} "
        f"({first_wave_path(a)})")
    return err, kr[5], int(np.count_nonzero(kr[0])), kern, plain


def first_wave_path(a):
    """How the kernel selects the first wave's rows on K1 inputs `a`,
    from the test-only model of its algorithm (ops/place.py
    bulk_wave_select_model) on the plain version's grid."""
    import torch
    from nomad_tpu_torch.ops import place as tp
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()  # noqa
    ms, fits_m, score_m = tp.bulk_wave_grid(
        t(a["cap"]), t(a["used"]), t(a["demand"]), t(a["feas"]), t(a["aff"]),
        a["has_aff"], float(a["desired"]), t(a["pen"]), t(a["coll"]),
        a.get("spread", False), tp._FILL_GRID)
    _, _, info = tp.bulk_wave_select_model(ms, fits_m, score_m, a["count"])
    return f"first wave: path {info['path']}, {info['rounds']} round(s)"


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
    bound, by = bulk_bound_ms(a_main, waves, run_rows)
    ms = time_cuda(kern)
    plain_ms = time_cuda(plain)
    entries["place_bulk"] = dict(
        name="place_bulk", route="cuda",
        source="nomad_tpu_torch/csrc/place_bulk.cu",
        replaces="nomad_tpu/ops/place.py:626",
        jax_function="place_bulk_jit",
        launches=0, max_abs_err=max(err_m, err_h, err_o, err_f), ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None)
    log(f"kernels: place_bulk C2M group N={N_ROWS}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({by})")
    check_bulk_select()
    check_bulk_odd()

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

    entries["place_batch"], err_c = check_batch_scan()
    entries["place_scan"]["max_abs_err"] = max(
        entries["place_scan"]["max_abs_err"], err_c)
    entries["place_bulk_batch"] = check_batch_bulk()
    entries.update(check_world_scatter())
    entries["preempt"] = check_preempt()
    check_bulk_large()
    entries.update(check_stage_probe())
    return entries


def _bitwise(name, got, ref):
    """Bit-equal float arrays (equal NaN/inf positions included)."""
    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape or not np.array_equal(
            got.view(np.uint32), ref.view(np.uint32)):
        diff = np.abs(np.nan_to_num(got) - np.nan_to_num(ref))
        raise AssertionError(f"{name}: not bit-equal (max |diff| "
                             f"{float(diff.max()) if diff.size else 0})")


def _deltas(rng, k, n_nodes=N_NODES):
    """k usage deltas on distinct rows (a stop, a preplacement) plus one
    repeated row, integer sizes as real allocs have."""
    rows = rng.choice(n_nodes, k, replace=False)
    out = [(int(r), (rng.integers(-3, 4, 4) * np.array([100, 256, 0, 0]))
            .astype(np.float32)) for r in rows]
    out.append((out[0][0], np.array([100, 0, 0, 0], np.float32)))
    return out


def batch_scan_inputs(seed: int, E: int, S: int, with_deltas: bool,
                      n_rows: int = N_ROWS, n_nodes: int = N_NODES):
    """K3 inputs: an E-eval chain of rack-spread evals (scan_inputs' main
    path, 64 slots of which 50 active) with the slot axis padded to S,
    each with deltas or none, packed as the engine packs them.  Returns
    (capacity, used0, heavy, dyn, dims)."""
    from nomad_tpu_torch.ops import place as tp
    rng = np.random.default_rng(seed)
    evals = [scan_inputs(seed + e, True, n_rows, n_nodes) for e in range(E)]
    cap, used = evals[0]["capacity"], evals[0]["used"]
    inps = [tp.PlaceInputs(**f) for f in evals]
    heavy = np.stack([tp.pack_heavy(i) for i in inps])
    dyn = np.concatenate([
        tp.pack_light(i, _deltas(rng, 3) if with_deltas else [],
                      DELTA_BUCKET, S) for i in inps])
    g, n, k, vp1 = tp.heavy_dims(inps[0])
    return cap, used, heavy, dyn, (g, n, k, vp1, S, DELTA_BUCKET)


def _batch_scan_case(label, inputs, want_placed, jitter=False):
    """K3 kernel vs plain on the card, bit for bit (with jitter, again
    under each of SCAN_JITTER_SEEDS); returns (kernel callable, plain
    callable, slots placed)."""
    import torch
    from nomad_tpu_torch.ops import place as tp
    cap, used, heavy, dyn, dims = inputs
    t = lambda x: torch.from_numpy(np.array(x)).cuda()
    args = (t(cap), t(used), t(heavy), t(dyn), dims)
    kern = lambda: tp.place_batch_packed(*args)
    plain = lambda: tp.place_batch_packed_plain(*args)
    k_packed, k_used = kern()
    p_packed, p_used = plain()
    torch.cuda.synchronize()
    kp, pp = k_packed.cpu().numpy(), p_packed.cpu().numpy()
    pu = p_used.cpu().numpy()
    _bitwise(f"place_batch {label} packed", kp, pp)
    _bitwise(f"place_batch {label} used", k_used.cpu().numpy(), pu)
    if jitter:
        jittered(f"place_batch {label}", kern, (pp, pu), "place_scan",
                 SCAN_JITTER_SEEDS)
    placed = int((tp.unpack_outputs(kp)[0] >= 0).sum())
    if placed != want_placed:
        raise AssertionError(f"place_batch {label}: placed {placed} of "
                             f"{want_placed} slots")
    log(f"kernels: place_batch {label}, N={dims[1]} S={dims[4]}: placed "
        f"{placed} slots, bit-equal"
        f"{' under every seed' if jitter else ''}")
    return kern, plain, placed


def check_scan_cases():
    """K2 and K3 on the card on every edge case of the cached step
    (ops/place.py scan_model_cases, the CPU tests' cases), binpack and
    spread: K3 bit-equal to its plain version, K2 with equal integers
    and floats within RTOL/ATOL; each again under SCAN_JITTER_SEEDS, K3
    bit-equal to the plain version and K2 to its own undelayed output."""
    import torch
    from nomad_tpu_torch.convert import place_inputs_from_numpy
    from nomad_tpu_torch.ops import place as tp
    t = lambda x: torch.from_numpy(np.array(x)).cuda()
    err = 0.0
    cases = tp.scan_model_cases()
    for label, evals, deltas in cases:
        cap, used, heavy, dyn, dims = tp.scan_case_batch(evals, deltas)
        inp = place_inputs_from_numpy(evals[0], "cuda")
        for spread in (False, True):
            name = f"{label} ({'spread' if spread else 'binpack'})"
            args = (t(cap), t(used), t(heavy), t(dyn), dims)
            k3 = lambda: tp.place_batch_packed(*args, spread_algorithm=spread)
            want = [x.cpu().numpy() for x in tp.place_batch_packed_plain(
                *args, spread_algorithm=spread)]
            for i, x in enumerate(k3()):
                _bitwise(f"place_batch case {name} output {i}",
                         x.cpu().numpy(), want[i])
            jittered(f"place_batch case {name}", k3, want, "place_scan",
                     SCAN_JITTER_SEEDS)
            k2 = lambda: tp.place_eval_packed(inp, spread)
            got = [x.cpu().numpy() for x in k2()]
            ref = [x.cpu().numpy() for x in tp.place_eval_plain(inp, spread)]
            kr, pr = tp.unpack_outputs(got[0]), tp.unpack_outputs(ref[0])
            for i, nm in ((0, "node"), (3, "n_eval"), (4, "n_exh"),
                          (5, "top_nodes")):
                np.testing.assert_array_equal(kr[i], pr[i],
                                              err_msg=f"{name} {nm}")
            err = max(err, _compare_floats(f"{name} score", kr[1], pr[1]),
                      _compare_floats(f"{name} fit", kr[2], pr[2]),
                      _compare_floats(f"{name} top_scores", kr[6], pr[6]),
                      _compare_floats(f"{name} used", got[1], ref[1]))
            jittered(f"place_scan case {name}", k2, got, "place_scan",
                     SCAN_JITTER_SEEDS)
    log(f"kernels: K2/K3 edge cases: {2 * len(cases)} "
        f"(case, algorithm) pairs, K3 bit-equal, K2 integers equal and "
        f"max |err| {err:.3g}, each again under seeds "
        f"{list(SCAN_JITTER_SEEDS)} of the delays")
    return err


def check_batch_scan():
    """K3 kernel vs plain on the card, bit for bit: the main path's shape
    (one rack-spread eval alone with the engine's slot bucket, S = 128,
    no deltas) and an E = 8 chain with deltas at S = 64 (timed), both
    again under the delays; one eval at 131,072 rows (a 100,000-node
    world, timed) and one past the rows the cluster caches in shared
    memory (the cache in the global scratch); then the edge cases
    (check_scan_cases)."""
    from nomad_tpu_torch.parallel.engine import _s_bucket
    s_main = _s_bucket(64)
    m_kern, _, _ = _batch_scan_case(
        "E=1 rack-spread eval (main path)",
        batch_scan_inputs(21, 1, s_main, False), 50, jitter=True)
    inputs = batch_scan_inputs(11, 8, 64, True)
    kern, plain, placed = _batch_scan_case(
        "E=8 rack-spread chain with deltas", inputs, 400, jitter=True)
    n_big, nodes_big = LARGE_WORLDS[-1]
    b_kern, b_plain, _ = _batch_scan_case(
        "E=1 rack-spread eval",
        batch_scan_inputs(41, 1, s_main, False, n_big, nodes_big), 50)
    from nomad_tpu_torch.ops import _build
    from nomad_tpu_torch.ops import place as tp
    blocks = _build.load("place_scan").place_scan_cluster_size()
    _batch_scan_case(
        "E=1 rack-spread eval, the cache past shared memory",
        batch_scan_inputs(42, 1, s_main, False,
                          blocks * (tp.SCAN_SMEM_ROWS + 1), nodes_big), 50)
    ms = time_cuda(kern)
    plain_ms = time_cuda(plain, reps=3, warmup=1)
    m_ms = time_cuda(m_kern)
    b_ms = time_cuda(b_kern)
    b_plain_ms = time_cuda(b_plain, reps=3, warmup=1)
    heavy, dyn, dims = inputs[2:]
    E = heavy.shape[0]
    g, n, k, vp1, S, D = dims
    nbytes = (n * 16 * 3 + heavy.nbytes + dyn.nbytes + E * S * 15 * 4)
    ops = placed * n * (OPS_PER_SCAN_ROW + k * OPS_PER_SPREAD)
    bound, by = _bound(nbytes, ops)
    log(f"kernels: place_batch E=8: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.6f} ms ({by}); E=1 S={s_main} "
        f"(main path): kernel {m_ms:.4f} ms; E=1 S={s_main} N={n_big}: "
        f"kernel {b_ms:.4f} ms, plain {b_plain_ms:.4f} ms")
    err = check_scan_cases()
    return dict(name="place_batch", route="cuda",
                source="nomad_tpu_torch/csrc/place_scan.cu",
                replaces="nomad_tpu/ops/place.py:403",
                jax_function="place_batch_packed_jit",
                launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None), err


def batch_bulk_inputs(seed: int, E: int = 16, n_rows: int = N_ROWS,
                      n_nodes: int = N_NODES):
    """K4 inputs: an E-eval chain of C2M groups (count 10, 30 MHz/60 MB)
    on the partly loaded 10,000-node cluster, with random feasibility
    and co-placements, half of them with deltas, then one count-0 pad (a
    zero light block, as the reference engine pads a chain).  Returns
    (capacity, used0, heavy, dyn, D)."""
    from nomad_tpu_torch.ops import place as tp
    rng = np.random.default_rng(seed)
    a = bulk_inputs(seed, True, n_rows, n_nodes)
    heavy, lights = [], []
    for e in range(E):
        feas = a["feas"].copy()
        feas[:n_nodes] = rng.random(n_nodes) < 0.95
        coll = np.zeros(n_rows, np.int32)
        coll[rng.choice(n_nodes, 20, replace=False)] = 1
        heavy.append(tp.pack_bulk_heavy(feas, a["aff"], a["pen"], coll))
        deltas = _deltas(rng, 3, n_nodes) if e % 2 else []
        lights.append(tp.pack_bulk_light(False, 10, 10, a["demand"], deltas,
                                          n_rows, DELTA_BUCKET))
    heavy.append(heavy[0])
    lights.append(np.zeros_like(lights[0]))
    return (a["cap"], a["used"], np.stack(heavy), np.concatenate(lights),
            DELTA_BUCKET)


def c2m_eval_inputs(seed: int, n_rows: int = N_ROWS, n_nodes: int = N_NODES,
                    fresh: bool = False, E: int = 10, count: int = 10):
    """K4 at the main path's shape: one C2M eval's ten groups as the
    engine ships them (every ready row feasible, no co-placements yet,
    no deltas, so D = 0).  fresh: an empty cluster, on which every ready
    row ties, so each wave's set is the whole cluster (the largest sort);
    E and count give bench.py bench_kernel_100k_nodes' shape (8 evals of
    count 512).  Returns (capacity, used0, heavy, dyn, D)."""
    from nomad_tpu_torch.ops import place as tp
    a = bulk_inputs(seed, True, n_rows, n_nodes)
    if fresh:
        a["used"][:] = 0.0
    h = tp.pack_bulk_heavy(a["feas"], a["aff"], a["pen"], a["coll"])
    light = tp.pack_bulk_light(False, count, count, a["demand"], [], n_rows,
                               0)
    return (a["cap"], a["used"], np.stack([h] * E),
            np.concatenate([light] * E), 0)


def _batch_bulk_case(label, inputs, sparse, exact, fill_grid, spread=False,
                     host_check=True, jitter=False, max_waves=65536,
                     stall_ok=False):
    """K4 kernel vs plain on the card, bit for bit (and, with the exact
    carry and host_check, against the host rank-1 update; with jitter,
    again under each of JITTER_SEEDS); returns unpack_bulk_batch of the
    kernel's output.  Every eval places its count, unless stall_ok."""
    import torch
    from nomad_tpu_torch import native
    from nomad_tpu_torch.ops import place as tp
    cap, used, heavy, dyn, D = inputs
    t = lambda x: torch.from_numpy(np.array(x)).cuda()
    E, n = heavy.shape[0], cap.shape[0]
    calls = [lambda fn=fn: fn(
        t(cap), t(used), t(heavy), t(dyn), D, sparse_out=sparse,
        fill_grid=fill_grid, exact_out=exact, spread_algorithm=spread,
        max_waves=max_waves)
        for fn in (tp.place_bulk_batch, tp.place_bulk_batch_plain)]
    outs = [[x.cpu().numpy() for x in call()] for call in calls]
    torch.cuda.synchronize()
    for i, part in enumerate(("packed", "used", "exact")[:len(outs[0])]):
        _bitwise(f"place_bulk_batch {label} {part}", outs[0][i], outs[1][i])
    if jitter:
        jittered(f"place_bulk_batch {label}", calls[0], outs[1])
    res = tp.unpack_bulk_batch(outs[0][0], n, sparse=sparse)
    light = dyn.reshape(E, -1)
    want = np.rint(light[:, 2]).astype(np.int32)
    if not stall_ok and not np.array_equal(res[2], want):
        raise AssertionError(f"place_bulk_batch {label}: placed "
                             f"{res[2].tolist()} of {want.tolist()}")
    if exact and host_check:
        host = used.copy()
        for e in range(E):
            rows = np.flatnonzero(res[0][e])
            native.scatter_add_rank1(host, rows, res[0][e][rows],
                                     light[e, 3:7])
        _bitwise(f"place_bulk_batch {label} exact vs host rank-1",
                 outs[0][2], host)
    log(f"kernels: place_bulk_batch {label}, N={n}: placed "
        f"{int(res[2].sum())}, bit-equal"
        f"{' under every seed' if jitter else ''}")
    return res


# row counts of the selection cases: a 10,000-node cluster with no
# padding rows (not a multiple of the cluster's threads), and the buckets
# of a 10,000- and of a 100,000-node cluster
SELECT_WORLDS = ((10000, 10000), (N_ROWS, N_NODES), (32768, 20000),
                 (131072, 100000))


def select_k1_inputs(kind, seed, n_rows, n_nodes):
    """K1 inputs for one path of the kernels' selection: "ties" a strict
    wave (worst fit) whose threshold score is shared by many rows, count
    300; "rounds" a strict wave of nearly distinct scores whose first
    5,000 rows span several KMAX rounds (desired 1 on heterogeneous
    fractional nodes, no co-placements); "staircase" a strict wave whose
    count 20 spans twelve one-row score levels and part of a tied one
    (the radix select's threshold among ties); "toprounds" a fresh
    cluster, where every ready row ties at the top score, count 5,000
    (the first rows at the top in several KMAX rounds); "zero" count 0; "negzero" the C2M group with every 7th node's usage
    -0.0 (the plain version turns it into +0.0 on rows that take
    nothing)."""
    if kind == "rounds":
        a = fractional(bulk_inputs(seed, False, n_rows, n_nodes))
        a["desired"], a["count"] = 1, 5000
        a["coll"][:] = 0
        return a
    a = bulk_inputs(seed, True, n_rows, n_nodes)
    if kind == "ties":
        a["spread"], a["count"] = True, 300
    elif kind == "staircase":
        rows = np.arange(12) * 7 + 3
        a["used"][rows, 0] = 1200 + 10 * np.arange(12)
        a["used"][rows, 1] = a["used"][rows, 0] * 2
        a["count"] = a["desired"] = 20
    elif kind == "toprounds":
        a["used"][:] = 0.0
        a["coll"][:] = 0
        a["count"] = 5000
    elif kind == "zero":
        a["count"] = 0
    else:
        a["used"][:n_nodes:7] = -0.0
        a["used"][n_nodes:] = -0.0
    return a


def select_k4_inputs(seed, n_rows, n_nodes, counts, desired=None,
                     negzero=False, fractional_nodes=False):
    """A K4 chain for the selection cases: one eval per entry of
    `counts` (0 is a pad), each with random feasibility, 20
    co-placements unless desired is 1, and deltas on odd evals: three
    random ones, a pair that cancels (+v then -v on one row), one that
    takes a row's usage to exactly 0, and rows -1 and -n_rows (which the
    reference takes as n_rows - 1 and 0), -n_rows - 1 and n_rows (which
    it drops).  negzero: every 7th node's usage (and the padding rows')
    -0.0."""
    from nomad_tpu_torch.ops import place as tp
    rng = np.random.default_rng(seed)
    a = bulk_inputs(seed, not fractional_nodes, n_rows, n_nodes)
    if fractional_nodes:
        a = fractional(a)
    if negzero:
        a["used"][:n_nodes:7] = -0.0
        a["used"][n_nodes:] = -0.0
    heavy, lights = [], []
    for e, count in enumerate(counts):
        feas = a["feas"].copy()
        feas[:n_nodes] = rng.random(n_nodes) < 0.95
        coll = np.zeros(n_rows, np.int32)
        if desired != 1:
            coll[rng.choice(n_nodes, 20, replace=False)] = 1
        heavy.append(tp.pack_bulk_heavy(feas, a["aff"], a["pen"], coll))
        deltas = []
        if e % 2:
            deltas = _deltas(rng, 3, n_nodes)
            r, r0 = (int(x) for x in rng.choice(n_nodes, 2, replace=False))
            v = np.array([300, 512, 0, 0], np.float32)
            deltas += [(r, v), (r, -v), (r0, -a["used"][r0]),
                       (-1, v), (-n_rows, v), (-n_rows - 1, v), (n_rows, v)]
        d = count if desired is None else desired
        lights.append(tp.pack_bulk_light(False, max(d, 1), count,
                                          a["demand"], deltas, n_rows,
                                          DELTA_BUCKET))
    return (a["cap"], a["used"], np.stack(heavy), np.concatenate(lights),
            DELTA_BUCKET)


# the runaway guard of the NaN cases: on the card a fitting row's NaN
# score is +NaN, which lax.top_k's order ranks above every score, so a
# tie wave is empty and an eval runs to max_waves
NAN_WAVES = 40


def select_odd_inputs(kind, seed, n_rows, n_nodes, spread):
    """K1 inputs with fitting rows that score NaN or -inf (ops/place.py
    bulk_wave_allocs, ROADMAP queue C): "NaN at m = 1" three rows at +inf
    capacity and usage (NaN at every m); "NaN at m = 2" cpu demands of
    1e38 on capacities of the largest f32, three rows at +inf capacity
    and 2e38 usage (finite at m = 1, NaN at m = 2, and at m = 1 once they
    took an instance); either NaN at m = 2 makes s* NaN, so every wave is
    a tie wave.  "-inf": an affinity of -inf on every node, so every
    fitting row scores -inf, with nodes at full usage (which do not fit
    and score -inf too) before and among them: the tie set at -inf is
    the fitting rows.  Count 40, max_waves NAN_WAVES."""
    rng = np.random.default_rng(seed)
    a = bulk_inputs(seed, True, n_rows, n_nodes)
    rows = [0, n_nodes // 2, n_nodes - 1]
    if kind == "NaN at m = 1":
        a["cap"][rows, 0] = a["used"][rows, 0] = np.inf
    elif kind == "-inf":
        full = [0, 1, 3, n_nodes // 2]
        a["used"][full, :2] = a["cap"][full, :2]
        a["aff"][:] = -np.inf
        a["has_aff"] = True
    else:
        a["demand"][0] = 1e38
        a["cap"][:n_nodes, 0] = np.finfo(np.float32).max
        a["used"][:n_nodes, 0] = rng.choice(
            np.float32([0.0, 0.5e38, 1e38]), n_nodes)
        a["cap"][rows, 0], a["used"][rows, 0] = np.inf, 2e38
    a.update(spread=spread, count=40, desired=40, max_waves=NAN_WAVES)
    return a


def check_bulk_odd():
    """K1 and K4 bit-equal to their plain versions on fitting rows that
    score NaN or -inf (select_odd_inputs, binpack and spread, at 10,000
    and 16,384 rows), each also under every seed of JITTER_SEEDS: the
    wave's top-2 in lax.top_k's order (the card's +NaN first), s* NaN
    where a fitting m = 2 score is, and the tie set of the fitting rows
    at a top score of -inf."""
    from nomad_tpu_torch.ops import place as tp
    for n_rows, n_nodes in SELECT_WORLDS[:2]:
        for kind in ("NaN at m = 1", "NaN at m = 2", "-inf"):
            for spread in (False, True):
                a = select_odd_inputs(kind, 46, n_rows, n_nodes, spread)
                how = "spread" if spread else "binpack"
                check_bulk(a, f"{kind} {how} N={n_rows}", kind == "-inf",
                           jitter=True, stall_ok=kind != "-inf")
            a = select_odd_inputs(kind, 47, n_rows, n_nodes, False)
            heavy = np.stack([tp.pack_bulk_heavy(a["feas"], a["aff"],
                                                 a["pen"], a["coll"])] * 4)
            dyn = np.concatenate([
                tp.pack_bulk_light(a["has_aff"], max(c, 1), c, a["demand"],
                                   [], n_rows, DELTA_BUCKET)
                for c in (30, 0, 12, 25)])
            _batch_bulk_case(
                f"{kind}, E=4 counts 30/0/12/25, dense, exact carry",
                (a["cap"], a["used"], heavy, dyn, DELTA_BUCKET), False, True,
                16, host_check=False, jitter=True, max_waves=NAN_WAVES,
                stall_ok=kind != "-inf")


def check_bulk_select():
    """K1 and K4 bit-equal to their plain versions on each path of the
    kernels' selection (select_k1_inputs, select_k4_inputs), at 10,000,
    16,384, 32,768 and 131,072 rows; K4 sparse and dense, with deltas
    (some that cancel), the exact carry, count-0 pads and -0.0 usages.
    Each case also under every seed of JITTER_SEEDS."""
    from nomad_tpu_torch.ops import place as tp
    fg = tp.fill_grid_for(10)
    for n_rows, n_nodes in SELECT_WORLDS:
        for kind in ("ties", "rounds", "staircase", "toprounds", "zero",
                     "negzero"):
            check_bulk(select_k1_inputs(kind, 41, n_rows, n_nodes),
                       f"{kind} N={n_rows}", True, jitter=True)
        small = select_k4_inputs(42, n_rows, n_nodes, [10, 100, 0, 10, 7],
                                 negzero=True)
        for sparse in (True, False):
            for exact in (False, True):
                # the host rank-1 update touches only the assigned rows,
                # so it keeps the -0.0 usages the reference's add turns
                # into +0.0: only the plain version is held here
                _batch_bulk_case(
                    f"E=5 counts 10/100/0/10/7, deltas that cancel, -0.0 "
                    f"usages, {'sparse' if sparse else 'dense'}"
                    f"{', exact carry' if exact else ''}", small, sparse,
                    exact, tp.fill_grid_for(100), host_check=False,
                    jitter=True)
        _batch_bulk_case(
            "E=4 worst fit counts 300/10/0/300 (strict waves, threshold "
            "ties), dense, exact carry",
            select_k4_inputs(43, n_rows, n_nodes, [300, 10, 0, 300]),
            False, True, tp._FILL_GRID, spread=True, jitter=True)
        _batch_bulk_case(
            "E=3 desired 1 counts 5000/0/3000 on fractional nodes (several "
            "KMAX rounds), dense, exact carry",
            select_k4_inputs(44, n_rows, n_nodes, [5000, 0, 3000], desired=1,
                             fractional_nodes=True),
            False, True, tp._FILL_GRID, jitter=True)
        _batch_bulk_case(
            "E=17 C2M chain with deltas and a count-0 pad, sparse, exact "
            "carry", batch_bulk_inputs(45, 16, n_rows, n_nodes), True, True,
            fg, jitter=True)


# the longest chain the bench's spine gives one K4 launch: the engine's
# max_batch (C2M-100K averaged about 210 groups a launch, C2M-1M up to 410)
BENCH_CHAIN = 512


def check_batch_bulk():
    """K4 kernel vs plain on the card, bit for bit: an E = 16 chain with
    deltas and a count-0 pad, sparse and dense output, exact carry off
    and on (the sparse, no-carry form timed); the main path's shape,
    one C2M eval's ten groups with no deltas (D = 0), sparse, with the
    exact carry the donated dispatch adopts; and the bench spine's
    longest chain, BENCH_CHAIN groups with deltas, sparse, with the
    exact carry (timed)."""
    import torch
    from nomad_tpu_torch.ops import place as tp
    t = lambda x: torch.from_numpy(np.array(x)).cuda()   # noqa: E731
    fill_grid = tp.fill_grid_for(10)
    main = c2m_eval_inputs(14)
    m_res = _batch_bulk_case(
        "E=10 C2M eval, D=0, sparse, exact carry (main path)", main, True,
        True, fill_grid)
    bench_chain = batch_bulk_inputs(15, BENCH_CHAIN - 1)
    res = _batch_bulk_case(
        f"E={BENCH_CHAIN} C2M chain with deltas and a count-0 pad, sparse, "
        f"exact carry (the bench spine's longest K4 launch)",
        bench_chain, True, True, fill_grid)
    b_args = tuple(t(x) for x in bench_chain[:4]) + (bench_chain[4],)
    kw = dict(sparse_out=True, fill_grid=fill_grid, exact_out=True)
    bound, by = _k4_bound(bench_chain, res, fill_grid, True)
    b_ms = time_cuda(lambda: tp.place_bulk_batch(*b_args, **kw), reps=5)
    b_plain_ms = time_cuda(lambda: tp.place_bulk_batch_plain(*b_args, **kw),
                           reps=2, warmup=1)
    log(f"kernels: place_bulk_batch E={BENCH_CHAIN} bench chain: kernel "
        f"{b_ms:.4f} ms, plain {b_plain_ms:.4f} ms, bound {bound:.6f} ms "
        f"({by})")
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
    kw = dict(sparse_out=True, fill_grid=fill_grid)
    args = (t(cap), t(used), t(heavy), t(dyn), D)
    kern = lambda: tp.place_bulk_batch(*args, **kw)
    plain = lambda: tp.place_bulk_batch_plain(*args, **kw)
    m_args = tuple(t(x) for x in main[:4]) + (main[4],)
    m_kern = lambda: tp.place_bulk_batch(*m_args, **kw)
    m_bound, m_by = _k4_bound(main, m_res, fill_grid, True)
    m_ms = time_cuda(m_kern)
    plain_ms = time_cuda(plain, reps=5, warmup=1)
    assign, _, placed, _, _, waves = timed
    nbytes = (n * 16 * 3 + heavy.nbytes + dyn.nbytes
              + E * (3 * tp.SPARSE_CAP + 4) * 4)
    cells = sum(bulk_cells(n, int(waves[e]), int(np.count_nonzero(assign[e])),
                           fill_grid) for e in range(E) if placed[e] > 0)
    bound, by = _bound(nbytes, cells * OPS_PER_CELL)
    ms = time_cuda(kern)
    log(f"kernels: place_bulk_batch E={E} sparse: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({by}); E=10 D=0 "
        f"(main path, no exact carry): kernel {m_ms:.4f} ms, bound "
        f"{m_bound:.6f} ms ({m_by})")
    return dict(name="place_bulk_batch", route="cuda",
                source="nomad_tpu_torch/csrc/place_bulk.cu",
                replaces="nomad_tpu/ops/place.py:729",
                jax_function="_place_bulk_batch",
                launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)


def check_world_scatter():
    """K5 set_rows (64/512/4096-row buckets, pad rows dropped) and
    add_rank1 vs plain on the card, bit for bit, as one segment and as
    two segments of one launch (each bucket beside another, as an update
    scatters capacity and basis); times at the largest bucket, one
    launch between an event pair and a burst of 50, beside the one
    PyTorch call (index_copy_ / index_add_); then the stall reading."""
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
    cap = np.full((N_ROWS, 4), 8000.0, np.float32)
    pairs = []
    for i, b in enumerate(tw.ROW_BUCKETS):
        b2 = tw.ROW_BUCKETS[(i + 1) % len(tw.ROW_BUCKETS)]
        pairs.append((b, b2))
        rows2 = []
        for bb in (b, b2):
            r = np.full(bb, N_ROWS, np.int32)
            r[:bb * 3 // 4] = rng.choice(N_NODES, bb * 3 // 4, replace=False)
            rows2.append(r)
        vals2 = [(rng.random((bb, 4)) * 5000).astype(np.float32)
                 for bb in (b, b2)]
        counts2 = [rng.integers(-3, 40, bb).astype(np.int32)
                   for bb in (b, b2)]
        # the second set segment carries old host values (a chained
        # update's dirty rows)
        olds2 = (rng.random((b2, 4)) * 5000).astype(np.float32)
        for name in ("set_rows", "add_rank1"):
            outs = []
            for fn in (tw.scatter_segments, tw.scatter_segments_plain):
                ds = [t(cap), t(base)]
                ops = [(t(vals2[0]),), (t(vals2[1]), t(olds2))] \
                    if name == "set_rows" else \
                    [(t(counts2[j]), t(dem)) for j in range(2)]
                n0 = tw.launches[name]
                fn(name, [(ds[j], 0, t(rows2[j]), *ops[j])
                          for j in range(2)])
                if fn is tw.scatter_segments and \
                        tw.launches[name] != n0 + 1:
                    raise AssertionError(f"{name}: two segments took "
                                         f"{tw.launches[name] - n0} launches")
                outs.append(ds)
            torch.cuda.synchronize()
            for j in range(2):
                _bitwise(f"{name} two segments {(b, b2)}, segment {j}",
                         outs[0][j].cpu().numpy(), outs[1][j].cpu().numpy())
    log(f"kernels: set_rows (the second segment with old values) / "
        f"add_rank1 as two segments of one launch, buckets {pairs}: "
        f"bit-equal to plain")
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
        burst = time_burst(kern)
        lib_burst = time_burst(lib)
        h_us, lib_h_us = host_us(kern), host_us(lib)
        bound, by = _bound(nbytes, ops)
        log(f"kernels: {name} B={B}: kernel {ms:.4f} ms (burst of 50: "
            f"{burst:.4f} ms a launch), plain {plain_ms:.4f} ms, library "
            f"{lib_ms:.4f} ms (burst {lib_burst:.4f}), bound {bound:.6f} ms "
            f"({by}); host time a call: wrapper {h_us:.3f} us, library "
            f"{lib_h_us:.3f} us")
        entries[name] = dict(
            name=name, route="cuda",
            source="nomad_tpu_torch/csrc/world_scatter.cu",
            replaces=("nomad_tpu/parallel/world.py:86" if name == "set_rows"
                      else "nomad_tpu/parallel/world.py:88"),
            jax_function=f"_single_device_fns ({name})",
            launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=lib_ms,
            burst_ms=burst, library_burst_ms=lib_burst, host_us=h_us,
            library_host_us=lib_h_us)
    # what the wrapper's parts cost on the host, a call
    rec = tw._record("set_rows", (d, 0, r, v), False, d.get_device())
    parts = {
        "checks and record": lambda: tw._record("set_rows", (d, 0, r, v),
                                                False, d.get_device()),
        "ctypes call and launch": lambda: tw._entries[0](
            rec, 1, torch._C._cuda_getCurrentRawStream(0)),
        "stream as current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(d.device).cuda_stream,
        "stream as the raw handle":
            lambda: torch._C._cuda_getCurrentRawStream(0)}
    log("kernels: set_rows wrapper, host time a call: " + ", ".join(
        f"{k} {host_us(f):.3f} us" for k, f in parts.items()))
    entries["set_rows"].update(stall_reading("kernels"))
    return entries


# the most DeviceWorld.update may take (host time, median of 5) with a
# kernel in flight: its own work took 0.6-1.3 ms on the H100, so an
# update that waits for part of the ~70 ms in flight, or takes a new
# blocking step, goes over it
STALL_UPDATE_MS = 2.0


def stall_reading(label, mesh=None):
    """A kernel of at least 50 ms in flight (torch.cuda._sleep) on a
    stream of its own, as the engine's dispatch is on the engine's, then
    DeviceWorld.update with dirty rows in both matrices (40 capacity
    rows, 400 basis rows) timed on the host clock, beside the old way of
    shipping the same operands: a blocking .to(device) each.  Medians of
    5 after a warm-up, with the update's split into staging the
    operands, the launch and the rest (the host diff).  Fails if the
    update's median reaches STALL_UPDATE_MS (it waited for the kernel in
    flight, or for part of it), if it launched other than once on the
    card, or if it left the device pair unequal to the host snapshot."""
    import torch
    from nomad_tpu_torch.parallel import world as tw
    rng = np.random.default_rng(29)
    cap = np.full((N_ROWS, 4), 10000.0, np.float32)
    basis = np.zeros((N_ROWS, 4), np.float32)
    w = tw.DeviceWorld(mesh=mesh, device="cuda")
    name = w._names[0]
    old_ops = [np.full(64, N_ROWS, np.int32), np.zeros((64, 4), np.float32),
               np.full(512, N_ROWS, np.int32),
               np.zeros((512, 4), np.float32)]
    ev = lambda: torch.cuda.Event(enable_timing=True)   # noqa: E731
    spent = {"stage": 0.0, "scatter_shards": 0.0}
    real = {k: getattr(tw, k) for k in spent}

    def timed(key):
        def run(*a):
            t0 = time.perf_counter()
            try:
                return real[key](*a)
            finally:
                spent[key] += (time.perf_counter() - t0) * 1e3
        return run
    read = {"update": [], "stage": [], "launch": [], "blocking": [],
            "inflight": []}
    stream = torch.cuda.Stream()
    for k in spent:
        setattr(tw, k, timed(k))
    try:
        with torch.cuda.stream(stream):
            w.update(cap, basis)
            s, e = ev(), ev()
            s.record()
            torch.cuda._sleep(10 ** 7)
            e.record()
            e.synchronize()
            cycles = int(10 ** 7 * 70 / s.elapsed_time(e))   # about 70 ms
            for rep in range(6):
                cap[rng.choice(N_NODES, 40, replace=False), 0] += 1
                basis[rng.choice(N_NODES, 400, replace=False), 1] += 30
                for old_way in (False, True):
                    s, e = ev(), ev()
                    s.record()
                    torch.cuda._sleep(cycles)
                    e.record()
                    n0, was = tw.launches[name], dict(spent)
                    t0 = time.perf_counter()
                    if old_way:
                        for a in old_ops:
                            torch.from_numpy(a).to("cuda")
                    else:
                        w.update(cap, basis)
                    dt = (time.perf_counter() - t0) * 1e3
                    launched = tw.launches[name] - n0
                    stream.synchronize()
                    if not old_way and launched != 1:
                        raise AssertionError(
                            f"{label}: an update with both matrices dirty "
                            f"launched {launched} times on one card")
                    if not rep:
                        continue
                    read["inflight"].append(s.elapsed_time(e))
                    if old_way:
                        read["blocking"].append(dt)
                        continue
                    read["update"].append(dt)
                    read["stage"].append(spent["stage"] - was["stage"])
                    read["launch"].append(spent["scatter_shards"]
                                          - was["scatter_shards"])
    finally:
        for k, f in real.items():
            setattr(tw, k, f)
    dev_cap, dev_basis = w.device_arrays()
    if mesh is not None:
        dev_cap, dev_basis = torch.cat(dev_cap), torch.cat(dev_basis)
    _bitwise(f"{label}: stall reading, device basis vs host snapshot",
             dev_basis.cpu().numpy(), w.host_basis())
    _bitwise(f"{label}: stall reading, device capacity", dev_cap.cpu().numpy(),
             cap)
    med = {k: statistics.median(v) for k, v in read.items()}
    f = med["inflight"]
    where = f"mesh {mesh.shape}" if mesh else "one world"
    log(f"{label}: stall reading ({where}): {min(read['inflight']):.1f}-"
        f"{max(read['inflight']):.1f} ms in flight; DeviceWorld.update "
        f"{med['update']:.4f} ms host time (median of 5; "
        f"{', '.join(f'{x:.4f}' for x in read['update'])}; medians "
        f"{med['stage']:.4f} ms staging, {med['launch']:.4f} ms the launch, "
        f"the rest the host diff), the blocking uploads "
        f"{med['blocking']:.4f} ms "
        f"({', '.join(f'{x:.2f}' for x in read['blocking'])})")
    if min(read["inflight"]) < 50:
        raise AssertionError(f"{label}: the kernel in flight ran "
                             f"{min(read['inflight']):.1f} ms, under 50")
    if med["update"] >= f / 2:
        raise AssertionError(f"{label}: DeviceWorld.update took "
                             f"{med['update']:.3f} ms behind {f:.1f} ms in "
                             f"flight: it waited")
    if med["update"] >= STALL_UPDATE_MS:
        raise AssertionError(f"{label}: DeviceWorld.update took "
                             f"{med['update']:.3f} ms (median of 5) behind "
                             f"{f:.1f} ms in flight, over "
                             f"{STALL_UPDATE_MS} ms: part of it waited")
    return dict(stall_update_ms=med["update"],
                stall_blocking_ms=med["blocking"], stall_inflight_ms=f,
                stall_stage_ms=med["stage"], stall_launch_ms=med["launch"])


def preempt_inputs(seed: int, A: int = 16, R: int = 4, edge: bool = False,
                   special: bool = False):
    """Seeded K6 inputs over N_ROWS rows (rows past N_NODES hold no
    candidate).  The path's shape: every node filled by nine identical
    420 MHz / 850 MB filler allocs, three at each of priorities 20, 30
    and 40 (the first A of them where A < 9), with about 5% of its
    capacity free (bench.py bench_preemption_heavy), against a 420 MHz /
    850 MB ask.  edge: rows already met, rows without a valid candidate,
    rows that cannot be met and mixed candidate sizes, in turn.
    special: in turn, rows whose lowest tier's distances are all +inf
    behind two invalid candidates (so the reference picks off the tier,
    an invalid candidate first), rows with NaN resources in the first
    tier and the second, and path rows."""
    rng = np.random.default_rng(seed)
    n = N_NODES
    cap = np.array([4000, 8192, 102400, 1000][:R], np.float32)
    one = np.array([420, 850, 0, 0][:R], np.float32)
    res = np.zeros((N_ROWS, A, R), np.float32)
    prio = np.zeros((N_ROWS, A), np.int32)
    valid = np.zeros((N_ROWS, A), bool)
    k = min(A, 9)
    res[:n, :k] = one
    prio[:n, :k] = np.repeat([20, 30, 40], 3)[:k]
    valid[:n, :k] = True
    rem = np.zeros((N_ROWS, R), np.float32)
    rem[:n] = cap - 9 * one
    if special:
        kind = np.arange(N_ROWS) % 3
        live = np.arange(N_ROWS) < n
        inf = live & (kind == 0)
        valid[inf, :2] = False
        res[inf, :2] = rng.choice([105.5, 210.0, 420.0],
                                  size=(int(inf.sum()), 2, R))
        res[inf, 2:6, 0] = 1e37            # (420 - 1e37)^2 / 420^2 = +inf
        prio[inf, 2:6] = 10
        nan = live & (kind == 1)
        res[nan, 1, 1] = np.nan
        res[nan, 2, 0] = np.nan
        res[nan, 4, 0] = np.nan
    if edge:
        kind = np.arange(N_ROWS) % 4
        live = np.arange(N_ROWS) < n
        rem[live & (kind == 0)] = cap                  # met already
        valid[kind == 1] = False                       # no candidate
        rem[live & (kind == 2), 0] = -5000.0           # cannot be met
        mixed = live & (kind == 3)
        k = int(mixed.sum())
        res[mixed, :A] = rng.choice([0.0, 105.5, 210.0, 420.0, 850.25],
                                    size=(k, A, R)).astype(np.float32)
        prio[mixed, :A] = rng.choice([20, 30, 40], size=(k, A))
        valid[mixed, :A] = rng.random((k, A)) < 0.8
    return res, prio, valid, rem, one.copy()


def _sectors(offsets, nbytes):
    """Bytes in the 32-byte sectors that elements of `nbytes` bytes at
    the byte `offsets` touch, each sector counted once."""
    lo = np.asarray(offsets, np.int64).ravel() // 32
    hi = (np.asarray(offsets, np.int64).ravel() + nbytes - 1) // 32
    spans = [np.minimum(lo + k, hi) for k in range(int((hi - lo).max(
        initial=0)) + 1)]
    return np.unique(np.concatenate(spans)).size * 32


def preempt_bound_ms(x, picked, met0, max_steps):
    """Bytes: what this run's data needs, each input read once (in
    32-byte sectors where it is gathered) and each output written once.
    Every row reads remaining and writes met, picked and avail; a row not
    met at the start also reads its validity; a row that picks also reads
    the priorities of its valid candidates and the resources of the
    candidates in the tiers it picks from (picks go tier by tier, lowest
    priority first, so those are the tiers of its picked candidates).
    Operations: per pick, a distance over each open candidate of its
    tier (R subtractions, divisions, multiplications and additions, one
    square root) and the R-wide avail/needed update."""
    res, prio, valid, rem, ask = x
    n, a, r = res.shape
    cand = np.arange(n)[:, None] * a + np.arange(a)[None, :]
    picks = ~met0 & valid.any(axis=1) & (max_steps > 0)
    same = prio[:, :, None] == prio[:, None, :]
    tier = valid & (same & picked[:, None, :]).any(axis=2)
    nbytes = (rem.nbytes + ask.nbytes + n + n * a + rem.nbytes
              + _sectors(cand[~met0], 1)
              + _sectors(4 * cand[picks][valid[picks]], 4)
              + _sectors(4 * r * cand[tier], 4 * r))
    # the m-th pick (from 0) of a tier of c valid candidates scores c - m
    # open ones: summed over a tier's k picks, k*c - k*(k-1)/2
    c = (same & tier[:, None, :]).sum(axis=2)
    k = (same & picked[:, None, :]).sum(axis=2)
    dists = int(round(float((c - (k - 1) / 2)[picked].sum())))
    ops = dists * (4 * r + 1) + int(picked.sum()) * 2 * r
    return _bound(nbytes, ops)


# K6's shapes: (label, preempt_inputs keywords, max_steps); max_steps is
# the Preemptor's min(A, 32)
PREEMPT_SHAPES = (("path shape", {}, 16),
                  ("edge rows", {"edge": True}, 16),
                  ("A=4", {"A": 4, "edge": True}, 4),
                  ("A=8", {"A": 8, "edge": True}, 8),
                  ("A=32", {"A": 32, "edge": True}, 32),
                  ("A=64", {"A": 64, "edge": True}, 32),
                  ("R=3", {"R": 3, "edge": True}, 16),
                  ("inf and NaN rows", {"special": True}, 16))


def check_preempt():
    """K6 against its plain version on the card, bit for bit in met,
    picked and avail, on every PREEMPT_SHAPES entry: the path's shape
    (N = 16,384, A = 16, R = 4, max_steps = 16, ties on every node), the
    edge rows at A = 16, 4, 8, 32 and 64 (one to 32 lanes a node, and two
    slots a lane) and at R = 3, and rows whose tier's distances are +inf
    or NaN; at each shape the wrapper call's time (CUDA events) and the
    kernel's alone (the profiler), the plain version's at the path's."""
    import torch
    from nomad_tpu_torch.ops import preempt as tk
    times = {}
    for label, kw, steps in PREEMPT_SHAPES:
        x = preempt_inputs(21, **kw)
        t = [torch.from_numpy(np.ascontiguousarray(v)).cuda() for v in x]
        kern = lambda t=t, steps=steps: tk.preempt_for_task_group(
            *t, max_steps=steps)
        plain = lambda t=t, steps=steps: tk.preempt_for_task_group_plain(
            *t, max_steps=steps)
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        for nm, g, w in zip(("met", "picked", "avail"), got, want):
            g, w = g.cpu().numpy(), w.cpu().numpy()
            if g.dtype == np.bool_:
                if not np.array_equal(g, w):
                    raise AssertionError(f"preempt {label} {nm}: "
                                         f"{int((g != w).sum())} differ")
            else:
                _bitwise(f"preempt {label} {nm}", g, w)
        met = got[0].cpu().numpy()
        picked = got[1].cpu().numpy()
        avail = got[2].cpu().numpy()
        log(f"kernels: preempt {label}: {int(met.sum())} of {N_ROWS} rows "
            f"met, {int(picked.sum())} victims picked, "
            f"{int(np.isnan(avail).any(axis=1).sum())} rows with a NaN "
            f"avail, bit-equal")
        if label == "path shape":
            if not met[:N_NODES].all() or \
                    not (picked[:N_NODES].sum(axis=1) == 1).all() or \
                    not picked[:N_NODES, 0].all():
                raise AssertionError("preempt path shape: every node must "
                                     "be met by its first (lowest-index) "
                                     "priority-20 filler")
            main_kern, main_plain = kern, plain
            met0 = (x[3] >= x[4]).all(axis=1)
            bound, by = preempt_bound_ms(x, picked, met0, steps)
        if label == "inf and NaN rows":
            kind = np.arange(N_NODES) % 3
            # the +inf tier: an invalid candidate picked off the tier
            if not picked[:N_NODES][kind == 0, 0].all():
                raise AssertionError("preempt inf rows: candidate 0 (off "
                                     "the +inf tier) must be picked")
            # NaN wins at its lowest index
            if not picked[:N_NODES][kind == 1, 1].all() or \
                    met[:N_NODES][kind == 1].any():
                raise AssertionError("preempt NaN rows: candidate 1 (the "
                                     "first NaN) picked, never met")
        times[label] = (time_cuda(kern),
                        kernel_device_ms(kern, "preempt_kernel"))
    ms, dev_ms = times["path shape"]
    plain_ms = time_cuda(main_plain)
    log(f"kernels: preempt N={N_ROWS} A=16 R=4 max_steps=16: kernel "
        f"{ms:.4f} ms (the wrapper call between CUDA events; the kernel "
        f"alone {dev_ms:.4f} ms on the profiler), plain {plain_ms:.4f} ms, "
        f"bound {bound:.6f} ms ({by})")
    log("kernels: preempt times, call / kernel alone: " + "; ".join(
        f"{label} {c:.4f} / {d:.4f} ms" for label, (c, d) in times.items()))
    return dict(name="preempt", route="cuda",
                source="nomad_tpu_torch/csrc/preempt.cu",
                replaces="nomad_tpu/ops/preempt.py:72",
                jax_function="preempt_for_task_group",
                launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)


# row counts past the shared-memory sort: the ClusterMatrix buckets of a
# 20,000-node and of a 100,000-node cluster
LARGE_WORLDS = ((32768, 20000), (131072, 100000))


def _k4_bound(inputs, res, fill_grid, sparse):
    """K4's bound on this run's data: each input read and each output
    written once, and the grid cells the evals' waves need."""
    from nomad_tpu_torch.ops import place as tp
    cap, used, heavy, dyn, D = inputs
    E, n = heavy.shape[0], cap.shape[0]
    assign, _, placed, _, _, waves = res
    width = 3 * tp.SPARSE_CAP + 4 if sparse else 2 * n + 4
    nbytes = n * 16 * 3 + heavy.nbytes + dyn.nbytes + E * width * 4
    cells = sum(bulk_cells(n, int(waves[e]), int(np.count_nonzero(assign[e])),
                           fill_grid) for e in range(E) if placed[e] > 0)
    return _bound(nbytes, cells * OPS_PER_CELL)


def check_bulk_large():
    """K1 and K4 past the shared-memory sort (the repair of the
    16,384-row ceiling), at the row counts of a 20,000- and a
    100,000-node cluster, against their plain versions, bit for bit.
    K4 on a fresh cluster, where every ready row ties and is in the
    wave, and at bench.py bench_kernel_100k_nodes' dispatch
    shape (8 evals of count 512, dense, fill grid 64), timed."""
    import torch
    from nomad_tpu_torch.ops import place as tp
    t = lambda x: torch.from_numpy(np.array(x)).cuda()   # noqa: E731
    for n_rows, n_nodes in LARGE_WORLDS:
        a = bulk_inputs(31, True, n_rows, n_nodes)
        _, waves, run_rows, kern, plain = check_bulk(
            a, f"C2M group N={n_rows}", True)
        check_bulk(bulk_inputs(32, False, n_rows, n_nodes),
                   f"heterogeneous N={n_rows}", True)
        fg = tp.fill_grid_for(10)
        _batch_bulk_case(
            f"E=10 C2M eval on a fresh {n_nodes}-node world (every ready row "
            f"in the wave), sparse, exact carry",
            c2m_eval_inputs(33, n_rows, n_nodes, fresh=True), True, True, fg)
        _batch_bulk_case(
            "E=17 C2M chain with deltas and a count-0 pad, dense",
            batch_bulk_inputs(34, 16, n_rows, n_nodes), False, False, fg)
        bound, by = bulk_bound_ms(a, waves, run_rows)
        ms = time_cuda(kern, reps=5)
        plain_ms = time_cuda(plain, reps=3, warmup=1)
        log(f"kernels: place_bulk C2M group N={n_rows}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({by})")
        shape = c2m_eval_inputs(35, n_rows, n_nodes, fresh=True, E=8,
                                count=512)
        fg = tp.fill_grid_for(512)
        res = _batch_bulk_case(
            f"E=8 evals of count 512 on a fresh {n_nodes}-node world, dense, "
            f"exact carry (bench_kernel_100k_nodes' dispatch)",
            shape, False, True, fg)
        args = tuple(t(x) for x in shape[:4]) + (0,)
        kw = dict(sparse_out=False, fill_grid=fg)
        bound, by = _k4_bound(shape, res, fg, False)
        ms = time_cuda(lambda: tp.place_bulk_batch(*args, **kw), reps=5)
        plain_ms = time_cuda(lambda: tp.place_bulk_batch_plain(*args, **kw),
                             reps=3, warmup=1)
        log(f"kernels: place_bulk_batch E=8 count=512 fresh world N={n_rows}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound:.6f} ms ({by}), waves {res[5].tolist()}")


# the probe's units: wrapper name -> the reference's jitted function
STAGE_UNITS = {
    "stage_feasibility": ("feasibility", "nomad_tpu/parallel/stage_probe.py:65"),
    "stage_fit": ("fit", "nomad_tpu/parallel/stage_probe.py:73"),
    "stage_score": ("score", "nomad_tpu/parallel/stage_probe.py:77"),
    "stage_argmax": ("argmax", "nomad_tpu/parallel/stage_probe.py:95"),
    "stage_scatter": ("scatter", "nomad_tpu/parallel/stage_probe.py:109"),
    "stage_fused_wave": ("probe_fused.fused_wave",
                         "nomad_tpu/parallel/stage_probe.py:196"),
}
# float32 operations per cell of the fit (two subtractions, two
# divisions, two powf counted as one each, a sum, a clip, the 1/18), of
# the score stack, and of a util/fits cell (R multiplies, adds, compares)
OPS_FIT = 11
OPS_SCORE = 12


def _compare_any(name, got, ref):
    """Integers and bools equal; floats within the tests' tolerances.
    Returns (max |err|, bit-equal)."""
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: {got.shape} {got.dtype} vs "
                             f"{ref.shape} {ref.dtype}")
    if got.dtype != np.float32:
        if not np.array_equal(got, ref):
            raise AssertionError(f"{name}: {int((got != ref).sum())} differ")
        return 0.0, True
    err = _compare_floats(name, got, ref)
    return err, bool(np.array_equal(got.view(np.uint32), ref.view(np.uint32)))


def _stage_work(n, M, run, R=4):
    """({unit: bytes}, {unit: float ops}) of each K8 unit at n rows and
    fill grid M, given K8d's runs (the cells K8d and K8f evaluate)."""
    extra_cells = int(np.minimum(run.cpu().numpy() + 1, M).sum()) - n
    f4 = 4
    nbytes = {
        "stage_feasibility": n * R * f4 * 2 + R * f4 + n + M * f4
        + n * M * R * f4 + n * M,
        "stage_fit": n * 2 * f4 + n * M * 2 * f4 + n * M * f4,
        "stage_score": n * M * f4 + n * 3 * f4 + M * f4 + n * M * f4,
        "stage_argmax": (n + extra_cells) * (1 + f4) + M * f4 + n * 2 * f4,
        "stage_scatter": n * 2 * f4 + n * R * f4 * 2 + R * f4 + n * f4 * 2
        + f4,
        "stage_fused_wave": n * R * f4 * 3 + R * f4 + n + n * f4 * 4 + f4,
    }
    ops = {
        "stage_feasibility": n * M * 3 * R,
        "stage_fit": n * M * OPS_FIT,
        "stage_score": n * M * OPS_SCORE,
        "stage_argmax": 0,
        "stage_scatter": n * (2 * R + 1),
        "stage_fused_wave": (n + extra_cells) * OPS_PER_CELL,
    }
    return nbytes, ops


def check_stage_probe():
    """K8a-K8f against their plain versions on the card at the bench's
    shape (N = 10,000 unpadded rows, M = fill_grid_for(10) = 16, R = 4;
    the probe's seeded inputs): each unit on the same inputs (the plain
    chain's outputs of the stages before it), integers and bools equal,
    floats within the tests' tolerances (the log says whether they are
    bit-equal); the fused wave (K8f) equal to the K8a->K8e kernel chain
    in used2, coll2 and placed.  CUDA-event times beside the kernel alone
    (profiler), the wrapper's host time a call, the plain versions'
    times and the bounds."""
    import torch
    from nomad_tpu_torch.ops import stage_probe as sp
    from nomad_tpu_torch.parallel import stage_probe as psp
    n, M, R = N_NODES, 16, 4
    x = psp.probe_inputs(n, fill_grid=M, device="cuda")
    cap, used, dem, feas, ms_ = (x[k] for k in ("capacity", "used", "demand",
                                                "feasible", "ms"))
    util_m, fits_m = sp.feasibility_plain(cap, used, dem, feas, ms_)
    fit_m = sp.fit_plain(cap, util_m)
    score_m = sp.score_plain(fit_m, x["coll"], ms_, x["desired_f"],
                             x["penalty"], x["affinity"], x["has_affinity"])
    run, order = sp.argmax_plain(fits_m, score_m, ms_)
    fused_args = (cap, used, dem, feas, x["affinity"], x["has_affinity"],
                  x["desired_f"], x["penalty"], x["coll"], x["count"], M)
    calls = {
        "stage_feasibility": ("feasibility", (cap, used, dem, feas, ms_)),
        "stage_fit": ("fit", (cap, util_m)),
        "stage_score": ("score", (fit_m, x["coll"], ms_, x["desired_f"],
                                  x["penalty"], x["affinity"],
                                  x["has_affinity"])),
        "stage_argmax": ("argmax", (fits_m, score_m, ms_)),
        "stage_scatter": ("scatter", (run, order, x["count"], used, dem,
                                      x["coll"])),
        "stage_fused_wave": ("fused_wave", fused_args),
    }
    nbytes, ops = _stage_work(n, M, run)
    entries = {}
    for name, (fn, args) in calls.items():
        kern = lambda fn=fn, args=args: getattr(sp, fn)(*args)
        plain = lambda fn=fn, args=args: getattr(sp, fn + "_plain")(*args)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs = [_compare_any(f"{name}[{i}]", g, w)
                for i, (g, w) in enumerate(zip(got, want))]
        err = max(e for e, _ in errs)
        bits = all(b for _, b in errs)
        k_ms = time_cuda(kern)
        p_ms = time_cuda(plain)
        bound, by = _bound(nbytes[name], ops[name])
        alone = kernel_device_ms(kern, STAGE_KERNELS[name])
        # the wrapper's host time, and without _on_card (its share), in
        # turns
        host = {}
        for turn in ("bare", "on_card", "on_card", "bare"):
            with _without_on_card(sp) if turn == "bare" else \
                    contextlib.nullcontext():
                host.setdefault(turn, []).append(host_us(kern, n=500))
        log(f"kernels: {name} N={n} M={M}: integers equal, floats "
            f"{'bit-equal' if bits else f'max |err| {err:.3g}'}; kernel "
            f"{k_ms:.4f} ms (alone {alone:.4f} ms, wrapper's host time "
            f"{'/'.join(f'{h:.2f}' for h in host['on_card'])} us a call, "
            f"{'/'.join(f'{h:.2f}' for h in host['bare'])} without "
            f"_on_card), plain {p_ms:.4f} ms, bound {bound:.6f} ms ({by})")
        jax_fn, replaces = STAGE_UNITS[name]
        entries[name] = dict(
            name=name, route="cuda",
            source="nomad_tpu_torch/csrc/stage_probe.cu", replaces=replaces,
            jax_function=jax_fn, launches=0, max_abs_err=err, ms=k_ms,
            plain_ms=p_ms, bound_ms=bound, bound_by=by, library_ms=None,
            device_ms=alone, host_us=statistics.median(host["on_card"]))
    # the fused wave against the chain of the five unit kernels
    k_util, k_fits = sp.feasibility(cap, used, dem, feas, ms_)
    k_fit = sp.fit(cap, k_util)
    k_score = sp.score(k_fit, x["coll"], ms_, x["desired_f"], x["penalty"],
                       x["affinity"], x["has_affinity"])
    k_run, k_order = sp.argmax(k_fits, k_score, ms_)
    chain = sp.scatter(k_run, k_order, x["count"], used, dem, x["coll"])
    fused = sp.fused_wave(*fused_args)
    torch.cuda.synchronize()
    for nm, c, f in zip(("used2", "coll2", "placed"), chain, fused):
        _bitwise(f"stage_fused_wave {nm} vs the K8a->K8e chain",
                 f.cpu().numpy().reshape(-1), c.cpu().numpy().reshape(-1))
    log(f"kernels: stage_fused_wave: used2, coll2 and placed "
        f"({int(fused[2])} of {x['count']}) equal to the K8a->K8e kernel "
        f"chain")
    check_stage_cases()
    check_score_cases()
    return entries


@contextlib.contextmanager
def _without_on_card(module):
    """`module`'s wrappers calling their C entry points directly, with
    whatever card is current (the parent tree's form), while the block
    runs: what ops/place.py `_on_card` costs a call."""
    on_card = module._on_card
    module._on_card = lambda idx, entry, *args: entry(*args)
    try:
        yield
    finally:
        module._on_card = on_card


# the kernel's name in the profiler, per K8 wrapper
STAGE_KERNELS = {"stage_feasibility": "feasibility_kernel",
                 "stage_fit": "fit_kernel", "stage_score": "score_kernel",
                 "stage_argmax": "argmax_kernel",
                 "stage_scatter": "scatter_kernel",
                 "stage_fused_wave": "fused_wave_kernel"}
# K8's shapes past the bench's (N = 10,000, M = 16): a 20,000-node
# cluster, past the 16,384 rows one block sorted in shared memory, and
# 131,072 rows (8 a thread), each at the probe's two fill grids
STAGE_SHAPES = ((10000, 16), (20000, 16), (131072, 16), (10000, 64),
                (20000, 64), (131072, 64))
STAGE_JITTER_SEEDS = range(1, 4)


def _stage_chain(x, kernels):
    """K8a->K8e and K8f on the probe inputs x: the kernels (`kernels`) or
    the plain versions, each unit fed the outputs of its own chain."""
    from nomad_tpu_torch.ops import stage_probe as sp
    f = (lambda k: getattr(sp, k)) if kernels else \
        (lambda k: getattr(sp, k + "_plain"))
    util_m, fits_m = f("feasibility")(x["capacity"], x["used"], x["demand"],
                                      x["feasible"], x["ms"])
    fit_m = f("fit")(x["capacity"], util_m)
    score_m = f("score")(fit_m, x["coll"], x["ms"], x["desired_f"],
                         x["penalty"], x["affinity"], x["has_affinity"])
    run, order = f("argmax")(fits_m, score_m, x["ms"])
    used2, coll2, placed = f("scatter")(run, order, x["count"], x["used"],
                                        x["demand"], x["coll"])
    fused = f("fused_wave")(*_fused_args(x))
    return dict(util_m=util_m, fits_m=fits_m, fit_m=fit_m, score_m=score_m,
                run=run, order=order, used2=used2, coll2=coll2,
                placed=placed.reshape(1), fused_used2=fused[0],
                fused_coll2=fused[1], fused_placed=fused[2].reshape(1))


def _fused_args(x):
    return (x["capacity"], x["used"], x["demand"], x["feasible"],
            x["affinity"], x["has_affinity"], x["desired_f"], x["penalty"],
            x["coll"], x["count"], x["fill_grid"])


def _same(name, got, want):
    """Integers and bools equal; floats bit for bit, NaN against NaN."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape} {got.dtype} vs "
                             f"{want.shape} {want.dtype}")
    if want.dtype == np.float32:
        nan = np.isnan(want)
        if not np.array_equal(np.isnan(got), nan):
            raise AssertionError(f"{name}: NaN where the plain version has "
                                 f"none, or none where it has")
        got, want = np.where(nan, 0, got), np.where(nan, 0, want)
        got, want = got.view(np.uint32), want.view(np.uint32)
    if not np.array_equal(got, want):
        raise AssertionError(f"{name}: {int((got != want).sum())} differ")


def check_stage_cases():
    """K8a-K8f against their plain versions on every shape of
    STAGE_SHAPES and on the edge rows of probe_edge_inputs at N = 10,000
    (a best row scoring -inf, NaN scores at m = 1 and past it, no row
    fitting, every row tied, two rows, a count above every run), M = 16
    and 64: every output bit-equal (NaN against NaN), K8f's equal to the
    K8a->K8e kernel chain's, K8e also on a random permutation of the rows
    (its contract: any permutation), and K8a, K8b, K8d, K8e (on both
    orders) and K8f again under each of STAGE_JITTER_SEEDS of the delays
    at the cluster exchanges (K8a and K8b have no delay site: under a
    seed they run again and must repeat their outputs)."""
    import torch
    from nomad_tpu_torch.ops import stage_probe as sp
    from nomad_tpu_torch.parallel import stage_probe as psp
    cases = [(f"N={n} M={M}", psp.probe_inputs(n, fill_grid=M,
                                                device="cuda"))
             for n, M in STAGE_SHAPES]
    stc = _cases("_stage_cases")
    cases += [(f"{kind}, M={M}",
               stc.probe_edge_inputs(kind, N_NODES, M, device="cuda"))
              for M in (16, 64) for kind in stc.EDGE_KINDS]
    for label, x in cases:
        got = _stage_chain(x, kernels=True)
        want = _stage_chain(x, kernels=False)
        torch.cuda.synchronize()
        got = {k: v.cpu().numpy() for k, v in got.items()}
        want = {k: v.cpu().numpy() for k, v in want.items()}
        for k in want:
            _same(f"stage probe {label}: {k}", got[k], want[k])
        for k in ("used2", "coll2", "placed"):
            _same(f"stage probe {label}: K8f {k} vs the K8a->K8e chain",
                  got["fused_" + k], got[k])
        # under the delays, each kernel against its own output above
        fits_m, score_m = (torch.from_numpy(got[k]).cuda()
                           for k in ("fits_m", "score_m"))
        jittered(f"stage probe {label}: K8d",
                 lambda: sp.argmax(fits_m, score_m, x["ms"]),
                 (got["run"], got["order"]), kernel="stage_probe",
                 seeds=STAGE_JITTER_SEEDS)
        jittered(f"stage probe {label}: K8f",
                 lambda: sp.fused_wave(*_fused_args(x)),
                 (got["fused_used2"], got["fused_coll2"],
                  got["fused_placed"].reshape(())), kernel="stage_probe",
                 seeds=STAGE_JITTER_SEEDS)
        jittered(f"stage probe {label}: K8a",
                 lambda: sp.feasibility(x["capacity"], x["used"],
                                        x["demand"], x["feasible"], x["ms"]),
                 (got["util_m"], got["fits_m"]), kernel="stage_probe",
                 seeds=STAGE_JITTER_SEEDS)
        # K8e on K8d's order and on a random permutation of the rows
        n = x["capacity"].shape[0]
        perm = torch.from_numpy(np.random.default_rng(n).permutation(n)
                                .astype(np.int32)).cuda()
        run = torch.from_numpy(got["run"]).cuda()
        for what, order in (("K8d's order", torch.from_numpy(
                got["order"]).cuda()), ("a random permutation", perm)):
            sc = (run, order, x["count"], x["used"], x["demand"], x["coll"])
            k_out = sp.scatter(*sc)
            p_out = sp.scatter_plain(*sc)
            torch.cuda.synchronize()
            for k, (a, b) in enumerate(zip(k_out, p_out)):
                _same(f"stage probe {label}: K8e on {what} output {k}",
                      a.cpu().numpy(), b.cpu().numpy())
            jittered(f"stage probe {label}: K8e on {what}",
                     lambda sc=sc: sp.scatter(*sc),
                     [t.cpu().numpy() for t in k_out], kernel="stage_probe",
                     seeds=STAGE_JITTER_SEEDS)
        nw = int((want["order"] != np.arange(want["order"].size)).sum())
        log(f"kernels: stage probe {label}: K8a-K8f bit-equal to their "
            f"plain versions, K8f to the K8a->K8e chain, K8e also on a "
            f"random permutation, K8a/K8d/K8e/K8f also under "
            f"{len(STAGE_JITTER_SEEDS)} seeds of the delays (K8a and K8b "
            f"have no delay site); placed "
            f"{int(want['placed'][0])} of {x['count']}, {nw} rows out of "
            f"row order")


def _score_args(x, dev="cuda"):
    """K8c's arguments (fit_m, coll, ms, desired_f, penalty, affinity,
    has_affinity) on `dev`: from score_inputs' numpy dict, or from the
    probe's inputs (fit_m from the plain K8a->K8b chain)."""
    import torch
    from nomad_tpu_torch.ops import stage_probe as sp
    t = lambda v: (torch.from_numpy(v).to(dev)  # noqa: E731
                   if isinstance(v, np.ndarray) else v)
    x = {k: t(v) for k, v in x.items()}
    if "fit_m" not in x:
        util_m, _ = sp.feasibility_plain(x["capacity"], x["used"],
                                         x["demand"], x["feasible"], x["ms"])
        x["fit_m"] = sp.fit_plain(x["capacity"], util_m)
    return tuple(x[k] for k in ("fit_m", "coll", "ms", "desired_f",
                                "penalty", "affinity", "has_affinity"))


def check_score_cases():
    """K8c bit-equal to its plain version (NaN against NaN) on its own
    cases (tests/_stage_cases.py score_inputs: each of SCORE_KINDS at
    each fill grid of SCORE_GRIDS, M = 1, 3, 7, 16 and 64) at 33 rows
    (a warp's lanes past the last cell) and 10,000; then K8f and K1,
    whose score stack is K8c's, bit-equal to theirs on the wave grid's
    score cases (wave_score_inputs: a desired count of 0, 0.5 and NaN,
    collisions past 2^24; K1 takes an integer desired count) at 10,000
    rows."""
    import torch
    from nomad_tpu_torch.ops import place as tp
    from nomad_tpu_torch.ops import stage_probe as sp
    stc = _cases("_stage_cases")
    cases = 0
    for n in (33, N_NODES):
        for kind in stc.SCORE_KINDS:
            for M in stc.SCORE_GRIDS:
                args = _score_args(stc.score_inputs(kind, n, M, seed=n + M))
                got, want = sp.score(*args), sp.score_plain(*args)
                torch.cuda.synchronize()
                _same(f"K8c {kind}, N={n}, M={M}", got.cpu().numpy(),
                      want.cpu().numpy())
                cases += 1
    for kind in stc.WAVE_SCORE_KINDS:
        x = stc.wave_score_inputs(kind, N_NODES, 16, "cuda")
        args = _fused_args(x)
        for k, (g, w) in enumerate(zip(sp.fused_wave(*args),
                                       sp.fused_wave_plain(*args))):
            _same(f"K8f {kind} output {k}", g.cpu().numpy(),
                  w.cpu().numpy())
        if kind != "desired NaN":
            k1 = (x["capacity"], x["used"], x["feasible"], x["affinity"],
                  True, int(x["desired_f"]), x["penalty"] > 0, x["coll"],
                  x["demand"], x["count"], False, 64, 16)
            _same(f"K1 {kind}", tp.place_bulk(*k1).cpu().numpy(),
                  tp.place_bulk_plain(*k1).cpu().numpy())
    log(f"kernels: K8c bit-equal to its plain version on {cases} cases "
        f"({', '.join(stc.SCORE_KINDS)}; M = "
        f"{', '.join(map(str, stc.SCORE_GRIDS))}; N = 33 and {N_NODES}); "
        f"K8f and K1 bit-equal to theirs on the wave grid's score cases "
        f"({', '.join(stc.WAVE_SCORE_KINDS)}; K1 not on a NaN desired "
        f"count)")


# where a tree of the parent commit may be unpacked (`git archive`) to
# time its stage-probe kernels beside this tree's in the same run
PARENT_TREE = "smoke_archive/parent"


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


def _launch_counts():
    from nomad_tpu_torch.ops import place as tp
    from nomad_tpu_torch.ops import sharded as k7
    from nomad_tpu_torch.ops import stage_probe as sp
    from nomad_tpu_torch.parallel import world as tw
    return (tp.launches, tw.launches, sp.launches, k7.launches)


def _reset_counts():
    from nomad_tpu_torch.parallel import world as tw
    for d in _launch_counts() + (tw.staged,):
        for k in d:
            d[k] = 0


def _counts():
    """Kernel launches by wrapper, and `staged_<name>`: the world's
    staged operand buffers (one a card a dirty update or rank-1 apply
    touches)."""
    from nomad_tpu_torch.parallel import world as tw
    out = {k: v for d in _launch_counts() for k, v in d.items()}
    out.update({f"staged_{k}": v for k, v in tw.staged.items()})
    return out


def _per_update(launches, name):
    """K5's launches per dirty update on one card (launches over staged
    buffers); fails past one."""
    n, staged = launches[name], launches[f"staged_{name}"]
    if n > staged:
        raise AssertionError(f"{name}: {n} launches for {staged} dirty "
                             f"updates on one card")
    return f"{name} {n} launches / {staged} staged updates"


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
    log(f"engine: launches per dirty update: "
        f"{_per_update(launches, 'set_rows')}")
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
            f"{launches2}; {_per_update(launches2, 'add_rank1')}")
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


# --------------------------------------------------------------- the spine

PREEMPT_WORKERS = 16


def _server(workers):
    from nomad_tpu_torch.core.server import Server, ServerConfig
    s = Server(ServerConfig(num_schedulers=workers, heartbeat_ttl=3600.0,
                            gc_interval=3600.0), device="cuda")
    s.start()
    return s


def _wait_for(cond, timeout, what):
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            raise AssertionError(f"timed out after {timeout} s waiting for "
                                 f"{what}")
        time.sleep(0.01)


def _running(store, jobs):
    return [a for j in jobs for a in store.allocs_by_job(j.namespace, j.id)
            if a.desired_status == "run" and not a.terminal_status()]


def _check_spine(s, eng, label):
    """At a quiescent point (the server stopped, or idle): committed
    usage equals the sum of the live allocs row by row and stays within
    capacity, and the engine's resident basis equals its host snapshot."""
    from nomad_tpu_torch.encode.matrixizer import comparable_vec
    cm = s.store.matrix
    expect = np.zeros(cm.used.shape, np.float64)
    for a in s.store.allocs():
        if not a.terminal_status():
            expect[cm.row_of[a.node_id]] += comparable_vec(
                a.comparable_resources())
    if not np.allclose(cm.used, expect, atol=1e-3):
        raise AssertionError(f"{label}: committed usage differs from the "
                             f"live allocs' sum")
    if not (cm.used <= cm.capacity + 1e-3).all():
        raise AssertionError(f"{label}: committed usage exceeds capacity")
    _check_world(eng, label)


# the one cause for which a worker may fail an eval on these paths: the
# scheduler's attempt limit after its plans were rejected, under
# contention, by the applier (scheduler/generic.py SetStatusError); any
# other cause (a kernel's launch error among them) fails the phase
ATTEMPT_LIMIT = "SetStatusError: maximum attempts reached"


def _failures(workers):
    """-> Counter of the causes of the evals the workers failed so far
    (a worker catches the error, counts it and nacks the eval)."""
    from collections import Counter
    return sum((w.failures for w in workers), Counter())


def _check_failures(label, causes):
    other = {c: n for c, n in causes.items() if c != ATTEMPT_LIMIT}
    if other:
        raise AssertionError(f"{label}: evals failed for {other}")


def spine_e2e(snapshot_path):
    """bench.py bench_e2e_spine's shape: 1,000 mock nodes, 50 batch jobs
    of count 100, registered through Server.register_job; at the end
    the operator's snapshot save (Server.save_snapshot) to
    `snapshot_path`."""
    from nomad_tpu_torch import mock
    s = _server(8)
    try:
        for _ in range(1000):
            s.register_node(mock.node())
        acked0 = s.broker.stats["acked"]
        failures0 = _failures(s.workers)
        jobs = []
        t0 = time.perf_counter()
        for _ in range(50):
            j = mock.batch_job()
            j.task_groups[0].count = 100
            jobs.append(j)
            s.register_job(j)
        _wait_for(lambda: len(_running(s.store, jobs)) >= 5000, 300,
                  "5,000 allocs")
        wall = time.perf_counter() - t0
        if not s.wait_for_idle(60):
            raise AssertionError("spine e2e: evals still in flight")
        placed = len(_running(s.store, jobs))
        if placed != 5000:
            raise AssertionError(f"spine e2e: {placed} of 5000 committed")
        _check_spine(s, s._engine, "spine e2e")
        causes = _failures(s.workers) - failures0
        _check_failures("spine e2e", causes)
        evals = s.broker.stats["acked"] - acked0
        log(f"spine e2e: 8 workers, 1,000 nodes, 50 batch jobs: {placed} "
            f"of 5000 allocs committed in {wall:.3f} s: "
            f"{placed / wall:.1f} allocs/s, {evals / wall:.2f} evals/s "
            f"({evals} evals acked); evals failed by cause "
            f"{dict(causes)}; usage equals the allocs' sum, device basis "
            f"equals host snapshot")
        t0 = time.perf_counter()
        s.save_snapshot(snapshot_path)
        log(f"spine e2e: save_snapshot in "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms, "
            f"{os.path.getsize(snapshot_path)} bytes "
            f"({len(s.store.allocs())} allocs, index "
            f"{s.store.latest_index})")
    finally:
        s.stop()


SNAPSHOT_C2M_JOBS = 10   # C2M jobs the restored server places


def spine_snapshot(path):
    """The operator's restore (Server.restore_snapshot) of the e2e
    spine's snapshot into a fresh server on the card: the restored
    store saves to the same bytes, holds every alloc with committed
    usage equal to their sum, then places SNAPSHOT_C2M_JOBS C2M jobs
    (10 groups x count 10) with every alloc committed, usage equal to
    the live allocs' sum and the engine's resident basis bit-equal to
    the world's host snapshot."""
    import pickle
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.core.server import Server, ServerConfig
    from nomad_tpu_torch.state import digest
    s = Server(ServerConfig(num_schedulers=8, heartbeat_ttl=3600.0,
                            gc_interval=3600.0), device="cuda")
    t0 = time.perf_counter()
    s.restore_snapshot(path)
    restore_ms = (time.perf_counter() - t0) * 1e3
    again = path + ".again"
    s.save_snapshot(again)
    with open(path, "rb") as fh:
        first = pickle.load(fh)
    with open(again, "rb") as fh:
        second = pickle.load(fh)
    if second != first:
        raise AssertionError("snapshot: the restored store saves to other "
                             "bytes")
    if digest.blob_digests(second["data"]) != digest.tables_digests(
            s.fsm.snapshot_tables()):
        raise AssertionError("snapshot: the restored tables' digests "
                             "differ from the snapshot's")
    restored = len(_running(s.store, s.store.jobs()))
    s.start()
    try:
        acked0 = s.broker.stats["acked"]
        jobs = [_c2m_job(mock) for _ in range(SNAPSHOT_C2M_JOBS)]
        want = SNAPSHOT_C2M_JOBS * 100
        t0 = time.perf_counter()
        for j in jobs:
            s.register_job(j)
        _wait_for(lambda: len(_running(s.store, jobs)) >= want, 300,
                  f"{want} allocs after the restore")
        wall = time.perf_counter() - t0
        if not s.wait_for_idle(60):
            raise AssertionError("snapshot: evals still in flight")
        placed = len(_running(s.store, jobs))
        if placed != want:
            raise AssertionError(f"snapshot: {placed} of {want} committed")
        _check_spine(s, s._engine, "snapshot")
        _check_failures("snapshot", _failures(s.workers))
        log(f"spine snapshot: restore_snapshot in {restore_ms:.1f} ms "
            f"({restored} running allocs restored, index "
            f"{first['index']}), re-saved to the same bytes and digests; "
            f"the restored server placed {placed} of {want} C2M allocs "
            f"({SNAPSHOT_C2M_JOBS} jobs x 10 groups x count 10) in "
            f"{wall:.3f} s ({s.broker.stats['acked'] - acked0} evals "
            f"acked); usage equals the allocs' sum, device basis equals "
            f"host snapshot")
    finally:
        s.stop()


class FindSplit:
    """What each Preemptor.find spends around K6 while installed, on the
    host clock: its three blocking uploads (cand_valid, remaining and
    demand, scheduler/preemption.py `find`), K6's launch (the wrapper
    call) and its two reads (met and picked `.cpu()`, the first of
    which waits for the kernel).  It swaps the preemption module's
    `torch` for a proxy whose `from_numpy(...).to()` is timed and its
    `preempt_for_task_group` for a wrapper whose outputs time `.cpu()`;
    the calls themselves are unchanged.  Uploads a thread makes before
    its find's three (the Preemptor's first build uploads its candidate
    matrices) are kept apart."""

    def __init__(self):
        import threading
        self.records = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def _up(self, dt):
        ups = getattr(self._local, "ups", None)
        if ups is None:
            ups = self._local.ups = []
        ups.append(dt)

    def install(self):
        import torch
        from nomad_tpu_torch.scheduler import preemption as pre
        split = self

        class Upload:
            def __init__(self, t):
                self._t = t

            def to(self, *a, **k):
                t0 = time.perf_counter()
                out = self._t.to(*a, **k)
                split._up(time.perf_counter() - t0)
                return out

        class Read:
            def __init__(self, t, rec):
                self._t, self._rec = t, rec

            def cpu(self):
                t0 = time.perf_counter()
                out = self._t.cpu()
                self._rec["read_s"] += time.perf_counter() - t0
                return out

        class Torch:
            def __getattr__(self, name):
                return getattr(torch, name)

            def from_numpy(self, a):
                return Upload(torch.from_numpy(a))

        real = pre.preempt_for_task_group

        def kernel(*args, **kw):
            ups = getattr(self._local, "ups", [])
            self._local.ups = []
            t0 = time.perf_counter()
            met, picked, avail = real(*args, **kw)
            rec = dict(upload_s=sum(ups[-3:]), build_upload_s=sum(ups[:-3]),
                       launch_s=time.perf_counter() - t0, read_s=0.0)
            with self._lock:
                self.records.append(rec)
            return Read(met, rec), Read(picked, rec), avail

        self._saved = (pre.torch, pre.preempt_for_task_group)
        pre.torch, pre.preempt_for_task_group = Torch(), kernel

    def uninstall(self):
        from nomad_tpu_torch.scheduler import preemption as pre
        pre.torch, pre.preempt_for_task_group = self._saved

    def report(self, n, window, kernel_s):
        """One line over the first n finds (the window's); kernel_s: K6's
        device time in the window (the profiler's)."""
        recs = self.records[:n]
        if not recs:
            return "no find"
        parts = ("upload_s", "launch_s", "read_s")
        med = {k: statistics.median(r[k] for r in recs) for k in parts}
        tot = {k: sum(r[k] for r in recs) for k in parts}
        around = sum(tot.values())
        build = [r["build_upload_s"] for r in recs if r["build_upload_s"]]
        return (f"{len(recs)} finds; medians: uploads "
                f"{med['upload_s'] * 1e3:.4f} ms, K6 launch "
                f"{med['launch_s'] * 1e3:.4f} ms, reads "
                f"{med['read_s'] * 1e3:.4f} ms, sum "
                f"{sum(med.values()) * 1e3:.4f} ms; sums: uploads "
                f"{tot['upload_s']:.4f} s, launches {tot['launch_s']:.4f} s, "
                f"reads {tot['read_s']:.4f} s, {around:.4f} s in all over "
                f"the workers (K6 on the card {kernel_s:.6f} s) in the "
                f"{window:.3f} s window; {len(build)} Preemptor builds "
                f"uploaded their candidates in {sum(build):.4f} s")


def spine_preemption():
    """bench.py bench_preemption_heavy's shape at full size: 10,000 nodes
    in 50 racks filled to ~95% by three batch jobs of count 30,000
    (420 MHz / 850 MB) at priorities 20/30/40, then 10 service jobs of
    count 50 at priority 90 that can only land by preempting.  The
    window ends when the 500 are committed and the broker holds no ready
    eval; the victims' jobs then reschedule through preemption evals
    (priority 30 and 40 fillers preempt priority 20 ones) until the
    server stops, after which the state is checked.  Returns the
    kernels' launch counts of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import preempt as tk
    s = _server(PREEMPT_WORKERS)
    try:
        cfg = s.store.scheduler_config
        cfg.preemption_config.service_scheduler_enabled = True
        cfg.preemption_config.batch_scheduler_enabled = True
        for i in range(N_NODES):
            node = mock.node()
            node.attributes["rack"] = f"r{i % RACKS}"
            s.store.upsert_node(s.next_index(), node)

        def sized(j, count, prio):
            tg = j.task_groups[0]
            tg.count = count
            tg.tasks[0].resources.cpu = 420
            tg.tasks[0].resources.memory_mb = 850
            tg.ephemeral_disk.size_mb = 0
            j.priority = prio
            return j

        fillers = [sized(mock.batch_job(), N_NODES * 3, 20 + 10 * k)
                   for k in range(3)]
        t0 = time.perf_counter()
        for j in fillers:
            s.register_job(j)
        _wait_for(lambda: len(_running(s.store, fillers)) >= N_NODES * 9,
                  400, "the 90,000 filler allocs")
        fill_wall = time.perf_counter() - t0
        if not s.wait_for_idle(60):
            raise AssertionError("spine preemption: fill still in flight")
        log(f"spine preemption: {N_NODES * 9} filler allocs committed in "
            f"{fill_wall:.3f} s ({N_NODES * 9 / fill_wall:.1f} allocs/s)")

        services = [sized(mock.job(), 50, 90) for _ in range(10)]
        partial0 = s.applier.stats["partial"]
        workers = list(s.workers)      # stop() empties the server's list
        failures0 = _failures(workers)
        _reset_counts()
        tk.launches["preempt"] = 0
        acked0 = s.broker.stats["acked"]
        split = FindSplit()
        split.install()
        # the device's share of the window, from the device time the
        # profiler records (kernels and copies; CUDA activity only: the
        # workers' host work is not traced)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for j in services:
                s.register_job(j)
            _wait_for(lambda: len(_running(s.store, services)) >= 500, 300,
                      "the 500 priority-90 allocs")
            wall = time.perf_counter() - t0
            _wait_for(lambda: s.broker.ready_count() == 0, 300,
                      "no ready eval")
            launches = {**_counts(), "preempt": tk.launches["preempt"]}
            n_finds = len(split.records)
            evals = s.broker.stats["acked"] - acked0
            partial = s.applier.stats["partial"] - partial0
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        dev = {ev.key: (getattr(ev, "device_time_total", 0.0)
                        or getattr(ev, "cuda_time_total", 0.0))
               for ev in prof.key_averages()}
        dev_us = sum(dev.values())
        k6_s = sum(v for k, v in dev.items() if "preempt_kernel" in k) / 1e6
        busy = (f"{dev_us / 1e6 / window:.5f}" if dev_us > 0
                else "not measured (the profiler recorded no device time)")
        eng = s._engine
        t0 = time.perf_counter()
        s.stop()
        stop_s = time.perf_counter() - t0
        split.uninstall()
        log(f"spine preemption: the find split (host clock): "
            f"{split.report(n_finds, window, k6_s)}")
        # the window's failures and those of the cascade that ran on
        # until the stop
        causes = _failures(workers) - failures0
        _check_failures("spine preemption", causes)

        placed = len(_running(s.store, services))
        if placed != 500:
            raise AssertionError(f"spine preemption: {placed} of 500 "
                                 f"priority-90 allocs committed")
        victims = [a for a in s.store.allocs() if a.desired_status == "evict"]
        if not victims:
            raise AssertionError("spine preemption: nothing was preempted")
        by_id = {}
        for a in victims:
            by = by_id.get(a.preempted_by_allocation)
            if by is None:
                by = by_id[a.preempted_by_allocation] = \
                    s.store.alloc_by_id(a.preempted_by_allocation)
            if by is None or by.job.priority - a.job.priority < 10:
                raise AssertionError(
                    f"spine preemption: victim {a.id} (priority "
                    f"{a.job.priority}) not 10 below its preemptor "
                    f"{a.preempted_by_allocation!r} ("
                    f"{'missing' if by is None else by.job.priority})")
        pre_jobs = {e.job_id for e in s.store.evals()
                    if e.triggered_by == "preemption"}
        missing = {a.job_id for a in victims} - pre_jobs
        if missing:
            raise AssertionError(f"spine preemption: no preemption eval for "
                                 f"{sorted(missing)}")
        if launches["preempt"] == 0:
            raise AssertionError("spine preemption: K6 never launched")
        _check_spine(s, eng, "spine preemption")
        log(f"spine preemption: {PREEMPT_WORKERS} workers, {N_NODES} nodes "
            f"at ~95%: {placed} of 500 priority-90 allocs committed in "
            f"{wall:.3f} s: {placed / wall:.1f} allocs/s, "
            f"{evals / wall:.2f} evals/s ({evals} evals acked in the "
            f"window), {len(victims)} victims, {launches['preempt']} K6 "
            f"launches; launches {launches}; {partial} plans partly "
            f"rejected by the applier; evals failed by cause (window and "
            f"cascade, each redelivered) {dict(causes)}; device busy "
            f"share {busy} "
            f"({dev_us / 1e3:.3f} ms of device time in {window:.3f} s); "
            f"stopped in {stop_s:.1f} s; usage equals the allocs' sum, "
            f"device basis equals host snapshot")
        return launches
    finally:
        s.stop()


def phase_spine():
    """The dev-mode server spine (core/server.py) on the card: the e2e
    shape and its snapshot saved, restored into a fresh server that
    places more jobs, then the preemption shape."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_snapshot")
    try:
        path = os.path.join(tmp, "spine.snap")
        spine_e2e(path)
        spine_snapshot(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return spine_preemption()


# --------------------------------------------------------------- the lifecycle

# the loops' threads and the spine's: none may outlive Server.stop()
LOOP_THREADS = ("heartbeat", "heartbeat-batch", "deploy-watcher",
                "volume-watcher", "drainer", "periodic", "core-gc",
                "worker-", "plan-apply", "plan-commit", "eval-reaper",
                "dup-blocked-reaper")
LIFECYCLE_WORKERS = 16
LIFECYCLE_LOST = 100       # nodes the driver stops heartbeating
LIFECYCLE_DRAINED = 100    # nodes drained with a 30 s deadline


class FleetDriver(threading.Thread):
    """Keeps the registered nodes alive through Server.node_heartbeats,
    in chunks of 1,000 every 0.5 s (the reference's fleet driver,
    scenarios.py FleetDriver), and records the largest gap between the
    starts of two passes.  Nodes in `stopped` are left to expire."""

    def __init__(self, server, interval=0.5, chunk=1000):
        super().__init__(name="fleet-driver", daemon=True)
        self.server = server
        self.interval = interval
        self.chunk = chunk
        self.ids = []
        self.stopped = set()
        self.lock = threading.Lock()
        self.halt = threading.Event()
        self.passes = 0
        self.max_gap = 0.0
        self.last_start = None
        self.gen = 0              # bumped by every stop_nodes
        self.gen_end = {}         # gen -> end of the last pass under it
        self.errors = []

    def run(self):
        while not self.halt.is_set():
            t0 = time.monotonic()
            if self.last_start is not None:
                self.max_gap = max(self.max_gap, t0 - self.last_start)
            self.last_start = t0
            with self.lock:
                gen = self.gen
                ids = [i for i in self.ids if i not in self.stopped]
            try:
                for k in range(0, len(ids), self.chunk):
                    self.server.node_heartbeats(ids[k:k + self.chunk])
            except Exception as e:      # noqa: BLE001
                self.errors.append(repr(e))
            self.gen_end[gen] = time.time()
            self.passes += 1
            self.halt.wait(self.interval)

    def stop_nodes(self, ids):
        """Stop heartbeating `ids`; returns the wall-clock time of the
        end of the last pass that still included them."""
        with self.lock:
            self.stopped.update(ids)
            self.gen += 1
            gen = self.gen
        while gen not in self.gen_end:
            time.sleep(0.01)
        return self.gen_end[gen - 1]


class EventTap(threading.Thread):
    """One subscription to every topic, drained on its own thread: per
    step the (topic, type) counts, and the largest backlog seen."""

    def __init__(self, broker):
        super().__init__(name="event-tap", daemon=True)
        self.sub = broker.subscribe({"*": ["*"]}, max_queue=1 << 22)
        self.broker = broker
        self.step = "setup"
        self.seen = {}
        self.halt = threading.Event()
        self.max_backlog = 0
        self.down_seen = set()

    def run(self):
        while not self.halt.is_set():
            ev = self.sub.next(timeout=0.2)
            if ev is None:
                continue
            self.max_backlog = max(self.max_backlog, len(self.sub.queue))
            per = self.seen.setdefault(self.step, {})
            key = (ev.topic, ev.type)
            per[key] = per.get(key, 0) + 1
            if ev.topic == "Node" and getattr(ev.payload, "status", "") \
                    == "down":
                self.down_seen.add(ev.key)

    def finish(self):
        deadline = time.time() + 30
        while self.sub.queue and time.time() < deadline:
            time.sleep(0.05)
        self.halt.set()
        self.join(5)
        return self.broker.stats()["subs"][0]


# the loggers of the control loops (a worker's failed eval is read from
# Worker.failures instead, by cause)
LOOP_LOGGERS = tuple(f"nomad_tpu_torch.core.{m}" for m in (
    "heartbeat", "drainer", "deployments", "volumes", "periodic",
    "core_gc", "events", "server"))


class ErrorRecords(logging.Handler):
    """ERROR records of the control loops' loggers (a loop that catches
    and logs must not hide a failure while the run exits 0)."""

    def __init__(self):
        super().__init__(level=logging.ERROR)
        self.records = []

    def emit(self, record):
        exc = record.exc_info[1] if record.exc_info else None
        self.records.append(f"{record.name}: {record.getMessage()}"
                            + (f": {exc!r}" if exc is not None else ""))


def _lifecycle_state(s, jobs, driver, errors):
    """A failed wait's context: the broker, blocked evals, the applier,
    the evals not terminal, and every thread's stack (on stderr)."""
    import faulthandler
    from collections import Counter
    live = Counter(e.status + "/" + e.triggered_by
                   for e in s.store.evals() if not e.terminal())
    log(f"lifecycle state: running {len(_running(s.store, jobs))}; broker "
        f"ready {s.broker.ready_count()} unacked "
        f"{s.broker.unacked_count()} stats {dict(s.broker.stats)}; "
        f"blocked {s.blocked_evals.blocked_count()}; plan queue "
        f"{s.plan_queue.depth()}; applier {dict(s.applier.stats)}; evals "
        f"not terminal {dict(live)}; failures "
        f"{dict(_failures(s.workers))}; driver passes {driver.passes}, "
        f"largest gap {driver.max_gap:.3f} s; nodes "
        f"{Counter(n.status for n in s.store.nodes())}; ERROR records "
        f"{errors.records[:3]}")
    faulthandler.dump_traceback(sys.stderr, all_threads=True)


def _live_on(store, node_id):
    return [a for a in store.allocs_by_node(node_id)
            if not a.terminal_status()]


def _report_healthy(s, allocs):
    from nomad_tpu_torch.raft import MessageType
    updates = []
    for a in allocs:
        u = a.copy()
        u.client_status = "running"
        u.deployment_status = {"healthy": True}
        updates.append(u)
    if updates:
        s.apply(MessageType.ALLOC_CLIENT_UPDATE, {"allocs": updates})


def phase_lifecycle():
    """The dev-mode server's control loops on the card at fleet size:
    Server(device="cuda") with 16 workers and the default 10 s
    heartbeat TTL, NOMAD_TPU_FLEET_AGENTS (10,000) nodes kept alive by a
    FleetDriver thread, 100 C2M batch jobs (K4), 20 rack-spread service
    jobs of count 50 (K3), one of them with a canary, auto-promote,
    auto-revert update strategy; then expiry, drain, a rolling deploy,
    scale, periodic, core GC and the event stream.  Returns the K3, K4
    and K5 launch counts of the phase."""
    from nomad_tpu_torch import knobs, mock
    from nomad_tpu_torch.core.periodic import next_cron_after
    from nomad_tpu_torch.core.server import Server, ServerConfig
    from nomad_tpu_torch.raft import MessageType
    from nomad_tpu_torch.structs.job import (PeriodicConfig, Spread,
                                             UpdateStrategy)
    n_nodes = knobs.get_int("NOMAD_TPU_FLEET_AGENTS")
    errors = ErrorRecords()
    for name in LOOP_LOGGERS:
        logging.getLogger(name).addHandler(errors)
    before = set(threading.enumerate())
    t_phase = time.perf_counter()
    steps = {}

    def step(name, t0):
        steps[name] = time.perf_counter() - t0
        log(f"lifecycle: step {name}: {steps[name]:.3f} s")

    _reset_counts()
    # an eval that fails at the scheduler's attempt limit (a node went
    # down or was drained under an in-flight plan) is retried after 2 s
    # instead of the default 60 s, so the phase fits its budget
    s = Server(ServerConfig(num_schedulers=LIFECYCLE_WORKERS,
                            failed_eval_followup_delay=2.0),
               device="cuda")
    batches = []
    apply = s.apply

    def counting(msg_type, payload):
        if msg_type == MessageType.NODE_HEARTBEAT_BATCH:
            batches.append([(u["node_id"], u["status"])
                            for u in payload["updates"]])
        return apply(msg_type, payload)
    s.apply = counting
    s.start()
    tap = EventTap(s.event_broker)
    tap.start()
    driver = FleetDriver(s)
    driver.start()
    workers = list(s.workers)
    failures0 = _failures(workers)
    state_jobs = []
    try:
        # ---- setup: the fleet, then the load
        t0 = time.perf_counter()
        for i in range(n_nodes):
            node = mock.node()
            node.attributes["rack"] = f"r{i % RACKS}"
            s.register_node(node)
            with driver.lock:
                driver.ids.append(node.id)
        log(f"lifecycle: {n_nodes} nodes registered in "
            f"{time.perf_counter() - t0:.3f} s")
        c2m = [_c2m_job(mock) for _ in range(100)]
        spread = []
        for k in range(20):
            j = mock.job()
            j.task_groups[0].count = 50
            j.task_groups[0].spreads = [Spread("${attr.rack}", 100, ())]
            if k == 0:
                j.update = UpdateStrategy(max_parallel=5, canary=1,
                                          auto_promote=True,
                                          auto_revert=True)
                j.task_groups[0].update = None
            else:
                j.update = None
                j.task_groups[0].update = None
            spread.append(j)
        rolling, scaled = spread[0], spread[1]
        jobs = c2m + spread
        state_jobs[:] = jobs
        for j in jobs:
            s.register_job(j)
        _wait_for(lambda: len(_running(s.store, jobs)) >= 11000, 300,
                  "the 11,000 allocs of the load")
        if not s.wait_for_idle(120):
            raise AssertionError("lifecycle: the load still in flight")
        # v0 of the rolling job healthy and stable: its rollback target
        _report_healthy(s, _running(s.store, [rolling]))
        _wait_for(lambda: s.store.job_by_id("default", rolling.id).stable,
                  60, "v0 of the rolling job stable")
        step("setup", t0)

        # ---- 1. expiry
        t0 = time.perf_counter()
        tap.step = "expiry"
        held = sorted({a.node_id for a in _running(s.store, jobs)})
        victims = held[:: max(1, len(held) // LIFECYCLE_LOST)][
            :LIFECYCLE_LOST]
        on_victims = {a.id for v in victims for a in _live_on(s.store, v)}
        nb0 = len(batches)
        last_hb = driver.stop_nodes(victims)
        _wait_for(lambda: all(s.store.node_by_id(v).status == "down"
                              for v in victims), 60,
                  f"the {len(victims)} stopped nodes to go down")
        down_at = {v: s.store.node_by_id(v).modify_index for v in victims}
        down_entries = sum(1 for b in batches[nb0:]
                           if any(st == "down" for _, st in b))
        _wait_for(lambda: all(s.store.alloc_by_id(i).client_status == "lost"
                              for i in on_victims)
                  and len(_running(s.store, jobs)) >= 11000
                  and s.wait_for_idle(1.0), 120,
                  "the down nodes' allocs lost and replaced")
        last_commit = time.time()
        lost = [s.store.alloc_by_id(i) for i in on_victims]
        log(f"lifecycle: expiry: {len(victims)} nodes down through "
            f"{down_entries} NODE_HEARTBEAT_BATCH entries carrying down "
            f"transitions ({len(batches) - nb0} batch entries in the "
            f"step), {len(lost)} allocs lost and replaced (11,000 "
            f"live again); "
            f"{last_commit - last_hb:.3f} s from the last heartbeat to "
            f"the last replacement committed")
        if down_entries >= len(victims):
            raise AssertionError(f"lifecycle: {down_entries} batch entries "
                                 f"for {len(victims)} expiries")
        step("expiry", t0)

        # ---- 2. drain
        t0 = time.perf_counter()
        tap.step = "drain"
        others = [n for n in held if n not in set(victims)]
        drained = others[:: max(1, len(others) // LIFECYCLE_DRAINED)][
            :LIFECYCLE_DRAINED]
        drain_at = {}
        for n in drained:
            s.drainer.drain_node(n, deadline_s=30.0)
            drain_at[n] = s.store.latest_index

        def drained_done():
            for n in drained:
                node = s.store.node_by_id(n)
                if node.drain_strategy is not None \
                        or node.scheduling_eligibility != "ineligible" \
                        or _live_on(s.store, n):
                    return False
            return True
        _wait_for(drained_done, 120, "the drained nodes to empty")
        _wait_for(lambda: s.wait_for_idle(1.0)
                  and len(_running(s.store, jobs)) >= 11000, 120,
                  "the migrated allocs")
        forced = sum(1 for n in drained for a in s.store.allocs_by_node(n)
                     if "drain deadline" in (a.desired_description or ""))
        log(f"lifecycle: drain: {len(drained)} nodes empty, ineligible, "
            f"strategy cleared; {forced} allocs force-stopped at the "
            f"deadline")
        step("drain", t0)

        # ---- 3. rolling deploy
        t0 = time.perf_counter()
        tap.step = "deploy"
        v1 = s.store.job_by_id("default", rolling.id).copy()
        v1.task_groups[0].tasks[0].config = {"command": "/bin/v1"}
        s.register_job(v1)
        version = s.store.job_by_id("default", rolling.id).version
        statuses = []

        def deployed():
            d = s.store.latest_deployment_by_job_id("default", rolling.id)
            if d is None or d.job_version != version:
                return False
            if not statuses or statuses[-1] != d.status:
                statuses.append(d.status)
            if d.status == "successful":
                return True
            if d.status in ("failed", "cancelled"):
                raise AssertionError(f"lifecycle: the deployment ended "
                                     f"{d.status}: {d.status_description}")
            _report_healthy(s, [a for a in s.store.allocs_by_job(
                "default", rolling.id) if a.deployment_id == d.id
                and not a.terminal_status() and not a.is_healthy()])
            return False
        _wait_for(deployed, 120, "the rolling deployment")
        _wait_for(lambda: s.store.job_by_id("default", rolling.id).stable,
                  30, "v1 stable")
        if not s.wait_for_idle(60):
            raise AssertionError("lifecycle: deploy evals in flight")
        live_v1 = [a for a in _running(s.store, [rolling])
                   if a.job.version == version]
        log(f"lifecycle: deploy: v{version} SUCCESSFUL and stable, "
            f"statuses {statuses}, {len(live_v1)} of 50 live allocs on "
            f"v{version}")
        if len(live_v1) != 50:
            raise AssertionError(f"lifecycle: {len(live_v1)} of 50 allocs "
                                 f"on v{version}")
        step("deploy", t0)

        # ---- 4. scale
        t0 = time.perf_counter()
        tap.step = "scale"
        group = scaled.task_groups[0].name
        for count in (80, 40):
            s.scale_job("default", scaled.id, group, count,
                        message=f"to {count}")
            _wait_for(lambda: s.wait_for_idle(1.0) and len(
                _running(s.store, [scaled])) == count, 60,
                f"the scaled job at {count}")
        st = s.job_scale_status("default", scaled.id)["task_groups"][group]
        counts = [e.count for e in sorted(st["events"],
                                          key=lambda e: e.time)]
        if (st["desired"], st["placed"]) != (40, 40) \
                or counts[-2:] != [80, 40]:
            raise AssertionError(f"lifecycle: job_scale_status {st}")
        step("scale", t0)

        # ---- 5. periodic
        t0 = time.perf_counter()
        tap.step = "periodic"
        p = mock.batch_job()
        p.task_groups[0].count = 10
        p.periodic = PeriodicConfig(spec="0 0 1 1 *")
        s.register_job(p)
        s.periodic.dispatch_due(time.time())        # arms the job
        fire1 = next_cron_after(p.periodic.spec, time.time())
        fire2 = next_cron_after(p.periodic.spec, fire1)
        children = (s.periodic.dispatch_due(fire1)
                    + s.periodic.dispatch_due(fire2))
        if len(children) != 2:
            raise AssertionError(f"lifecycle: periodic launched {children}")
        kids = [s.store.job_by_id("default", c) for c in children]
        _wait_for(lambda: s.wait_for_idle(1.0)
                  and len(_running(s.store, kids)) == 20, 60,
                  "both periodic children placed")
        step("periodic", t0)

        # ---- the state at a quiescent point
        if not s.wait_for_idle(60):
            raise AssertionError("lifecycle: evals in flight")
        _check_spine(s, s._engine, "lifecycle")
        launches = _counts()
        went_down = sorted(n.id for n in s.store.nodes()
                           if n.status != "ready" and n.id not in victims)
        if went_down or (tap.down_seen - set(victims)):
            raise AssertionError(f"lifecycle: nodes the driver kept alive "
                                 f"went down: {went_down[:5]} "
                                 f"{sorted(tap.down_seen - set(victims))[:5]}")
        marks = dict(down_at)
        marks.update(drain_at)
        bad = [a.id for n, idx in marks.items()
               for a in s.store.allocs_by_node(n) if a.create_index > idx]
        if bad:
            raise AssertionError(f"lifecycle: {len(bad)} allocs placed on "
                                 f"a down or ineligible node")

        # ---- 6. GC and events
        t0 = time.perf_counter()
        tap.step = "gc"
        for j in c2m[:10] + kids:
            s.deregister_job(j.namespace, j.id)
        if not s.wait_for_idle(60):
            raise AssertionError("lifecycle: deregistrations in flight")
        gc = s.core_scheduler.process("force-gc", force=True)
        left_down = [n.id for n in s.store.nodes() if n.status == "down"]
        if left_down or gc["nodes"] != len(victims) or gc["jobs"] < 12 \
                or gc["evals"] == 0:
            raise AssertionError(f"lifecycle: force-gc {gc}, "
                                 f"{len(left_down)} down nodes left")
        step("gc", t0)
    except Exception:
        _lifecycle_state(s, state_jobs, driver, errors)
        raise
    finally:
        driver.halt.set()
        driver.join(10)
        t0 = time.perf_counter()
        s.stop()
        stop_s = time.perf_counter() - t0
        sub = tap.finish()
        for name in LOOP_LOGGERS:
            logging.getLogger(name).removeHandler(errors)
    left = sorted(t.name for t in threading.enumerate()
                  if t not in before and t.name.startswith(LOOP_THREADS))
    if left:
        raise AssertionError(f"lifecycle: threads outlived stop(): {left}")
    causes = _failures(workers) - failures0
    _check_failures("lifecycle", causes)
    if errors.records:
        raise AssertionError(f"lifecycle: ERROR records: "
                             f"{errors.records[:5]}")
    if driver.errors:
        raise AssertionError(f"lifecycle: driver errors {driver.errors[:3]}")
    if sub["dropped"] != 0:
        raise AssertionError(f"lifecycle: the subscription dropped "
                             f"{sub['dropped']} events")
    silent = [k for k in steps if not tap.seen.get(k)]
    if silent:
        raise AssertionError(f"lifecycle: the subscription saw nothing in "
                             f"{silent}")
    for name in ("place_batch", "place_bulk_batch", "set_rows"):
        if launches[name] == 0:
            raise AssertionError(f"lifecycle: {name} never launched")
    log(f"lifecycle: {n_nodes} nodes, {LIFECYCLE_WORKERS} workers: the "
        f"driver's largest gap between passes {driver.max_gap:.3f} s over "
        f"{driver.passes} passes; the subscription delivered "
        f"{sub['delivered']} events, dropped {sub['dropped']}, largest "
        f"backlog {tap.max_backlog}; per step "
        f"{ {k: sum(v.values()) for k, v in tap.seen.items()} }; evals "
        f"failed by cause {dict(causes)}; launches K3 "
        f"{launches['place_batch']}, K4 {launches['place_bulk_batch']}, "
        f"K5 set_rows {launches['set_rows']}; stopped in {stop_s:.1f} s; "
        f"phase {time.perf_counter() - t_phase:.1f} s; usage equals the "
        f"allocs' sum, device basis equals host snapshot, no thread left")
    return {k: launches[k] for k in ("place_batch", "place_bulk_batch",
                                     "set_rows")}


# --------------------------------------------------------------- the bench

# the native module's functions the parent tree also has, swapped for
# the parent's own in its turns
PARENT_NATIVE = ("ports_check", "ports_set", "validate_plan",
                 "expand_pairs", "format_uuids", "scatter_add_rank1")
# the calls whose count and host time the C2M turns split
CLOCKED = ("scatter_add_rank1", "expand_pairs")


def _parent_native():
    """The parent tree's nomad_tpu_torch/native.py (PARENT_TREE) as a
    module of its own, or None where there is no parent tree."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        PARENT_TREE, "nomad_tpu_torch", "native.py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location("parent_native", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class NativeClock:
    """While installed, nomad_tpu_torch.native's PARENT_NATIVE functions
    are `impl`'s (the parent's, or this tree's own), and each CLOCKED
    call is counted and timed on the host clock, split by thread: the
    engine's dispatcher ("placement-engine", whose resolve is the
    engine's resolve_s) and every other thread (workers, applier)."""

    def __init__(self, impl):
        import threading
        self.impl = impl
        self.lock = threading.Lock()
        self.stats = {}             # (name, "resolve" | "other") -> [n, s]

    def _clocked(self, name, fn):
        import threading

        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                where = ("resolve" if threading.current_thread().name ==
                         "placement-engine" else "other")
                with self.lock:
                    st = self.stats.setdefault((name, where), [0, 0.0])
                    st[0] += 1
                    st[1] += dt
        return call

    @contextlib.contextmanager
    def installed(self):
        from nomad_tpu_torch import native
        saved = {n: getattr(native, n) for n in PARENT_NATIVE}
        try:
            for n in PARENT_NATIVE:
                fn = getattr(self.impl, n)
                setattr(native, n, self._clocked(n, fn) if n in CLOCKED
                        else fn)
            yield self
        finally:
            for n, fn in saved.items():
                setattr(native, n, fn)

    def split(self) -> str:
        return ", ".join(
            f"{n} {where} {c} calls {t:.3f} s ({t / c * 1e6:.1f} us a call)"
            for (n, where), (c, t) in sorted(self.stats.items()) if c)


def c2m_turn(turn, impl, main):
    """bench_c2m_1m at 10,000 nodes with 1,000 jobs (C2M-100K) with the
    native functions of `impl` (NativeClock): every alloc committed,
    device_stages there, the steady-state and fused checks clean, the
    device basis equal to its host snapshot.  The main turn's kernel
    counts are set to 0 just before it and read just after.  Returns
    (launches or None, the turn's record of resolve_s, put_s, the
    window, allocs/s and the clocked calls)."""
    from nomad_tpu_torch import bench
    rec = bench.Record()
    clock = NativeClock(impl)
    if main:
        _reset_counts()
    t0 = time.perf_counter()
    with clock.installed():
        rate, placed, want = bench.bench_c2m_1m(
            n_jobs=1000, deadline_s=300.0, device="cuda", rec=rec)
    wall = time.perf_counter() - t0
    launches = _counts() if main else None
    if placed != want:
        raise AssertionError(f"bench c2m ({turn}): {placed} of {want} "
                             f"committed")
    ds = rec.device_stages.get("c2m_1m")
    if ds is None:
        raise AssertionError(f"bench c2m ({turn}): no device_stages")
    steady = rec.steady_state["c2m_1m"]
    fused = bench.fused_check(rec, "c2m_1m")
    if rec.basis_matches_host.get("c2m_1m") is not True:
        raise AssertionError(f"bench c2m ({turn}): the device basis differs "
                             f"from the world's host snapshot after the "
                             f"window")
    if steady["violations"] or fused["violations"]:
        raise AssertionError(f"bench c2m ({turn}): {steady['violations']} "
                             f"{fused['violations']}")
    eng = rec.engine_snap["c2m_1m"]
    res = {"resolve_s": eng["resolve_s"], "put_s": eng["put_s"],
           "window_s": placed / rate, "allocs_s": rate,
           "clock": dict(clock.stats)}
    plan = rec.plan_stats["c2m_1m"]["submit_ms"]
    log(f"bench c2m_1m turn {turn} (10,000 nodes, 1,000 jobs x 10 groups x "
        f"count 10, 48 workers): {placed} of {want} allocs committed at "
        f"{rate:.1f} allocs/s, window {res['window_s']:.1f} s (scenario "
        f"{wall:.1f} s with world build, warmup and probe); resolve_s "
        f"{res['resolve_s']:.3f}, put_s {res['put_s']:.3f}; plan.submit p50 "
        f"{plan['p50']} ms p99 {plan['p99']} ms (n={plan['count']}); "
        f"steady state {steady['steady_reuploads']} re-uploads, "
        f"{steady['donated_carries']} donated carries; fused "
        f"{fused['bulk_parts']} parts for {fused['bulk_groups']} groups; "
        f"native calls: {clock.split()}")
    if main:
        log(f"bench c2m_1m device_stages: {json.dumps(ds)}")
    return launches, res


def phase_bench():
    """The port's bench entry point (nomad_tpu_torch/bench.py) on the
    card: C2M at 10,000 nodes with 1,000 jobs (100,000 allocs: BASELINE
    configs[2]'s C2M size, 10% of C2M-1M's jobs so the script keeps
    within its time limit) through the spine with 48 workers, then the
    stage probe (K8), in turns against the parent tree's native
    functions where PARENT_TREE holds one (parent, new, new, parent;
    the first new turn is the main path's); the scan-spread shape at
    full size (K3); and the 100,000-node kernel scenario (K4 at 131,072
    rows).  Every alloc must commit, device_stages must be there, the
    steady-state and fused checks must hold, and each path's kernels
    must launch.  Returns the launch counts of the main C2M turn (K8's
    are its probe's)."""
    from nomad_tpu_torch import bench
    from nomad_tpu_torch import native
    rec = bench.Record()

    parent = _parent_native()
    if parent is None:
        log(f"bench c2m_1m: turns against the parent's native functions "
            f"skipped (no tree under {PARENT_TREE})")
    turns = ("parent", "new", "new", "parent") if parent else ("new",)
    launches, results = None, {}
    for turn in turns:
        main = turn == "new" and launches is None
        got, res = c2m_turn(turn, parent if turn == "parent" else native,
                            main)
        launches = got if main else launches
        results.setdefault(turn, []).append(res)
    need = ["place_bulk_batch"] + list(STAGE_UNITS)
    if not all(launches[k] > 0 for k in need):
        raise AssertionError(f"bench c2m: a kernel of the path never "
                             f"launched: {launches}")
    log(f"bench c2m_1m main turn launches {launches}")
    for key in ("resolve_s", "put_s", "window_s", "allocs_s"):
        log(f"bench c2m_1m turns {key}: " + "; ".join(
            f"{turn} " + "/".join(f"{r[key]:.3f}" for r in rs)
            for turn, rs in results.items()))
    for turn, rs in results.items():
        for r in rs:
            calls = r["clock"].get(("scatter_add_rank1", "resolve"), [0, 0.0])
            log(f"bench c2m_1m turn {turn}: scatter_add_rank1 in the "
                f"engine's resolve {calls[0]} calls, {calls[1]:.3f} s = "
                f"{calls[1] / max(r['resolve_s'], 1e-9) * 100:.2f}% of "
                f"resolve_s "
                f"{r['resolve_s']:.3f}")

    # each K3 launch's chain length (E) and dims, from the engine's call
    from nomad_tpu_torch.parallel import engine as engine_mod
    k3, chains = engine_mod.place_batch_packed, []

    def logged_k3(capacity, used0, heavy, dyn, dims, **kw):
        chains.append((heavy.shape[0], tuple(int(x) for x in dims)))
        return k3(capacity, used0, heavy, dyn, dims, **kw)

    _reset_counts()
    engine_mod.place_batch_packed = logged_k3
    try:
        sp_rate = bench.bench_scan_spread(device="cuda", rec=rec)
    finally:
        engine_mod.place_batch_packed = k3
    sp_launches = _counts()
    got = rec.allocs["scan_spread"]
    if got["placed"] != got["want"] or sp_launches["place_batch"] == 0:
        raise AssertionError(f"bench scan-spread: {got}, launches "
                             f"{sp_launches}")
    plan = rec.plan_stats["scan_spread"]["submit_ms"]
    log(f"bench scan_spread (10,000 nodes, 60 spread+affinity service jobs "
        f"x 100, 48 workers): {got['placed']} of {got['want']} committed at "
        f"{sp_rate:.1f} allocs/s; plan.submit p50 {plan['p50']} ms p99 "
        f"{plan['p99']} ms; launches {sp_launches}")
    log(f"bench scan_spread K3 chains (E, (G, N, K, V1, S, D)) in launch "
        f"order: {chains}")

    _reset_counts()
    traj = bench.bench_kernel_100k_nodes(device="cuda")
    k_launches = _counts()
    if traj["placed"] != traj["want"] or not traj["basis_matches_host"] \
            or k_launches["place_bulk_batch"] == 0:
        raise AssertionError(f"bench kernel_100k_nodes: {traj}, launches "
                             f"{k_launches}")
    log(f"bench kernel_100k_nodes: {json.dumps(traj)}; launches "
        f"{k_launches}")
    return launches


# --------------------------------------------------------- the sharded path

# the meshes of one card repeated: (node_shard, wave)
SHARD_SHAPES = ((8, 1), (4, 2))
# K7 wrapper (ops/sharded.py) -> (json name, the reference's jitted function)
K7_UNITS = {
    "scan_local": ("shard_scan_local",
                   "nomad_tpu/parallel/sharded.py:434"),
    "scan_apply": ("shard_scan_apply",
                   "nomad_tpu/parallel/sharded.py:434"),
    "bulk_stats": ("shard_bulk_stats",
                   "nomad_tpu/parallel/sharded.py:485"),
    "bulk_run": ("shard_bulk_run", "nomad_tpu/parallel/sharded.py:485"),
    "bulk_order": ("shard_bulk_order",
                   "nomad_tpu/parallel/sharded.py:485"),
    "basis_merge": ("shard_basis_merge",
                    "nomad_tpu/parallel/sharded.py:485"),
}
LOAD_JOBS = 300      # C2M jobs of the load run (C2M-1M has 10,000)


def _mesh(shape):
    from nomad_tpu_torch.parallel import sharded as ps
    return ps.make_mesh(shape[1], shape[0], devices=["cuda:0"] * 8)


def _bits(t):
    import torch
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# K7 wrappers whose state ends in scratch only the kernel keeps (K7a's
# row cache): restored with the state, not compared with the plain
# version's, which has none
_SCRATCH = {"scan_local": 1}


def _state_of(name, args):
    """The tensors a K7 call may read after another call changed them or
    may write: restored before each timed launch, compared after (but the
    last _SCRATCH[name])."""
    from nomad_tpu_torch.ops import sharded as k7
    if name == "scan_local":
        sh, recs = args[0], args[6]
        return [sh.used, sh.tg_count, sh.place_cap, sh.counts, recs, sh.pick,
                sh.cache]
    if name == "scan_apply":
        sh, recs, out = args[0], args[2], args[3]
        return [sh.used, sh.tg_count, sh.place_cap, sh.counts, recs,
                sh.pick] + ([out] if out is not None else [])
    if name in ("bulk_stats", "bulk_run", "bulk_order"):
        sh = args[0]
        assert isinstance(sh, k7.BulkShard)
        extra = [args[3], args[4]] if name == "bulk_stats" else \
            [args[2], args[3], args[4]]
        return [sh.used, sh.exact, sh.delta, sh.coll, sh.assign, sh.scores,
                sh.partial, sh.state, sh.fits] + extra
    # basis_merge: u0, exacts, out, and node shard 0's partials and counts
    return [a for a in args if a is not None]


class K7Check:
    """Wraps ops/sharded.py's kernel wrappers while a sharded function
    runs on the card: each call runs the kernel, then, from the same
    state restored, its plain version on the same tensors, and requires
    every state tensor bit-equal (but K7a's cache, which only the kernel
    keeps: restored, not compared).  The first step of each kernel
    across the mesh (its launch on every node shard of one lane; a scan
    slot past the first for K7a; K7g's first, node shard 0's, carrying
    K7f's counts) is kept for timing.  These launches are the
    comparison's, not a path's."""

    def __init__(self, shape=(1, 1)):
        from nomad_tpu_torch.ops import sharded as k7
        self.k7 = k7
        self.seen = {n: 0 for n in K7_UNITS}
        self.step = {n: shape[0] for n in K7_UNITS}
        self.kept = {n: [] for n in K7_UNITS}
        self.orig = {n: getattr(k7, n) for n in K7_UNITS}

    def __enter__(self):
        for n in K7_UNITS:
            setattr(self.k7, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.k7, n, fn)

    def _wrap(self, name):
        import torch
        kern = self.orig[name]
        plain = getattr(self.k7, name + "_plain")

        def call(*args):
            state = _state_of(name, args)
            before = [t.clone() for t in state]
            kern(*args)
            torch.cuda.synchronize()
            after = [t.clone() for t in state]
            for t, b in zip(state, before):
                t.copy_(b)
            plain(*args)
            torch.cuda.synchronize()
            compared = len(state) - _SCRATCH.get(name, 0)
            for k, (t, a) in enumerate(zip(state, after)):
                if k < compared and not torch.equal(_bits(t), _bits(a)):
                    raise AssertionError(f"{name}: kernel and plain differ "
                                         f"in state tensor {k}")
                t.copy_(a)
            self.seen[name] += 1
            kept = self.kept[name]
            if len(kept) < self.step[name] and (
                    kept or name != "scan_local" or args[1] != 0):
                kept.append((args, state, before))
        return call

    def timed(self, name, reps=20):
        """(kernel ms, plain ms) a launch of the kept step (step_ms)."""
        calls = self.kept[name]
        return (step_ms(calls, self.orig[name], reps),
                step_ms(calls, getattr(self.k7, name + "_plain"), reps))

    def device(self, name):
        """The kernel alone, ms a launch over the kept step (profiler)."""
        return step_device_ms(self.kept[name], self.orig[name],
                              f"{name}_kernel")

    def host(self, name):
        """The wrapper's host time, us a launch over the kept step."""
        return step_host_us(self.kept[name], self.orig[name])


def restore(calls):
    """The state of a step `calls` [(args, state, state before)] as it was
    before it (restored in reverse call order, so buffers the shards
    share end as they were before the step's first call)."""
    for _, state, before in reversed(calls):
        for t, b in zip(state, before):
            t.copy_(b)


def step_ms(calls, fn, reps=20):
    """CUDA-event time a launch of fn over the step `calls` (its launches
    one after another, over their count), median of `reps`, the state
    restored before each repetition outside the timed events."""
    import torch
    times = []
    for r in range(reps + 2):
        restore(calls)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for args, _, _ in calls:
            fn(*args)
        e.record()
        e.synchronize()
        if r >= 2:
            times.append(s.elapsed_time(e))
    return statistics.median(times) / len(calls)


def step_host_us(calls, fn, reps=20):
    """The host time of fn's launches over the step `calls` (the
    wrapper's Python and the launch, the queue drained before each
    repetition), us a launch, median of `reps`."""
    import torch
    times = []
    for r in range(reps + 2):
        restore(calls)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for args, _, _ in calls:
            fn(*args)
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        if r >= 2:
            times.append(t / len(calls) * 1e6)
    return statistics.median(times)


def step_device_ms(calls, fn, kernel):
    """The device time of the CUDA kernels named `kernel`, ms a launch,
    over steps of fn (torch.profiler)."""
    def step():
        restore(calls)
        for args, _, _ in calls:
            fn(*args)
    return kernel_device_ms(step, kernel)


def _k7_work(name, args) -> tuple:
    """(bytes, float operations) one K7 launch needs on the kept call's
    data: its inputs read and outputs written once."""
    from nomad_tpu_torch.ops import sharded as k7
    if name == "scan_local":
        sh = args[0]
        n = sh.capacity.shape[0]
        G, K = sh.spread_wfrac.shape
        V1 = sh.spread_desired.shape[2]
        nbytes = (n * 32 + G * n * 14 + G * K * n * 4 + G * K * V1 * 8
                  + k7.SCAN_REC * 4)
        ops = n * (OPS_PER_SCAN_ROW + K * OPS_PER_SPREAD) \
            if bool(sh.slot_active[args[1]]) else 0
        return nbytes, ops
    if name == "scan_apply":
        return args[2].numel() * 4 + 32 + 15 * 4, 0
    if name in ("bulk_stats", "bulk_run", "bulk_order"):
        sh = args[0]
        n, N = sh.capacity.shape[0], sh.n_rows
        row = 16 + 16 + 1 + 4 + 1 + 4
        if name == "bulk_stats":
            return n * (row + 4) + 16, 2 * n * OPS_PER_CELL
        base = args[4][sh.off:sh.off + n].cpu().numpy()
        wave = int(np.count_nonzero(base))
        if name == "bulk_run":
            cells = int(base.sum()) + wave
            return (n * 8 + wave * row + 16 * args[2].shape[0],
                    cells * OPS_PER_CELL)
        return 8 * N + wave * 40, 0
    u0, exacts, out, *counts = args
    return ((exacts.numel() + 2 * u0.numel()) * 4
            + sum(t.numel() * 4 for t in counts if t is not None),
            2 * exacts.numel())


def _k7_bound(name, calls) -> tuple:
    """A K7 kernel's bound a launch, over the kept step's launches on all
    its shards: their bytes over the card's memory rate, or their float
    operations over its f32 rate, the larger, over the launch count."""
    work = [_k7_work(name, args) for args, _, _ in calls]
    bound, by = _bound(sum(w[0] for w in work), sum(w[1] for w in work))
    return bound / len(calls), by


def shard_scan_chain(seeds, S, with_deltas, main_path=True, n_rows=N_ROWS,
                     n_nodes=N_NODES, values=RACKS):
    """place_batch_sharded operands over n_rows rows: a chain of scan
    evals (scan_inputs of `seeds`, spread over `values` values), the slot
    axis padded to S, each eval with deltas or none; and the K3 operands
    of the same chain."""
    from nomad_tpu_torch.ops import place as tp
    rng = np.random.default_rng(seeds[0])
    evals = [scan_inputs(sd, main_path, n_rows, n_nodes, values)
             for sd in seeds]
    cap, used = evals[0]["capacity"], evals[0]["used"]
    E = len(evals)
    fields = {}
    for name in evals[0]:
        if name in ("capacity", "used"):
            continue
        arrs = [f[name] for f in evals]
        if name in ("demand", "slot_tg", "slot_active"):
            arrs = [np.concatenate([a, np.zeros((S - a.shape[0],)
                                                + a.shape[1:], a.dtype)])
                    for a in arrs]
        fields[name] = np.stack(arrs)
    drows = np.full((E, DELTA_BUCKET), n_rows, np.int32)
    dvals = np.zeros((E, DELTA_BUCKET, 4), np.float32)
    deltas = []
    for e in range(E):
        ds = _deltas(rng, 3, n_nodes) if with_deltas else []
        deltas.append(ds)
        for d, (row, vec) in enumerate(ds):
            drows[e, d], dvals[e, d] = row, vec
    inps = [tp.PlaceInputs(**f) for f in evals]
    heavy = np.stack([tp.pack_heavy(i) for i in inps])
    dyn = np.concatenate([tp.pack_light(i, ds, DELTA_BUCKET, S)
                          for i, ds in zip(inps, deltas)])
    g, n, k, vp1 = tp.heavy_dims(inps[0])
    k3 = (cap, used, heavy, dyn, (g, n, k, vp1, S, DELTA_BUCKET))
    return (cap, used, fields, drows, dvals), k3


def check_shard_scan(shape, chk, label, seeds, S, with_deltas, main_path,
                     **world):
    """K7a/K7b on a mesh of the card repeated, every call checked against
    its plain version by `chk`; the whole function bit-equal to its plain
    form (the reference's function over the shard list) and equal to
    the unsharded K3 in node rows, counts and top-K rows.  `world`:
    shard_scan_chain's n_rows, n_nodes, values."""
    import torch
    from nomad_tpu_torch.ops import place as tp
    from nomad_tpu_torch.parallel import sharded as ps
    mesh = _mesh(shape)
    ops, k3 = shard_scan_chain(seeds, S, with_deltas, main_path, **world)
    with chk:
        packed, used = ps.place_batch_sharded(mesh, *ops)
    torch.cuda.synchronize()
    p_packed, p_used = ps.place_batch_sharded_plain(mesh, *ops)
    _bitwise(f"sharded scan {label} packed", packed.cpu().numpy(),
             p_packed.cpu().numpy())
    _bitwise(f"sharded scan {label} used", torch.cat(used).cpu().numpy(),
             torch.cat(p_used).cpu().numpy())
    t = lambda x: torch.from_numpy(np.array(x)).cuda()   # noqa: E731
    k3_packed, k3_used = tp.place_batch_packed(t(k3[0]), t(k3[1]), t(k3[2]),
                                               t(k3[3]), k3[4])
    got = tp.unpack_outputs(packed.cpu().numpy())
    single = tp.unpack_outputs(k3_packed.cpu().numpy())
    for i, nm in ((0, "node"), (3, "n_eval"), (4, "n_exh"),
                  (5, "top_nodes")):
        np.testing.assert_array_equal(got[i], single[i],
                                      err_msg=f"sharded scan {label} {nm}")
    err = max(float(np.max(np.abs(np.nan_to_num(got[i]) -
                                  np.nan_to_num(single[i]))))
              for i in (1, 2, 6))
    placed = int((got[0] >= 0).sum())
    if placed == 0:
        raise AssertionError(f"sharded scan {label}: nothing placed")
    log(f"sharded: scan {label} on {shape}, N={ops[0].shape[0]}: placed "
        f"{placed} slots; kernels "
        f"bit-equal to their plain versions ({chk.seen['scan_local']} K7a, "
        f"{chk.seen['scan_apply']} K7b calls checked) and the function to "
        f"its plain form; rows, counts and top-K equal the unsharded K3 "
        f"(scores max |diff| {err:.3g})")
    return err


def check_shard_eval_batch(shape, chk):
    """place_eval_batch_sharded (independent evals, the batch over the
    wave lanes) on a mesh of the card repeated at N = 16,384: K7a/K7b
    checked by `chk`, the function bit-equal to its plain form, and each
    eval's node rows, counts and top-K equal to the single-eval K2's."""
    import torch
    from nomad_tpu_torch.convert import place_inputs_from_numpy
    from nomad_tpu_torch.ops import place as tp
    from nomad_tpu_torch.parallel import sharded as ps
    mesh = _mesh(shape)
    evals = [scan_inputs(47 + b, main_path=False) for b in range(2)]
    stacked = ps.stack_inputs([tp.PlaceInputs(**f) for f in evals])
    with chk:
        got = ps.place_eval_batch_sharded(mesh, stacked)
    torch.cuda.synchronize()
    plain = ps.place_eval_batch_sharded_plain(mesh, stacked)
    for k, (x, y) in enumerate(zip(got, plain)):
        _bitwise(f"sharded eval batch output {k}", x.cpu().numpy(),
                 y.cpu().numpy())
    for b, f in enumerate(evals):
        packed, _ = tp.place_eval_packed(place_inputs_from_numpy(f, "cuda"))
        single = tp.unpack_outputs(packed.cpu().numpy())
        for i in (0, 3, 4, 5):
            np.testing.assert_array_equal(got[i][b].cpu().numpy(), single[i],
                                          err_msg=f"sharded eval batch {b}")
    log(f"sharded: eval batch of 2 mixed evals on {shape}: bit-equal to its "
        f"plain form, rows, counts and top-K equal the single-eval K2")


def shard_bulk_lanes(seed, W, E, n_rows=N_ROWS, n_nodes=N_NODES, count=10,
                     fresh=False):
    """place_bulk_batch_sharded operands: W lanes of E C2M groups (count
    `count`, 30 MHz/60 MB, random feasibility and co-placements, deltas
    on every other eval; the last lane one eval short, padded with a
    count-0 eval); fresh: an empty cluster and no co-placements."""
    rng = np.random.default_rng(seed)
    a = bulk_inputs(seed, True, n_rows, n_nodes)
    if fresh:
        a["used"][:] = 0.0
    f = dict(feasible=np.zeros((W, E, n_rows), bool),
             affinity=np.zeros((W, E, n_rows), np.float32),
             has_affinity=np.zeros((W, E), bool),
             desired=np.ones((W, E), np.int32),
             penalty=np.zeros((W, E, n_rows), bool),
             coll0=np.zeros((W, E, n_rows), np.int32),
             demand=np.zeros((W, E, 4), np.float32),
             count=np.zeros((W, E), np.int32),
             delta_rows=np.full((W, E, DELTA_BUCKET), n_rows, np.int32),
             delta_vals=np.zeros((W, E, DELTA_BUCKET, 4), np.float32))
    for w in range(W):
        for e in range(E - (1 if w == W - 1 and W > 1 else 0)):
            f["feasible"][w, e, :n_nodes] = rng.random(n_nodes) < 0.95
            if not fresh:
                f["coll0"][w, e, rng.choice(n_nodes, 20, replace=False)] = 1
            f["demand"][w, e] = a["demand"]
            f["count"][w, e] = f["desired"][w, e] = count
            if e % 2 and not fresh:
                for d, (row, vec) in enumerate(_deltas(rng, 3, n_nodes)):
                    f["delta_rows"][w, e, d], f["delta_vals"][w, e, d] = \
                        row, vec
    return a["cap"], a["used"], f


SHARD_BULK_ORDER = ("feasible", "affinity", "has_affinity", "desired",
                    "penalty", "coll0", "demand", "count", "delta_rows",
                    "delta_vals")


def check_shard_bulk(shape, chk, label, lanes, fill_grid):
    """K7c-K7g on a mesh of the card repeated, every call checked against
    its plain version by `chk`; the whole function bit-equal to its plain
    form; each lane equal to the unsharded K4 chain of its evals in rows,
    counts, placed/n_eval/n_exh and waves; the merged basis against the
    host rank-1 update of every lane's placements.  Returns the largest
    difference of that basis (0 where bit-equal)."""
    import torch
    from nomad_tpu_torch import native
    from nomad_tpu_torch.ops import place as tp
    from nomad_tpu_torch.parallel import sharded as ps
    mesh = _mesh(shape)
    cap, used, f = lanes
    args = [f[k] for k in SHARD_BULK_ORDER]
    with chk:
        out = ps.place_bulk_batch_sharded(mesh, cap, used, *args,
                                          fill_grid=fill_grid, donate=True)
    torch.cuda.synchronize()
    plain = ps.place_bulk_batch_sharded_plain(mesh, cap, used, *args,
                                              fill_grid=fill_grid,
                                              donate=True)
    got = [x.cpu().numpy() for x in out[:6]]
    for k, (x, y) in enumerate(zip(got, plain[:6])):
        _bitwise(f"sharded bulk {label} output {k}", x, y.cpu().numpy())
    merged = torch.cat(out[6]).cpu().numpy()
    _bitwise(f"sharded bulk {label} merged basis", merged,
             torch.cat(plain[6]).cpu().numpy())
    t = lambda x: torch.from_numpy(np.array(x)).cuda()   # noqa: E731
    W, E, n = f["feasible"].shape
    host = used.copy()
    for w in range(W):
        heavy = np.stack([tp.pack_bulk_heavy(f["feasible"][w, e],
                                             f["affinity"][w, e],
                                             f["penalty"][w, e],
                                             f["coll0"][w, e])
                          for e in range(E)])
        dyn = np.concatenate([tp.pack_bulk_light(
            f["has_affinity"][w, e], f["desired"][w, e], f["count"][w, e],
            f["demand"][w, e],
            [(int(r), f["delta_vals"][w, e, d])
             for d, r in enumerate(f["delta_rows"][w, e]) if r < n],
            n, DELTA_BUCKET) for e in range(E)])
        k4, _ = tp.place_bulk_batch(t(cap), t(used), t(heavy), t(dyn),
                                    DELTA_BUCKET, fill_grid=fill_grid)
        single = tp.unpack_bulk_batch(k4.cpu().numpy(), n)
        np.testing.assert_array_equal(got[0][w], single[0],
                                      err_msg=f"sharded bulk {label} lane "
                                              f"{w} assign")
        for k, nm in ((2, "placed"), (3, "n_eval"), (4, "n_exh"),
                      (5, "waves")):
            np.testing.assert_array_equal(got[k][w], single[k],
                                          err_msg=f"sharded bulk {label} "
                                                  f"lane {w} {nm}")
        for e in range(E):
            rows = np.flatnonzero(got[0][w, e])
            native.scatter_add_rank1(host, rows, got[0][w, e][rows],
                                     f["demand"][w, e])
    if not np.array_equal(got[2], f["count"]):
        raise AssertionError(f"sharded bulk {label}: placed "
                             f"{got[2].tolist()} of {f['count'].tolist()}")
    diff = float(np.max(np.abs(merged - host)))
    log(f"sharded: bulk {label} on {shape}, N={n}: placed "
        f"{int(got[2].sum())} in {int(got[5].sum())} waves; kernels "
        f"bit-equal to their plain versions ({dict(chk.seen)} calls "
        f"checked) and the function to its plain form; every lane equals "
        f"the unsharded K4 in rows, counts and waves; merged basis vs host "
        f"rank-1 update max |diff| {diff:.3g}")
    return diff


def check_local_scatters(shape):
    """K5' (set_rows_local, add_rank1_local) on every shard of a mesh of
    the card repeated against their plain versions, bit for bit, at the
    world's buckets; returns the timed entries at B = 4,096 on shard 0."""
    import torch
    from nomad_tpu_torch.parallel import world as tw
    rng = np.random.default_rng(17)
    NS = shape[0]
    n = N_ROWS // NS
    base = np.zeros((N_ROWS, 4), np.float32)
    base[:N_NODES, 0] = rng.integers(0, 40, N_NODES) * 30
    base[:N_NODES, 1] = base[:N_NODES, 0] * 2 + 0.5
    t = lambda x: torch.from_numpy(np.array(x)).cuda()   # noqa: E731
    for b in tw.ROW_BUCKETS:
        rows = np.full(b, N_ROWS, np.int32)
        live = b * 3 // 4
        rows[:live] = rng.choice(N_NODES, live, replace=False)
        vals = (rng.random((b, 4)) * 5000).astype(np.float32)
        counts = rng.integers(-3, 40, b).astype(np.int32)
        dem = np.array([33.3, 70.7, 0.1, 5.0], np.float32)
        for i in range(NS):
            sh = base[i * n:(i + 1) * n]
            k = tw.set_rows_local(t(sh), t(rows), t(vals), i * n)
            p = tw.set_rows_plain(t(sh), t(rows), t(vals), i * n)
            _bitwise(f"set_rows_local B={b} shard {i}", k.cpu().numpy(),
                     p.cpu().numpy())
            k = tw.add_rank1_local(t(sh), t(rows), t(counts), t(dem), i * n)
            p = tw.add_rank1_plain(t(sh), t(rows), t(counts), t(dem), i * n)
            _bitwise(f"add_rank1_local B={b} shard {i}", k.cpu().numpy(),
                     p.cpu().numpy())
    log(f"sharded: set_rows_local / add_rank1_local on {shape}, buckets "
        f"{tw.ROW_BUCKETS}: bit-equal to plain on every shard")
    # every shard of both matrices in one launch, through the path the
    # engine's updates take (DeviceWorld._scatter: one staged upload a
    # card, then world.scatter_shards)
    mesh = _mesh(shape)
    w = tw.DeviceWorld(mesh=mesh)
    base2 = base[::-1].copy()
    for b in tw.ROW_BUCKETS:
        ops = []
        for _ in range(2):
            rows = np.full(b, N_ROWS, np.int32)
            rows[:b * 3 // 4] = rng.choice(N_NODES, b * 3 // 4,
                                           replace=False)
            ops.append(dict(rows=rows,
                            vals=(rng.random((b, 4)) * 5000).astype(
                                np.float32),
                            counts=rng.integers(-3, 40, b).astype(np.int32),
                            dem=(rng.random(4) * 80).astype(np.float32)))
        for name, keys, plain in (
                ("set_rows_local", ("rows", "vals"), tw.set_rows_plain),
                ("add_rank1_local", ("rows", "counts", "dem"),
                 tw.add_rank1_plain)):
            mats = (w._put_full(base), w._put_full(base2))
            n0, s0 = tw.launches[name], tw.staged[name]
            w._scatter(name, [(m, [o[k] for k in keys])
                              for m, o in zip(mats, ops)])
            if (tw.launches[name] - n0, tw.staged[name] - s0) != (1, 1):
                raise AssertionError(
                    f"{name}: two matrices of {NS} shards on one card took "
                    f"{tw.launches[name] - n0} launches and "
                    f"{tw.staged[name] - s0} uploads")
            torch.cuda.synchronize()
            for m, h, o in zip(mats, (base, base2), ops):
                want = plain(t(h), *[t(o[k]) for k in keys])
                _bitwise(f"{name} B={b}, {NS} shards x 2 matrices in one "
                         f"launch", torch.cat(m).cpu().numpy(),
                         want.cpu().numpy())
    log(f"sharded: set_rows_local / add_rank1_local with both matrices' "
        f"{NS} shards of {shape} in one upload and one launch "
        f"(DeviceWorld._scatter), buckets {tw.ROW_BUCKETS}: bit-equal to "
        f"plain")
    B = tw.ROW_BUCKETS[-1]
    rows = rng.choice(N_NODES, B, replace=False).astype(np.int32)
    live = rows[rows < n]
    d = t(base[:n])
    r, v = t(rows), t(rng.random((B, 4)).astype(np.float32))
    c, dm = t(rng.integers(1, 40, B).astype(np.int32)), t(
        np.array([33.3, 70.7, 0.1, 5.0], np.float32))
    keep = torch.from_numpy(np.flatnonzero(rows < n)).cuda()
    rl, vl, cl = r[keep].long(), v[keep], c[keep].float()
    entries = {}
    for name, kern, plain, lib, nbytes, ops in (
            ("set_rows_local", lambda: tw.set_rows_local(d, r, v, 0),
             lambda: tw.set_rows_plain(d, r, v, 0),
             lambda: d.index_copy_(0, rl, vl),
             B * 20 + live.size * 16, 0),
            ("add_rank1_local", lambda: tw.add_rank1_local(d, r, c, dm, 0),
             lambda: tw.add_rank1_plain(d, r, c, dm, 0),
             lambda: d.index_add_(0, rl, cl[:, None] * dm),
             B * 8 + 16 + live.size * 32, 2 * live.size * 4)):
        ms = time_cuda(kern, reps=50)
        plain_ms = time_cuda(plain)
        lib_ms = time_cuda(lib, reps=50)
        burst = time_burst(kern)
        lib_burst = time_burst(lib)
        bound, by = _bound(nbytes, ops)
        log(f"sharded: {name} B={B} on shard 0 of {shape} ({live.size} rows "
            f"its own): kernel {ms:.4f} ms (burst of 50: {burst:.4f} ms a "
            f"launch), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
            f"(burst {lib_burst:.4f}), bound {bound:.6f} ms ({by})")
        entries[name] = dict(
            name=name, route="cuda",
            source="nomad_tpu_torch/csrc/world_scatter.cu",
            replaces=("nomad_tpu/parallel/sharded.py:382"
                      if name == "set_rows_local"
                      else "nomad_tpu/parallel/sharded.py:386"),
            jax_function=f"serving_update_fns ({name[:-6]})",
            launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=lib_ms,
            burst_ms=burst, library_burst_ms=lib_burst)
    entries["set_rows_local"].update(stall_reading("sharded", mesh))
    return entries


def _check_sharded_world(eng, label):
    """The sharded world's device basis (its shards, in order) against
    its host snapshot: bit-equal (integer-sized allocs, so the merged
    basis u0 + psum_wave(exact - u0) rounds nowhere), and no ticket
    open."""
    import torch
    torch.cuda.synchronize()
    worlds = [w for w in eng._worlds.values() if w.mesh is not None]
    if not worlds:
        raise AssertionError(f"{label}: no sharded world")
    for w in worlds:
        _, basis = w.device_arrays()
        _bitwise(f"{label}: sharded device basis vs host snapshot",
                 torch.cat(basis).cpu().numpy(), w.host_basis())
    if eng.stats["tickets_open"] != 0:
        raise AssertionError(f"{label}: {eng.stats['tickets_open']} "
                             f"tickets left open")


def _sharded_engine(shape, **kw):
    from nomad_tpu_torch.parallel.engine import (PlacementEngine,
                                                 install_engine, stop_engines)
    stop_engines()
    n = shape[0] * shape[1]
    return install_engine(PlacementEngine(device="cuda",
                                          mesh_devices=["cuda:0"] * n, **kw))


def shard_stream(shape):
    """The engine phase's 10,000-node stream (100 C2M evals, 8 scan evals,
    one at a time) through Harness(device="cuda"), on an engine over
    `shape` (or the single-device engine for None).  Returns (per-job row
    maps, launch counts, engine stats, wall s)."""
    import torch
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.parallel.engine import get_engine, stop_engines
    from nomad_tpu_torch.scheduler.testing import Harness
    eng = _sharded_engine(shape) if shape else None
    if shape is None:
        stop_engines()
    h = Harness(device="cuda")
    _world(h, mock, N_NODES)
    eng = get_engine("cuda")
    cm = h.store.matrix
    spec = dict(feasible=cm.ready.copy(),
                affinity=np.zeros(cm.n_rows, np.float32), has_affinity=False,
                desired=10, penalty=np.zeros(cm.n_rows, bool),
                coll0=np.zeros(cm.n_rows, np.int32),
                demand=np.array([30, 60, 0, 0], np.float32), count=10)
    eng.warmup(cm, bulk=spec)
    jobs = [("batch", _c2m_job(mock)) for _ in range(100)] + \
        _scan_jobs(mock)
    for k, (_, j) in enumerate(jobs):
        j.id = f"stream-{k}"
    want = {j.id: sum(tg.count for tg in j.task_groups) for _, j in jobs}
    stats0 = dict(eng.stats)
    _reset_counts()
    t0 = time.perf_counter()
    for kind, job in jobs:
        _run(h, mock, kind, job)
        if h.last_scheduler.failed_tg_allocs:
            raise AssertionError(f"{job.id}: failed groups")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    _check_stream(h, jobs, want)
    if shape:
        _check_sharded_world(eng, f"sharded stream {shape}")
    else:
        _check_world(eng, "single-device stream")
    maps = [_row_counts(h, j) for _, j in jobs]
    st = {k: eng.stats[k] - stats0.get(k, 0) for k in eng.stats
          if isinstance(eng.stats[k], int)}
    stop_engines()
    return maps, launches, st, wall


def _spine_maps(shape, n_jobs=50):
    """bench_e2e_spine's shape (1,000 nodes, 50 batch jobs of count 100)
    through Server(device="cuda") with one worker, each job registered
    once the last is idle, on a mesh engine over `shape` (or the
    single-device engine): per-job row maps, launch counts, wall s."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.parallel.engine import stop_engines
    os.environ["NOMAD_TPU_PIPELINE_DEPTH"] = "0"
    eng = _sharded_engine(shape) if shape else None
    if shape is None:
        stop_engines()
    s = _server(1)
    try:
        for i in range(1000):
            n = mock.node()
            n.id = f"node-{i:04d}"
            n.name = n.id
            s.register_node(n)
        jobs = []
        _reset_counts()
        t0 = time.perf_counter()
        for k in range(n_jobs):
            j = mock.batch_job(id=f"spine-{k}")
            j.task_groups[0].count = 100
            jobs.append(j)
            s.register_job(j)
            if not s.wait_for_idle(120):
                raise AssertionError("sharded spine: evals in flight")
        wall = time.perf_counter() - t0
        launches = _counts()
        placed = len(_running(s.store, jobs))
        if placed != 100 * n_jobs:
            raise AssertionError(f"sharded spine: {placed} committed")
        if shape:
            _check_sharded_world(s._engine, f"sharded spine {shape}")
            if s._engine is not eng or eng.stats["sharded_evals"] == 0:
                raise AssertionError("sharded spine: the mesh engine did "
                                     "not serve the server")
        cm = s.store.matrix
        maps = []
        for j in jobs:
            per = {}
            for a in s.store.allocs_by_job(j.namespace, j.id):
                per[cm.row_of[a.node_id]] = per.get(cm.row_of[a.node_id],
                                                    0) + 1
            maps.append(per)
        return maps, launches, wall
    finally:
        s.stop()
        os.environ.pop("NOMAD_TPU_PIPELINE_DEPTH", None)
        stop_engines()


def shard_load(shape, n_jobs=LOAD_JOBS, workers=48):
    """C2M-shaped jobs (10 groups x count 10, 30 MHz/60 MB) through the
    spine with 48 workers at 10,000 nodes on a mesh engine over `shape`:
    every alloc committed, usage equal to the allocs' sum, the sharded
    basis equal to its host snapshot.  Returns (allocs/s, launches,
    engine stats)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.parallel.engine import stop_engines
    eng = _sharded_engine(shape)
    s = _server(workers)
    try:
        for i in range(N_NODES):
            n = mock.node()
            n.attributes["rack"] = f"r{i % RACKS}"
            s.store.upsert_node(s.next_index(), n)
        cm = s.store.matrix
        spec = dict(feasible=cm.ready.copy(),
                    affinity=np.zeros(cm.n_rows, np.float32),
                    has_affinity=False, desired=10,
                    penalty=np.zeros(cm.n_rows, bool),
                    coll0=np.zeros(cm.n_rows, np.int32),
                    demand=np.array([30, 60, 0, 0], np.float32), count=10)
        eng.warmup(cm, bulk=spec)
        jobs = [_c2m_job(mock) for _ in range(n_jobs)]
        failures0 = _failures(s.workers)
        _reset_counts()
        stats0 = dict(eng.stats)
        t0 = time.perf_counter()
        for j in jobs:
            s.register_job(j)
        want = 100 * n_jobs
        _wait_for(lambda: len(_running(s.store, jobs)) >= want, 600,
                  f"{want} allocs")
        wall = time.perf_counter() - t0
        if not s.wait_for_idle(60):
            raise AssertionError("sharded load: evals still in flight")
        launches = _counts()
        placed = len(_running(s.store, jobs))
        if placed != want:
            raise AssertionError(f"sharded load: {placed} of {want}")
        causes = _failures(s.workers) - failures0
        _check_failures("sharded load", causes)
        from nomad_tpu_torch.encode.matrixizer import comparable_vec
        expect = np.zeros(cm.used.shape, np.float64)
        for a in s.store.allocs():
            if not a.terminal_status():
                expect[cm.row_of[a.node_id]] += comparable_vec(
                    a.comparable_resources())
        if not np.allclose(cm.used, expect, atol=1e-3) or \
                not (cm.used <= cm.capacity + 1e-3).all():
            raise AssertionError("sharded load: committed usage wrong")
        _check_sharded_world(eng, "sharded load")
        st = {k: eng.stats[k] - stats0.get(k, 0) for k in
              ("sharded_evals", "bulk_parts", "donated_carries",
               "lane_evals", "lane_slots", "waves")}
        st["wave_lanes"] = eng.stats["wave_lanes"]
        return placed / wall, launches, st, dict(causes)
    finally:
        s.stop()
        stop_engines()


def _shard_outputs(out):
    import torch
    return [x.cpu().numpy() for x in out[:6]] + \
        [torch.cat([u.cpu() for u in out[6]]).numpy()]


def _cases(name: str = "_sharded_cases"):
    """A numpy case builder of tests/, shared with the CPU tests:
    tests/_sharded_cases.py (the sharded path's edge cases) or
    tests/_stage_cases.py (the stage probe's edge rows)."""
    import importlib
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module(name)


def check_scan_cache_cases():
    """K7a's cache cases (tests/_sharded_cases.py scan_cache_cases: the
    group and the demand changing between slots, inactive slots, a pick
    on every shard and either side of a shard boundary, no feasible row,
    ties across shards, -0.0 and NaN/+-inf usage under deltas, a spread
    over 80 values, spreads whose boost tables pass K7a's shared memory)
    at N = 64 and 16,384 on (4, 2) and (2, 4): every K7a/K7b call
    bit-equal to its plain version (K7Check), and again under
    SCAN_JITTER_SEEDS of K7a's cluster delays (K7b reads the records
    K7a's cluster exchange writes), the function bit-equal to its first
    run."""
    import torch
    from nomad_tpu_torch.parallel import sharded as ps
    sc = _cases()
    seen = {"scan_local": 0, "scan_apply": 0}
    for shape in ((4, 2), (2, 4)):
        mesh = _mesh(shape)
        for n_rows in (64, N_ROWS):
            for label, cap, used, f, drows, dvals, spread in \
                    sc.scan_cache_cases(n_rows, shape[0]):
                def run():
                    chk = K7Check(shape)
                    with chk:
                        packed, used_sh = ps.place_batch_sharded(
                            mesh, cap, used, f, drows, dvals, spread)
                    for k in seen:
                        seen[k] += chk.seen[k]
                    return packed, torch.cat(used_sh)
                want = [x.cpu().numpy() for x in run()]
                jittered(f"scan cache case {label} on {shape}, N={n_rows}",
                         run, want, kernel="sharded",
                         seeds=SCAN_JITTER_SEEDS)
    log(f"sharded: K7a's cache cases ({len(sc.scan_cache_cases(64, 4))} "
        f"cases at N = 64 and {N_ROWS} on (4, 2) and (2, 4)), also under "
        f"{len(SCAN_JITTER_SEEDS)} seeds of K7a's cluster delays: {seen} "
        f"calls bit-equal to their plain versions; the function bit-equal "
        f"under the delays to its first run")


def check_apply_cases():
    """K7b's merge cases (tests/_sharded_cases.py scan_apply_cases:
    hand-set records on 1, 2, 4 and 8 shards with equal bests, rows out
    of shard order, +0.0 and -0.0 bests and top entries, shards of fewer
    than 5 rows, -inf tails, no feasible row, K = 1 and 64, inactive
    spreads and the V1 - 1 sentinel, picks on every shard and either side
    of a boundary, a NaN best, NaN top entries): each call on each shard
    bit-equal to scan_apply_plain from the same state (carries, pick
    word, packed row)."""
    import torch
    from nomad_tpu_torch.ops import sharded as k7
    sc = _cases()
    calls = 0
    before = k7.launches["scan_apply"]
    for NS in (1, 2, 4, 8):
        for case in sc.scan_apply_cases(NS):
            shards, recs, out = sc.scan_apply_shards(case, "cuda")
            for t, r in enumerate(recs):
                s = t % sc.APPLY_SLOTS
                for i, sh in enumerate(shards):
                    o = out if i == 0 else None
                    state = [sh.used, sh.tg_count, sh.place_cap, sh.counts,
                             sh.pick, r] + ([o] if o is not None else [])
                    prior = [x.clone() for x in state]
                    k7.scan_apply(sh, s, r, o)
                    got = [x.clone() for x in state]
                    for x, b in zip(state, prior):
                        x.copy_(b)
                    k7.scan_apply_plain(sh, s, r, o)
                    for k, (x, g) in enumerate(zip(state, got)):
                        _bitwise(f"K7b case {case['label']} on {NS} shards, "
                                 f"call {t}, shard {i}, tensor {k}",
                                 g.cpu().numpy(), x.cpu().numpy())
                    calls += 1
    torch.cuda.synchronize()
    if k7.launches["scan_apply"] - before != calls:
        raise AssertionError("K7b cases: launches and calls differ")
    n_cases = sum(len(sc.scan_apply_cases(NS)) for NS in (1, 2, 4, 8))
    log(f"sharded: K7b's merge cases ({calls} calls over {n_cases} cases "
        f"on 1, 2, 4 and 8 shards) bit-equal to scan_apply_plain")


def check_basis_merge_large(n=32768, lanes=(1, 2, 4)):
    """K7g on one shard of n rows with W lanes (non-integer deltas on a
    third of the cells, -0.0 usage): bit-equal to basis_merge_plain with
    `out` a fresh tensor and `out` u0 itself (the donated basis); its
    time a launch on CUDA events, alone (profiler) and the wrapper's
    host time, each over a step of one launch as the kernels line's K7
    times.  Returns {W: (ms, plain ms, device ms, host us, bound ms)}."""
    import torch
    from nomad_tpu_torch.ops import sharded as k7
    rng = np.random.default_rng(47)
    res = {}
    for W in lanes:
        u_np = (rng.random((n, 4)) * 1000).astype(np.float32)
        u_np[rng.random((n, 4)) < 0.2] = -0.0
        ex = (u_np[None] + (rng.random((W, n, 4)) < 0.3)
              * rng.random((W, n, 4)) * 70.7).astype(np.float32)
        u0 = torch.from_numpy(u_np).cuda()
        exacts = torch.from_numpy(ex).cuda()
        want = torch.empty_like(u0)
        k7.basis_merge_plain(u0, exacts, want)
        out = torch.empty_like(u0)
        k7.basis_merge(u0, exacts, out)
        _bitwise(f"K7g n={n} W={W}", out.cpu().numpy(), want.cpu().numpy())
        donated = u0.clone()
        k7.basis_merge(donated, exacts, donated)
        _bitwise(f"K7g n={n} W={W} donated", donated.cpu().numpy(),
                 want.cpu().numpy())
        calls = [((u0, exacts, out), [out], [out.clone()])]
        ms = step_ms(calls, k7.basis_merge)
        plain_ms = step_ms(calls, k7.basis_merge_plain)
        dev_ms = step_device_ms(calls, k7.basis_merge, "basis_merge_kernel")
        h_us = step_host_us(calls, k7.basis_merge)
        bound, by = _bound(*_k7_work("basis_merge", (u0, exacts, out)))
        res[W] = (ms, plain_ms, dev_ms, h_us, bound)
        log(f"sharded: K7g n={n} rows a shard, W={W}: bit-equal to its plain "
            f"version (out fresh and donated); {ms:.4f} ms (CUDA events), "
            f"kernel alone {dev_ms:.4f} (profiler), host {h_us:.2f} us, plain "
            f"{plain_ms:.4f}, bound {bound:.6f} ({by})")
    return res


def bulk_counts_entry(kept):
    """The kernels line's entry of K7f, which has no launch of its own:
    node shard 0's K7g launch of the kept (4, 2) step carries it (its
    thread j writes counts[j]).  ms, device_ms and host_us are that
    launch's (events, alone, host), tail_ms its alone time less the same
    launch without the counts; plain_ms is bulk_counts_plain on its partials;
    the bound counts the partials read and the counts written."""
    from nomad_tpu_torch.ops import sharded as k7
    fused = kept.kept["basis_merge"][:1]
    args, state, before = fused[0]
    u0, exacts, out, partials, counts = args
    bare = [((u0, exacts, out), [out], [before[2]])]
    merge = kept.orig["basis_merge"]
    ms = step_ms(fused, merge)
    dev_ms = step_device_ms(fused, merge, "basis_merge_kernel")
    bare_ms = step_device_ms(bare, merge, "basis_merge_kernel")
    h_us = step_host_us(fused, merge)
    plain_ms = step_ms([((partials, counts), [counts], [counts.clone()])],
                       k7.bulk_counts_plain)
    bound, by = _bound((partials.numel() + counts.numel()) * 4, 0)
    log(f"sharded: shard_bulk_counts inside node shard 0's K7g launch on "
        f"(4, 2) (partials {tuple(partials.shape)}): that launch {ms:.4f} "
        f"ms (CUDA events), alone {dev_ms:.5f} ms against {bare_ms:.5f} "
        f"without the counts, host {h_us:.2f} us; plain {plain_ms:.4f} ms, "
        f"bound {bound:.7f} ({by})")
    return dict(
        name="shard_bulk_counts", route="cuda",
        source="nomad_tpu_torch/csrc/sharded.cu",
        replaces="nomad_tpu/parallel/sharded.py:485", launches=0,
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=None, device_ms=dev_ms, host_us=h_us,
        runs_in="shard_basis_merge", tail_ms=dev_ms - bare_ms)


# (2, 2) meshes over several cards, [node shard][lane] card indices: a
# lane a card (lane 1's counts gathered on its shard 0's card, then one
# copy to the output card), a node shard a card, a shard a card
FOLD_LAYOUTS = ([[0, 1], [0, 1]], [[0, 0], [1, 1]], [[0, 1], [2, 3]])


def check_fold_cards():
    """The staged bulk path on (2, 2) meshes whose shards sit on several
    cards (FOLD_LAYOUTS, each where the machine has its cards), so
    shards' partials reach the output card by peer copies before the
    fused K7g launch: every output of every selection case bit-equal to
    the plain form on the same mesh.  Logs that it skipped on a machine
    of one card (a mesh of one card repeated has no such copy)."""
    import torch
    from nomad_tpu_torch.parallel import sharded as ps
    ran = []
    for cards in FOLD_LAYOUTS:
        if torch.cuda.device_count() <= max(max(r) for r in cards):
            continue
        mesh = ps.make_mesh(2, 2, devices=[f"cuda:{c}" for r in cards
                                           for c in r])
        cases = _cases().bulk_select_cases(N_ROWS, 2, 2)
        for label, cap, used, f, spread in cases:
            args = [f[k] for k in SHARD_BULK_ORDER]
            got = _shard_outputs(ps.place_bulk_batch_sharded(
                mesh, cap, used, *args, spread_algorithm=spread))
            want = _shard_outputs(ps.place_bulk_batch_sharded_plain(
                mesh, cap, used, *args, spread_algorithm=spread))
            for k, (x, y) in enumerate(zip(got, want)):
                _bitwise(f"cards {cards}: {label} output {k}", x, y)
        ran.append(f"{cards} ({len(cases)} cases)")
    if not ran:
        log("sharded: K7f's counts with shards on several cards skipped "
            "(one card: the peer copies of the partials run only across "
            "cards)")
        return
    log(f"sharded: K7f's counts on (2, 2) meshes over cards "
        f"{'; '.join(ran)}: every output bit-equal to the plain form")


def check_run_cases():
    """K7d on its run cases (tests/_sharded_cases.py bulk_run_cases: a run
    cap of 1, fill grids of 16 and 64, m = 1 forced, rows that fit one
    instance and not two, no row fitting, the tie and the strict set, a
    done lane, NaN and +-inf usage) at N = 64 and 16,384 on 2 and 4
    shards: bit-equal to bulk_run_plain."""
    import torch
    from nomad_tpu_torch.ops import sharded as k7
    sc = _cases()
    checked = 0
    for n_rows in (64, N_ROWS):
        for case in sc.bulk_run_cases(n_rows):
            fill_grid, spread = case[4], case[5]
            for NS in (2, 4):
                outs = []
                for fn in (k7.bulk_run, k7.bulk_run_plain):
                    shards, stats, cur_g = sc.bulk_run_shards(case, NS,
                                                              "cuda")
                    base = torch.full((n_rows,), -7, dtype=torch.int32,
                                      device="cuda")
                    for sh in shards:
                        fn(sh, 0, stats, cur_g, base, spread, fill_grid)
                    outs.append(base.cpu().numpy())
                _bitwise(f"K7d run case {case[0]}, N={n_rows}, {NS} shards",
                         *outs)
                checked += NS
    log(f"sharded: K7d on its run cases ({checked} launches at N = 64 and "
        f"{N_ROWS} on 2 and 4 shards) bit-equal to bulk_run_plain")


def check_shard_select(shape=(4, 2)):
    """K7e's selection cases (tests/_sharded_cases.py: a tie wave
    with more tied rows than `remaining`, strict waves at one score and
    split across a shard boundary, a `remaining` of at least the wave,
    scores of exactly 0.0, lane pads with deltas, repeated delta rows, a
    usage row at +inf under deltas, fitting rows that score NaN at m = 1,
    at m = 2 only and between finite scores on other shards) at N =
    16,384 on a mesh of the card
    repeated: every K7c-K7g call checked bit for bit against its plain
    version (K7Check, every call), the function bit-equal to its plain
    form, and again under each of JITTER_SEEDS of K7c's cluster delays;
    the count-512 evals on a fresh 100,000-node world at N = 131,072
    (where K7e sorted in a global scratch before) under the delays; and
    K7e alone on waves whose scores tie +0.0 and -0.0."""
    import torch
    from nomad_tpu_torch.ops import place as tp
    from nomad_tpu_torch.ops import sharded as k7
    from nomad_tpu_torch.parallel import sharded as ps
    _sharded_cases = _cases()
    mesh = _mesh(shape)
    W = shape[1]
    runs = [(label, cap, used, f, spread, 64) for label, cap, used, f, spread
            in _sharded_cases.bulk_select_cases(N_ROWS, shape[0], W)]
    n_rows, n_nodes = LARGE_WORLDS[-1]
    cap, used, f = shard_bulk_lanes(45, W, 4 // W, n_rows, n_nodes,
                                    count=512, fresh=True)
    runs.append((f"count-512 evals at N={n_rows}", cap, used, f, False,
                 tp.fill_grid_for(512)))
    for label, cap, used, f, spread, fg in runs:
        args = [f[k] for k in SHARD_BULK_ORDER]
        kw = dict(spread_algorithm=spread, fill_grid=fg)
        chk = K7Check(shape)
        with chk:
            out = _shard_outputs(ps.place_bulk_batch_sharded(mesh, cap, used,
                                                             *args, **kw))
        plain = _shard_outputs(ps.place_bulk_batch_sharded_plain(
            mesh, cap, used, *args, **kw))
        for k, (x, y) in enumerate(zip(out, plain)):
            _bitwise(f"selection case {label}: output {k}", x, y)
        jittered(f"selection case {label}",
                 lambda: [torch.from_numpy(x) for x in _shard_outputs(
                     ps.place_bulk_batch_sharded(mesh, cap, used, *args,
                                                 **kw))],
                 out, kernel="sharded")
        log(f"sharded: selection case {label} on {shape}, N="
            f"{f['feasible'].shape[2]}: placed {out[2].tolist()} of "
            f"{f['count'].tolist()} in waves {out[5].tolist()}; "
            f"{chk.seen['bulk_stats']} K7c and {chk.seen['bulk_order']} K7e "
            f"calls bit-equal to their plain versions, the function to its "
            f"plain form, also under {len(JITTER_SEEDS)} seeds of K7c's "
            f"delays")
    check_signed_zero_order()


def check_signed_zero_order(n_rows=N_ROWS, n_shards=4, dev="cuda"):
    """K7e alone against its plain version on each shard of a wave whose
    gathered scores tie +0.0 and -0.0 (the order word of -cur + 0.0), at
    `remaining` 1, 17, 700 and 5,000 (two selection rounds), every state
    tensor bit for bit but the tail's scores (the tail reuses the scores
    and fits K7c wrote for the shard's rows; these are made up: every row
    fits at its gathered score)."""
    import torch
    from nomad_tpu_torch.ops import sharded as k7
    rng = np.random.default_rng(5)
    n = n_rows // n_shards
    cur = torch.from_numpy(rng.choice(np.array(
        [0.5, 0.0, -0.0, -0.25, 0.0, -0.0], np.float32), n_rows)).to(dev)
    base = torch.from_numpy(rng.integers(0, 3, n_rows).astype(np.int32)).to(dev)
    stats = torch.tensor([[0.5, 0.5, 0.0, 1.0, 0.5]], device=dev)
    z = lambda *s, t=torch.float32: torch.zeros(s, dtype=t, device=dev)  # noqa
    for remaining in (1, 17, 700, 5000):
        for i in range(n_shards):
            outs = []
            for fn in (k7.bulk_order, k7.bulk_order_plain):
                sh = k7.BulkShard(
                    off=i * n, n_rows=n_rows, capacity=z(n, 4) + 1e6,
                    used=z(n, 4), exact=z(n, 4), delta=z(n, 4),
                    coll=z(n, t=torch.int32),
                    feasible=torch.ones((1, n), dtype=torch.bool,
                                        device=dev),
                    affinity=z(1, n), penalty=z(1, n, t=torch.bool),
                    coll0=z(1, n, t=torch.int32),
                    has_affinity=z(1, t=torch.bool),
                    desired=torch.ones(1, dtype=torch.int32, device=dev),
                    demand=torch.tensor([[1.0, 1.0, 0.0, 0.0]],
                                        device=dev),
                    count=torch.tensor([remaining], dtype=torch.int32,
                                       device=dev),
                    delta_rows=None, delta_vals=None,
                    assign=z(1, n, t=torch.int32), scores=z(1, n),
                    partial=z(1, 4, t=torch.int32),
                    state=z(4, t=torch.int32),
                    fits=torch.ones(n, dtype=torch.bool,
                                    device=dev)).check()
                fn(sh, 0, stats, cur, base, False, 1000)
                outs.append([t.cpu().numpy() for t in (
                    sh.used, sh.coll, sh.assign, sh.state, sh.partial,
                    sh.exact)])
            for k, (x, y) in enumerate(zip(*outs)):
                _bitwise(f"signed-zero order, remaining {remaining}, shard "
                         f"{i}, tensor {k}", x, y)
    log(f"sharded: K7e on waves tying +0.0 and -0.0 scores (N={n_rows}, "
        f"{n_shards} shards, remaining 1, 17, 700, 5000) bit-equal to its "
        f"plain version")


def k7c_kinds(shape=(4, 2)):
    """K7c's time a launch on (4, 2) at N = 16,384, by kind: a begin with
    a wave and a count-0 begin-and-tail (a lane pad with 64 delta slots),
    the first step of each in 2 lanes of C2M chains with deltas (where
    every eval takes one wave), and a wave of its own, the first in 2
    lanes of count-512 evals on a fresh world; CUDA events around the
    step (kernel and plain version) and the kernel alone (profiler).
    Returns {kind: (ms, plain ms, device ms)}, each a launch."""
    import torch
    from nomad_tpu_torch.ops import sharded as k7
    from nomad_tpu_torch.parallel import sharded as ps
    mesh = _mesh(shape)
    kinds = {"begin with a wave": [], "count-0 begin and tail": [],
             "wave": []}
    kern = k7.bulk_stats
    seen = [0]

    def call(*args):
        sh, e, begin = args[0], args[1], args[2]
        kind = "wave" if not begin else (
            "begin with a wave" if int(sh.count[e]) > 0
            else "count-0 begin and tail")
        keep = kinds[kind]
        if not keep or (len(keep) < shape[0] and keep[-1][3] == seen[0] - 1):
            state = _state_of("bulk_stats", args)
            keep.append((args, state, [t.clone() for t in state], seen[0]))
        seen[0] += 1
        kern(*args)

    lanes = [shard_bulk_lanes(44, shape[1], 8, N_ROWS, N_NODES),
             shard_bulk_lanes(45, shape[1], 2, N_ROWS, N_NODES, count=512,
                              fresh=True)]
    k7.bulk_stats = call
    try:
        for cap, used, f in lanes:
            seen[0] += 1               # no step spans two runs
            ps.place_bulk_batch_sharded(mesh, cap, used,
                                        *[f[k] for k in SHARD_BULK_ORDER])
    finally:
        k7.bulk_stats = kern
    torch.cuda.synchronize()
    out = {}
    for kind, keep in kinds.items():
        calls = [(a, st, b) for a, st, b, _ in keep]
        if len(calls) != shape[0]:
            raise AssertionError(f"K7c kinds: {len(calls)} {kind} launches")
        ms = step_ms(calls, kern)
        plain_ms = step_ms(calls, k7.bulk_stats_plain)
        dev_ms = step_device_ms(calls, kern, "bulk_stats_kernel")
        out[kind] = (ms, plain_ms, dev_ms)
        log(f"sharded: K7c {kind}, N={N_ROWS} on {shape}, "
            f"{k7.bulk_stats_cluster_size()} blocks a cluster: {ms:.4f} ms a "
            f"launch (CUDA events over a step of {len(calls)}), plain "
            f"{plain_ms:.4f}, kernel alone {dev_ms:.4f} ms a launch "
            f"(profiler)")
    return out


def phase_sharded():
    """The sharded serving path (K7, K5') on meshes of the card repeated.
    Returns the kernels line's entries of K7a-K7g and K5' with the
    launches of the main path (the engine stream on (4, 2))."""
    import torch
    from nomad_tpu_torch.ops import place as tp
    entries = {}
    fg = tp.fill_grid_for(10)
    kept = None
    for shape in SHARD_SHAPES:
        chk = K7Check(shape)
        check_shard_scan(shape, chk, "E=2 rack-spread chain with deltas, "
                         "S=128", (41, 42), 128, True, True)
        check_shard_scan(shape, K7Check(), "E=1 mixed spread/affinity eval",
                         (43,), 64, False, False)
        check_shard_eval_batch(shape, K7Check())
        W = shape[1]
        check_shard_bulk(shape, chk, f"{W} lanes of C2M chains with deltas",
                         shard_bulk_lanes(44, W, 16 // W, N_ROWS, N_NODES),
                         fg)
        n_rows, n_nodes = LARGE_WORLDS[-1]
        check_shard_bulk(shape, K7Check(), f"count-512 evals on a fresh "
                         f"{n_nodes}-node world (every ready row in the "
                         f"wave)", shard_bulk_lanes(45, W, 4 // W, n_rows,
                                                    n_nodes, count=512,
                                                    fresh=True),
                         tp.fill_grid_for(512))
        if shape == (4, 2):
            kept = chk
        else:
            # K7b at (8, 1): 40 candidates in the merge
            ms, plain_ms = chk.timed("scan_apply")
            log(f"sharded: shard_scan_apply N={N_ROWS} on {shape} ("
                f"{len(chk.kept['scan_apply'])} launches): kernel {ms:.4f} "
                f"ms a launch (CUDA events), kernel alone "
                f"{chk.device('scan_apply'):.4f} (profiler), the wrapper's "
                f"host time {chk.host('scan_apply'):.2f} us, plain "
                f"{plain_ms:.4f}")
        entries.update(check_local_scatters(shape))
    # K7a at N = 131,072 and over a spread of 1,000 values; its cache
    # cases under its cluster's delays; K7d's run cases
    n_rows, n_nodes = LARGE_WORLDS[-1]
    check_shard_scan((4, 2), K7Check(), "E=1 rack-spread eval", (48,), 64,
                     False, True, n_rows=n_rows, n_nodes=n_nodes)
    check_shard_scan((4, 2), K7Check(), "E=2 eval chain spread over 1,000 "
                     "values, with deltas", (49, 50), 64, True, True,
                     values=1000)
    check_scan_cache_cases()
    check_apply_cases()
    check_basis_merge_large()
    check_run_cases()
    # K7e's selection cases, K7c's cluster under its delays
    check_shard_select((4, 2))
    # non-integer sizes (no deltas, so each lane's chain carry is K4's):
    # the merged basis u0 + psum_wave(exact - u0) rounds otherwise than
    # the host's rank-1 adds, one eval after another
    cap, used, f = shard_bulk_lanes(46, 2, 8, N_ROWS, N_NODES)
    rng = np.random.default_rng(46)
    used[:N_NODES, :2] += rng.random((N_NODES, 2), dtype=np.float32) * 50
    f["demand"][f["count"] > 0] = np.array([33.3, 70.7, 0.1, 0], np.float32)
    f["delta_rows"][:] = N_ROWS
    frac = check_shard_bulk((4, 2), K7Check(), "2 lanes of C2M chains with "
                            "non-integer sizes", (cap, used, f), fg)
    log(f"sharded: with non-integer sizes the merged basis differs from the "
        f"host rank-1 update by at most {frac:.6g}; with integer sizes it "
        f"is bit-equal")
    for name, (jname, replaces) in K7_UNITS.items():
        ms, plain_ms = kept.timed(name)
        dev_ms = kept.device(name)
        h_us = kept.host(name)
        bound, by = _k7_bound(name, kept.kept[name])
        log(f"sharded: {jname} N={N_ROWS}, ms a launch over one step on "
            f"(4, 2) ({len(kept.kept[name])} launches): kernel {ms:.4f} "
            f"(CUDA events), kernel alone {dev_ms:.4f} (profiler), the "
            f"wrapper's host time {h_us:.2f} us, plain {plain_ms:.4f}, bound "
            f"{bound:.6f} ({by})")
        entries[name] = dict(
            name=jname, route="cuda", source="nomad_tpu_torch/csrc/sharded.cu",
            replaces=replaces, launches=0, max_abs_err=0.0,
            ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=None, device_ms=dev_ms, host_us=h_us)
    entries["bulk_counts"] = bulk_counts_entry(kept)
    check_fold_cards()

    k7c_kinds((4, 2))

    # the main path: the engine stream over (4, 2) against the
    # single-device engine, identical per-job row maps
    maps_1, launches_1, _, wall_1 = shard_stream(None)
    maps_s, launches, st, wall_s = shard_stream((4, 2))
    log(f"sharded: launches per dirty update, engine stream: (4, 2) "
        f"{_per_update(launches, 'set_rows_local')}; single-device "
        f"{_per_update(launches_1, 'set_rows')}")
    if maps_s != maps_1:
        raise AssertionError("sharded stream: placements differ from the "
                             "single-device engine's")
    k7c = {k: launches.get(k, 0) for k in list(K7_UNITS) + ["set_rows_local"]}
    missing = [k for k in list(K7_UNITS) + ["set_rows_local"]
               if k7c[k] == 0]
    if missing or st["sharded_evals"] == 0:
        raise AssertionError(f"sharded stream: never launched {missing}; "
                             f"sharded_evals {st['sharded_evals']}")
    # K7f runs inside node shard 0's K7g launch, none of its own
    log(f"sharded: K7 launches on the (4, 2) engine stream: "
        f"{ {k: k7c[k] for k in K7_UNITS} }, K7f inside basis_merge")
    if launches["place_bulk_batch"] or launches["place_batch"]:
        raise AssertionError(f"sharded stream: unsharded kernels ran "
                             f"{launches}")
    log(f"sharded: engine stream on (4, 2) (100 C2M + 8 scan evals, 10,000 "
        f"nodes): per-job row maps equal the single-device engine's; "
        f"{wall_s:.3f} s vs {wall_1:.3f} s single-device; launches {k7c}; "
        f"sharded_evals {st['sharded_evals']}, wave_lanes "
        f"{st['wave_lanes']}, donated_carries {st['donated_carries']}; "
        f"device basis equals host snapshot bit for bit")
    for name in list(K7_UNITS) + ["set_rows_local"]:
        entries[name]["launches"] = k7c[name]

    # donation off: resolved placements scatter into the sharded basis
    os.environ["NOMAD_TPU_DONATE"] = "0"
    try:
        from nomad_tpu_torch import mock
        from nomad_tpu_torch.parallel.engine import stop_engines
        from nomad_tpu_torch.scheduler.testing import Harness
        eng = _sharded_engine((4, 2))
        h = Harness(device="cuda")
        _world(h, mock, N_NODES)
        jobs = [("batch", _c2m_job(mock)) for _ in range(10)]
        _reset_counts()
        for kind, job in jobs:
            _run(h, mock, kind, job)
        torch.cuda.synchronize()
        off = _counts()
        _check_stream(h, jobs, {j.id: 100 for _, j in jobs})
        _check_sharded_world(eng, "sharded, donation off")
        if off["add_rank1_local"] == 0 or eng.stats["donated_carries"]:
            raise AssertionError(f"sharded donation off: {off}")
        entries["add_rank1_local"]["launches"] = off["add_rank1_local"]
        log(f"sharded: donation off, 10 C2M evals on (4, 2): "
            f"add_rank1_local launched {off['add_rank1_local']} times; "
            f"{_per_update(off, 'add_rank1_local')}")
    finally:
        os.environ.pop("NOMAD_TPU_DONATE", None)
        stop_engines()

    # the spine: bench_e2e_spine's shape, one worker, (8, 1) vs single
    maps_1, _, sp_wall_1 = _spine_maps(None)
    maps_s, sp_launches, sp_wall = _spine_maps((8, 1))
    if maps_s != maps_1:
        raise AssertionError("sharded spine: placements differ from the "
                             "single-device server's")
    if not all(sp_launches[k] for k in ("bulk_stats", "bulk_run",
                                        "bulk_order", "basis_merge")):
        raise AssertionError(f"sharded spine: {sp_launches}")
    log(f"sharded: spine (1,000 nodes, 50 batch jobs x 100, one worker) on "
        f"(8, 1): per-job row maps equal the single-device server's; "
        f"{sp_wall:.3f} s vs {sp_wall_1:.3f} s single-device; "
        f"launches { {k: sp_launches[k] for k in K7_UNITS} }")

    # load: C2M through the spine, 48 workers, (4, 2), cut to LOAD_JOBS jobs
    rate, ld_launches, ld_st, causes = shard_load((4, 2), LOAD_JOBS)
    if not all(ld_launches[k] for k in ("bulk_stats", "bulk_run",
                                        "bulk_order", "basis_merge")):
        raise AssertionError(f"sharded load: {ld_launches}")
    log(f"sharded: load, {LOAD_JOBS} C2M jobs ({LOAD_JOBS * 100} allocs, "
        f"10,000 nodes, 48 workers) on (4, 2): every alloc committed at "
        f"{rate:.1f} allocs/s; engine {ld_st}; evals failed by cause "
        f"{causes}; launches { {k: ld_launches[k] for k in K7_UNITS} }; "
        f"device basis equals host snapshot bit for bit")
    return entries


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
    t_start = time.perf_counter()

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    timed("build", phase_build)
    timed("native", phase_native)
    entries = timed("kernels", phase_kernels)
    # the engine-off path (K1, K2), then the default engine-on path (K3,
    # K4, K5); each reads its kernels' counts, set to 0 just before it
    os.environ["NOMAD_TPU_ENGINE"] = "0"
    try:
        slice_launches = timed("slice", phase_slice)
    finally:
        os.environ.pop("NOMAD_TPU_ENGINE", None)
    for name in ("place_bulk", "place_scan"):
        entries[name]["launches"] = slice_launches[name]
    for name, n in timed("engine", phase_engine).items():
        entries[name]["launches"] = n
    # the server spine, the preemption path last: K6's count is read on
    # its window, set to 0 just before it
    entries["preempt"]["launches"] = timed("spine", phase_spine)["preempt"]
    # the control loops at fleet size: K3, K4 and K5 must launch in it
    # (their kernels line keeps the engine phase's counts)
    log(f"lifecycle launches: {timed('lifecycle', phase_lifecycle)}")
    # the bench entry point: K8's counts are read on the main C2M run's
    # probe
    bench_launches = timed("bench", phase_bench)
    for name in STAGE_UNITS:
        entries[name]["launches"] = bench_launches[name]
    # the sharded serving path on meshes of the card repeated: K7's and
    # K5''s counts are read on its engine stream (K5' add_rank1_local on
    # its donation-off run)
    entries.update(timed("sharded", phase_sharded))
    log(f"chip_smoke: every phase in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": list(entries.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
