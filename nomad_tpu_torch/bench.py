"""The port's benchmark runner: the reference's bench.py scenarios
(BASELINE.json shapes) through the port's dev-mode server on one device.

    python -m nomad_tpu_torch.bench [--smoke | --100k] [--device cuda|cpu]
                                    [--out PATH] [--deadline SECONDS]

Prints ONE JSON line on stdout, with the reference's keys.  Headline:
C2M-1M at its actual size — 10,000 nodes and 1,000,000 allocations
(10,000 jobs x 10 task groups x count 10) through the whole spine: job
register -> eval broker -> 48 scheduler workers -> the placement engine
(K4 on the card) -> plan queue -> pipelined applier -> state store, its
window cut at `--deadline` seconds (3,600 as in the reference); then
the stage probe (K8), the 10,000-node kernel scan and the 100,000-node
kernel scenario (K4 over 131,072 rows, whose trajectory JSON goes to
nomad_tpu_torch/build/BENCH_kernel_100k_nodes.json or `--out`).
`--smoke` runs the same shape shrunk to seconds, plus the scan-spread,
device and preemption shapes shrunk, with the reference's gates.

The device is "cuda" unless `--device cpu` is given (the plain PyTorch
versions of the kernels).  Parts of the reference's bench that exist
only for JAX or need the multi-server cluster print `null`: the
transfer guard and recompile budget of the steady-state gate, the fused
kernels' jit caches, the serving plane (a 3-server cluster) and the
tracing leg; `--fleet-soak` and `--matrix` raise (ROADMAP A6).

Supplementary numbers go to stderr, so stdout holds the one JSON line.
The exit code is 1 when a scenario raised, device_stages is missing, or
a steady-state, fused or p99 gate failed (each logged), else 0.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from nomad_tpu_torch import knobs

# the north-star C2M rate the reference compares against (1M allocs in
# 30 s on a TPU v5e-8); a ratio, not a target of this port
TARGET_ALLOCS_PER_S = 1_000_000 / 30.0
# the --smoke gate's cap on each shrunk scenario's plan.submit p99: it
# catches order-of-magnitude regressions, not runner jitter
SMOKE_P99_CAP_MS = 750.0
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@dataclass
class Record:
    """What the scenarios of one run report, folded into the JSON line:
    per-scenario plan latency, steady-state checks, stage attribution and
    the engine's stats at the end of the window; each scenario's placed
    and wanted allocs; and whether the engine's device basis equalled
    its host snapshot once a complete window went idle."""
    allocs: dict = field(default_factory=dict)
    plan_stats: dict = field(default_factory=dict)
    steady_state: dict = field(default_factory=dict)
    device_stages: dict = field(default_factory=dict)
    engine_snap: dict = field(default_factory=dict)
    basis_matches_host: dict = field(default_factory=dict)


class _SteadyGate:
    """The steady-state checks around a measured window, after warmup:
    the engine's worlds must not be re-uploaded in full (a full [N, R]
    upload after the epoch's first means the row scatter leaked), and
    with donation on, bulk dispatches must donate their carry and the
    world adopt it.  The reference's transfer guard and recompile budget
    are JAX's and have no counterpart here (null)."""

    def __init__(self, scenario: str, engine, rec: Record):
        self.scenario = scenario
        self.eng = engine
        self.rec = rec

    def __enter__(self):
        self._world0 = self.eng.world_stats() if self.eng else {}
        self._eng0 = dict(self.eng.stats) if self.eng else {}
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        wstats = self.eng.world_stats() if self.eng else {}
        estats = dict(self.eng.stats) if self.eng else {}

        def diff(now, before, k):
            return now.get(k, 0) - before.get(k, 0)
        reuploads = diff(wstats, self._world0, "steady_reuploads")
        donated = diff(estats, self._eng0, "donated_carries")
        bulk_parts = diff(estats, self._eng0, "bulk_parts")
        adopts = diff(wstats, self._world0, "basis_adopts")
        violations = []
        if reuploads > 0:
            violations.append(
                f"{reuploads} full world re-upload(s) during the measured "
                f"window (steady state must scatter rows only)")
        if self.eng is not None and self.eng.donate and bulk_parts > 0 \
                and (donated <= 0 or adopts <= 0):
            violations.append(
                f"donation enabled but {bulk_parts} bulk dispatch(es) "
                f"produced donated_carries={donated} basis_adopts={adopts} "
                f"(steady state must keep the usage basis resident)")
        self.rec.steady_state[self.scenario] = {
            "transfer_guard": None,
            "recompiled": None,
            "compile_events": None,
            "steady_reuploads": reuploads,
            "donated_carries": donated,
            "basis_adopts": adopts,
            "world": wstats,
            "violations": violations,
        }
        log(f"{self.scenario} steady-state: reuploads={reuploads} "
            f"violations={violations or 'none'}")
        return False


def _log_plan_submit(scenario: str, rec: Record) -> dict:
    """Per-scenario p50/p99 plan-submit and plan-evaluate latency; resets
    the series so scenarios don't pollute each other.  Called after the
    scenario's server stopped: a worker samples a submit after its plan
    is evaluated, which can be after the plan's allocs are visible, and
    only the joined workers have sampled every submit."""
    from nomad_tpu_torch.telemetry import global_metrics
    s = global_metrics.take_sample("nomad.plan.submit")
    ev = global_metrics.take_sample("nomad.plan.evaluate")

    def _ms(m):
        return {"p50": round(m["p50"], 2), "p99": round(m["p99"], 2),
                "mean": round(m["mean"], 2), "max": round(m["max"], 2),
                "count": m["count"]}
    rec.plan_stats[scenario] = {"submit_ms": _ms(s), "evaluate_ms": _ms(ev)}
    log(f"{scenario}: plan.submit p50 {s['p50']:.1f} / p99 {s['p99']:.1f} ms "
        f"(mean {s['mean']:.1f} ms, n={s['count']}); "
        f"plan.evaluate p50 {ev['p50']:.1f} / p99 {ev['p99']:.1f} ms")
    return rec.plan_stats[scenario]


def _wait_allocs(store, jobs, want, timeout=300.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        placed = sum(len(store.allocs_by_job("default", j.id)) for j in jobs)
        if placed >= want:
            return placed
        time.sleep(0.01)
    return sum(len(store.allocs_by_job("default", j.id)) for j in jobs)


def _server(workers=8, device="cuda"):
    from nomad_tpu_torch.core.server import Server, ServerConfig
    s = Server(ServerConfig(num_schedulers=workers, heartbeat_ttl=3600.0,
                            gc_interval=3600.0), device=device)
    s.start()
    return s


def _fill_nodes(s, n, racks=50, node_fn=None):
    from nomad_tpu_torch import mock
    for i in range(n):
        node = mock.node()
        node.attributes["rack"] = f"r{i % racks}"
        if node_fn:
            node_fn(node, i)
        s.store.upsert_node(s.next_index(), node)


def _warm_engine(s, scan_job=None, bulk_job=None):
    """Build the kernels and run each dispatch path once for this
    server's matrix (engine.warmup), so no build or first launch lands
    inside a measured window."""
    from nomad_tpu_torch.parallel.engine import get_engine
    from nomad_tpu_torch.scheduler.stack import DenseStack
    eng = get_engine(s.device)
    if eng is None:
        return
    cm = s.store.matrix
    inputs = None
    bulk = None
    if scan_job is not None:
        st = DenseStack(cm, device=s.device)
        groups = [st.compile_group(scan_job, tg)
                  for tg in scan_job.task_groups]
        count = max(scan_job.task_groups[0].count, 1)
        inputs = st.build_host_inputs(scan_job, groups, [0] * count, {})
    if bulk_job is not None:
        st = DenseStack(cm, device=s.device)
        g = st.compile_group(bulk_job, bulk_job.task_groups[0])
        N = cm.n_rows
        bulk = dict(
            feasible=g.feasible, affinity=g.affinity.astype(np.float32),
            has_affinity=bool(g.has_affinity),
            desired=max(bulk_job.task_groups[0].count, 1),
            penalty=np.zeros(N, bool), coll0=np.zeros(N, np.int32),
            demand=g.demand.astype(np.float32),
            count=bulk_job.task_groups[0].count)
    eng.warmup(cm, inputs=inputs, bulk=bulk)


def _batch_job(count, cpu=100, mem=64):
    from nomad_tpu_torch import mock
    j = mock.batch_job()
    tg = j.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = cpu
    tg.tasks[0].resources.memory_mb = mem
    tg.ephemeral_disk.size_mb = 0
    return j


def _service_job(count, cpu=100, mem=64, spread=True, priority=None):
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs.job import Affinity, Spread
    j = mock.job()
    tg = j.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = cpu
    tg.tasks[0].resources.memory_mb = mem
    tg.ephemeral_disk.size_mb = 0
    if spread:
        tg.spreads = [Spread("${attr.rack}", 50, ())]
        tg.affinities = [Affinity("${node.datacenter}", "dc1", "=", 50)]
    if priority is not None:
        j.priority = priority
    return j


# --------------------------------------------------------------- scenarios

def bench_e2e_spine(n_nodes=1000, n_jobs=50, count=100, workers=48,
                    device="cuda", rec: Optional[Record] = None):
    """configs[1]: 1K nodes / 5K batch allocs, binpack, through the spine."""
    from nomad_tpu_torch import mock
    rec = rec or Record()
    s = _server(workers, device)
    try:
        t0 = time.time()
        for _ in range(n_nodes):
            s.register_node(mock.node())
        log(f"world build ({n_nodes} nodes): {time.time()-t0:.2f}s")
        t0 = time.time()
        wj = mock.batch_job()
        wj.task_groups[0].count = count
        _warm_engine(s, scan_job=wj, bulk_job=wj)
        log(f"warm: {time.time()-t0:.2f}s")

        jobs = []
        t0 = time.time()
        for _ in range(n_jobs):
            j = mock.batch_job()
            j.task_groups[0].count = count
            jobs.append(j)
            s.register_job(j)
        placed = _wait_allocs(s.store, jobs, n_jobs * count)
        dt = time.time() - t0
        if s._engine is not None:
            log(f"engine stats: {s._engine.stats}")
    finally:
        s.stop()
    rec.allocs["e2e_spine"] = {"placed": placed, "want": n_jobs * count}
    log(f"e2e spine: placed {placed} allocs in {dt:.2f}s "
        f"({placed/dt:.0f} allocs/s, {n_jobs/dt:.1f} evals/s, "
        f"{workers} workers)")
    _log_plan_submit("e2e_spine", rec)
    if placed != n_jobs * count:
        raise AssertionError(f"e2e spine: placed {placed} of "
                             f"{n_jobs * count}")
    return placed / dt


def bench_dev_agent_sim(device="cuda", rec: Optional[Record] = None):
    """configs[0]: 1 service job, 3 task groups, 5-node dev-agent sim —
    end-to-end registration->placement latency."""
    from nomad_tpu_torch import mock
    rec = rec or Record()
    s = _server(2, device)
    try:
        _fill_nodes(s, 5)
        lat = []
        for _ in range(6):
            j = mock.job()
            tgs = []
            for k in range(3):
                tg = j.task_groups[0].copy() if k else j.task_groups[0]
                tg.name = f"g{k}"
                tg.count = 2
                tgs.append(tg)
            j.task_groups = tgs
            t0 = time.time()
            s.register_job(j)
            placed = _wait_allocs(s.store, [j], 6, timeout=30)
            lat.append(time.time() - t0)
            if placed != 6:
                raise AssertionError(f"dev-agent sim: placed {placed} of 6")
        lat.sort()
        log(f"dev-agent sim: p50 register->placed latency "
            f"{lat[len(lat)//2]*1000:.0f} ms (6 allocs, 3 tgs, 5 nodes)")
    finally:
        s.stop()
    _log_plan_submit("dev_agent", rec)
    return lat[len(lat)//2]


def bench_c2m(n_nodes=10000, n_batch=96, batch_count=1000,
              n_service=40, service_count=100, workers=48, device="cuda",
              rec: Optional[Record] = None):
    """configs[2]: C2M — 10K nodes / 100K allocs, mixed service+batch,
    spread + node-affinity scoring, through the full spine."""
    rec = rec or Record()
    s = _server(workers, device)
    try:
        t0 = time.time()
        _fill_nodes(s, n_nodes)
        log(f"C2M world build ({n_nodes} nodes): {time.time()-t0:.1f}s")
        _warm_engine(s, scan_job=_service_job(service_count),
                     bulk_job=_batch_job(batch_count))
        w1, w2 = _batch_job(100), _service_job(50)
        s.register_job(w1)
        s.register_job(w2)
        _wait_allocs(s.store, [w1, w2], 150, timeout=300)
        log(f"C2M warm done: {time.time()-t0:.1f}s")

        jobs = [_batch_job(batch_count) for _ in range(n_batch)] + \
               [_service_job(service_count) for _ in range(n_service)]
        want = n_batch * batch_count + n_service * service_count
        t0 = time.time()
        for j in jobs:
            s.register_job(j)
        placed = _wait_allocs(s.store, jobs, want, timeout=600)
        dt = time.time() - t0
        log(f"C2M spine: {placed}/{want} allocs in {dt:.1f}s "
            f"({placed/dt:.0f} allocs/s)")
        rec.allocs["c2m"] = {"placed": placed, "want": want}
    finally:
        s.stop()
    _log_plan_submit("c2m", rec)
    return placed / dt


def _basis_matches_host(eng) -> bool:
    """Every resident world's device basis equals its host snapshot, bit
    for bit, after the queued work of every device it uses (a mesh
    world's: each distinct device of its mesh).  A mesh world's basis is
    its node shards concatenated in order.

    Bit for bit holds because every bench scenario places integer sizes
    (C2M's 30 MHz / 60 MB): on a mesh the merged basis u0 +
    psum_wave(exact - u0) then rounds nowhere.  A world with non-integer
    sizes would differ there from the host's rank-1 updates by up to
    1.19e-07 (PERF.md section 6)."""
    import torch
    ok = True
    for w in list(eng._worlds.values()):
        devs = {w.device} if w.mesh is None else \
            {d for row in w.mesh.devices for d in row}
        for d in devs:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        _, basis = w.device_arrays()
        if basis is None:
            ok = False
            continue
        dev = torch.cat([s.cpu() for s in basis]) \
            if isinstance(basis, list) else basis.cpu()
        ok = ok and np.array_equal(dev.numpy().view(np.uint32),
                                   w.host_basis().view(np.uint32))
    return ok


def _check_basis(s, eng, scenario: str, rec: Record) -> None:
    """Once a complete window's evals are all acked, the engine holds no
    open ticket and its device basis equals its host snapshot; a miss
    is a steady-state violation of the scenario."""
    idle = s.wait_for_idle(timeout=60.0)
    ok = _basis_matches_host(eng)
    rec.basis_matches_host[scenario] = ok
    steady = rec.steady_state[scenario]
    if not idle or eng.stats["tickets_open"]:
        steady["violations"].append(
            f"not idle 60 s after the window (idle={idle}, "
            f"{eng.stats['tickets_open']} engine tickets open)")
    if not ok:
        steady["violations"].append(
            "the device basis differs from the world's host snapshot")
    log(f"{scenario} world check: idle={idle}, tickets open "
        f"{eng.stats['tickets_open']}, basis matches host: {ok}")


def bench_c2m_1m(n_nodes=10000, n_jobs=10000, groups_per_job=10,
                 group_count=10, workers=48, deadline_s=3600.0,
                 scenario="c2m_1m", device="cuda",
                 rec: Optional[Record] = None):
    """The north-star C2M at its actual size (BASELINE.json configs[2] /
    north_star): 1M allocations over 100K task groups on 10K nodes,
    through the full spine.  10,000 jobs x 10 task groups x count 10;
    allocs sized so the cluster holds them (30 cpu / 60 mb each).
    Returns (allocs/s, placed, want)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops.place import fill_grid_for
    from nomad_tpu_torch.parallel import stage_probe
    rec = rec or Record()

    s = _server(workers, device)
    try:
        t0 = time.time()
        _fill_nodes(s, n_nodes)
        log(f"{scenario} world build ({n_nodes} nodes): "
            f"{time.time()-t0:.1f}s")

        def make_job():
            j = mock.batch_job()
            base = j.task_groups[0]
            base.count = group_count
            base.tasks[0].resources.cpu = 30
            base.tasks[0].resources.memory_mb = 60
            base.ephemeral_disk.size_mb = 0
            tgs = []
            for k in range(groups_per_job):
                tg = base.copy() if k else base
                tg.name = f"g{k}"
                tgs.append(tg)
            j.task_groups = tgs
            return j

        t0 = time.time()
        _warm_engine(s, scan_job=make_job(), bulk_job=make_job())
        wj = make_job()
        s.register_job(wj)
        _wait_allocs(s.store, [wj], groups_per_job * group_count,
                     timeout=300)
        log(f"{scenario} warm: {time.time()-t0:.1f}s")

        eng = s._engine
        want = n_jobs * groups_per_job * group_count
        base_allocs = len(s.store._allocs)
        t0 = time.time()
        # the warm epoch's world is resident: from here on the dispatch
        # loop must scatter rows, never re-ship the world
        with _SteadyGate(scenario, eng, rec):
            for _ in range(n_jobs):
                s.register_job(make_job())
            reg_dt = time.time() - t0
            log(f"{scenario} registered {n_jobs} jobs in {reg_dt:.1f}s")
            deadline = time.time() + deadline_s
            placed = 0
            next_log = time.time() + 60.0
            while time.time() < deadline:
                placed = len(s.store._allocs) - base_allocs
                if placed >= want:
                    break
                if deadline_s >= 600 and time.time() >= next_log:
                    # a long window logs its progress once a minute
                    next_log += 60.0
                    log(f"{scenario} progress: {placed}/{want} allocs at "
                        f"{time.time() - t0:.0f}s; applier "
                        f"{s.applier.stats}; engine tickets open "
                        f"{eng.stats['tickets_open'] if eng else None}")
                time.sleep(0.2 if deadline_s < 600 else 1.0)
        dt = time.time() - t0
        rec.allocs[scenario] = {"placed": placed, "want": want}
        log(f"{scenario} spine: {placed}/{want} allocs in {dt:.1f}s "
            f"({placed/dt:.0f} allocs/s on {device}; "
            f"{n_jobs * groups_per_job} task groups)")
        if s.applier.stats.get("coalesced"):
            log(f"{scenario} applier stats: {s.applier.stats}")
        if eng is not None:
            log(f"{scenario} engine stats: {eng.stats}")
            rec.engine_snap[scenario] = dict(eng.stats)
            if placed >= want:
                _check_basis(s, eng, scenario, rec)
            # stage attribution runs strictly after the window: the
            # probe's launches and uploads are not the serving path's
            pipe_overlap = stage_probe.interval_overlap_s(
                list(eng.upload_windows), list(eng.device_windows))
            commit_overlap = stage_probe.interval_overlap_s(
                list(eng.device_windows), list(s.applier.commit_windows))
            ds = stage_probe.device_stages(
                eng.stats, n_nodes, fill_grid=fill_grid_for(group_count),
                pipeline_overlap_s=pipe_overlap,
                commit_overlap_s=commit_overlap, wave=eng.stats,
                device=device)
            if ds is not None:
                rec.device_stages[scenario] = ds
                log(f"{scenario} device stages: dominant="
                    f"{ds['dominant_stage']} {ds['stages_s']} "
                    f"pipeline_overlap={ds['pipeline_overlap_s']}s "
                    f"commit_overlap={ds['commit_overlap_s']}s "
                    f"wave={ds.get('wave')} fused={ds['fused']}")
    finally:
        s.stop()
    _log_plan_submit(scenario, rec)
    return placed / dt, placed, want


def bench_smoke(workers=8, device="cuda", rec: Optional[Record] = None):
    """The C2M-1M shape shrunk to seconds: a small world through the same
    spine and commit pipeline.  Returns (allocs/s, placed, want)."""
    return bench_c2m_1m(n_nodes=128, n_jobs=30, groups_per_job=5,
                        group_count=4, workers=workers, deadline_s=240.0,
                        scenario="smoke", device=device, rec=rec)


def bench_scan_spread(n_nodes=10000, n_jobs=60, count=100, workers=48,
                      device="cuda", rec: Optional[Record] = None):
    """The scan path at C2M shape: spread + affinity service jobs (the
    workload class the bulk wavefront excludes), so every placement goes
    through the chained scan (K3).  Reports allocs/s and batched_evals."""
    rec = rec or Record()
    s = _server(workers, device)
    try:
        t0 = time.time()
        _fill_nodes(s, n_nodes)
        log(f"scan-spread world build ({n_nodes} nodes): "
            f"{time.time()-t0:.1f}s")
        _warm_engine(s, scan_job=_service_job(count))
        w = _service_job(50)
        s.register_job(w)
        _wait_allocs(s.store, [w], 50, timeout=300)

        eng = s._engine
        base_batched = eng.stats["batched_evals"] if eng else 0
        jobs = [_service_job(count) for _ in range(n_jobs)]
        want = n_jobs * count
        t0 = time.time()
        for j in jobs:
            s.register_job(j)
        placed = _wait_allocs(s.store, jobs, want, timeout=600)
        dt = time.time() - t0
        batched = (eng.stats["batched_evals"] - base_batched) if eng else 0
        rec.allocs["scan_spread"] = {"placed": placed, "want": want}
        log(f"scan-spread: {placed}/{want} spread-service allocs in "
            f"{dt:.1f}s ({placed/dt:.0f} allocs/s, "
            f"batched_evals={batched})")
        if eng:
            log(f"scan-spread engine stats: {eng.stats}")
    finally:
        s.stop()
    _log_plan_submit("scan_spread", rec)
    return placed / dt


def bench_device_constrained(n_nodes=10000, n_jobs=20, count=100,
                             warm_count=50, device="cuda",
                             rec: Optional[Record] = None):
    """configs[3]: 10K nodes, half with GPU device groups; jobs with
    device requests and job anti-affinity."""
    from nomad_tpu_torch.structs.resources import DeviceRequest, NodeDevice
    rec = rec or Record()
    s = _server(8, device)
    try:
        def node_fn(node, i):
            if i % 2 == 0:
                node.node_resources.devices = [NodeDevice(
                    vendor="nvidia", type="gpu", name="a100",
                    instance_ids=[f"gpu-{i}-0", f"gpu-{i}-1"])]
        t0 = time.time()
        _fill_nodes(s, n_nodes, node_fn=node_fn)
        log(f"device world build: {time.time()-t0:.1f}s")
        warm = _batch_job(warm_count)
        warm.task_groups[0].tasks[0].resources.devices = [
            DeviceRequest(name="gpu", count=1)]
        s.register_job(warm)
        _wait_allocs(s.store, [warm], warm_count, timeout=300)

        jobs = []
        for _ in range(n_jobs):
            j = _batch_job(count)
            j.task_groups[0].tasks[0].resources.devices = [
                DeviceRequest(name="gpu", count=1)]
            jobs.append(j)
        want = n_jobs * count
        t0 = time.time()
        for j in jobs:
            s.register_job(j)
        placed = _wait_allocs(s.store, jobs, want, timeout=300)
        dt = time.time() - t0
        rec.allocs["device"] = {"placed": placed, "want": want}
        log(f"device-constrained: {placed}/{want} GPU allocs in {dt:.1f}s "
            f"({placed/dt:.0f} allocs/s)")
    finally:
        s.stop()
    _log_plan_submit("device", rec)
    return placed / dt


def bench_preemption_heavy(n_nodes=10000, workers=48, n_service=10,
                           service_count=50, device="cuda",
                           rec: Optional[Record] = None):
    """configs[4]: 10K nodes at ~95% utilization of low-priority work;
    high-priority service jobs must preempt across priority tiers."""
    rec = rec or Record()
    s = _server(workers, device)
    try:
        cfg = s.store.scheduler_config
        cfg.preemption_config.service_scheduler_enabled = True
        cfg.preemption_config.batch_scheduler_enabled = True
        _fill_nodes(s, n_nodes)
        # fill to ~95%: nodes are 4000cpu/8192mb; 9 allocs x 420cpu = 94.5%
        fillers = [_batch_job(n_nodes * 3, cpu=420, mem=850)
                   for _ in range(3)]
        for i, j in enumerate(fillers):
            j.priority = 20 + i * 10
            s.register_job(j)
        _wait_allocs(s.store, fillers, n_nodes * 9, timeout=600)

        jobs = [_service_job(service_count, cpu=420, mem=850, spread=False,
                             priority=90) for _ in range(n_service)]
        want = n_service * service_count
        t0 = time.time()
        for j in jobs:
            s.register_job(j)
        placed = _wait_allocs(s.store, jobs, want, timeout=300)
        dt = time.time() - t0
        rec.allocs["preemption"] = {"placed": placed, "want": want}
        preempted = sum(1 for a in s.store._allocs.values()
                        if a.desired_status == "evict")
        log(f"preemption-heavy: {placed}/{want} high-prio allocs in "
            f"{dt:.1f}s ({placed/dt:.0f} allocs/s, {preempted} preempted)")
    finally:
        s.stop()
    _log_plan_submit("preemption", rec)
    return placed / dt


def bench_kernel_c2m_scale(device="cuda"):
    """Kernel-only: one dense placement scan (1,024 slots of a service
    job) at 10K-node scale, through DenseStack.place."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.encode.matrixizer import ClusterMatrix
    from nomad_tpu_torch.scheduler.stack import DenseStack

    cm = ClusterMatrix(initial_rows=16384)
    t0 = time.time()
    for i in range(10000):
        n = mock.node()
        n.attributes["rack"] = f"r{i % 50}"
        cm.upsert_node(n)
    log(f"world build (10000 nodes): {time.time()-t0:.2f}s")

    job = mock.job()
    job.task_groups[0].count = 1024
    stack = DenseStack(cm, device=device)
    groups = [stack.compile_group(job, tg) for tg in job.task_groups]
    inp = stack.build_host_inputs(job, groups, [0] * 1024, {})

    from nomad_tpu_torch.parallel.engine import get_engine
    eng = get_engine(device)
    res = stack.place(inp)          # build + first launch
    if eng is not None and stack.last_ticket is not None:
        eng.complete(stack.last_ticket)
    t0 = time.time()
    res = stack.place(inp)
    dt = time.time() - t0
    if eng is not None and stack.last_ticket is not None:
        eng.complete(stack.last_ticket)
    placed = int((res.node[:1024] >= 0).sum())
    log(f"kernel: {placed} placements over 10K nodes in {dt:.3f}s "
        f"({placed/dt:.0f} placements/s on {device})")
    return placed / dt


def bench_kernel_100k_nodes(n_nodes=100_000, waves=12, per_wave=8,
                            count=512, out_path=None, device="cuda"):
    """A 100K-node world (131,072 padded rows) on the device-resident
    world: uploaded once, then `waves` dispatches of `per_wave`
    concurrent bulk evals (chained into one K4 launch each) place allocs
    whose commits flow back as rank-1 updates.  Writes its trajectory
    JSON (per-wave dispatch p50/p99, engine stats, whether the device
    basis equals the world's host snapshot) to `out_path` (default
    nomad_tpu_torch/build/BENCH_kernel_100k_nodes.json) and returns it."""
    import torch

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.encode.matrixizer import ClusterMatrix
    from nomad_tpu_torch.parallel.engine import PlacementEngine
    from nomad_tpu_torch.scheduler.stack import DenseStack

    out_path = out_path or os.path.join(BUILD_DIR,
                                        "BENCH_kernel_100k_nodes.json")
    cm = ClusterMatrix(initial_rows=131072)
    t0 = time.time()
    for i in range(n_nodes):
        n = mock.node()
        n.attributes["rack"] = f"r{i % 200}"
        cm.upsert_node(n)
    log(f"kernel_100k world build ({n_nodes} nodes, {cm.n_rows} padded "
        f"rows): {time.time()-t0:.1f}s")

    job = mock.batch_job()
    job.task_groups[0].count = count
    st = DenseStack(cm, device=device)
    g = st.compile_group(job, job.task_groups[0])
    N = cm.n_rows
    demand = np.zeros(cm.used.shape[1], np.float32)
    dm = np.asarray(g.demand, np.float32)
    demand[:min(len(dm), len(demand))] = dm[:len(demand)]
    bulk = dict(feasible=g.feasible,
                affinity=g.affinity.astype(np.float32),
                has_affinity=bool(g.has_affinity), desired=count,
                penalty=np.zeros(N, bool), coll0=np.zeros(N, np.int32),
                demand=g.demand.astype(np.float32), count=count)

    eng = PlacementEngine(max_batch=per_wave, device=device)
    try:
        t0 = time.time()
        eng.warmup(cm, bulk=bulk)
        log(f"kernel_100k warm: {time.time()-t0:.1f}s")

        lat_s = []
        placed_total = 0
        t_run = time.time()
        for _ in range(waves):
            t0 = time.time()
            futs = [eng.place_bulk_begin(cm, **bulk)
                    for _ in range(per_wave)]
            results = [f.result() for f in futs]
            lat_s.append(time.time() - t0)
            for assign, placed, _ev, _ex, _scores, ticket in results:
                placed_total += int(placed)
                rows = np.flatnonzero(assign)
                for r_ in rows:
                    cm.used[r_] += assign[r_] * demand
                if ticket is not None:
                    eng.complete(ticket)
        dt = time.time() - t_run
        basis_ok = _basis_matches_host(eng)

        lat_ms = sorted(v * 1000.0 for v in lat_s)
        p50 = lat_ms[len(lat_ms) // 2]
        p99 = lat_ms[min(len(lat_ms) - 1, int(len(lat_ms) * 0.99))]
        stats = {k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in eng.stats.items()}
        traj = {
            "metric": "kernel_100k_nodes_allocs_per_sec",
            "value": round(placed_total / dt, 1),
            "unit": "allocs/s",
            "n_nodes": n_nodes, "padded_rows": int(N),
            "device": (torch.cuda.get_device_name(eng.device)
                       if eng.device.type == "cuda" else "cpu"),
            "devices": 1,
            "waves": waves, "evals_per_wave": per_wave, "count": count,
            "placed": placed_total, "want": waves * per_wave * count,
            "p50_ms": round(p50, 2), "p99_ms": round(p99, 2),
            "basis_matches_host": bool(basis_ok),
            "engine_stats": stats,
            "world_stats": eng.world_stats(),
        }
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(traj, f, indent=2)
            f.write("\n")
        log(f"kernel_100k_nodes: {placed_total} allocs in {dt:.1f}s "
            f"({placed_total/dt:.0f} allocs/s; wave p50 {p50:.0f} ms / "
            f"p99 {p99:.0f} ms on {traj['device']}); written to {out_path}")
        return traj
    finally:
        eng.stop()


# --------------------------------------------------------------- main

def fused_check(rec: Record, scenario: str) -> dict:
    """The fused-path check: every bulk wave group must have run as ONE
    device dispatch (bulk_parts == bulk_groups) when NOMAD_TPU_FUSE is
    on.  The reference's jit-cache entries of the fused kernels have no
    counterpart here (null)."""
    snap = rec.engine_snap.get(scenario, {})
    groups = snap.get("bulk_groups", 0)
    parts = snap.get("bulk_parts", 0)
    violations = []
    if knobs.get_bool("NOMAD_TPU_FUSE"):
        if groups <= 0:
            violations.append(
                "no bulk wave groups dispatched (fused path unused)")
        elif parts != groups:
            violations.append(
                f"fused path inactive: {parts} device dispatches for "
                f"{groups} wave groups (expected 1 per wave)")
    return {"bulk_groups": groups, "bulk_parts": parts, "kernels": None,
            "violations": violations}


def smoke(device="cuda") -> tuple:
    """The --smoke run: returns (the JSON line's dict, its violations)."""
    rec = Record()
    rate, placed, want = bench_smoke(device=device, rec=rec)
    steady = rec.steady_state.get("smoke", {})
    # per-scenario gate: the spread / device / preemption shapes shrunk
    # to seconds, their plan.submit p99 capped
    violations = []
    for name, fn in (
            ("scan_spread", lambda: bench_scan_spread(
                n_nodes=256, n_jobs=6, count=20, workers=8, device=device,
                rec=rec)),
            ("device", lambda: bench_device_constrained(
                n_nodes=256, n_jobs=4, count=25, warm_count=10,
                device=device, rec=rec)),
            ("preemption", lambda: bench_preemption_heavy(
                n_nodes=96, workers=8, n_service=2, service_count=12,
                device=device, rec=rec))):
        fn()
        p99 = rec.plan_stats.get(name, {}).get("submit_ms", {}).get("p99",
                                                                    0.0)
        if p99 > SMOKE_P99_CAP_MS:
            violations.append(f"scenario gate: {name}: plan.submit p99 "
                              f"{p99} ms > cap {SMOKE_P99_CAP_MS} ms")
    fused = fused_check(rec, "smoke")
    violations += [f"steady-state: {v}" for v in steady.get("violations", [])]
    violations += [f"fused gate: {v}" for v in fused["violations"]]
    if rec.device_stages.get("smoke") is None:
        violations.append("stage probe: no device_stages")
    line = {
        "metric": "c2m_smoke_allocs_per_sec",
        "value": round(rate, 1),
        "unit": "allocs/s",
        "vs_baseline": round(rate / TARGET_ALLOCS_PER_S, 4),
        "placed": placed,
        "want": want,
        "plan_latency_ms": rec.plan_stats,
        "steady_state": steady,
        "serving_plane": None,
        "device_stages": rec.device_stages.get("smoke"),
        "fused": fused,
        "tracing": None,
    }
    return line, violations


def headline(device="cuda", out_path=None, deadline_s=3600.0) -> tuple:
    """C2M-1M at full size (its window cut at `deadline_s`), then the
    kernel scenarios.  A scenario that raises is logged and the line
    still prints.  Returns (the JSON line's dict, its violations): each
    failed scenario, a missing device_stages, and the steady-state and
    fused checks' violations."""
    rec = Record()
    rate, placed, want = 0.0, 0, 0
    violations = []
    try:
        rate, placed, want = bench_c2m_1m(device=device, rec=rec,
                                          deadline_s=deadline_s)
        if placed < want:
            log(f"c2m_1m INCOMPLETE: {placed}/{want} before deadline")
    except Exception:                           # noqa: BLE001
        log(f"c2m_1m headline failed:\n{traceback.format_exc()}")
        violations.append("scenario c2m_1m failed")
    for name, fn in (("kernel_c2m_scale",
                      lambda: bench_kernel_c2m_scale(device)),
                     ("kernel_100k_nodes",
                      lambda: bench_kernel_100k_nodes(out_path=out_path,
                                                      device=device))):
        try:
            fn()
        except Exception:                       # noqa: BLE001
            log(f"{name} bench failed:\n{traceback.format_exc()}")
            violations.append(f"scenario {name} failed")
    steady = rec.steady_state.get("c2m_1m", {})
    fused = fused_check(rec, "c2m_1m")
    violations += [f"steady-state: {v}" for v in steady.get("violations", [])]
    violations += [f"fused gate: {v}" for v in fused["violations"]]
    if rec.device_stages.get("c2m_1m") is None:
        violations.append("stage probe: no device_stages")
    line = {
        "metric": "c2m_1m_allocs_per_sec_10knodes_1mallocs",
        "value": round(rate, 1),
        "unit": "allocs/s",
        "vs_baseline": round(rate / TARGET_ALLOCS_PER_S, 4),
        "placed": placed,
        "want": want,
        "plan_latency_ms": rec.plan_stats,
        "steady_state": rec.steady_state,
        "serving_plane": None,
        "device_stages": rec.device_stages.get("c2m_1m"),
        "fused": fused,
        "tracing": None,
    }
    return line, violations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nomad_tpu_torch.bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the C2M-1M shape shrunk to seconds, with gates")
    ap.add_argument("--100k", dest="k100", action="store_true",
                    help="the 100K-node kernel scenario alone")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None,
                    help="path of the 100K-node trajectory JSON")
    ap.add_argument("--deadline", type=float, default=3600.0,
                    help="seconds the headline's C2M-1M window may run "
                         "(the reference's 3,600; less to end inside a "
                         "time limit)")
    ap.add_argument("--fleet-soak", action="store_true")
    ap.add_argument("--matrix", action="store_true")
    args = ap.parse_args(argv)
    if args.fleet_soak or args.matrix:
        raise NotImplementedError(
            "--fleet-soak and --matrix need the multi-server cluster, which "
            "the port does not have yet (ROADMAP A6)")
    from nomad_tpu_torch.device import resolve_device
    resolve_device(args.device)     # raises where cuda is asked for and absent
    from nomad_tpu_torch.parallel.engine import stop_engines
    try:
        if args.k100:
            traj = bench_kernel_100k_nodes(out_path=args.out,
                                           device=args.device)
            print(json.dumps(traj), flush=True)
            return 0 if traj["placed"] == traj["want"] \
                and traj["basis_matches_host"] else 1
        if args.smoke:
            line, violations = smoke(args.device)
        else:
            line, violations = headline(args.device, args.out,
                                        args.deadline)
        print(json.dumps(line), flush=True)
        for v in violations:
            log(v)
        return 1 if violations else 0
    finally:
        stop_engines()


if __name__ == "__main__":
    sys.exit(main())
