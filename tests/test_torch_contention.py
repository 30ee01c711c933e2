"""Contended evals in the port and in the reference (ROADMAP queue C).

Both packages' dev-mode servers run with 16 workers on the CPU at
bench.py's preemption-heavy shape (`bench_preemption_heavy`, bench.py:791)
cut to the CPU, over seeds 0, 1 and 2.  The cuts:

* 10,000 nodes -> 64 (mock nodes in 50 racks);
* three batch fillers of count 30,000 at priorities 20/30/40 -> count
  192 each: 9 allocs of 420 MHz / 850 MB a node, 94.5% of a mock node's
  4,000 MHz as at full size, registered together;
* ten service jobs of count 50 at priority 90 -> ten of 80 allocs in
  all, split among them by the seed (each at least 1), registered
  together once the fill is idle;
* 48 workers -> 16, as chip_smoke.py's preemption phase runs it.

The reference runs with NOMAD_TPU_SHARD=0 (its engine single-device on
conftest.py's eight CPU devices), the port with `device="cpu"`.

Asserted in both packages: every service alloc committed (after any
failed eval's redelivery); committed usage equal to the live allocs' sum
row by row and within capacity; every victim whose preemptor committed
10 or more priority below it.  In the port every victim's preemptor
committed.  The reference commits a rejected node's preemptions (a
settled divergence, tests/test_torch_preemption.py), so most of its
victims' preemptors never commit: counted, and asserted to be there.

Recorded, in each test's report: each package's evals failed by a
worker and the applier's partly rejected plans (`stats["partial"]`).
Measured with this file's main, six copies at once (the load of a
six-worker pytest-xdist run), seeds 10-12 in each, 18 runs a package:
the port failed 0-4 evals a run, all at the scheduler's attempt limit,
some in 14 of the 18 runs; the reference none.  The difference follows
from the divergence: at this shape every placement needs a preemption
(a node's 220 MHz left is below a 420 MHz alloc), so every reference
plan, even one whose nodes are all rejected, evicts something, which
the scheduler counts as progress and which resets its five attempts; a
port plan so rejected commits nothing.  So the reference failing none
is asserted, and the port's count (zero in 4 of 18 runs) is recorded
only.  The partly rejected plans (42-65 a run in the reference, 37-69
in the port) show no clear difference: recorded only.  Victims: 80-81 a run in
both; 61-76 of the reference's without a committed preemptor, none of
the port's; the smallest priority gap 70 in both.

The store keeps a dropped placement's victims (a racer's placement for a
name another live alloc holds, or an over-quota one): at 16 workers a
failed eval's redelivery and its blocked eval race for one job, and the
reference's store then evicts victims for a preemptor it drops.
"""
import collections
import importlib
import time

import numpy as np
import pytest
import torch

from nomad_tpu_torch.encode.matrixizer import comparable_vec
from nomad_tpu_torch.parallel.engine import stop_engines

torch.set_num_threads(1)

SEEDS = (0, 1, 2)
N_NODES = 64
N_SERVICES = 10
SERVICE_ALLOCS = 80
WORKERS = 16
PACKAGES = ("nomad_tpu", "nomad_tpu_torch")
ATTEMPT_LIMIT = "SetStatusError: maximum attempts reached"


def _sized(j, count, prio):
    tg = j.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = 420
    tg.tasks[0].resources.memory_mb = 850
    tg.ephemeral_disk.size_mb = 0
    j.priority = prio
    return j


def _live(store, jobs):
    return sum(1 for j in jobs for a in store.allocs_by_job("default", j.id)
               if a.desired_status == "run" and not a.terminal_status())


def _wait(cond, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.02)
    return cond()


def _run(root, seed):
    """One contended run; returns what the tests check."""
    m = importlib.import_module(f"{root}.mock")
    srv = importlib.import_module(f"{root}.core.server")
    kw = {"device": "cpu"} if root == "nomad_tpu_torch" else {}
    s = srv.Server(srv.ServerConfig(num_schedulers=WORKERS,
                                    heartbeat_ttl=3600.0,
                                    gc_interval=3600.0), **kw)
    s.start()
    try:
        cfg = s.store.scheduler_config
        cfg.preemption_config.service_scheduler_enabled = True
        cfg.preemption_config.batch_scheduler_enabled = True
        for i in range(N_NODES):
            n = m.node()
            n.id = n.name = f"node-{seed}-{i:03d}"
            n.attributes["rack"] = f"r{i % 50}"
            s.store.upsert_node(s.next_index(), n)
        fillers = [_sized(m.batch_job(id=f"fill-{k}"), N_NODES * 3,
                          20 + 10 * k) for k in range(3)]
        for j in fillers:
            s.register_job(j)
        assert _wait(lambda: _live(s.store, fillers) >= N_NODES * 9, 300)
        assert s.wait_for_idle(60)
        workers = list(s.workers)      # stop() empties the server's list
        failed0 = sum(w.stats["failed"] for w in workers)
        partial0 = s.applier.stats["partial"]
        rng = np.random.default_rng(seed)
        counts = rng.multinomial(SERVICE_ALLOCS - N_SERVICES,
                                 [1 / N_SERVICES] * N_SERVICES) + 1
        services = [_sized(m.job(id=f"svc-{k}"), int(c), 90)
                    for k, c in enumerate(counts)]
        for j in services:
            s.register_job(j)
        placed = _wait(lambda: _live(s.store, services) >= SERVICE_ALLOCS,
                       300)
        idle = s.wait_for_idle(120)
        out = dict(
            placed=_live(s.store, services) if placed else 0, idle=idle,
            failed=sum(w.stats["failed"] for w in workers) - failed0,
            partial=s.applier.stats["partial"] - partial0,
            causes=sum((getattr(w, "failures", collections.Counter())
                        for w in workers), collections.Counter()))
        cm = s.store.matrix
        expect = np.zeros(cm.used.shape, np.float64)
        for a in s.store.allocs():
            if not a.terminal_status():
                expect[cm.row_of[a.node_id]] += comparable_vec(
                    a.comparable_resources())
        out["usage_equal"] = bool(np.allclose(cm.used, expect, atol=1e-3))
        out["within_capacity"] = bool((cm.used <= cm.capacity + 1e-3).all())
        gaps, orphans = [], 0
        victims = [a for a in s.store.allocs() if a.desired_status == "evict"]
        for a in victims:
            by = s.store.alloc_by_id(a.preempted_by_allocation)
            if by is None or by.desired_status != "run":
                orphans += 1
            else:
                gaps.append(by.job.priority - a.job.priority)
        out.update(victims=len(victims), orphans=orphans, gaps=gaps)
        return out
    finally:
        s.stop()


@pytest.fixture(scope="module")
def runs():
    pytest.importorskip("jax")
    mp = pytest.MonkeyPatch()
    mp.setenv("NOMAD_TPU_SHARD", "0")
    try:
        return {root: [_run(root, seed) for seed in SEEDS]
                for root in PACKAGES}
    finally:
        mp.undo()
        stop_engines()


def _report(runs, root):
    return "; ".join(
        f"seed {seed}: {r['failed']} evals failed, {r['partial']} plans "
        f"partly rejected, {r['victims']} victims ({r['orphans']} with no "
        f"committed preemptor)" for seed, r in zip(SEEDS, runs[root]))


@pytest.mark.parametrize("root", PACKAGES)
def test_every_service_alloc_commits(runs, root):
    for r in runs[root]:
        assert r["placed"] == SERVICE_ALLOCS and r["idle"], _report(runs, root)


@pytest.mark.parametrize("root", PACKAGES)
def test_committed_usage_is_the_live_allocs_within_capacity(runs, root):
    for r in runs[root]:
        assert r["usage_equal"] and r["within_capacity"], _report(runs, root)


@pytest.mark.parametrize("root", PACKAGES)
def test_victims_are_10_or_more_below_their_preemptors(runs, root):
    for r in runs[root]:
        assert r["victims"] >= SERVICE_ALLOCS, _report(runs, root)
        assert all(g >= 10 for g in r["gaps"]), _report(runs, root)


def test_every_port_victim_has_a_committed_preemptor(runs):
    """The port evicts a victim only with its committed preemptor; the
    reference's rejected nodes keep theirs (the settled divergence)."""
    assert all(r["orphans"] == 0 for r in runs["nomad_tpu_torch"]), \
        _report(runs, "nomad_tpu_torch")
    assert sum(r["orphans"] for r in runs["nomad_tpu"]) > 0, \
        _report(runs, "nomad_tpu")


def test_failed_evals_split_as_the_divergence_predicts(runs):
    """Every port eval failed at the scheduler's attempt limit, and was
    redelivered (every alloc commits); the reference fails none, since
    each of its plans evicts something, which counts as progress."""
    port, ref = runs["nomad_tpu_torch"], runs["nomad_tpu"]
    for r in port:
        assert set(r["causes"]) <= {ATTEMPT_LIMIT}, r["causes"]
        assert sum(r["causes"].values()) == r["failed"]
    report = (f"port: {_report(runs, 'nomad_tpu_torch')} | reference: "
              f"{_report(runs, 'nomad_tpu')}")
    assert all(r["failed"] == 0 for r in ref), report


def _racer_preemption(root):
    """A plan result whose placement the store drops as a racer (another
    live alloc holds its name) and which preempts a victim for it."""
    m = importlib.import_module(f"{root}.mock")
    st = importlib.import_module(f"{root}.state.store")
    store = st.StateStore()
    node = m.node()
    store.upsert_node(1, node)
    low = _sized(m.batch_job(id="low"), 1, 20)
    high = _sized(m.job(id="high"), 1, 90)
    store.upsert_job(2, low)
    store.upsert_job(3, high)
    victim = m.alloc_for(low, node.id)
    holder = m.alloc_for(high, node.id)
    store.upsert_allocs(4, [victim, holder])
    racer = m.alloc_for(high, node.id)
    assert racer.name == holder.name and racer.id != holder.id
    evicted = victim.copy()
    evicted.desired_status = "evict"
    evicted.preempted_by_allocation = racer.id
    evicted.job = None
    store.upsert_plan_results(5, st.AppliedPlanResults(
        allocs_to_place=[racer], allocs_preempted=[evicted]))
    assert store.alloc_by_id(racer.id) is None
    return store.alloc_by_id(victim.id).desired_status


def test_dropped_racer_keeps_its_victim_where_the_reference_evicts_it():
    pytest.importorskip("jax")
    assert _racer_preemption("nomad_tpu") == "evict"
    assert _racer_preemption("nomad_tpu_torch") == "run"


if __name__ == "__main__":
    # The band in the docstring: each package's runs at the given seeds,
    # one line a run.  Six copies at once stand for a six-worker
    # pytest-xdist run:  JAX_PLATFORMS=cpu PYTHONPATH=. python
    # tests/test_torch_contention.py 10 11 12
    import os
    import sys
    os.environ["NOMAD_TPU_SHARD"] = "0"
    for root in PACKAGES:
        for seed in [int(a) for a in sys.argv[1:]] or SEEDS:
            r = _run(root, seed)
            print(f"{root} seed {seed}: {r['failed']} evals failed "
                  f"({dict(r['causes'])}), {r['partial']} plans partly "
                  f"rejected, {r['victims']} victims, {r['orphans']} with no "
                  f"committed preemptor, smallest gap "
                  f"{min(r['gaps'], default=None)}", flush=True)
    stop_engines()
