"""The port's scheduler slice, end to end on the CPU.

1. Parity: the same 1,000-node world (nodes inserted in the same order, so
   rows match) and the same job stream go through the reference Harness
   and the port's Harness(device="cpu"), both in the engine-off
   configuration (NOMAD_TPU_ENGINE=0; tests/test_torch_engine.py runs the
   same stream engine-on).  Per-job {task group: {row: count}} maps,
   failed task groups, blocked/follow-up eval counts and the committed
   usage matrix must agree.
2. A parametrized mirror of tests/test_generic_sched.py against the port.
3. The one place the port departs from the reference's engine-off path:
   bulk groups of one eval chain (ROADMAP.md queue C), and so match the
   reference run with its engine on.

The mirror runs in the default configuration (engine on); the fixture
below stops the CPU engine those Harnesses make.
"""
import numpy as np
import pytest
import torch

import nomad_tpu.mock as ref_mock
import nomad_tpu.scheduler.testing as ref_testing
import nomad_tpu.structs.job as ref_job
import nomad_tpu_torch.mock as port_mock
import nomad_tpu_torch.scheduler.testing as port_testing
import nomad_tpu_torch.structs.job as port_job
from nomad_tpu_torch import mock
from nomad_tpu_torch.parallel.engine import stop_engines
from nomad_tpu_torch.scheduler.testing import Harness
from nomad_tpu_torch.structs import AllocClientStatus, AllocDesiredStatus, EvalStatus
from nomad_tpu_torch.structs.evaluation import EvalTrigger

# one intra-op thread: the suite runs test files in parallel worker
# processes, and these small tensors gain nothing from more threads
torch.set_num_threads(1)

N_NODES = 1000
RACKS = 20


@pytest.fixture(autouse=True, scope="module")
def _stop_engines():
    yield
    stop_engines()


# --------------------------------------------------------------- parity

def _stream(m, J):
    """The job stream, built from one package's mock/structs modules.
    Returns [(kind, job)] with fixed ids so both packages see the same."""
    jobs = []
    for i in range(3):                     # C2M-shaped: 10 groups x 10
        j = m.batch_job(id=f"c2m-{i}")
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
        jobs.append(("batch", j))
    j = m.job(id="spread-rack")
    j.task_groups[0].count = 20
    j.task_groups[0].spreads = [J.Spread("${attr.rack}", 100, ())]
    jobs.append(("service", j))
    j = m.job(id="distinct")
    j.task_groups[0].count = 10
    j.constraints.append(J.Constraint(operand=J.Operand.DISTINCT_HOSTS))
    jobs.append(("service", j))
    j = m.job(id="single")
    j.task_groups[0].count = 1
    j.affinities.append(J.Affinity("${attr.rack}", "r3", J.Operand.EQ, weight=50))
    jobs.append(("service", j))
    j = m.job(id="to-scale")
    j.task_groups[0].count = 12
    jobs.append(("service", j))
    return jobs


def _drive(m, J, H, harness_kw):
    h = H(**harness_kw)
    for i in range(N_NODES):
        nd = m.node()
        nd.id = f"node-{i:04d}"
        nd.name = nd.id
        nd.attributes["rack"] = f"r{i % RACKS}"
        h.store.upsert_node(h.next_index(), nd)
    jobs = _stream(m, J)
    failed = []

    def run(kind, job_id, **kw):
        ev = m.eval(job_id=job_id, type=kind, **kw)
        h.store.upsert_evals(h.next_index(), [ev])
        h.process(kind, ev)
        failed.append(sorted(h.last_scheduler.failed_tg_allocs))

    for kind, job in jobs:
        h.store.upsert_job(h.next_index(), job)
        run(kind, job.id)
    # scale-down
    scaled = h.store.job_by_id("default", "to-scale").copy()
    scaled.task_groups[0].count = 4
    h.store.upsert_job(h.next_index(), scaled)
    run("service", "to-scale")
    # node-down replacement: the node hosting the spread job's first alloc
    victim = sorted(a.node_id for a in h.store.allocs_by_job("default",
                                                             "spread-rack"))[0]
    h.store.update_node_status(h.next_index(), victim, "down")
    for kind, job in jobs:
        if any(a.node_id == victim
               for a in h.store.allocs_by_job("default", job.id)):
            run(kind, job.id, triggered_by="node-update")

    maps = {}
    for _, job in jobs:
        per = {}
        for a in h.store.allocs_by_job("default", job.id):
            if a.desired_status != "run" or a.client_status == "lost":
                continue
            row = h.store.matrix.row_of[a.node_id]
            tg = per.setdefault(a.task_group, {})
            tg[row] = tg.get(row, 0) + 1
        maps[job.id] = per
    blocked = sum(1 for e in h.create_evals_list if e.status == "blocked")
    followup = sum(1 for e in h.create_evals_list if e.wait_until > 0)
    return maps, failed, blocked, followup, h.store.matrix.used.copy()


@pytest.fixture(scope="module")
def parity_runs():
    mp = pytest.MonkeyPatch()
    mp.setenv("NOMAD_TPU_ENGINE", "0")
    try:
        ref = _drive(ref_mock, ref_job, ref_testing.Harness, {})
        port = _drive(port_mock, port_job, port_testing.Harness,
                      {"device": "cpu"})
    finally:
        mp.undo()
    return ref, port


def test_scheduler_parity_row_counts(parity_runs):
    ref, port = parity_runs
    assert set(port[0]) == set(ref[0])
    for job_id in ref[0]:
        assert port[0][job_id] == ref[0][job_id], job_id
    assert sum(c for m in port[0].values() for tg in m.values()
               for c in tg.values()) == 3 * 100 + 20 + 10 + 1 + 4


def test_scheduler_parity_failures_and_evals(parity_runs):
    ref, port = parity_runs
    assert port[1] == ref[1]
    assert (port[2], port[3]) == (ref[2], ref[3])


def test_scheduler_parity_committed_usage(parity_runs):
    ref, port = parity_runs
    np.testing.assert_allclose(port[4], ref[4], rtol=1e-6)


# --------------------------------------------------------------- mirror
# tests/test_generic_sched.py, case for case, on the port's Harness.

def make_world(h, n_nodes=10):
    nodes = [mock.node() for _ in range(n_nodes)]
    for n in nodes:
        h.store.upsert_node(h.next_index(), n)
    return nodes


def register_and_eval(h, job):
    h.store.upsert_job(h.next_index(), job)
    ev = mock.eval(job_id=job.id, type=job.type, priority=job.priority)
    h.store.upsert_evals(h.next_index(), [ev])
    return ev


def case_service_job_register_places_all(h):
    make_world(h, 10)
    job = mock.job()
    ev = register_and_eval(h, job)
    h.process("service", ev)
    assert len(h.plans) == 1
    placed = h.store.allocs_by_job("default", job.id)
    assert len(placed) == 10
    assert len({a.node_id for a in placed}) == 10
    for a in placed:
        assert a.desired_status == AllocDesiredStatus.RUN
        assert a.metrics.nodes_evaluated == 10
        assert a.metrics.score_meta
    assert ev.queued_allocations == {"web": 0}


def case_insufficient_capacity_creates_blocked_eval(h):
    make_world(h, 2)
    job = mock.job()
    job.task_groups[0].count = 4
    job.task_groups[0].tasks[0].resources.cpu = 3000
    ev = register_and_eval(h, job)
    h.process("service", ev)
    assert len(h.store.allocs_by_job("default", job.id)) == 2
    assert ev.queued_allocations["web"] == 2
    blocked = [e for e in h.create_evals_list if e.status == EvalStatus.BLOCKED]
    assert len(blocked) == 1
    assert ev.blocked_eval == blocked[0].id
    assert blocked[0].class_eligibility


def case_no_feasible_nodes(h):
    make_world(h, 3)
    job = mock.job()
    job.constraints.append(port_job.Constraint("${attr.kernel.name}", "windows"))
    ev = register_and_eval(h, job)
    h.process("service", ev)
    assert h.store.allocs_by_job("default", job.id) == []
    assert ev.queued_allocations["web"] == 10


def case_job_update_destructive_honors_max_parallel(h):
    make_world(h, 10)
    job = mock.job()
    job.update.max_parallel = 3
    h.process("service", register_and_eval(h, job))
    assert len(h.store.allocs_by_job("default", job.id)) == 10
    job2 = job.copy()
    job2.task_groups[0].tasks[0].config = {"command": "/bin/sleep"}
    job2.update = job.update
    h.store.upsert_job(h.next_index(), job2)
    h.process("service", mock.eval(job_id=job.id,
                                   triggered_by=EvalTrigger.JOB_REGISTER))
    allocs = h.store.allocs_by_job("default", job.id)
    stopped = [a for a in allocs if a.desired_status == AllocDesiredStatus.STOP]
    new_version = [a for a in allocs if a.desired_status == AllocDesiredStatus.RUN
                   and a.job is not None and a.job.version == job2.version]
    assert len(stopped) == 3
    assert len(new_version) == 3


def case_job_update_inplace_when_compatible(h):
    make_world(h, 5)
    job = mock.job()
    job.task_groups[0].count = 5
    h.process("service", register_and_eval(h, job))
    before = {a.id for a in h.store.allocs_by_job("default", job.id)}
    job2 = job.copy()
    job2.priority = 70
    h.store.upsert_job(h.next_index(), job2)
    h.process("service", mock.eval(job_id=job.id))
    run = [a for a in h.store.allocs_by_job("default", job.id)
           if a.desired_status == AllocDesiredStatus.RUN]
    assert {a.id for a in run} == before
    assert all(a.job.version == job2.version for a in run)


def case_scale_down_stops_highest_indices(h):
    make_world(h, 6)
    job = mock.job()
    job.task_groups[0].count = 6
    h.process("service", register_and_eval(h, job))
    job2 = job.copy()
    job2.task_groups[0].count = 2
    h.store.upsert_job(h.next_index(), job2)
    h.process("service", mock.eval(job_id=job.id))
    run = [a for a in h.store.allocs_by_job("default", job.id)
           if a.desired_status == AllocDesiredStatus.RUN]
    assert sorted(a.index() for a in run) == [0, 1]


def case_stop_job_stops_everything(h):
    make_world(h, 4)
    job = mock.job()
    job.task_groups[0].count = 4
    h.process("service", register_and_eval(h, job))
    job2 = job.copy()
    job2.stop = True
    h.store.upsert_job(h.next_index(), job2)
    h.process("service", mock.eval(job_id=job.id,
                                   triggered_by=EvalTrigger.JOB_DEREGISTER))
    assert all(a.desired_status == AllocDesiredStatus.STOP
               for a in h.store.allocs_by_job("default", job.id))


def case_failed_alloc_batch_reschedules_immediately(h):
    make_world(h, 3)
    job = mock.batch_job()
    job.task_groups[0].count = 1
    h.process("batch", register_and_eval(h, job))
    allocs = h.store.allocs_by_job("default", job.id)
    assert len(allocs) == 1
    failed = allocs[0].copy()
    failed.client_status = AllocClientStatus.FAILED
    h.store.update_allocs_from_client(h.next_index(), [failed])
    h.process("batch", mock.eval(job_id=job.id, type="batch",
                                 triggered_by=EvalTrigger.RETRY_FAILED_ALLOC))
    run = [a for a in h.store.allocs_by_job("default", job.id)
           if a.desired_status == AllocDesiredStatus.RUN
           and not a.client_terminal_status()]
    assert len(run) == 1
    assert run[0].previous_allocation == failed.id
    assert run[0].reschedule_tracker is not None
    assert run[0].node_id != failed.node_id


def case_failed_service_alloc_creates_delayed_followup(h):
    make_world(h, 2)
    job = mock.job()
    job.task_groups[0].count = 1
    h.process("service", register_and_eval(h, job))
    a = h.store.allocs_by_job("default", job.id)[0].copy()
    a.client_status = AllocClientStatus.FAILED
    h.store.update_allocs_from_client(h.next_index(), [a])
    h.process("service", mock.eval(job_id=job.id))
    followups = [e for e in h.create_evals_list if e.wait_until > 0]
    assert len(followups) == 1
    assert followups[0].triggered_by == EvalTrigger.RETRY_FAILED_ALLOC


def case_node_down_replaces_allocs(h):
    make_world(h, 3)
    job = mock.job()
    job.task_groups[0].count = 3
    h.process("service", register_and_eval(h, job))
    victim = h.store.allocs_by_job("default", job.id)[0]
    h.store.update_node_status(h.next_index(), victim.node_id, "down")
    h.process("service", mock.eval(job_id=job.id,
                                   triggered_by=EvalTrigger.NODE_UPDATE))
    allocs = h.store.allocs_by_job("default", job.id)
    lost = [a for a in allocs if a.client_status == AllocClientStatus.LOST]
    assert len(lost) == 1 and lost[0].id == victim.id
    run = [a for a in allocs if a.desired_status == AllocDesiredStatus.RUN
           and a.client_status != AllocClientStatus.LOST]
    assert len(run) == 3
    assert all(a.node_id != victim.node_id for a in run)


def case_partial_plan_rejection_retries(h):
    make_world(h, 4)
    job = mock.job()
    job.task_groups[0].count = 4
    ev = register_and_eval(h, job)
    h.reject_plan = True
    with pytest.raises(Exception):
        h.process("service", ev)
    assert len(h.plans) == 5


def case_system_job_places_one_per_node(h):
    nodes = make_world(h, 5)
    job = mock.system_job()
    h.process("system", register_and_eval(h, job))
    allocs = h.store.allocs_by_job("default", job.id)
    assert {a.node_id for a in allocs} == {n.id for n in nodes}
    h.store.upsert_node(h.next_index(), mock.node())
    h.process("system", mock.eval(job_id=job.id, type="system",
                                  triggered_by=EvalTrigger.NODE_UPDATE))
    assert len(h.store.allocs_by_job("default", job.id)) == 6


def case_sysbatch_does_not_rerun_completed(h):
    make_world(h, 2)
    job = mock.sysbatch_job()
    h.process("sysbatch", register_and_eval(h, job))
    allocs = h.store.allocs_by_job("default", job.id)
    assert len(allocs) == 2
    done = allocs[0].copy()
    done.client_status = AllocClientStatus.COMPLETE
    h.store.update_allocs_from_client(h.next_index(), [done])
    h.process("sysbatch", mock.eval(job_id=job.id, type="sysbatch"))
    assert len(h.store.allocs_by_job("default", job.id)) == 2


def case_bulk_path_large_batch(h):
    """tests/test_bulk.py's end-to-end bulk case on the port."""
    make_world(h, 16)
    job = mock.batch_job()
    tg = job.task_groups[0]
    tg.count = 600
    tg.tasks[0].resources.cpu = 50
    tg.tasks[0].resources.memory_mb = 100
    tg.ephemeral_disk.size_mb = 0
    h.process("batch", register_and_eval(h, job))
    allocs = h.store.allocs_by_job("default", job.id)
    assert len(allocs) == 600
    assert (h.store.matrix.used <= h.store.matrix.capacity + 1e-3).all()
    assert allocs[0].metrics.nodes_evaluated > 0


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generic_sched_mirror(case):
    CASES[case](Harness(device="cpu"))


def _c2m_filling(m, J, H, kw, n_jobs=20):
    """The filling regime: 20 C2M-shaped jobs (2,000 allocs) on 64 nodes,
    so the groups of one eval share nodes that fill up.  Returns the
    Harness and the per-job {task group: {row: count}} maps."""
    h = H(**kw)
    for i in range(64):
        nd = m.node()
        nd.id = f"node-{i:04d}"
        h.store.upsert_node(h.next_index(), nd)
    for i in range(n_jobs):
        job = _stream(m, J)[0][1]
        job.id = f"c2m-{i}"
        h.store.upsert_job(h.next_index(), job)
        ev = m.eval(job_id=job.id, type="batch")
        h.store.upsert_evals(h.next_index(), [ev])
        h.process("batch", ev)
    maps = {}
    for i in range(n_jobs):
        per = {}
        for a in h.store.allocs_by_job("default", f"c2m-{i}"):
            tg = per.setdefault(a.task_group, {})
            row = h.store.matrix.row_of[a.node_id]
            tg[row] = tg.get(row, 0) + 1
        maps[f"c2m-{i}"] = per
    return h, maps


def test_engine_off_bulk_groups_chain_where_the_reference_overcommits():
    """Reference fault (ROADMAP queue C): with the engine off the
    reference gives every bulk group of one eval the same usage base, so
    the ten groups of C2M-shaped jobs stack on the same nodes until a
    filling node is over-committed, the applier rejects it and the eval
    fails.  The port chains the groups, and so places exactly what the
    reference places with its engine on (which chains the groups of one
    eval through its FIFO dispatch).  Both engine-off runs pin
    NOMAD_TPU_ENGINE=0."""
    from nomad_tpu.scheduler.generic import SetStatusError as RefSetStatusError

    mp = pytest.MonkeyPatch()
    mp.setenv("NOMAD_TPU_ENGINE", "0")
    try:
        with pytest.raises(RefSetStatusError, match="maximum attempts"):
            _c2m_filling(ref_mock, ref_job, ref_testing.Harness, {})
        h, maps = _c2m_filling(port_mock, port_job, port_testing.Harness,
                               {"device": "cpu"})
        mp.setenv("NOMAD_TPU_ENGINE", "1")
        ref_h, ref_maps = _c2m_filling(ref_mock, ref_job,
                                       ref_testing.Harness, {})
    finally:
        mp.undo()
    assert sum(c for m in maps.values() for tg in m.values()
               for c in tg.values()) == 2000
    assert maps == ref_maps
    np.testing.assert_allclose(h.store.matrix.used, ref_h.store.matrix.used,
                               rtol=1e-6)
    assert (h.store.matrix.used <= h.store.matrix.capacity).all()
