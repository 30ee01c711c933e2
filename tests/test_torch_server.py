"""The port's server spine on the CPU.

1. Unit cases for the plan queue, the eval broker (leases, nack
   redelivery, priority order, job dedup, dead letters, delays, wave
   dequeue), the blocked-evals tracker, the wave feeder and the
   pipelined plan-apply loop, mirroring tests/test_core.py,
   tests/test_plan_pipeline.py and tests/test_wave_pipeline.py.
2. The dev-mode Server end to end: register, blocked-then-unblocked,
   node down, and `stop()` leaving no thread behind.
3. Parity: the same world and job stream through the reference's
   `Server` and the port's `Server(device="cpu")`, each with one worker
   and NOMAD_TPU_PIPELINE_DEPTH=0, so evals run one at a time in broker
   order.  The reference runs with NOMAD_TPU_SHARD=0, so its engine stays
   single-device on conftest.py's eight CPU devices.  Alloc ids differ
   between the packages; placements are compared as {job index: {row:
   count}} maps.
   - the e2e spine shape at 1,000 nodes x 10 batch jobs of count 100:
     identical maps and committed usage;
   - a small preemption-heavy world (64 nodes filled by three batch jobs
     of 192 at priorities 20/30/40, then 5 service jobs of 8 at 90, each
     job run to idle before the next is registered): identical maps,
     identical evictions per (job index, row), and the same number of
     preemption evals.
"""
import importlib
import threading
import time

import numpy as np
import pytest
import torch

from nomad_tpu_torch import mock
from nomad_tpu_torch.core.blocked import BlockedEvals
from nomad_tpu_torch.core.broker import FAILED_QUEUE, EvalBroker, EvalWaveFeeder
from nomad_tpu_torch.core.plan_apply import PlanApplier
from nomad_tpu_torch.core.plan_queue import LeadershipLostError, PlanQueue
from nomad_tpu_torch.core.server import Server, ServerConfig
from nomad_tpu_torch.parallel.engine import stop_engines
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import (AllocClientStatus, AllocDesiredStatus,
                                     Evaluation, EvalStatus)
from nomad_tpu_torch.structs.plan import Plan

torch.set_num_threads(1)

# threads the spine and its engine start
SPINE_THREADS = ("worker-", "plan-apply", "plan-commit", "eval-reaper",
                 "dup-blocked-reaper", "placement-engine")


@pytest.fixture(autouse=True, scope="module")
def _stop_engines():
    yield
    stop_engines()


def _spine_threads(before=()):
    """Names of the spine's live threads that were not in `before` (an
    earlier test file in the same process may have left an engine)."""
    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith(SPINE_THREADS) and t not in before)


# ------------------------------------------------------------ plan queue

def test_plan_queue_priority_order_and_batch():
    q = PlanQueue()
    q.set_enabled(True)
    plans = [Plan(eval_id=f"e{p}", priority=p) for p in (10, 90, 50, 90)]
    for p in plans:
        q.enqueue(p)
    assert q.depth() == 4
    got = [p.plan.eval_id for p in q.dequeue_batch(3, timeout=0.1)]
    assert got == ["e90", "e90", "e50"]
    assert [p.plan.eval_id for p in q.dequeue_batch(3, timeout=0.1)] == \
        ["e10"]
    assert q.dequeue_batch(3, timeout=0.05) == []


def test_plan_queue_disable_fails_pending_plans():
    q = PlanQueue()
    with pytest.raises(LeadershipLostError):
        q.enqueue(Plan(eval_id="e"))
    q.set_enabled(True)
    pending = q.enqueue(Plan(eval_id="e"))
    q.set_enabled(False)
    with pytest.raises(LeadershipLostError):
        pending.future.result(timeout=1)
    with pytest.raises(LeadershipLostError):
        pending.evaluated.result(timeout=1)


# ------------------------------------------------------------ broker

def make_broker():
    b = EvalBroker(nack_timeout=5.0, initial_nack_delay=0.0,
                   subsequent_nack_delay=0.0)
    b.set_enabled(True)
    return b


def test_broker_priority_and_fifo():
    b = make_broker()
    lo = mock.eval(priority=10)
    hi = mock.eval(priority=90)
    mid1 = mock.eval(priority=50)
    mid2 = mock.eval(priority=50)
    for e in (lo, mid1, hi, mid2):
        b.enqueue(e)
    got = [b.dequeue(["service"])[0].id for _ in range(4)]
    assert got == [hi.id, mid1.id, mid2.id, lo.id]


def test_broker_lease_nack_redelivery():
    b = make_broker()
    ev = mock.eval()
    b.enqueue(ev)
    got, token = b.dequeue(["service"])
    assert got.id == ev.id
    assert b.outstanding(ev.id) == token
    assert b.dequeue(["service"])[0] is None     # leased, not available
    assert not b.ack(ev.id, "wrong-token")
    assert b.nack(ev.id, token)
    got2, token2 = b.dequeue(["service"])        # redelivered
    assert got2.id == ev.id and token2 != token
    assert b.ack(ev.id, token2)
    assert b.ready_count() == 0 and b.unacked_count() == 0


def test_broker_expired_lease_auto_nacks():
    b = EvalBroker(nack_timeout=0.05, initial_nack_delay=0.0,
                   subsequent_nack_delay=0.0)
    b.set_enabled(True)
    ev = mock.eval()
    b.enqueue(ev)
    _, token = b.dequeue(["service"])
    time.sleep(0.1)
    assert b.outstanding(ev.id) is None
    got, token2 = b.dequeue(["service"], timeout=1.0)
    assert got.id == ev.id and token2 != token
    assert not b.ack(ev.id, token)


def test_broker_job_dedup_pending():
    b = make_broker()
    e1 = mock.eval(job_id="same-job")
    e2 = mock.eval(job_id="same-job")
    b.enqueue(e1)
    got, token = b.dequeue(["service"])
    b.enqueue(e2)                                 # waits behind e1
    assert b.dequeue(["service"])[0] is None
    b.ack(got.id, token)
    got2, _ = b.dequeue(["service"])
    assert got2.id == e2.id


def test_broker_delivery_limit_dead_letters():
    b = make_broker()
    b.delivery_limit = 2
    ev = mock.eval()
    b.enqueue(ev)
    for _ in range(2):
        got, token = b.dequeue(["service"])
        if got is None:
            break
        b.nack(ev.id, token)
    got, _ = b.dequeue([FAILED_QUEUE])
    assert got is not None and got.id == ev.id


def test_broker_delayed_eval():
    b = make_broker()
    ev = mock.eval()
    ev.wait_until = time.time() + 0.15
    b.enqueue(ev)
    assert b.dequeue(["service"])[0] is None
    got, _ = b.dequeue(["service"], timeout=1.0)
    assert got is not None and got.id == ev.id
    assert time.time() >= ev.wait_until


def test_broker_scheduler_type_routing():
    b = make_broker()
    svc = mock.eval(type="service")
    sys_ = mock.eval(type="system")
    b.enqueue(svc)
    b.enqueue(sys_)
    got, _ = b.dequeue(["system"])
    assert got.id == sys_.id


def _eval(ns="default", job="j", prio=50):
    return Evaluation(id=mock._uuid(), namespace=ns, priority=prio,
                      type="batch", job_id=job)


def test_broker_dequeue_batch_drains_ready_without_waiting():
    broker = make_broker()
    evs = [_eval(job=f"j{i}") for i in range(6)]
    for ev in evs:
        broker.enqueue(ev)
    t0 = time.time()
    wave = broker.dequeue_batch(["batch"], max_n=4, timeout=5.0)
    assert len(wave) == 4
    assert time.time() - t0 < 1.0
    for ev, tok in wave:
        assert broker.ack(ev.id, tok)
    assert len(broker.dequeue_batch(["batch"], max_n=8, timeout=1.0)) == 2
    t0 = time.time()
    assert broker.dequeue_batch(["batch"], max_n=4, timeout=0.2) == []
    assert 0.15 < time.time() - t0 < 2.0


def test_broker_fair_dequeue_alternates_namespaces():
    b = make_broker()
    for i in range(3):
        b.enqueue(_eval(ns="a", job=f"a{i}"))
    for i in range(3):
        b.enqueue(_eval(ns="b", job=f"b{i}"))
    got = [b.dequeue(["batch"])[0].namespace for _ in range(6)]
    assert got == ["a", "b", "a", "b", "a", "b"]


# ------------------------------------------------------------ wave feeder

def test_wave_feeder_buffers_and_closes():
    broker = make_broker()
    for i in range(5):
        broker.enqueue(_eval(job=f"j{i}"))
    feeder = EvalWaveFeeder(broker, max_n=5)
    first = feeder.get(["batch"], timeout=1.0)
    assert first is not None
    assert feeder.stats["waves"] == 1
    assert feeder.stats["wave_evals"] == 5
    second = feeder.get(["batch"], timeout=0.0)
    assert second is not None and second[0].id != first[0].id
    feeder.close()                       # nacks the three still buffered
    assert broker.stats["nacked"] == 3


# ------------------------------------------------------------ blocked

def test_blocked_unblock_on_class():
    b = make_broker()
    blocked = BlockedEvals(b)
    blocked.set_enabled(True)
    ev = mock.eval()
    ev.status = EvalStatus.BLOCKED
    ev.class_eligibility = {"v1:abc": False}
    blocked.block(ev)
    assert blocked.blocked_count() == 1
    assert blocked.unblock("v1:abc", 100) == []
    released = blocked.unblock("v1:new-class", 101)
    assert len(released) == 1
    assert b.ready_count() == 1


def test_blocked_unblocks_on_node_capacity_change():
    b = make_broker()
    blocked = BlockedEvals(b)
    blocked.set_enabled(True)
    ev = mock.eval()
    ev.status = EvalStatus.BLOCKED
    blocked.block(ev)
    node = mock.node()
    node.modify_index = 7
    blocked.watch_state("nodes", node)
    assert blocked.blocked_count() == 0 and b.ready_count() == 1
    got, _ = b.dequeue(["service"])
    assert got.status == EvalStatus.PENDING and got.snapshot_index == 7


def test_blocked_dedup_per_job_and_unblock_all():
    b = make_broker()
    blocked = BlockedEvals(b)
    blocked.set_enabled(True)
    e1 = mock.eval(job_id="j1")
    e1.create_index = 1
    e2 = mock.eval(job_id="j1")
    e2.create_index = 2
    blocked.block(e1)
    blocked.block(e2)
    assert blocked.blocked_count() == 1
    assert [d.id for d in blocked.get_duplicates()] == [e1.id]
    assert blocked.get_duplicates() == []
    assert [e.id for e in blocked.unblock_all(5)] == [e2.id]
    assert blocked.blocked_count() == 0 and b.ready_count() == 1


# ------------------------------------------------------------ applier loop

def _one_node_store():
    store = StateStore()
    node = mock.node()
    store.upsert_node(1, node)
    return store, node


def _plan_for(node_id, cpu, mem):
    j = mock.job()
    j.task_groups[0].tasks[0].resources.cpu = cpu
    j.task_groups[0].tasks[0].resources.memory_mb = mem
    plan = Plan(eval_id=mock._uuid(), job=j)
    plan.append_alloc(mock.alloc_for(j, node_id=node_id), j)
    return plan


def test_pipeline_overlaps_commit_and_rejects_conflicts():
    store, node = _one_node_store()
    gate = threading.Event()          # holds the first commit
    committed = []

    def slow_commit(applied):
        if not committed:
            gate.wait(timeout=10)
        idx = store.latest_index + 1
        if isinstance(applied, list):
            store.upsert_plan_results_many(idx, applied)
        else:
            store.upsert_plan_results(idx, applied)
        committed.append(idx)
        return idx

    applier = PlanApplier(store, commit_fn=slow_commit, device="cpu")
    queue = PlanQueue()
    queue.set_enabled(True)
    stop = threading.Event()
    t = threading.Thread(target=applier.run_loop, args=(queue, stop),
                         daemon=True)
    t.start()
    try:
        pa = queue.enqueue(_plan_for(node.id, 3000, 6000))
        pa.evaluated.result(timeout=10)
        # B wants the same resources: rejected against A's in-flight
        # overlay although A has not committed
        pb = queue.enqueue(_plan_for(node.id, 3000, 6000))
        deadline = time.time() + 5
        while time.time() < deadline and applier.stats["partial"] == 0:
            time.sleep(0.02)
        assert applier.stats["partial"] == 1
        assert not committed
        gate.set()
        ra = pa.future.result(timeout=10)
        rb = pb.future.result(timeout=10)
        assert ra.node_allocation and not ra.rejected_nodes
        assert rb.rejected_nodes == [node.id]
    finally:
        stop.set()
        gate.set()
        t.join(5)
    assert not applier._overlay


def test_pipeline_coalesces_a_batch_into_one_commit():
    store, node = _one_node_store()
    commits = []

    def commit(applied):
        idx = store.latest_index + 1
        batch = applied if isinstance(applied, list) else [applied]
        store.upsert_plan_results_many(idx, batch)
        commits.append(len(batch))
        return idx

    applier = PlanApplier(store, commit_fn=commit, device="cpu")
    queue = PlanQueue()
    queue.set_enabled(True)
    pendings = [queue.enqueue(_plan_for(node.id, 500, 512))
                for _ in range(3)]
    stop = threading.Event()
    t = threading.Thread(target=applier.run_loop, args=(queue, stop),
                         daemon=True)
    t.start()
    try:
        for p in pendings:
            assert p.future.result(timeout=10).node_allocation
    finally:
        stop.set()
        t.join(5)
    assert commits == [3]
    assert applier.stats["coalesced"] == 3
    row = store.matrix.row_of[node.id]
    assert store.matrix.used[row, 0] == 1500.0
    assert not applier._overlay


# ------------------------------------------------------------ server

def test_server_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Server()
    with pytest.raises(NotImplementedError):
        Server(device="cpu", raft_transport=object())
    assert Server(device="cpu").device.type == "cpu"


def test_server_end_to_end_spine_and_stop():
    before = set(threading.enumerate())
    s = Server(ServerConfig(num_schedulers=2), device="cpu")
    s.start()
    eng = s._engine
    try:
        for _ in range(5):
            s.register_node(mock.node())
        job = mock.job()
        job.task_groups[0].count = 5
        s.register_job(job)
        assert s.wait_for_idle(30.0)
        assert len(s.store.allocs_by_job("default", job.id)) == 5
        evs = s.store.evals_by_job("default", job.id)
        assert any(e.status == EvalStatus.COMPLETE for e in evs)
        assert eng._thread.is_alive()
        assert "plan-apply" in _spine_threads(before)
    finally:
        s.stop()
    assert not eng._thread.is_alive()
    assert _spine_threads(before) == []


def test_server_stops_promptly_with_plans_in_flight(monkeypatch):
    """stop() on a busy server: the workers finish their evals while the
    applier still drains the plan queue, so a worker waiting on its
    plan's result is never left to its join timeout (60 s a worker, one
    after another) behind an applier that already stopped."""
    real = PlanApplier._evaluate

    def slow_evaluate(self, plan):
        time.sleep(0.02)
        return real(self, plan)

    monkeypatch.setattr(PlanApplier, "_evaluate", slow_evaluate)
    before = set(threading.enumerate())
    s = Server(ServerConfig(num_schedulers=8), device="cpu")
    s.start()
    for _ in range(32):
        s.register_node(mock.node())
    for _ in range(24):
        job = mock.batch_job()
        job.task_groups[0].count = 4
        s.register_job(job)
    assert _wait(lambda: s.plan_queue.depth() >= 2, 30.0)
    stopper = threading.Thread(target=s.stop)
    t0 = time.monotonic()
    stopper.start()
    stopper.join(45.0)
    assert not stopper.is_alive()
    assert time.monotonic() - t0 < 30.0
    assert _spine_threads(before) == []


def test_worker_counts_failed_evals_by_cause(monkeypatch):
    """An eval the scheduler fails on is marked failed and redelivered,
    and the worker counts the error by cause, so a caller can tell the
    scheduler's attempt limit from a kernel's launch error."""
    from nomad_tpu_torch.core import worker as worker_mod

    def launch_error(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(worker_mod.factory, "new_scheduler", launch_error)
    s = Server(ServerConfig(num_schedulers=1), device="cpu")
    s.start()
    w = s.workers[0]
    try:
        s.register_node(mock.node())
        s.register_job(mock.job())
        assert _wait(lambda: w.stats["failed"] >= 2, 10.0)
    finally:
        s.stop()
    assert dict(w.failures) == {
        "RuntimeError: kernel launch failed": w.stats["failed"]}


def test_server_blocked_eval_unblocks_on_new_node():
    s = Server(ServerConfig(num_schedulers=1), device="cpu")
    s.start()
    try:
        s.register_node(mock.node())
        job = mock.job()
        job.task_groups[0].count = 3
        job.task_groups[0].tasks[0].resources.cpu = 3000
        s.register_job(job)
        assert s.wait_for_idle(30.0)
        assert len(s.store.allocs_by_job("default", job.id)) == 1
        assert s.blocked_evals.blocked_count() == 1
        s.register_node(mock.node())
        s.register_node(mock.node())
        deadline = time.time() + 10
        run = []
        while time.time() < deadline and len(run) < 3:
            run = [a for a in s.store.allocs_by_job("default", job.id)
                   if a.desired_status == AllocDesiredStatus.RUN]
            time.sleep(0.05)
        assert len(run) == 3
    finally:
        s.stop()


def test_server_node_down_triggers_replacement():
    s = Server(ServerConfig(num_schedulers=2), device="cpu")
    s.start()
    try:
        for _ in range(3):
            s.register_node(mock.node())
        job = mock.job()
        job.task_groups[0].count = 2
        s.register_job(job)
        assert s.wait_for_idle(30.0)
        victim = s.store.allocs_by_job("default", job.id)[0]
        s.update_node_status(victim.node_id, "down")
        assert s.wait_for_idle(30.0)
        run = [a for a in s.store.allocs_by_job("default", job.id)
               if a.desired_status == AllocDesiredStatus.RUN
               and a.client_status != AllocClientStatus.LOST]
        assert len(run) == 2
        assert all(a.node_id != victim.node_id for a in run)
    finally:
        s.stop()


def test_server_migrates_allocs_off_unhealthy_devices():
    """tests/test_device_health.py's migration case: a re-registration
    that marks a held device instance unhealthy reschedules the alloc
    onto healthy hardware."""
    from nomad_tpu_torch.structs.resources import DeviceRequest, NodeDevice
    s = Server(ServerConfig(num_schedulers=1), device="cpu")
    s.start()
    try:
        nodes = []
        for i in range(2):
            n = mock.node()
            n.node_resources.devices = [NodeDevice(
                vendor="nvidia", type="gpu", name="a100",
                instance_ids=[f"n{i}-g0"])]
            nodes.append(n)
            s.register_node(n)
        j = mock.batch_job()
        j.task_groups[0].count = 1
        j.task_groups[0].tasks[0].resources.devices = [
            DeviceRequest(name="gpu", count=1)]
        s.register_job(j)

        def live():
            return [a for a in s.store.allocs_by_job("default", j.id)
                    if not a.terminal_status()
                    and not a.desired_transition.should_force_reschedule()]
        assert _wait(lambda: len(live()) == 1, 30)
        a0 = live()[0]
        victim = next(n for n in nodes if n.id == a0.node_id)
        survivor = next(n for n in nodes if n.id != a0.node_id)
        victim.node_resources.devices[0].unhealthy_ids = list(
            victim.node_resources.devices[0].instance_ids)
        s.register_node(victim)
        assert _wait(lambda: len(live()) == 1 and live()[0].id != a0.id
                     and live()[0].node_id == survivor.id, 30)
    finally:
        s.stop()


def test_server_concurrent_workers_never_overcommit():
    """16 workers on a tight 32-node cluster with a short switch
    interval: every alloc lands, committed usage equals the live allocs'
    sum row by row and stays within capacity."""
    import sys
    from nomad_tpu_torch.encode.matrixizer import comparable_vec
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    s = Server(ServerConfig(num_schedulers=16), device="cpu")
    s.start()
    try:
        for _ in range(32):
            s.register_node(mock.node())
        jobs = []
        for k in range(40):
            j = mock.batch_job()
            tg = j.task_groups[0]
            tg.count = 6
            tg.tasks[0].resources.cpu = 420
            tg.tasks[0].resources.memory_mb = 850
            tg.ephemeral_disk.size_mb = 0
            jobs.append(j)
            s.register_job(j)
        assert _wait(lambda: _live(s.store, jobs) >= 240, 120)
        assert s.wait_for_idle(60)
    finally:
        s.stop()
        sys.setswitchinterval(prev)
    assert _live(s.store, jobs) == 240
    cm = s.store.matrix
    expect = np.zeros(cm.used.shape, np.float64)
    for a in s.store.allocs():
        if not a.terminal_status():
            expect[cm.row_of[a.node_id]] += comparable_vec(
                a.comparable_resources())
    np.testing.assert_array_equal(cm.used, expect)
    assert (cm.used <= cm.capacity).all()


# ------------------------------------------------------------ parity

def _server_mod(root):
    return (importlib.import_module(f"{root}.mock"),
            importlib.import_module(f"{root}.core.server"))


def _wait(cond, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.02)
    return cond()


def _live(store, jobs):
    return sum(1 for j in jobs for a in store.allocs_by_job("default", j.id)
               if a.desired_status == "run")


def _maps(store, jobs):
    maps = {}
    for k, j in enumerate(jobs):
        per = {}
        for a in store.allocs_by_job("default", j.id):
            if a.desired_status == "run":
                row = store.matrix.row_of[a.node_id]
                per[row] = per.get(row, 0) + 1
        maps[k] = per
    return maps


def _e2e(root, kw):
    m, srv = _server_mod(root)
    s = srv.Server(srv.ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                                    gc_interval=3600.0), **kw)
    s.start()
    try:
        for i in range(1000):
            n = m.node()
            n.id = f"node-{i:04d}"
            n.name = n.id
            s.register_node(n)
        jobs = []
        for k in range(10):
            j = m.batch_job(id=f"batch-{k}")
            j.task_groups[0].count = 100
            jobs.append(j)
            s.register_job(j)
        assert _wait(lambda: _live(s.store, jobs) >= 1000, 300)
        assert s.wait_for_idle(60)
        return _maps(s.store, jobs), s.store.matrix.used.copy()
    finally:
        s.stop()


def _preemption_world(root, kw):
    m, srv = _server_mod(root)
    s = srv.Server(srv.ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                                    gc_interval=3600.0), **kw)
    s.start()
    try:
        cfg = s.store.scheduler_config
        cfg.preemption_config.service_scheduler_enabled = True
        cfg.preemption_config.batch_scheduler_enabled = True
        for i in range(64):
            n = m.node()
            n.id = f"node-{i:04d}"
            n.name = n.id
            n.attributes["rack"] = f"r{i % 50}"
            s.store.upsert_node(s.next_index(), n)

        def sized(j, count, prio):
            tg = j.task_groups[0]
            tg.count = count
            tg.tasks[0].resources.cpu = 420
            tg.tasks[0].resources.memory_mb = 850
            tg.ephemeral_disk.size_mb = 0
            j.priority = prio
            return j

        # one job at a time, each run to idle: the broker orders ready
        # evals by priority, so jobs registered together would run in
        # an order that depends on how fast the worker dequeues
        fillers = [sized(m.batch_job(id=f"fill-{k}"), 192, 20 + 10 * k)
                   for k in range(3)]
        services = [sized(m.job(id=f"svc-{k}"), 8, 90) for k in range(5)]
        for j in fillers + services:
            s.register_job(j)
            assert s.wait_for_idle(60)
        assert _live(s.store, fillers) + _live(s.store, services) == 576
        assert _live(s.store, services) == 40
        jobs = fillers + services
        evicted = {}
        for k, j in enumerate(jobs):
            for a in s.store.allocs_by_job("default", j.id):
                if a.desired_status == "evict":
                    key = (k, s.store.matrix.row_of[a.node_id])
                    evicted[key] = evicted.get(key, 0) + 1
        n_pre = sum(1 for e in s.store.evals()
                    if e.triggered_by == "preemption")
        used, cap = s.store.matrix.used.copy(), s.store.matrix.capacity
        assert (used <= cap).all()
        return _maps(s.store, jobs), evicted, n_pre, used
    finally:
        s.stop()


@pytest.fixture(scope="module")
def spine_runs():
    pytest.importorskip("jax")
    mp = pytest.MonkeyPatch()
    mp.setenv("NOMAD_TPU_PIPELINE_DEPTH", "0")
    mp.setenv("NOMAD_TPU_SHARD", "0")
    try:
        out = {"e2e": (_e2e("nomad_tpu", {}),
                       _e2e("nomad_tpu_torch", {"device": "cpu"})),
               "preempt": (_preemption_world("nomad_tpu", {}),
                           _preemption_world("nomad_tpu_torch",
                                             {"device": "cpu"}))}
    finally:
        mp.undo()
    return out


def test_e2e_spine_parity_placements(spine_runs):
    ref, port = spine_runs["e2e"]
    assert port[0] == ref[0]
    assert sum(sum(per.values()) for per in port[0].values()) == 1000


def test_e2e_spine_parity_committed_usage(spine_runs):
    ref, port = spine_runs["e2e"]
    np.testing.assert_array_equal(port[1], ref[1])


def test_preemption_spine_parity_placements(spine_runs):
    ref, port = spine_runs["preempt"]
    assert port[0] == ref[0]
    assert sum(sum(port[0][k].values()) for k in range(3, 8)) == 40
    np.testing.assert_array_equal(port[3], ref[3])


def test_preemption_spine_parity_evictions(spine_runs):
    ref, port = spine_runs["preempt"]
    assert port[1] == ref[1]
    assert sum(port[1].values()) >= 40
    assert port[2] == ref[2] > 0
