"""The port's control loops on the CPU, on the port alone: heartbeats,
deployments, drainer, periodic, events, GC, the plan applier's
deployment dedup and the restored blocked eval.  The cases of
tests/test_control_loops.py, each on `Server(device="cpu")`, plus the
heartbeat wheel's `expire(now)`, the batcher's coalescing and forced
flush, `stop()` leaving no loop thread, and the multiregion entry point
that stays out of this port."""
import threading
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.core.server import Server, ServerConfig
from nomad_tpu_torch.structs import (
    AllocClientStatus,
    AllocDesiredStatus,
    DeploymentStatus,
    EvalStatus,
)
from nomad_tpu_torch.structs.job import PeriodicConfig, UpdateStrategy


LOOP_THREADS = ("heartbeat", "heartbeat-batch", "deploy-watcher",
                "volume-watcher", "drainer", "periodic", "core-gc")


@pytest.fixture(autouse=True, scope="module")
def _stop_engines():
    yield
    from nomad_tpu_torch.parallel.engine import stop_engines
    stop_engines()


def make_server(**kw):
    # a case that does not test expiry keeps its nodes for an hour: under
    # the test runner's parallel workers a case can outlive the 10 s
    # default without a heartbeat
    kw.setdefault("heartbeat_ttl", 3600.0)
    s = Server(ServerConfig(num_schedulers=2, **kw), device="cpu")
    s.start()
    return s


# --------------------------------------------------------------- heartbeat

def test_heartbeat_expiry_marks_node_down_and_replaces():
    # a 1 s TTL (the reference's case has 0.3 s): the kept node's
    # heartbeats every 0.05 s must never miss it, and under the test
    # runner's parallel workers a 0.3 s stall of this thread happens
    s = make_server(heartbeat_ttl=1.0)
    try:
        nodes = [mock.node() for _ in range(2)]
        for n in nodes:
            s.register_node(n)
        job = mock.job()
        job.task_groups[0].count = 1
        s.register_job(job)
        # keep both nodes alive until the first placement lands (first jit
        # compile can exceed the short TTL)
        deadline = time.time() + 30
        while time.time() < deadline:
            for n in nodes:
                s.node_heartbeat(n.id)
            if s.store.allocs_by_job("default", job.id):
                break
            time.sleep(0.05)
        victim = s.store.allocs_by_job("default", job.id)[0]
        other = [n for n in nodes if n.id != victim.node_id][0]
        # keep the other node alive, let the victim's node expire
        deadline = time.time() + 10.0
        while time.time() < deadline:
            s.node_heartbeat(other.id)
            if s.store.node_by_id(victim.node_id) and \
               s.store._nodes[victim.node_id].status == "down":
                break
            time.sleep(0.05)
        assert s.store._nodes[victim.node_id].status == "down"
        s.wait_for_idle(30.0)
        run = [a for a in s.store.allocs_by_job("default", job.id)
               if a.desired_status == AllocDesiredStatus.RUN
               and a.client_status != AllocClientStatus.LOST]
        assert len(run) == 1 and run[0].node_id == other.id
    finally:
        s.stop()


# ------------------------------------------------------------- deployments

def test_deployment_succeeds_when_allocs_healthy():
    s = make_server()
    try:
        for _ in range(4):
            s.register_node(mock.node())
        job = mock.job()
        job.task_groups[0].count = 2
        s.register_job(job)
        s.wait_for_idle(30.0)
        # destructive update creates a deployment
        job2 = job.copy()
        job2.task_groups[0].tasks[0].config = {"command": "/bin/new"}
        s.register_job(job2)
        s.wait_for_idle(30.0)
        d = s.store.latest_deployment_by_job_id("default", job.id)
        assert d is not None and d.status == DeploymentStatus.RUNNING
        # mark new-version allocs healthy as a client would
        deadline = time.time() + 20
        while time.time() < deadline:
            allocs = [a for a in s.store.allocs_by_job("default", job.id)
                      if a.deployment_id == d.id
                      and a.desired_status == AllocDesiredStatus.RUN]
            for a in allocs:
                if not a.is_healthy():
                    u = a.copy()
                    u.client_status = AllocClientStatus.RUNNING
                    u.deployment_status = {"healthy": True}
                    s.store.update_allocs_from_client(s.next_index(), [u])
            dd = s.store.deployment_by_id(d.id)
            if dd.status == DeploymentStatus.SUCCESSFUL:
                break
            s.wait_for_idle(5.0)
            time.sleep(0.05)
        assert s.store.deployment_by_id(d.id).status == DeploymentStatus.SUCCESSFUL
        assert s.store.job_by_id("default", job.id).stable
    finally:
        s.stop()


def test_deployment_fails_on_unhealthy_and_autoreverts():
    s = make_server()
    try:
        for _ in range(4):
            s.register_node(mock.node())
        job = mock.job()
        job.task_groups[0].count = 2
        job.update = UpdateStrategy(max_parallel=2, auto_revert=True)
        job.task_groups[0].update = None
        s.register_job(job)
        s.wait_for_idle(30.0)
        # v0 healthy -> stable
        for a in s.store.allocs_by_job("default", job.id):
            u = a.copy()
            u.client_status = AllocClientStatus.RUNNING
            u.deployment_status = {"healthy": True}
            s.store.update_allocs_from_client(s.next_index(), [u])
        s.store.job_by_id("default", job.id).stable = True

        job2 = job.copy()
        job2.task_groups[0].tasks[0].config = {"command": "/bin/bad"}
        s.register_job(job2)
        s.wait_for_idle(30.0)
        d = s.store.latest_deployment_by_job_id("default", job.id)
        # new allocs report unhealthy
        for a in s.store.allocs_by_job("default", job.id):
            if a.deployment_id == d.id and not a.terminal_status():
                u = a.copy()
                u.deployment_status = {"healthy": False}
                s.store.update_allocs_from_client(s.next_index(), [u])
        deadline = time.time() + 20
        while time.time() < deadline:
            if s.store.deployment_by_id(d.id).status == DeploymentStatus.FAILED:
                break
            time.sleep(0.05)
        assert s.store.deployment_by_id(d.id).status == DeploymentStatus.FAILED
        # auto-revert registered a new version with the old config
        deadline = time.time() + 20
        while time.time() < deadline:
            j = s.store.job_by_id("default", job.id)
            if j.version > job2.version:
                break
            time.sleep(0.05)
        j = s.store.job_by_id("default", job.id)
        assert j.task_groups[0].tasks[0].config == {"command": "/bin/date"}
    finally:
        s.stop()


# ----------------------------------------------------------------- drainer

def test_drain_migrates_allocs_off_node():
    s = make_server()
    try:
        nodes = [mock.node() for _ in range(3)]
        for n in nodes:
            s.register_node(n)
        job = mock.job()
        job.task_groups[0].count = 3
        s.register_job(job)
        assert s.wait_for_idle(30.0)
        victim_alloc = s.store.allocs_by_job("default", job.id)[0]
        s.drainer.drain_node(victim_alloc.node_id, deadline_s=30.0)
        deadline = time.time() + 20
        while time.time() < deadline:
            run = [a for a in s.store.allocs_by_job("default", job.id)
                   if a.desired_status == AllocDesiredStatus.RUN
                   and not a.terminal_status()]
            if len(run) == 3 and all(a.node_id != victim_alloc.node_id
                                     for a in run):
                break
            time.sleep(0.05)
        run = [a for a in s.store.allocs_by_job("default", job.id)
               if a.desired_status == AllocDesiredStatus.RUN
               and not a.terminal_status()]
        assert len(run) == 3
        assert all(a.node_id != victim_alloc.node_id for a in run)
        # drain completes: strategy cleared, node ineligible
        deadline = time.time() + 10
        while time.time() < deadline:
            n = s.store._nodes[victim_alloc.node_id]
            if n.drain_strategy is None:
                break
            time.sleep(0.05)
        n = s.store._nodes[victim_alloc.node_id]
        assert n.drain_strategy is None
        assert n.scheduling_eligibility == "ineligible"
    finally:
        s.stop()


# ---------------------------------------------------------------- periodic

def test_periodic_dispatch_creates_child_jobs():
    from nomad_tpu_torch.core.periodic import next_cron_after
    # cron parsing
    nxt = next_cron_after("*/5 * * * *", 0.0)
    assert nxt == 300.0
    assert next_cron_after("@every 30s", 100.0) == 130.0

    s = make_server()
    try:
        s.register_node(mock.node())
        job = mock.job()
        job.task_groups[0].count = 1
        job.periodic = PeriodicConfig(spec="@every 0.2s")
        s.register_job(job)
        deadline = time.time() + 10
        children = []
        while time.time() < deadline:
            children = [j for j in s.store.jobs() if j.parent_id == job.id]
            if children:
                break
            time.sleep(0.05)
        assert children, "no periodic child launched"
        assert children[0].id.startswith(f"{job.id}/periodic-")
        assert children[0].periodic is None
        s.wait_for_idle(30.0)
        assert len(s.store.allocs_by_job("default", children[0].id)) == 1
    finally:
        s.stop()


# ------------------------------------------------------------------ events

def test_event_stream_delivers_filtered_events():
    s = make_server()
    try:
        sub = s.event_broker.subscribe({"Job": ["*"]})
        s.register_node(mock.node())
        job = mock.job()
        s.register_job(job)
        ev = sub.next(timeout=5.0)
        assert ev is not None and ev.topic == "Job"
        assert ev.type == "JobRegistered" and ev.key == job.id
        sub.close()
    finally:
        s.stop()


# --------------------------------------------------------------------- GC

def test_core_gc_collects_dead_jobs_and_evals():
    s = make_server()
    try:
        s.register_node(mock.node())
        job = mock.job()
        job.task_groups[0].count = 1
        s.register_job(job)
        assert s.wait_for_idle(30.0)
        s.deregister_job("default", job.id)
        assert s.wait_for_idle(30.0)
        # allocs stopped but client still reports: mark complete
        for a in s.store.allocs_by_job("default", job.id):
            u = a.copy()
            u.client_status = AllocClientStatus.COMPLETE
            s.store.update_allocs_from_client(s.next_index(), [u])
        stats = s.core_scheduler.process("force-gc", force=True)
        assert stats["jobs"] == 1
        assert s.store.job_by_id("default", job.id) is None
        assert s.store.allocs_by_job("default", job.id) == []
    finally:
        s.stop()


def test_node_gc_removes_down_nodes():
    s = make_server()
    try:
        n = mock.node()
        s.register_node(n)
        s.update_node_status(n.id, "down")
        stats = s.core_scheduler.process("node-gc", force=True)
        assert stats["nodes"] == 1
        assert s.store.node_by_id(n.id) is None or \
            s.store.snapshot().node_by_id(n.id) is None
    finally:
        s.stop()


# ------------------------------- drainer under churn (deadline + down node)

def test_drain_deadline_force_stops_and_replaces_atomically():
    """Deadline expiry force-stops the remaining allocs and their
    replacement evals ride the same raft entry: afterwards the job is
    back at count elsewhere, each stopped alloc replaced exactly once,
    and the drain completes."""
    s = make_server()
    try:
        nodes = [mock.node() for _ in range(3)]
        for n in nodes:
            s.register_node(n)
        job = mock.job()
        job.task_groups[0].count = 3
        job.update = None
        job.task_groups[0].update = None
        # no migrate slots: nothing moves before the deadline fires
        job.task_groups[0].migrate.max_parallel = 0
        s.register_job(job)
        assert s.wait_for_idle(30.0)
        victim = s.store.allocs_by_job("default", job.id)[0].node_id
        on_victim = [a.id for a in s.store.allocs_by_node(victim)
                     if not a.terminal_status()]
        assert on_victim
        s.drainer.drain_node(victim, deadline_s=0.3)
        deadline = time.time() + 20
        while time.time() < deadline:
            live = [a for a in s.store.allocs_by_job("default", job.id)
                    if not a.terminal_status()]
            if (len(live) == 3
                    and all(a.node_id != victim for a in live)
                    and s.store.node_by_id(victim).drain_strategy is None):
                break
            time.sleep(0.05)
        live = [a for a in s.store.allocs_by_job("default", job.id)
                if not a.terminal_status()]
        assert len(live) == 3
        assert all(a.node_id != victim for a in live)
        names = [a.name for a in live]
        assert len(set(names)) == len(names)
        # the force-stopped allocs carry the deadline description
        stopped = [a for a in s.store.allocs_by_job("default", job.id)
                   if a.id in on_victim]
        assert all("drain deadline" in (a.desired_description or "")
                   for a in stopped)
        assert s.store.node_by_id(victim).drain_strategy is None
    finally:
        s.stop()


def test_node_down_mid_drain_hands_allocs_to_lost_path():
    """A node hard-killed mid-drain: the reconciler's lost path (not the
    drainer) replaces its allocs — exactly once — and the drain then
    completes on the emptied node."""
    s = make_server(heartbeat_ttl=60.0)
    try:
        nodes = [mock.node() for _ in range(2)]
        for n in nodes:
            s.register_node(n)
        job = mock.job()
        job.task_groups[0].count = 2
        job.update = None
        job.task_groups[0].update = None
        # no migrate slots + far deadline: the drain is stuck, so the DOWN
        # transition is the only way the allocs can leave the node
        job.task_groups[0].migrate.max_parallel = 0
        s.register_job(job)
        assert s.wait_for_idle(30.0)
        victim = s.store.allocs_by_job("default", job.id)[0].node_id
        s.drainer.drain_node(victim, deadline_s=600.0)
        time.sleep(0.2)
        from nomad_tpu_torch.structs.node import NodeStatus
        s.update_node_status(victim, NodeStatus.DOWN)
        deadline = time.time() + 20
        while time.time() < deadline:
            live = [a for a in s.store.allocs_by_job("default", job.id)
                    if not a.terminal_status()]
            if len(live) == 2 and all(a.node_id != victim for a in live):
                break
            time.sleep(0.05)
        live = [a for a in s.store.allocs_by_job("default", job.id)
                if not a.terminal_status()]
        assert len(live) == 2
        assert all(a.node_id != victim for a in live)
        names = [a.name for a in live]
        assert len(set(names)) == len(names)
        # lost allocs went through the node-update path, not the drainer
        lost = [a for a in s.store.allocs_by_job("default", job.id)
                if a.client_status == AllocClientStatus.LOST]
        assert lost
        # the dead node emptied out, so the drain completed
        assert s.wait_for_idle(10.0)
        deadline = time.time() + 10
        while (time.time() < deadline
               and s.store.node_by_id(victim).drain_strategy is not None):
            time.sleep(0.05)
        assert s.store.node_by_id(victim).drain_strategy is None
    finally:
        s.stop()


# ---------------------- deployment revert retry / redelivery idempotence

def _healthy_report(s, job_id, healthy=True, deployment_id=None):
    for a in s.store.allocs_by_job("default", job_id):
        if a.terminal_status():
            continue
        if deployment_id is not None and a.deployment_id != deployment_id:
            continue
        u = a.copy()
        u.client_status = AllocClientStatus.RUNNING
        u.deployment_status = {"healthy": healthy}
        s.store.update_allocs_from_client(s.next_index(), [u])


def test_failed_autorevert_deployment_retries_lost_revert():
    """A deployment committed as FAILED whose auto-revert register was
    lost (leadership churn between the two writes) must still revert:
    the watcher retries while the job sits at the deployment's version,
    and the version guard makes the retry fire exactly once."""
    from nomad_tpu_torch.raft import MessageType
    s = make_server()
    try:
        for _ in range(2):
            s.register_node(mock.node())
        job = mock.job()
        job.task_groups[0].count = 2
        job.update = UpdateStrategy(max_parallel=2, auto_revert=True)
        job.task_groups[0].update = None
        s.register_job(job)
        s.wait_for_idle(30.0)
        _healthy_report(s, job.id)
        s.store.job_by_id("default", job.id).stable = True

        job2 = job.copy()
        job2.task_groups[0].tasks[0].config = {"command": "/bin/bad"}
        s.register_job(job2)
        s.wait_for_idle(30.0)
        d = s.store.latest_deployment_by_job_id("default", job.id)
        assert d is not None and d.job_version == job2.version

        # simulate the strand: FAILED lands, the revert register did not
        failed = d.copy()
        failed.status = DeploymentStatus.FAILED
        failed.status_description = DeploymentStatus.DESC_FAILED_ALLOCATIONS
        failed.modify_time = time.time()
        s.apply(MessageType.DEPLOYMENT_UPSERT, {"deployment": failed})

        deadline = time.time() + 20
        while time.time() < deadline:
            j = s.store.job_by_id("default", job.id)
            if j.version > job2.version:
                break
            time.sleep(0.05)
        j = s.store.job_by_id("default", job.id)
        assert j.version > job2.version
        assert j.task_groups[0].tasks[0].config == {"command": "/bin/date"}

        # the revert's own deployment completes once its allocs are healthy
        s.wait_for_idle(30.0)
        _healthy_report(s, job.id)
        s.wait_for_idle(30.0)
        settled_version = s.store.job_by_id("default", job.id).version
        # watcher keeps passing over the FAILED deployment: the version
        # guard must make every later pass a no-op (no double revert)
        for _ in range(3):
            s.deployment_watcher.reconcile_all()
            time.sleep(0.1)
        assert s.store.job_by_id("default", job.id).version == settled_version
    finally:
        s.stop()


def test_retry_revert_is_noop_for_superseded_deployment():
    """_retry_revert must not touch a FAILED deployment the job has
    already moved past — reverting it would resurrect a dead version."""
    s = make_server()
    try:
        s.register_node(mock.node())
        job = mock.job()
        job.task_groups[0].count = 1
        job.update = UpdateStrategy(max_parallel=1, auto_revert=True)
        job.task_groups[0].update = None
        s.register_job(job)
        s.wait_for_idle(30.0)
        _healthy_report(s, job.id)
        s.store.job_by_id("default", job.id).stable = True
        job2 = job.copy()
        job2.task_groups[0].tasks[0].config = {"command": "/bin/new"}
        s.register_job(job2)
        s.wait_for_idle(30.0)
        d = s.store.latest_deployment_by_job_id("default", job.id)
        fake = d.copy()
        fake.status = DeploymentStatus.FAILED
        fake.job_version = job.version           # superseded by job2
        version_before = s.store.job_by_id("default", job.id).version
        s.deployment_watcher._retry_revert(fake)
        assert s.store.job_by_id("default", job.id).version == version_before
    finally:
        s.stop()


def test_redelivered_deployment_evals_do_not_flap_healthy_deployment():
    """broker.lease_expire storms redeliver deployment-watcher evals;
    processing the same watch eval again (and watcher re-passes) must
    leave a SUCCESSFUL deployment and its job untouched."""
    from nomad_tpu_torch.structs import Evaluation, EvalStatus
    from nomad_tpu_torch.structs.evaluation import EvalTrigger
    s = make_server()
    try:
        for _ in range(2):
            s.register_node(mock.node())
        job = mock.job()
        job.task_groups[0].count = 2
        job.update = UpdateStrategy(max_parallel=2, auto_revert=True)
        job.task_groups[0].update = None
        s.register_job(job)
        s.wait_for_idle(30.0)
        _healthy_report(s, job.id)
        s.store.job_by_id("default", job.id).stable = True
        job2 = job.copy()
        job2.task_groups[0].tasks[0].config = {"command": "/bin/v2"}
        s.register_job(job2)
        s.wait_for_idle(30.0)
        d = s.store.latest_deployment_by_job_id("default", job.id)
        _healthy_report(s, job.id, deployment_id=d.id)
        deadline = time.time() + 20
        while time.time() < deadline:
            if (s.store.deployment_by_id(d.id).status
                    == DeploymentStatus.SUCCESSFUL):
                break
            time.sleep(0.05)
        assert (s.store.deployment_by_id(d.id).status
                == DeploymentStatus.SUCCESSFUL)
        version = s.store.job_by_id("default", job.id).version
        # storm of redelivered watch evals + watcher re-passes
        for _ in range(4):
            s.create_evals([Evaluation(
                namespace="default", priority=50, type=job.type,
                job_id=job.id, deployment_id=d.id,
                triggered_by=EvalTrigger.DEPLOYMENT_WATCHER,
                status=EvalStatus.PENDING)])
            s.deployment_watcher.reconcile_all()
        assert s.wait_for_idle(30.0)
        assert (s.store.deployment_by_id(d.id).status
                == DeploymentStatus.SUCCESSFUL)
        assert s.store.job_by_id("default", job.id).version == version
        live = [a for a in s.store.allocs_by_job("default", job.id)
                if not a.terminal_status()]
        assert len(live) == 2
    finally:
        s.stop()


# ------------------- duplicate deployments / stranded blocked evals (storm)

def test_plan_apply_dedups_deployment_per_job_version():
    """Two evals for the same registration can race: each plans a fresh
    deployment against a snapshot that predates the other's commit.  The
    second plan's deployment must fold into the first — its placements
    remapped — instead of stranding a RUNNING deployment nothing will
    ever report health for."""
    from nomad_tpu_torch.state.store import AppliedPlanResults
    from nomad_tpu_torch.structs import Deployment

    s = make_server()
    try:
        s.register_node(mock.node())
        job = mock.job()
        job.task_groups[0].count = 1
        # no update stanza: registration must not create a deployment of
        # its own, so the two racing plans below are the only writers
        job.update = None
        job.task_groups[0].update = None
        s.register_job(job)
        s.wait_for_idle(30.0)
        jv = s.store.job_by_id("default", job.id)

        def mk_deployment():
            return Deployment(
                namespace="default", job_id=job.id, job_version=jv.version,
                job_modify_index=jv.job_modify_index,
                job_create_index=jv.create_index,
                status=DeploymentStatus.RUNNING)

        d1, d2 = mk_deployment(), mk_deployment()
        a1 = mock.alloc_for(jv, s.store.nodes()[0].id, index=7)
        a1.deployment_id = d1.id
        a2 = mock.alloc_for(jv, s.store.nodes()[0].id, index=8)
        a2.deployment_id = d2.id
        s.store.upsert_plan_results(s.next_index(), AppliedPlanResults(
            allocs_to_place=[a1], deployment=d1, plan_id="dup-d1"))
        s.store.upsert_plan_results(s.next_index(), AppliedPlanResults(
            allocs_to_place=[a2], deployment=d2, plan_id="dup-d2"))

        assert s.store.deployment_by_id(d1.id) is not None
        assert s.store.deployment_by_id(d2.id) is None
        by_job = [d for d in s.store.deployments()
                  if d.job_id == job.id and d.job_version == jv.version]
        assert len(by_job) == 1
        # the loser's placement joined the winner
        got = next(a for a in s.store.allocs_by_job("default", job.id)
                   if a.id == a2.id)
        assert got.deployment_id == d1.id
    finally:
        s.stop()


def test_failed_deployment_can_be_superseded_by_new_one():
    """The per-version dedup must not eat a legitimate retry after the
    prior deployment failed."""
    from nomad_tpu_torch.state.store import AppliedPlanResults
    from nomad_tpu_torch.structs import Deployment

    s = make_server()
    try:
        d1 = Deployment(namespace="default", job_id="j", job_version=3,
                        job_create_index=5, status=DeploymentStatus.FAILED)
        d2 = Deployment(namespace="default", job_id="j", job_version=3,
                        job_create_index=5, status=DeploymentStatus.RUNNING)
        s.store.upsert_plan_results(s.next_index(), AppliedPlanResults(
            deployment=d1, plan_id="sup-d1"))
        s.store.upsert_plan_results(s.next_index(), AppliedPlanResults(
            deployment=d2, plan_id="sup-d2"))
        assert s.store.deployment_by_id(d1.id) is not None
        assert s.store.deployment_by_id(d2.id) is not None
    finally:
        s.stop()


def test_restored_blocked_eval_gets_one_reevaluation():
    """Leader failover loses the missed-unblock indexes: a blocked eval
    restored from the store would otherwise wait forever on a capacity
    change that already happened.  _restore_evals must hand every
    restored blocked eval one clean re-evaluation."""
    from nomad_tpu_torch.structs import Evaluation
    from nomad_tpu_torch.structs.evaluation import EvalTrigger

    s = make_server()
    try:
        s.register_node(mock.node())
        job = mock.job()
        job.task_groups[0].count = 1
        s.register_job(job)
        s.wait_for_idle(30.0)
        # a blocked eval left over from a deposed leader: its snapshot
        # predates the node recovery that made the job placeable, and
        # this "new leader" has no unblock index covering it
        stale = Evaluation(
            namespace="default", priority=50, type=job.type, job_id=job.id,
            triggered_by=EvalTrigger.NODE_UPDATE, status=EvalStatus.BLOCKED,
            status_description="queued-allocs", snapshot_index=10 ** 9)
        s.create_evals([stale])
        stuck = s.store.eval_by_id(stale.id)
        stuck.status = EvalStatus.BLOCKED
        s._restore_evals()
        deadline = time.time() + 15
        while time.time() < deadline:
            ev = s.store.eval_by_id(stale.id)
            if EvalStatus.terminal(ev.status):
                break
            time.sleep(0.05)
        assert EvalStatus.terminal(s.store.eval_by_id(stale.id).status), \
            s.store.eval_by_id(stale.id).status
    finally:
        s.stop()


# ------------------------------------------------- the port's own cases

def test_wheel_expires_only_past_deadlines():
    """expire(now), the wheel's turn: only nodes whose deadline is at or
    before `now` expire, each once, and a re-armed node moves."""
    from nomad_tpu_torch.core.heartbeat import HeartbeatTracker

    class _Srv:
        class store:
            @staticmethod
            def node_by_id(nid):
                return None
    hb = HeartbeatTracker(_Srv(), ttl=10.0, tick=0.1)
    t0 = 1_000_000.0
    hb._cursor = t0
    with hb._lock:
        for i in range(8):
            hb._arm_locked(f"n{i}", t0 + 1.0 + i)
    assert hb.expire(t0 + 0.5) == []
    assert sorted(hb.expire(t0 + 3.0)) == ["n0", "n1", "n2"]
    with hb._lock:
        hb._arm_locked("n3", t0 + 20.0)      # a fresh heartbeat
    assert sorted(hb.expire(t0 + 6.0)) == ["n4", "n5"]
    assert hb.tracked() == 3
    assert sorted(hb.expire(t0 + 40.0)) == ["n3", "n6", "n7"]
    assert hb.tracked() == 0


def test_batcher_coalesces_into_one_entry_per_flush():
    """Expiries noted between two flushes commit as one
    NODE_HEARTBEAT_BATCH entry, and each transition gets its node evals;
    fingerprint deltas ride one NODE_FINGERPRINT_BATCH entry."""
    from nomad_tpu_torch.raft import MessageType
    from nomad_tpu_torch.telemetry import global_metrics
    s = make_server(heartbeat_batch_interval=3600.0)
    try:
        nodes = [mock.node() for _ in range(6)]
        for n in nodes:
            s.register_node(n)
        job = mock.job()
        job.task_groups[0].count = 6
        s.register_job(job)
        assert s.wait_for_idle(30.0)
        entries = []
        real = s.apply

        def counting(msg_type, payload):
            entries.append(msg_type)
            return real(msg_type, payload)
        s.apply = counting
        flush0 = {c["Name"]: c["Count"]
                  for c in global_metrics.snapshot()["Counters"]}
        for n in nodes[:3]:
            s.heartbeats._invalidate(n.id)
        s.node_update_fingerprint(nodes[4].id, {"attributes": {"k": "v"}})
        assert s.node_update_fingerprint("no-such-node", {}) == \
            {"known": False}
        s.heartbeat_batch.flush()
        assert entries.count(MessageType.NODE_HEARTBEAT_BATCH) == 1
        assert entries.count(MessageType.NODE_FINGERPRINT_BATCH) == 1
        assert all(s.store.node_by_id(n.id).status == "down"
                   for n in nodes[:3])
        assert s.store.node_by_id(nodes[4].id).attributes["k"] == "v"
        node_evals = [e for e in s.store.evals()
                      if e.triggered_by == "node-update"]
        assert {e.node_id for e in node_evals} <= {n.id for n in nodes[:3]}
        assert node_evals
        after = {c["Name"]: c["Count"]
                 for c in global_metrics.snapshot()["Counters"]}
        assert after["heartbeat.batch_flush"] - \
            flush0.get("heartbeat.batch_flush", 0) == 1
        assert after["heartbeat.batch_nodes"] - \
            flush0.get("heartbeat.batch_nodes", 0) == 3
        # a down node heartbeating again is revived through the batch
        s.node_heartbeat(nodes[0].id)
        s.heartbeat_batch.flush()
        assert s.store.node_by_id(nodes[0].id).status == "ready"
    finally:
        s.stop()


def test_batcher_forces_a_flush_at_its_cap(monkeypatch):
    """At NOMAD_TPU_HB_PENDING_MAX pending nodes the writer wakes the
    flusher at once instead of waiting out the interval."""
    monkeypatch.setenv("NOMAD_TPU_HB_PENDING_MAX", "2")
    s = make_server(heartbeat_batch_interval=3600.0)
    try:
        nodes = [mock.node() for _ in range(2)]
        for n in nodes:
            s.register_node(n)
        for n in nodes:
            s.heartbeat_batch.note(n.id, "down")
        deadline = time.time() + 10
        while time.time() < deadline and any(
                s.store.node_by_id(n.id).status != "down" for n in nodes):
            time.sleep(0.02)
        assert all(s.store.node_by_id(n.id).status == "down"
                   for n in nodes)
    finally:
        s.stop()


def test_leadership_rearms_restored_nodes(tmp_path):
    """A restored server arms a TTL for every live node at leadership."""
    s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0),
               device="cpu")
    nodes = [mock.node() for _ in range(3)]
    for n in nodes:
        s.store.upsert_node(s.next_index(), n)
    assert s.heartbeats.tracked() == 0
    s.start()
    try:
        assert s.heartbeats.tracked() == 3
    finally:
        s.stop()


def test_stop_joins_every_loop_thread():
    before = set(threading.enumerate())
    s = make_server()
    names = {t.name for t in threading.enumerate() if t not in before}
    assert set(LOOP_THREADS) <= names
    s.stop()
    left = [t.name for t in threading.enumerate()
            if t not in before and t.name.startswith(LOOP_THREADS)]
    assert left == []


def test_multiregion_fail_is_not_ported():
    s = Server(ServerConfig(num_schedulers=0), device="cpu")
    with pytest.raises(NotImplementedError, match="A7"):
        s.deployment_watcher.multiregion_fail("default", "j")


# --------------------------------------------------------------- secrets
# tests/test_secrets.py's provider cases (its client cases wait for the
# port's client, ROADMAP A9)

def test_secrets_put_read_versions():
    from nomad_tpu_torch.core.secrets import SecretsProvider
    p = SecretsProvider()
    assert p.put("db/creds", {"user": "u", "password": "p1"}) == 1
    tok = p.derive_token("a1", "t", ["db"])["token"]
    data, ver = p.read("db/creds", tok)
    assert data == {"user": "u", "password": "p1"} and ver == 1
    assert p.put("db/creds", {"user": "u", "password": "p2"}) == 2
    assert p.version("db/creds", tok) == 2


def test_secrets_policy_prefix_enforced():
    from nomad_tpu_torch.core.secrets import SecretsError, SecretsProvider
    p = SecretsProvider()
    p.put("db/creds", {"x": "1"})
    p.put("other/creds", {"x": "2"})
    tok = p.derive_token("a1", "t", ["db"])["token"]
    assert p.read("db/creds", tok)[0] == {"x": "1"}
    with pytest.raises(SecretsError, match="do not cover"):
        p.read("other/creds", tok)


def test_secrets_renew_and_revoke():
    from nomad_tpu_torch.core.secrets import SecretsError, SecretsProvider
    p = SecretsProvider()
    p.put("db/x", {"k": "v"})
    grant = p.derive_token("a1", "t", ["db"], ttl_s=0.2)
    tok = grant["token"]
    assert p.renew(tok)["renewals"] == 1
    time.sleep(0.25)
    with pytest.raises(SecretsError, match="expired"):
        p.renew(tok)
    tok2 = p.derive_token("a1", "t", ["db"])["token"]
    assert p.revoke_for_alloc("a1") >= 1
    with pytest.raises(SecretsError):
        p.read("db/x", tok2)


def test_server_holds_a_leader_local_secrets_provider():
    from nomad_tpu_torch.core.secrets import SecretsProvider
    s = Server(ServerConfig(num_schedulers=0), device="cpu")
    assert isinstance(s.secrets, SecretsProvider)


# ------------------------------------------------------ scaling, services
# tests/test_services_scaling.py's cases through the server's own API
# (its endpoint, client and federation cases wait for ROADMAP A4, A9, A7)

def _wait(cond, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def test_job_scale_up_down_and_events():
    from nomad_tpu_torch.structs.job import ScalingPolicy
    s = make_server()
    try:
        j = mock.job()
        tg = j.task_groups[0]
        tg.count = 2
        tg.scaling = ScalingPolicy(min=1, max=5)
        for _ in range(6):
            s.register_node(mock.node())
        s.register_job(j)

        def live():
            return len([a for a in s.store.allocs_by_job("default", j.id)
                        if not a.terminal_status()])
        assert _wait(lambda: live() == 2)
        ev = s.scale_job("default", j.id, tg.name, 4, message="scale up")
        assert ev.id
        assert _wait(lambda: live() == 4)
        with pytest.raises(ValueError, match="maximum: 99 > 5"):
            s.scale_job("default", j.id, tg.name, 99)
        with pytest.raises(ValueError, match="minimum: 0 < 1"):
            s.scale_job("default", j.id, tg.name, 0)
        with pytest.raises(ValueError, match="not found"):
            s.scale_job("default", "nope", tg.name, 1)
        with pytest.raises(ValueError, match="does not exist"):
            s.scale_job("default", j.id, "nope", 1)
        assert s.scale_job("default", j.id, tg.name, None, error=True,
                           message="autoscaler woes") is None
        st = s.job_scale_status("default", j.id)
        g = st["task_groups"][tg.name]
        assert g["desired"] == 4 and g["placed"] == 4
        msgs = [e.message for e in g["events"]]
        assert "autoscaler woes" in msgs and "scale up" in msgs
        assert s.job_scale_status("default", "nope") is None
        pols = s.store.scaling_policies()
        assert len(pols) == 1
    finally:
        s.stop()


def test_service_gc_sweeps_orphans():
    from nomad_tpu_torch.raft.fsm import MessageType
    from nomad_tpu_torch.structs.service import ServiceRegistration
    s = make_server()
    try:
        s.apply(MessageType.SERVICE_REGISTER, {"services": [
            ServiceRegistration(id="orphan-1", service_name="ghost",
                                alloc_id="no-such-alloc")]})
        assert s.store.services_by_name("default", "ghost")
        stats = s.core_scheduler.process("service-gc")
        assert stats["services"] == 1
        assert not s.store.services_by_name("default", "ghost")
    finally:
        s.stop()


# ------------------------------------------------ namespaces and quotas

def test_namespace_and_quota_api():
    from nomad_tpu_torch.structs.namespace import QuotaSpec
    s = make_server()
    try:
        with pytest.raises(ValueError, match="does not exist"):
            s.upsert_namespace("team", quota="gold")
        s.upsert_quota_spec(QuotaSpec(name="gold", cpu=2000))
        s.upsert_namespace("team", description="d", quota="gold")
        assert s.namespace("team").quota == "gold"
        assert {n.name for n in s.namespaces()} >= {"default", "team"}
        assert [q.name for q in s.quota_specs()] == ["gold"]
        assert s.quota_spec("gold").cpu == 2000
        with pytest.raises(ValueError, match="referenced by namespace"):
            s.delete_quota_spec("gold")
        s.register_node(mock.node())
        j = mock.job(namespace="team")
        j.task_groups[0].count = 1
        s.register_job(j)
        assert s.wait_for_idle(30.0)
        assert s.quota_usage("team")["cpu"] == 500
        assert s.quota_usages()["team"] == s.quota_usage("team")
        s.deregister_job("team", j.id, purge=True)
        s.upsert_namespace("team", quota="")
        s.delete_quota_spec("gold")
        assert s.quota_spec("gold") is None
        s.delete_namespace("team")
        assert s.namespace("team") is None
    finally:
        s.stop()


def test_fair_stats_starvation_bound():
    from nomad_tpu_torch.core.broker import EvalBroker
    b = EvalBroker(nack_timeout=5.0, initial_nack_delay=0.0,
                   subsequent_nack_delay=0.0)
    b.set_enabled(True)
    heavies = [f"bulk{i}" for i in range(10)]
    for ns in heavies:
        for i in range(20):
            b.enqueue(mock.eval(namespace=ns, job_id=f"{ns}-{i}"))

    def drain(n):
        out = []
        for _ in range(n):
            ev, tok = b.dequeue(["service"])
            out.append(ev)
            b.ack(ev.id, tok)
        return out
    drain(50)
    b.enqueue(mock.eval(namespace="victim", job_id="v0"))
    tail = [e.namespace for e in drain(len(heavies) + 1)]
    assert "victim" in tail
    st = b.fair_stats()
    assert st["enabled"] and st["picks"] == 61 and st["bypassed"] == 0
    assert st["runnable_namespaces"] == 10


def test_scheduler_config_tunes_broker_live():
    from nomad_tpu_torch.raft.fsm import MessageType
    from nomad_tpu_torch.structs.config import SchedulerConfiguration
    s = Server(ServerConfig(num_schedulers=0), device="cpu")
    s.start()
    try:
        assert s.broker.fair_stats()["enabled"]
        cfg = SchedulerConfiguration()
        cfg.fair_dequeue_enabled = False
        cfg.default_namespace_weight = 7
        cfg.namespace_weights = {"paid": 3}
        s.apply(MessageType.SCHEDULER_CONFIG, {"config": cfg})
        assert _wait(lambda: not s.broker.fair_stats()["enabled"], 5.0)
        st = s.broker.fair_stats()
        assert st["default_weight"] == 7
        assert st["weights"] == {"paid": 3}
    finally:
        s.stop()


def test_outstanding_reset_extends_the_lease():
    from nomad_tpu_torch.core.broker import EvalBroker
    b = EvalBroker(nack_timeout=0.3, initial_nack_delay=0.0,
                   subsequent_nack_delay=0.0)
    b.set_enabled(True)
    ev = mock.eval()
    b.enqueue(ev)
    got, tok = b.dequeue(["service"])
    assert not b.outstanding_reset(ev.id, "wrong")
    for _ in range(4):
        time.sleep(0.15)
        assert b.outstanding_reset(ev.id, tok)
    assert b.outstanding(ev.id) == tok
    time.sleep(0.4)
    assert b.outstanding(ev.id) is None


# ------------------------------------------------------------ telemetry

def test_metrics_registry_counters_gauges_and_exposition():
    from nomad_tpu_torch.telemetry import MetricsRegistry
    m = MetricsRegistry()
    m.incr("heartbeat.batch_flush")
    m.incr("heartbeat.batch_nodes", 3.0)
    m.set_gauge("broker.ready", 5.0)
    m.set_gauges({"a": 1.0, "b": 2.0}, prefix="k.")
    with m.timer("nomad.plan.evaluate"):
        pass
    snap = m.snapshot()
    assert snap["Counters"] == [
        {"Name": "heartbeat.batch_flush", "Count": 1.0},
        {"Name": "heartbeat.batch_nodes", "Count": 3.0}]
    assert [g["Name"] for g in snap["Gauges"]] == ["broker.ready", "k.a",
                                                   "k.b"]
    assert snap["Samples"][0]["Name"] == "nomad.plan.evaluate"
    text = m.prometheus()
    assert "heartbeat_batch_flush_total 1.0" in text
    assert "# TYPE broker_ready gauge" in text
    assert 'nomad_plan_evaluate{quantile="0.5"}' in text
    m.set_gauge("broker-ready", 1.0)
    assert "# collision" in m.prometheus()


def test_node_heartbeats_chunk_acts_as_node_heartbeat_each():
    """The batched heartbeat takes each lock once a chunk and leaves
    what `node_heartbeat` a node leaves: a down node's revival queued as
    a transition, a live node's liveness stamp (once a half-TTL), every
    id's TTL armed."""
    s = make_server(heartbeat_batch_interval=3600.0)
    try:
        nodes = [mock.node() for _ in range(3)]
        for n in nodes:
            s.register_node(n)
        s.update_node_status(nodes[0].id, "down")
        ids = [n.id for n in nodes] + ["no-such-node"]
        assert s.node_heartbeats(ids) == 3600.0
        b = s.heartbeat_batch
        assert b._pending[nodes[0].id][0] == "ready"
        assert b._transitions == {nodes[0].id}
        assert {b._pending[n.id][0] for n in nodes[1:]} == {"ready"}
        assert "no-such-node" not in b._pending
        assert s.heartbeats.tracked() == 4
        stamped = dict(b._last_stamp)
        s.node_heartbeats(ids)
        assert b._last_stamp == stamped       # within the half-TTL
        b.flush()
        assert s.store.node_by_id(nodes[0].id).status == "ready"
    finally:
        s.stop()
