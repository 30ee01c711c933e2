"""The port's control loops against the reference's, on the CPU.

The same seeded world goes through the reference's `Server` and the
port's `Server(device="cpu")`, each with one worker and
NOMAD_TPU_PIPELINE_DEPTH=0 (the reference with NOMAD_TPU_SHARD=0), every
job run to idle before the next is registered, as tests/test_torch_server.py
does.  Alloc ids differ between the packages, so placements are compared
as {job index: {node row: count}} maps.

The loops' own threads are stopped after `start()` and each loop is
driven through its clock-taking method with the same `now` in both
packages: `drainer.tick(now)`, `deployment_watcher.reconcile_all(now)`,
`periodic.dispatch_due(now)`, `core_scheduler.process(gc_type, now)`.
Heartbeats: the batcher flushes only when the test calls `flush()` (its
interval is an hour); the victims' deadlines are set 0.3 s ahead, where
the port's `HeartbeatTracker.expire(now)` and the reference's wheel
thread (it has no clock-taking method) invalidate them.  No test sleeps past a
TTL.  Integers are held equal:

- expiry: 4 of 64 nodes miss their TTL; the same nodes go down, the
  same node evals, replacement maps and lost allocs, one batch entry;
  and on another world the same nodes go down or disconnected (a group
  with max_client_disconnect_s decides), read from the batcher's
  pending table before a flush (after a flush both packages' schedulers
  retry the disconnected node's plan without end: ROADMAP queue C);
- drain: the same migrations tick by tick (live counts, the allocs
  left on the node and those marked to migrate), the same force-stop at
  the deadline, the same final eligibility; and a node that goes down
  mid-drain (after tests/test_control_loops.py:335);
- deployments: the status sequence, promotion, auto-revert, job
  versions and stability, for a healthy canary rollout, an unhealthy
  one that reverts and a superseded one;
- periodic: `next_cron_after` on seeded specs and times, and the same
  children at the same fire times, placed the same;
- core GC: the same evals, jobs, nodes, services and deployments
  collected at the same `now`, and with `force`;
- events: the (topic, type) sequence of one subscription over
  tests/test_torch_fsm.py's log, none dropped;
- the job, namespace and quota APIs: `scale_job` bounds and errors,
  `job_scale_status`, `fair_stats` after the same dequeues;
- telemetry: the `heartbeat.*` counters.
"""
import copy
import importlib
import time

import numpy as np
import pytest

REF, PORT = "nomad_tpu", "nomad_tpu_torch"
KW = {REF: {}, PORT: {"device": "cpu"}}


@pytest.fixture(autouse=True, scope="module")
def _env():
    pytest.importorskip("jax")
    mp = pytest.MonkeyPatch()
    mp.setenv("NOMAD_TPU_PIPELINE_DEPTH", "0")
    mp.setenv("NOMAD_TPU_SHARD", "0")
    yield
    mp.undo()
    from nomad_tpu_torch.parallel.engine import stop_engines
    stop_engines()


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def _server(root, n_nodes, racks=8, **cfg):
    """A started server with the loops' threads stopped (the heartbeat
    wheel's too, in the port) and `n_nodes` nodes of fixed ids."""
    m, srv = _mod(root, "mock"), _mod(root, "core.server")
    kw = dict(num_schedulers=1, heartbeat_ttl=3600.0, gc_interval=3600.0,
              heartbeat_batch_interval=3600.0)
    kw.update(cfg)
    s = srv.Server(srv.ServerConfig(**kw), **KW[root])
    s.start()
    for loop in (s.drainer, s.deployment_watcher, s.periodic):
        loop.stop()
    if root == PORT:
        s.heartbeats.stop()
    for i in range(n_nodes):
        n = m.node(id=f"node-{i:04d}", name=f"node-{i:04d}")
        n.attributes["rack"] = f"r{i % racks}"
        s.register_node(n)
    return m, s


def _register(s, job):
    s.register_job(job)
    assert s.wait_for_idle(60)


def _row(s, node_id):
    return s.store.matrix.row_of[node_id]


def _maps(s, jobs, keep=lambda a: a.desired_status == "run"
          and not a.terminal_status()):
    out = {}
    for k, j in enumerate(jobs):
        per = {}
        for a in s.store.allocs_by_job(j.namespace, j.id):
            if keep(a):
                r = _row(s, a.node_id)
                per[r] = per.get(r, 0) + 1
        out[k] = per
    return out


def _counters(root):
    snap = _mod(root, "telemetry").global_metrics.snapshot()
    return {c["Name"]: c["Count"] for c in snap["Counters"]
            if c["Name"].startswith("heartbeat.")}


def _both(fn):
    return fn(REF), fn(PORT)


# ------------------------------------------------------------ expiry

def _expire(root, s, victims):
    """Set the victims' deadlines a moment ahead of the wheel's cursor
    (the others stay an hour ahead) and wait until the batcher holds
    their transitions: the port's `expire(now)` or the reference's wheel
    thread invalidates them."""
    hb = s.heartbeats
    due = time.time() + 0.3
    with hb._lock:
        for v in victims:
            hb._arm_locked(v, due)
    if root == PORT:
        assert sorted(hb.expire(due)) == victims
    deadline = time.time() + 30
    while time.time() < deadline and \
            len(s.heartbeat_batch._pending) < len(victims):
        time.sleep(0.01)
    assert sorted(s.heartbeat_batch._pending) == victims


def _expiry_jobs(m, tolerant):
    jobs = []
    for k in range(4):
        j = m.job(id=f"svc-{k}")
        j.task_groups[0].count = 12
        j.task_groups[0].tasks[0].resources.cpu = 1500
        j.update = None
        j.task_groups[0].update = None
        if k == 0 and tolerant:
            j.task_groups[0].max_client_disconnect_s = 300.0
        jobs.append(j)
    b = m.batch_job(id="batch-0")
    b.task_groups[0].count = 24
    b.task_groups[0].tasks[0].resources.cpu = 1000
    jobs.append(b)
    return jobs


def _expiry_decision(root):
    """Which status each expired node takes: disconnected where an alloc
    of a group with max_client_disconnect_s runs, else down (the
    batcher's pending table, not flushed)."""
    m, s = _server(root, 64)
    try:
        for j in _expiry_jobs(m, tolerant=True):
            _register(s, j)
        tolerant = sorted({a.node_id for a in
                           s.store.allocs_by_job("default", "svc-0")})
        others = sorted({a.node_id for a in s.store.allocs()}
                        - set(tolerant))
        victims = sorted(tolerant[:2] + others[:2])
        _expire(root, s, victims)
        return {_row(s, v): st for v, (st, _) in
                s.heartbeat_batch._pending.items()}
    finally:
        s.stop()


def _expiry(root):
    """4 of 64 nodes miss their TTL: one batch entry, the node evals,
    the replacements and the lost allocs."""
    m, s = _server(root, 64)
    try:
        jobs = _expiry_jobs(m, tolerant=False)
        for j in jobs:
            _register(s, j)
        held = sorted({a.node_id for a in s.store.allocs()})
        victims = held[:: max(1, len(held) // 4)][:4]
        counters0 = _counters(root)
        entries = []
        apply = s.apply

        def counting(msg_type, payload):
            entries.append(msg_type)
            return apply(msg_type, payload)
        s.apply = counting
        _expire(root, s, victims)
        evals0 = {e.id for e in s.store.evals()}
        s.heartbeat_batch.flush()
        assert s.wait_for_idle(60)
        status = {_row(s, v): s.store.node_by_id(v).status for v in victims}
        ids = {j.id: k for k, j in enumerate(jobs)}
        node_evals = sorted(
            (ids[e.job_id], _row(s, e.node_id), e.triggered_by)
            for e in s.store.evals() if e.id not in evals0
            and e.triggered_by == "node-update")
        # the counters this expiry moved (the registry is the process's:
        # an earlier test may have made others)
        counters = {k: v - counters0.get(k, 0.0)
                    for k, v in _counters(root).items()
                    if v != counters0.get(k, 0.0)}
        return {
            "status": status, "node_evals": node_evals,
            "live": _maps(s, jobs),
            "lost": _maps(s, jobs, lambda a: a.client_status == "lost"),
            "batch_entries": entries.count("NodeHeartbeatBatchRequest"),
            "counters": counters,
        }
    finally:
        s.stop()


@pytest.fixture(scope="module")
def expiry():
    return _both(_expiry)


def test_expiry_same_nodes_down_or_disconnected():
    ref, port = _both(_expiry_decision)
    assert port == ref
    assert sorted(port.values()) == ["disconnected", "disconnected",
                                     "down", "down"]


def test_expiry_same_nodes_down(expiry):
    ref, port = expiry
    assert port["status"] == ref["status"]
    assert set(port["status"].values()) == {"down"}


def test_expiry_same_node_evals(expiry):
    ref, port = expiry
    assert port["node_evals"] == ref["node_evals"]
    assert port["node_evals"]


def test_expiry_same_replacements_and_lost_allocs(expiry):
    ref, port = expiry
    for key in ("live", "lost"):
        assert port[key] == ref[key], key
    assert sum(sum(p.values()) for p in port["lost"].values()) > 0
    assert port["batch_entries"] == ref["batch_entries"] == 1


def test_expiry_same_heartbeat_counters(expiry):
    ref, port = expiry
    assert port["counters"] == ref["counters"]
    assert port["counters"]["heartbeat.batch_flush"] == 1
    assert port["counters"]["heartbeat.batch_nodes"] == 4


# ------------------------------------------------------------ drain

def _drain_jobs(m):
    svc = m.job(id="drain-svc")
    svc.task_groups[0].count = 8
    svc.update = None
    svc.task_groups[0].update = None
    svc.task_groups[0].migrate.max_parallel = 2
    stuck = m.job(id="drain-stuck")
    stuck.task_groups[0].count = 4
    stuck.update = None
    stuck.task_groups[0].update = None
    stuck.task_groups[0].migrate.max_parallel = 0
    bat = m.batch_job(id="drain-batch")
    bat.task_groups[0].count = 8
    return [svc, stuck, bat]


def _drain(root):
    m, s = _server(root, 6)
    try:
        jobs = _drain_jobs(m)
        for j in jobs:
            _register(s, j)
        start = _maps(s, jobs)
        per_node = {}
        for a in s.store.allocs():
            per_node[a.node_id] = per_node.get(a.node_id, 0) + 1
        victim = sorted(per_node, key=lambda n: (-per_node[n], n))[0]
        s.drainer.drain_node(victim, deadline_s=30.0)
        fd = s.store.node_by_id(victim).drain_strategy.force_deadline
        steps = []
        for now in (fd - 25.0, fd - 20.0, fd - 15.0, fd - 10.0, fd + 1.0,
                    fd + 2.0):
            s.drainer.tick(now)
            assert s.wait_for_idle(60)
            live = {k: sum(per.values()) for k, per in _maps(s, jobs).items()}
            on_victim = sorted(
                (k, a.desired_transition.should_migrate(),
                 a.desired_status)
                for k, j in enumerate(jobs)
                for a in s.store.allocs_by_job("default", j.id)
                if a.node_id == victim and not a.terminal_status())
            migrated = sorted(
                k for k, j in enumerate(jobs)
                for a in s.store.allocs_by_job("default", j.id)
                if a.node_id == victim
                and a.desired_transition.should_migrate())
            steps.append((live, on_victim, migrated))
        node = s.store.node_by_id(victim)
        forced = sorted(
            (k, _row(s, a.node_id)) for k, j in enumerate(jobs)
            for a in s.store.allocs_by_job("default", j.id)
            if "drain deadline" in (a.desired_description or ""))
        return {"start": start, "steps": steps, "forced": forced,
                "final": (node.drain_strategy is None,
                          node.scheduling_eligibility)}
    finally:
        s.stop()


def _down_mid_drain(root):
    m, s = _server(root, 4)
    try:
        jobs = _drain_jobs(m)[1:2]
        _register(s, jobs[0])
        victim = sorted(a.node_id for a in s.store.allocs())[0]
        s.drainer.drain_node(victim, deadline_s=600.0)
        fd = s.store.node_by_id(victim).drain_strategy.force_deadline
        s.drainer.tick(fd - 500.0)
        assert s.wait_for_idle(60)
        s.update_node_status(victim, "down")
        assert s.wait_for_idle(60)
        s.drainer.tick(fd - 400.0)
        assert s.wait_for_idle(60)
        node = s.store.node_by_id(victim)
        return {"live": _maps(s, jobs),
                "lost": _maps(s, jobs, lambda a: a.client_status == "lost"),
                "final": (node.drain_strategy is None, node.status,
                          node.scheduling_eligibility)}
    finally:
        s.stop()


@pytest.fixture(scope="module")
def drains():
    return {"drain": _both(_drain), "down": _both(_down_mid_drain)}


def test_drain_same_migrations_tick_by_tick(drains):
    """Tick by tick: each job's live count, the allocs left on the
    draining node and the ones marked to migrate.  The rows the
    migrated allocs land on are left out: one run in six of this world
    placed one batch replacement on another row (ROADMAP queue C)."""
    ref, port = drains["drain"]
    assert port["start"] == ref["start"]
    assert port["steps"] == ref["steps"]
    assert port["steps"][-1][1] == []          # the node ends empty
    assert port["steps"][0][2]                 # the first tick migrates


def test_drain_same_force_stop_and_final_eligibility(drains):
    ref, port = drains["drain"]
    assert port["forced"] == ref["forced"]
    # only the stuck group's allocs wait for the deadline
    assert port["forced"] and {k for k, _ in port["forced"]} == {1}
    assert port["final"] == ref["final"] == (True, "ineligible")


def test_node_down_mid_drain_same_lost_path(drains):
    ref, port = drains["down"]
    assert port == ref
    assert sum(port["lost"][0].values()) > 0
    assert port["final"][0] is True


# ------------------------------------------------------------ deployments

def _report(s, root, job_id, healthy, deployment_id=None):
    MT = _mod(root, "raft.fsm").MessageType
    updates = []
    for a in s.store.allocs_by_job("default", job_id):
        if a.terminal_status():
            continue
        if deployment_id is not None and a.deployment_id != deployment_id:
            continue
        u = a.copy()
        u.client_status = "running"
        u.deployment_status = {"healthy": healthy}
        updates.append(u)
    s.apply(MT.ALLOC_CLIENT_UPDATE, {"allocs": updates})


def _deployment_record(s, job_id):
    deps = sorted(s.store.deployments(), key=lambda d: d.create_index)
    job = s.store.job_by_id("default", job_id)
    versions = sorted((v.version, bool(v.stable))
                      for v in s.store.job_versions("default", job_id))
    return ([(d.job_version, d.status,
              sorted((g, st.promoted, st.placed_allocs, st.healthy_allocs,
                      st.unhealthy_allocs)
                     for g, st in d.task_groups.items()))
             for d in deps if d.job_id == job_id],
            (job.version, bool(job.stable)), versions)


def _deploy(root, case):
    m, s = _server(root, 8)
    structs_job = _mod(root, "structs.job")
    w = s.deployment_watcher
    try:
        j = m.job(id=f"deploy-{case}")
        j.task_groups[0].count = 4
        if case == "healthy":
            j.update = structs_job.UpdateStrategy(
                max_parallel=2, canary=1, auto_promote=True)
        else:
            j.update = structs_job.UpdateStrategy(max_parallel=2,
                                                  auto_revert=True)
        j.task_groups[0].update = None
        _register(s, j)
        _report(s, root, j.id, True)
        now = 1_000_000.0
        w.reconcile_all(now)
        assert s.wait_for_idle(60)
        s.set_job_stability("default", j.id, 0, True)
        seq = [_deployment_record(s, j.id)]
        v1 = j.copy()
        v1.task_groups[0].tasks[0].config = {"command": f"/bin/{case}"}
        _register(s, v1)
        seq.append(_deployment_record(s, j.id))
        for step in range(8):
            d = s.store.latest_deployment_by_job_id("default", j.id)
            if case == "superseded" and step == 1:
                v2 = v1.copy()
                v2.task_groups[0].tasks[0].config = {"command": "/bin/v2"}
                _register(s, v2)
            elif d is not None and d.active():
                # the unhealthy case's v1 fails; its revert is healthy
                _report(s, root, j.id,
                        case != "unhealthy" or d.job_version != 1, d.id)
            w.reconcile_all(now + step)
            assert s.wait_for_idle(60)
            seq.append(_deployment_record(s, j.id))
        configs = {v.version: v.task_groups[0].tasks[0].config["command"]
                   for v in s.store.job_versions("default", j.id)}
        return {"seq": seq, "live": _maps(s, [j]), "configs": configs}
    finally:
        s.stop()


@pytest.fixture(scope="module")
def deploys():
    return {case: _both(lambda root: _deploy(root, case))
            for case in ("healthy", "unhealthy", "superseded")}


@pytest.mark.parametrize("case", ["healthy", "unhealthy", "superseded"])
def test_deployment_same_status_sequence(deploys, case):
    ref, port = deploys[case]
    assert port["seq"] == ref["seq"]
    assert port["live"] == ref["live"]
    assert port["configs"] == ref["configs"]


def test_deployment_healthy_promotes_and_marks_stable(deploys):
    _, port = deploys["healthy"]
    deps, (version, stable), _ = port["seq"][-1]
    assert deps[-1][1] == "successful"
    assert all(g[1] for g in deps[-1][2])        # promoted
    assert version == 1 and stable


def test_deployment_unhealthy_reverts(deploys):
    _, port = deploys["unhealthy"]
    deps, (version, _), _ = port["seq"][-1]
    assert any(d[1] == "failed" for d in deps)
    assert version == 2
    assert port["configs"][version] == "/bin/date"      # v0's command


def test_deployment_superseded_is_cancelled(deploys):
    _, port = deploys["superseded"]
    deps, _, _ = port["seq"][-1]
    assert deps[1][1] == "cancelled"


# ------------------------------------------------------------ periodic

def test_next_cron_after_equal_on_seeded_specs():
    rng = np.random.default_rng(20)
    specs = ["*/5 * * * *", "0 * * * *", "30 2 * * *", "15,45 * * * 1-5",
             "0 0 1 * *", "0 12 * * 0", "*/7 3-9 * * *", "0 0 * * 7",
             "@every 30s", "@every 90s", "bad spec"]
    ref = _mod(REF, "core.periodic").next_cron_after
    port = _mod(PORT, "core.periodic").next_cron_after
    times = rng.uniform(0, 2e9, size=12)
    for spec in specs:
        for t in times:
            assert port(spec, float(t)) == ref(spec, float(t)), (spec, t)


def _periodic(root):
    m, s = _server(root, 8)
    pc = _mod(root, "structs.job").PeriodicConfig
    try:
        j = m.batch_job(id="cron")
        j.task_groups[0].count = 3
        j.periodic = pc(spec="*/5 * * * *", prohibit_overlap=True)
        s.register_job(j)
        assert not s.store.evals_by_job("default", j.id)
        base = 1_700_000_000.0
        fired = []
        for now in (base, base + 300.0, base + 310.0, base + 600.0,
                    base + 900.0):
            fired.append(s.periodic.dispatch_due(now))
            assert s.wait_for_idle(60)
            for c in s.store.jobs():
                if c.parent_id == j.id:
                    for a in s.store.allocs_by_job("default", c.id):
                        if not a.terminal_status():
                            u = a.copy()
                            u.client_status = "complete"
                            s.apply(_mod(root, "raft.fsm").MessageType
                                    .ALLOC_CLIENT_UPDATE, {"allocs": [u]})
        children = sorted((c for c in s.store.jobs() if c.parent_id == j.id),
                          key=lambda c: c.id)
        return {"fired": fired, "maps": _maps(
            s, children, lambda a: a.desired_status == "run")}
    finally:
        s.stop()


def test_periodic_same_children_at_same_fire_times():
    ref, port = _both(_periodic)
    assert port == ref
    assert sum(len(f) for f in port["fired"]) >= 2
    assert all(sum(per.values()) == 3 for per in port["maps"].values())


# ------------------------------------------------------------ core GC

def _gc(root):
    m, s = _server(root, 6)
    MT = _mod(root, "raft.fsm").MessageType
    svc_mod = _mod(root, "structs.service")
    try:
        jobs = []
        for k in range(3):
            j = m.batch_job(id=f"gc-{k}")
            j.task_groups[0].count = 2
            jobs.append(j)
            _register(s, j)
        s.deregister_job("default", "gc-0")
        assert s.wait_for_idle(60)
        for a in s.store.allocs_by_job("default", "gc-0"):
            u = a.copy()
            u.client_status = "complete"
            s.apply(MT.ALLOC_CLIENT_UPDATE, {"allocs": [u]})
        spare = m.node(id="node-spare", name="node-spare")
        s.register_node(spare)
        s.update_node_status("node-spare", "down")
        assert s.wait_for_idle(60)
        s.apply(MT.SERVICE_REGISTER, {"services": [
            svc_mod.ServiceRegistration(id="orphan", service_name="ghost",
                                        alloc_id="no-such-alloc")]})
        out = {}
        now = time.time()
        for gc_type in ("eval-gc", "job-gc", "node-gc", "deployment-gc",
                        "service-gc"):
            out[gc_type] = s.core_scheduler.process(gc_type, now)
        out["later"] = s.core_scheduler.process("force-gc", now + 30 * 3600)
        out["force"] = s.core_scheduler.process("force-gc", now, force=True)
        out["left"] = (sorted(j.id for j in s.store.jobs()),
                       len(s.store.evals()), len(s.store.allocs()),
                       sorted(n.id for n in s.store.nodes())[-2:],
                       len(s.store.services()))
        return out
    finally:
        s.stop()


def test_core_gc_collects_the_same():
    ref, port = _both(_gc)
    assert port == ref
    assert port["eval-gc"] == {"evals": 0}
    assert port["later"]["jobs"] == 1 and port["later"]["nodes"] == 1
    assert "gc-0" not in port["left"][0]


# ------------------------------------------------------------ events

def test_event_sequence_over_the_fsm_log():
    """One subscription to every topic on each package's EventBroker,
    watching a store that the FSM log of tests/test_torch_fsm.py is
    applied to: the same (topic, type, key) sequence, none dropped."""
    import test_torch_fsm as tf
    mp = pytest.MonkeyPatch()
    try:
        server = tf._server_log(mp)
    finally:
        mp.undo()
    seeded = tf._seeded_log(19)
    entries = [(t, p, tf._translate(copy.deepcopy(p), REF, PORT))
               for t, p in seeded]
    entries += [(t, tf._translate(copy.deepcopy(p), PORT, REF), p)
                for t, p in server]
    seqs = {}
    for root, pick in ((REF, 1), (PORT, 2)):
        store = _mod(root, "state").StateStore()
        broker = _mod(root, "core.events").EventBroker()
        store.watch(broker.watch_state)
        sub = broker.subscribe({"*": ["*"]}, max_queue=1 << 20)
        fsm = _mod(root, "raft.fsm").NomadFSM(store)
        for index, e in enumerate(entries, start=1):
            fsm.apply(index, e[0], copy.deepcopy(e[pick]))
        seq = []
        while True:
            ev = sub.next(timeout=0.0)
            if ev is None:
                break
            key = ev.key if ev.topic in ("Job", "Node") else ""
            seq.append((ev.topic, ev.type, key, ev.index))
        stats = broker.stats()
        assert stats["subs"][0]["dropped"] == 0
        assert stats["published"] == len(seq)
        seqs[root] = seq
    assert seqs[PORT] == seqs[REF]
    assert {t for t, *_ in seqs[PORT]} == {
        "Node", "Job", "Evaluation", "Allocation", "Deployment"}


# ------------------------------------------------- job, namespace, quota

def _apis(root):
    m, s = _server(root, 6)
    sp = _mod(root, "structs.job").ScalingPolicy
    qs = _mod(root, "structs.namespace").QuotaSpec
    try:
        j = m.job(id="scale")
        j.update = None
        j.task_groups[0].update = None
        j.task_groups[0].count = 2
        j.task_groups[0].scaling = sp(min=1, max=5)
        _register(s, j)
        errors = []
        for count in (4, 99, 0, 3, None):
            try:
                s.scale_job("default", "scale", j.task_groups[0].name,
                            count, message=f"to {count}",
                            error=count is None)
                errors.append(None)
            except ValueError as e:
                errors.append(str(e))
            assert s.wait_for_idle(60)
        for bad in (("nope", j.task_groups[0].name), ("scale", "nope")):
            try:
                s.scale_job("default", bad[0], bad[1], 1)
            except ValueError as e:
                errors.append(str(e))
        st = s.job_scale_status("default", "scale")
        groups = {g: {k: (v if k != "events" else
                          [(e.previous_count, e.count, e.message, e.error,
                            bool(e.eval_id)) for e in v])
                      for k, v in info.items()}
                  for g, info in st["task_groups"].items()}
        status = (st["job_stopped"], groups)
        s.upsert_quota_spec(qs(name="gold", cpu=4000))
        s.upsert_namespace("team", description="t", quota="gold")
        for k in range(3):
            t = m.job(id=f"team-{k}", namespace="team")
            t.update = None
            t.task_groups[0].update = None
            t.task_groups[0].count = 2
            _register(s, t)
        try:
            s.delete_quota_spec("gold")
        except ValueError as e:
            errors.append(str(e))
        usage = (s.quota_usage("team"), s.quota_usages())
        spaces = sorted((n.name, n.quota) for n in s.namespaces())
        b = _mod(root, "core.broker").EvalBroker(
            nack_timeout=5.0, initial_nack_delay=0.0,
            subsequent_nack_delay=0.0)
        b.set_enabled(True)
        cfg = _mod(root, "structs.config").SchedulerConfiguration()
        cfg.namespace_weights = {"paid": 3}
        b.set_fair_config(cfg)
        for i in range(12):
            ns = ("paid", "free", "other")[i % 3]
            b.enqueue(m.eval(namespace=ns, job_id=f"{ns}-{i}"))
        order = []
        for _ in range(7):
            ev, tok = b.dequeue(["service"])
            order.append(ev.namespace)
            b.ack(ev.id, tok)
        return {"errors": errors, "status": status, "usage": usage,
                "spaces": spaces, "order": order, "fair": b.fair_stats(),
                "live": _maps(s, [j])}
    finally:
        s.stop()


@pytest.fixture(scope="module")
def apis():
    return _both(_apis)


def test_scale_job_same_bounds_errors_and_status(apis):
    ref, port = apis
    assert port["errors"] == ref["errors"]
    assert port["errors"][1] is not None and port["errors"][2] is not None
    assert port["status"] == ref["status"]
    assert port["live"] == ref["live"]
    assert port["status"][1]["web"]["desired"] == 3


def test_namespace_and_quota_same(apis):
    ref, port = apis
    assert port["usage"] == ref["usage"]
    assert port["spaces"] == ref["spaces"]
    assert port["usage"][0]["cpu"] == 3000


def test_fair_stats_same_after_the_same_dequeues(apis):
    ref, port = apis
    assert port["order"] == ref["order"]
    assert port["fair"] == ref["fair"]
    assert port["fair"]["picks"] == 7
