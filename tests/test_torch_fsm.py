"""The port's FSM against the reference's on one log, and the port's
snapshot and restore.

1. One log of entries, built from a numpy seed: first entries of every
   message type on objects of their own (nodes, a job in a namespace
   with a quota, evals, allocs, client updates, a deployment, a CSI
   volume and its claims, ACL policies and tokens, scaling events,
   service registrations, deletions, a no-op and a checkpoint), then
   every entry a dev-mode server applied while it placed a few jobs
   (the port's `Server(device="cpu")`, one worker,
   NOMAD_TPU_PIPELINE_DEPTH=0).  Each object is made once and copied
   field by field into the other package's class of the same module
   and name (`_translate`), so both FSMs get the same fields.  After
   each entry every snapshot table is equal between the packages under
   a package-neutral canonical form (`_canon`: each object's fields,
   recursively, its class's module path dropped and its name kept).
   The ACL records have no port module yet (the port's store keeps any
   record with the reference's fields): their port copies are the
   stand-in dataclasses below, with the reference's names and fields.
2. The port's snapshot -> restore -> snapshot: identical bytes and
   identical `tables_digests`; the restored ClusterMatrix equals the
   reference's restored one array for array.
3. `save_snapshot`/`restore_snapshot` on each package's dev-mode server
   (one worker, NOMAD_TPU_PIPELINE_DEPTH=0, the reference with
   NOMAD_TPU_SHARD=0): nodes and jobs, a save, a restore into a fresh
   server, more jobs: the same node rows and counts in both.
"""
import copy
import importlib
from dataclasses import dataclass, field
from typing import List

import numpy as np
import pytest

REF, PORT = "nomad_tpu", "nomad_tpu_torch"


@dataclass
class NamespaceRule:
    name: str = "default"
    policy: str = ""
    capabilities: List[str] = field(default_factory=list)


@dataclass
class ACLPolicy:
    name: str = ""
    description: str = ""
    rules: str = ""
    namespaces: List[NamespaceRule] = field(default_factory=list)
    node: str = ""
    agent: str = ""
    operator: str = ""
    quota: str = ""
    plugin: str = ""


@dataclass
class ACLToken:
    accessor_id: str = ""
    secret_id: str = ""
    name: str = ""
    type: str = "client"
    policies: List[str] = field(default_factory=list)
    global_: bool = False
    create_index: int = 0
    modify_index: int = 0


STAND_INS = {"NamespaceRule": NamespaceRule, "ACLPolicy": ACLPolicy,
             "ACLToken": ACLToken}


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


# ------------------------------------------------------------ translation

def _translate(obj, src, dst, memo=None):
    """`obj` with every object of package `src` copied field by field
    into the class of the same module and name in package `dst` (a
    stand-in where `dst` has no such module); sharing kept."""
    memo = {} if memo is None else memo
    key = id(obj)
    if key in memo:
        return memo[key][1]
    t = type(obj)
    if obj is None or t in (bool, int, float, str, bytes):
        return obj
    if isinstance(obj, np.ndarray):
        out = obj.copy()
    elif t in (list, tuple, set, frozenset):
        items = [_translate(v, src, dst, memo) for v in obj]
        out = items if t is list else t(items)
    elif isinstance(obj, dict):
        out = copy.copy(obj)
        out.clear()
        for k, v in obj.items():
            out[_translate(k, src, dst, memo)] = _translate(v, src, dst, memo)
    else:
        mod = t.__module__
        assert mod.split(".")[0] == src, (t, src)
        try:
            cls = getattr(_mod(dst, mod.split(".", 1)[1]), t.__qualname__)
        except ModuleNotFoundError:
            cls = STAND_INS[t.__qualname__]
        out = cls.__new__(cls)
        memo[key] = (obj, out)
        for k, v in vars(obj).items():
            object.__setattr__(out, k, _translate(v, src, dst, memo))
        return out
    memo[key] = (obj, out)
    return out


def _canon(x, stack=()):
    """Package-neutral canonical form: each object's class name and
    fields, recursively; floats by repr (NaN equal, -0.0 apart)."""
    t = type(x)
    if x is None or t in (bool, int, str, bytes):
        return x
    if t is float:
        return ("float", repr(x))
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return ("scalar", str(x.dtype), x.tobytes())
    assert id(x) not in stack, f"cycle through {t.__name__}"
    stack = stack + (id(x),)
    if t in (list, tuple):
        return (t.__name__, tuple(_canon(v, stack) for v in x))
    if isinstance(x, (set, frozenset)):
        return ("set", tuple(sorted(repr(_canon(v, stack)) for v in x)))
    if isinstance(x, dict):
        return ("dict", tuple((_canon(k, stack), _canon(v, stack))
                              for k, v in x.items()))
    return (t.__name__, tuple((k, _canon(v, stack))
                              for k, v in sorted(vars(x).items())))


def _tables(fsm):
    return {k: _canon(v) for k, v in fsm.snapshot_tables().items()}


# ------------------------------------------------------------ the log

def _seeded_log(seed):
    """Entries of every message type, made with the reference's classes
    from a numpy seed: [(msg_type, payload)]."""
    rng = np.random.default_rng(seed)
    m = _mod(REF, "mock")
    MT = _mod(REF, "raft.fsm").MessageType
    structs = _mod(REF, "structs")
    csi = _mod(REF, "structs.csi")
    ns_mod = _mod(REF, "structs.namespace")
    cfg = _mod(REF, "structs.config")
    dep = _mod(REF, "structs.deployment")
    job_mod = _mod(REF, "structs.job")
    svc = _mod(REF, "structs.service")
    node_mod = _mod(REF, "structs.node")
    acl = _mod(REF, "acl.policy")
    log = []

    def add(t, **payload):
        log.append((t, copy.deepcopy(payload)))

    def uid(tag):
        return f"{tag}-{int(rng.integers(1 << 30)):09d}"

    add(MT.NAMESPACE_UPSERT, name="team-a", description="team a")
    add(MT.QUOTA_SPEC_UPSERT, spec=ns_mod.QuotaSpec(
        name="q-a", cpu=int(rng.integers(20000, 40000)),
        memory_mb=int(rng.integers(20000, 40000)), allocs=64))
    add(MT.NAMESPACE_UPSERT, name="team-a", description="team a",
        quota="q-a")
    add(MT.SCHEDULER_CONFIG, config=cfg.SchedulerConfiguration(
        scheduler_algorithm="spread", namespace_weights={"team-a": 3}))

    nodes = []
    for k in range(6):
        n = m.node(id=f"fsm-node-{k}", name=f"fsm-node-{k}",
                   secret_id=uid("secret"))
        n.node_resources.cpu.cpu_shares = int(rng.integers(2000, 8000))
        n.node_resources.memory_mb = int(rng.integers(4096, 16384))
        n.attributes["rack"] = f"r{k % 3}"
        if k == 2:
            n.csi_node_plugins = {"ebs": {"provider": "aws", "healthy": True,
                                          "max_volumes": 8}}
        if k == 3:
            n.csi_controller_plugins = {"ebs": {"provider": "aws",
                                                "healthy": True}}
        n.computed_class = node_mod.compute_node_class(n)
        nodes.append(n)
        add(MT.NODE_REGISTER, node=n)
    add(MT.NODE_UPDATE_STATUS, node_id="fsm-node-1", status="down",
        updated_at=float(rng.uniform(1e9, 2e9)))
    add(MT.NODE_HEARTBEAT_BATCH, updates=[
        {"node_id": "fsm-node-1", "status": "ready",
         "updated_at": float(rng.uniform(1e9, 2e9))},
        {"node_id": "fsm-node-4", "status": "ready",
         "updated_at": float(rng.uniform(1e9, 2e9))},
        {"node_id": "no-such-node", "status": "down", "updated_at": 1.0}])
    add(MT.NODE_FINGERPRINT_BATCH, updates=[
        {"node_id": "fsm-node-0", "attributes": {"kernel.version": "6.1"}},
        {"node_id": "fsm-node-4", "devices": []}])
    add(MT.NODE_UPDATE_DRAIN, node_id="fsm-node-5",
        drain_strategy=node_mod.DrainStrategy(
            deadline_s=float(rng.integers(60, 600)), started_at=1.5e9))
    add(MT.NODE_UPDATE_DRAIN, node_id="fsm-node-5", drain_strategy=None,
        mark_eligible=True)
    add(MT.NODE_UPDATE_ELIGIBILITY, node_id="fsm-node-4",
        eligibility="ineligible")

    svc_job = m.job(id="fsm-svc", namespace="team-a")
    svc_job.task_groups[0].count = 3
    add(MT.JOB_REGISTER, job=svc_job)
    svc_job = copy.deepcopy(svc_job)
    svc_job.task_groups[0].count = 4
    add(MT.JOB_REGISTER, job=svc_job)
    add(MT.JOB_STABILITY, namespace="team-a", job_id="fsm-svc", version=0,
        stable=True)
    batch = m.batch_job(id="fsm-batch")
    add(MT.JOB_REGISTER, job=batch)

    evals = [m.eval(id=uid("eval"), namespace=j.namespace, job_id=j.id,
                    type=j.type, status=s)
             for j, s in ((svc_job, "pending"), (batch, "blocked"),
                          (batch, "complete"))]
    add(MT.EVAL_UPDATE, evals=evals)
    allocs = []
    for k in range(4):
        a = m.alloc_for(svc_job, f"fsm-node-{k}", index=k, id=uid("alloc"),
                        eval_id=evals[0].id, namespace="team-a")
        allocs.append(a)
    for k in range(2):
        allocs.append(m.alloc_for(batch, f"fsm-node-{k + 2}", index=k,
                                  id=uid("alloc"), eval_id=evals[2].id))
    add(MT.ALLOC_UPDATE, allocs=allocs)
    updates = []
    for a, status in zip(allocs[:3], ("running", "failed", "complete")):
        u = copy.deepcopy(a)
        u.client_status = status
        u.client_description = f"client says {status}"
        updates.append(u)
    add(MT.ALLOC_CLIENT_UPDATE, allocs=updates)
    moved = copy.deepcopy(allocs[3])
    moved.desired_transition = structs.DesiredTransition(migrate=True) \
        if hasattr(structs, "DesiredTransition") else moved.desired_transition
    moved.desired_status = "stop"
    add(MT.ALLOC_UPDATE_DESIRED_TRANSITION, allocs=[moved],
        evals=[m.eval(id=uid("eval"), namespace="team-a", job_id="fsm-svc",
                      status="pending", triggered_by="node-drain")])

    d = dep.Deployment(id=uid("deploy"), namespace="team-a", job_id="fsm-svc",
                       job_version=1, create_time=1.6e9,
                       task_groups={"web": dep.DeploymentState(
                           desired_total=4, placed_allocs=3,
                           healthy_allocs=int(rng.integers(0, 3)))})
    add(MT.DEPLOYMENT_UPSERT, deployment=d)
    d2 = copy.deepcopy(d)
    d2.status = "successful"
    add(MT.DEPLOYMENT_UPSERT, deployment=d2)

    vol = csi.CSIVolume(id="vol-1", namespace="default", name="vol-1",
                        plugin_id="ebs", access_mode="single-node-writer",
                        attachment_mode="file-system",
                        capacity_min=int(rng.integers(1, 100)))
    add(MT.CSI_VOLUME_REGISTER, volume=vol)
    add(MT.CSI_VOLUME_CLAIM, namespace="default", volume_id="vol-1",
        claim=csi.CSIVolumeClaim(alloc_id=allocs[4].id,
                                 node_id=allocs[4].node_id, mode="write"))
    add(MT.CSI_VOLUME_CLAIM, namespace="default", volume_id="vol-1",
        claim=csi.CSIVolumeClaim(alloc_id=allocs[4].id,
                                 node_id=allocs[4].node_id, mode="write",
                                 state="ready-to-free"))
    vol2 = csi.CSIVolume(id="vol-2", namespace="default", name="vol-2",
                         plugin_id="ebs")
    add(MT.CSI_VOLUME_REGISTER, volume=vol2)
    add(MT.CSI_VOLUME_CLAIM, namespace="default", volume_id="vol-2",
        claim=csi.CSIVolumeClaim(alloc_id=allocs[5].id,
                                 node_id=allocs[5].node_id, mode="read"))
    add(MT.CSI_VOLUME_DEREGISTER, namespace="default", volume_id="vol-2",
        force=True)

    add(MT.ACL_POLICY_UPSERT, policy=acl.ACLPolicy(
        name="readonly", description="read jobs",
        rules='namespace "default" { policy = "read" }',
        namespaces=[acl.NamespaceRule(name="default", policy="read")]))
    add(MT.ACL_POLICY_UPSERT, policy=acl.ACLPolicy(name="ops", node="write"))
    mgmt = acl.ACLToken(accessor_id=uid("acc"), secret_id=uid("sec"),
                        name="bootstrap", type="management")
    add(MT.ACL_TOKEN_UPSERT, token=mgmt, bootstrap=True)
    add(MT.ACL_TOKEN_UPSERT, bootstrap=True, token=acl.ACLToken(
        accessor_id=uid("acc"), secret_id=uid("sec"), name="again",
        type="management"))
    client = acl.ACLToken(accessor_id=uid("acc"), secret_id=uid("sec"),
                          name="reader", policies=["readonly"])
    add(MT.ACL_TOKEN_UPSERT, token=client)
    add(MT.ACL_TOKEN_DELETE, accessor_id=client.accessor_id)
    add(MT.ACL_POLICY_DELETE, name="ops")

    for k in range(2):
        add(MT.SCALING_EVENT, namespace="team-a", job_id="fsm-svc",
            group="web", event=job_mod.ScalingEvent(
                time=1.6e9 + k, previous_count=3 + k, count=4 + k,
                message=f"scaled to {4 + k}", eval_id=evals[0].id,
                meta={"by": "operator"}))

    regs = [svc.ServiceRegistration(
        id=svc.registration_id(a.id, "web", "http", "http"),
        service_name="http", namespace=a.namespace, node_id=a.node_id,
        datacenter="dc1", job_id=a.job_id, alloc_id=a.id,
        tags=["v1"], address="10.0.0.%d" % k,
        port=int(rng.integers(20000, 30000)))
        for k, a in enumerate(allocs[:4])]
    add(MT.SERVICE_REGISTER, services=regs)
    add(MT.SERVICE_DEREGISTER, ids=[regs[0].id])
    add(MT.SERVICE_DEREGISTER, alloc_id=allocs[1].id)

    add(MT.NOOP)
    add(MT.STATE_CHECKPOINT, digest="0" * 16)
    add(MT.EVAL_DELETE, eval_ids=[evals[2].id], alloc_ids=[allocs[5].id])
    add(MT.JOB_DEREGISTER, namespace="default", job_id="fsm-batch")
    add(MT.DEPLOYMENT_DELETE, deployment_id=d.id)
    add(MT.JOB_DEREGISTER, namespace="team-a", job_id="fsm-svc", purge=True)
    add(MT.NAMESPACE_UPSERT, name="team-a", description="team a")
    add(MT.QUOTA_SPEC_DELETE, name="q-a")
    add(MT.NAMESPACE_DELETE, name="team-a")
    add(MT.NODE_DEREGISTER, node_id="fsm-node-5")
    return log


def _server_log(monkeypatch):
    """Every entry the port's dev-mode server applies while it places
    three jobs (a deepcopy of each payload, taken before the apply)."""
    monkeypatch.setenv("NOMAD_TPU_PIPELINE_DEPTH", "0")
    m, srv = _mod(PORT, "mock"), _mod(PORT, "core.server")
    s = srv.Server(srv.ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                                    gc_interval=3600.0), device="cpu")
    log = []
    apply = s.fsm.apply

    def recording(index, msg_type, payload):
        log.append((msg_type, copy.deepcopy(payload)))
        return apply(index, msg_type, payload)

    s.fsm.apply = recording
    s.start()
    try:
        for k in range(12):
            s.register_node(m.node(id=f"srv-node-{k}", name=f"srv-node-{k}",
                                   secret_id=f"srv-secret-{k}"))
        for k, count in enumerate((6, 9)):
            j = m.batch_job(id=f"srv-batch-{k}")
            j.task_groups[0].count = count
            s.register_job(j)
            assert s.wait_for_idle(60)
        j = m.job(id="srv-svc")
        j.task_groups[0].count = 3
        s.register_job(j)
        assert s.wait_for_idle(60)
    finally:
        s.stop()
    return log


@pytest.fixture(scope="module")
def replay():
    """Both FSMs fed the log entry by entry: per entry (msg_type, first
    table that differs between the packages or None, whether the port's
    tables changed), plus both FSMs at the end."""
    pytest.importorskip("jax")
    mp = pytest.MonkeyPatch()
    try:
        server = _server_log(mp)
    finally:
        mp.undo()
    seeded = _seeded_log(19)
    entries = [(t, p, _translate(copy.deepcopy(p), REF, PORT))
               for t, p in seeded]
    entries += [(t, _translate(copy.deepcopy(p), PORT, REF), p)
                for t, p in server]
    ref_fsm = _mod(REF, "raft.fsm").NomadFSM(_mod(REF, "state").StateStore())
    port_fsm = _mod(PORT, "raft.fsm").NomadFSM(_mod(PORT, "state").StateStore())
    out = []
    before = _tables(port_fsm)
    for index, (t, ref_p, port_p) in enumerate(entries, start=1):
        ref_fsm.apply(index, t, ref_p)
        port_fsm.apply(index, t, port_p)
        want, got = _tables(ref_fsm), _tables(port_fsm)
        assert set(want) == set(got)
        diff = next((k for k in sorted(want) if want[k] != got[k]), None)
        out.append((t, diff, got != before))
        before = got
    return {"entries": out, "ref": ref_fsm, "port": port_fsm,
            "n_seeded": len(seeded)}


def _message_types(root):
    mt = _mod(root, "raft.fsm").MessageType
    return sorted(v for k, v in vars(mt).items() if not k.startswith("_"))


def test_port_has_every_message_type_of_the_reference():
    assert _message_types(PORT) == _message_types(REF)
    ref_touch = _mod(REF, "raft.fsm")._APPLY_TOUCHES
    port_touch = _mod(PORT, "raft.fsm")._APPLY_TOUCHES
    assert port_touch == {k: v for k, v in ref_touch.items()
                          if k != "RaftConfiguration"}


@pytest.mark.parametrize("msg_type", _message_types(REF))
def test_entries_keep_tables_equal(replay, msg_type):
    entries = replay["entries"]
    mine = [(i, diff, changed) for i, (t, diff, changed) in
            enumerate(entries) if t == msg_type]
    assert mine, f"the log has no {msg_type} entry"
    first = next(((i, d) for i, (_, d, _) in enumerate(entries) if d), None)
    for i, diff, _ in mine:
        assert diff is None, (f"after entry {i} ({msg_type}) table {diff} "
                              f"differs; first divergence {first}")
    if msg_type in ("Noop", "StateCheckpointRequest"):
        assert not any(changed for _, _, changed in mine)
    else:
        assert any(changed for _, _, changed in mine), \
            f"no {msg_type} entry changed a table"


def test_log_ends_with_the_servers_plans(replay):
    entries = replay["entries"]
    tail = [t for t, _, _ in entries[replay["n_seeded"]:]]
    assert tail.count("ApplyPlanResultsRequest") >= 3
    assert len(replay["port"].store.allocs()) >= 18


# ------------------------------------------------------------ snapshots

def test_snapshot_restore_snapshot_is_byte_identical(replay):
    digest = _mod(PORT, "state.digest")
    blob = replay["port"].snapshot()
    fsm = _mod(PORT, "raft.fsm").NomadFSM(_mod(PORT, "state").StateStore())
    fsm.restore(blob)
    again = fsm.snapshot()
    assert again == blob
    want = digest.blob_digests(blob)
    assert digest.tables_digests(fsm.snapshot_tables()) == want
    assert digest.blob_digests(again) == want
    assert digest.first_divergence(want, digest.blob_digests(again)) is None
    assert digest.canon(again) == digest.canon(blob)
    assert digest.combine(want) == digest.combine(digest.blob_digests(again))


def test_restore_keeps_tables_and_indexes(replay):
    port = replay["port"]
    fsm = _mod(PORT, "raft.fsm").NomadFSM(_mod(PORT, "state").StateStore())
    fsm.restore(port.snapshot())
    assert _tables(fsm) == _tables(port)
    s, live = fsm.store, port.store
    assert s.latest_index == live.latest_index
    for j in live.jobs():
        assert sorted(a.id for a in s.allocs_by_job(j.namespace, j.id)) == \
            sorted(a.id for a in live.allocs_by_job(j.namespace, j.id))
    for n in live.nodes():
        assert sorted(a.id for a in s.allocs_by_node(n.id)) == \
            sorted(a.id for a in live.allocs_by_node(n.id))
    assert s._live_names == live._live_names
    assert s._evals_by_job == live._evals_by_job
    assert s._allocs_by_eval == live._allocs_by_eval
    assert {k: v for k, v in s._services_by_alloc.items() if v} == \
        {k: v for k, v in live._services_by_alloc.items() if v}
    assert s._applied_plan_ids_set == live._applied_plan_ids_set
    assert set(s._acl_by_secret) == set(live._acl_by_secret)


@pytest.mark.parametrize("array", ("capacity", "used", "port_words", "ready"))
def test_restored_matrix_equals_the_references(replay, array):
    ref = _mod(REF, "raft.fsm").NomadFSM(_mod(REF, "state").StateStore())
    ref.restore(replay["ref"].snapshot())
    port = _mod(PORT, "raft.fsm").NomadFSM(_mod(PORT, "state").StateStore())
    port.restore(replay["port"].snapshot())
    want = getattr(ref.store.matrix, array)
    got = getattr(port.store.matrix, array)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert port.store.matrix.row_of == ref.store.matrix.row_of
    live = replay["port"].store.matrix
    rows = [port.store.matrix.row_of[n] for n in live.row_of]
    live_rows = list(live.row_of.values())
    np.testing.assert_array_equal(getattr(port.store.matrix, array)[rows],
                                  getattr(live, array)[live_rows])


def test_snapshot_carries_every_store_table(replay):
    tables = replay["port"].snapshot_tables()
    assert set(tables) == set(replay["ref"].snapshot_tables())
    assert tables["latest_index"] == len(replay["entries"])


# ------------------------------------------------------------ the server

def _server_round_trip(root, kw, path):
    m, srv = _mod(root, "mock"), _mod(root, "core.server")

    def server():
        s = srv.Server(srv.ServerConfig(num_schedulers=1, heartbeat_ttl=3600.0,
                                        gc_interval=3600.0), **kw)
        return s

    def run(s, jobs):
        for j in jobs:
            s.register_job(j)
            assert s.wait_for_idle(60)

    def jobs(first, n, count):
        out = []
        for k in range(first, first + n):
            j = m.batch_job(id=f"rt-batch-{k}")
            j.task_groups[0].count = count
            out.append(j)
        return out

    def maps(s, js):
        out = {}
        for j in js:
            per = {}
            for a in s.store.allocs_by_job("default", j.id):
                if a.desired_status == "run":
                    row = s.store.matrix.row_of[a.node_id]
                    per[row] = per.get(row, 0) + 1
            out[j.id] = per
        return out

    s = server()
    s.start()
    try:
        for i in range(64):
            s.register_node(m.node(id=f"rt-node-{i:03d}", name=f"rt-node-{i:03d}",
                                   secret_id=f"rt-secret-{i:03d}"))
        first = jobs(0, 3, 40)
        run(s, first)
        s.save_snapshot(path)
        before = maps(s, first)
    finally:
        s.stop()
    s2 = server()
    s2.restore_snapshot(path)
    restored = maps(s2, first)
    s2.start()
    try:
        more = jobs(3, 3, 40)
        run(s2, more)
        after = maps(s2, first + more)
        used = s2.store.matrix.used.copy()
    finally:
        s2.stop()
    return before, restored, after, used


@pytest.fixture(scope="module")
def server_round_trips(tmp_path_factory):
    pytest.importorskip("jax")
    mp = pytest.MonkeyPatch()
    mp.setenv("NOMAD_TPU_PIPELINE_DEPTH", "0")
    mp.setenv("NOMAD_TPU_SHARD", "0")
    d = tmp_path_factory.mktemp("snap")
    try:
        return (_server_round_trip(REF, {}, str(d / "ref.snap")),
                _server_round_trip(PORT, {"device": "cpu"},
                                   str(d / "port.snap")))
    finally:
        mp.undo()


def test_server_restore_keeps_the_placements(server_round_trips):
    for before, restored, _, _ in server_round_trips:
        assert restored == before
        assert sum(sum(per.values()) for per in before.values()) == 120


def test_server_places_as_the_reference_after_a_restore(server_round_trips):
    ref, port = server_round_trips
    assert port[0] == ref[0]
    assert port[2] == ref[2]
    assert sum(sum(per.values()) for per in port[2].values()) == 240
    np.testing.assert_array_equal(port[3], ref[3])


_ISOLATED = r"""
import os, sys, tempfile
os.environ["NOMAD_TPU_PIPELINE_DEPTH"] = "0"
from nomad_tpu_torch import mock, native
from nomad_tpu_torch.core.server import Server, ServerConfig
s = Server(ServerConfig(num_schedulers=1), device="cpu")
s.start()
s.register_node(mock.node())
s.register_job(mock.job())
assert s.wait_for_idle(30)
path = os.path.join(tempfile.mkdtemp(), "state.snap")
s.save_snapshot(path)
s.stop()
s2 = Server(ServerConfig(num_schedulers=1), device="cpu")
s2.restore_snapshot(path)
assert len(s2.store.allocs()) == len(s.store.allocs()) > 0
assert native._lib is not None
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "nomad_tpu" or m.startswith("nomad_tpu."))
print("LOADED:" + ",".join(bad))
"""


def test_snapshot_path_and_library_load_neither_jax_nor_reference():
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=repo,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert [ln for ln in out.stdout.splitlines()
            if ln.startswith("LOADED:")] == ["LOADED:"]
