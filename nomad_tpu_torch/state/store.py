"""StateStore: versioned in-memory MVCC-style store.

Reference: nomad/state/state_store.go (StateStore:83, Snapshot:190,
SnapshotMinIndex:217, UpsertPlanResults:337) and the table schemata in
nomad/state/schema.go:116-1107.  Differences by design:

- go-memdb's immutable radix trees give O(1) snapshots; here objects are
  treated as immutable-once-inserted (writers always insert copies) and a
  snapshot shallow-copies the table dicts, memoized per index so concurrent
  scheduler workers share one snapshot until the next write.
- The dense ClusterMatrix mirror is maintained inline on every node/alloc
  write — the dense analog of memdb watchsets feeding blocking queries.
"""
from __future__ import annotations

import threading
import time as _time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from nomad_tpu_torch.encode.matrixizer import ClusterMatrix
from nomad_tpu_torch.structs import (
    Allocation,
    AllocClientStatus,
    AllocDesiredStatus,
    Deployment,
    DeploymentStatus,
    Evaluation,
    EvalStatus,
    Job,
    JobStatus,
    Node,
    SchedulerConfiguration,
)
from nomad_tpu_torch.structs.evaluation import EvalTrigger
from nomad_tpu_torch.structs.namespace import (
    Namespace, QuotaSpec, alloc_quota_usage, usage_add)
from nomad_tpu_torch.structs.node import NodeStatus, compute_node_class
from nomad_tpu_torch.structs.plan import Plan, PlanResult
from nomad_tpu_torch.structs.service import ServiceRegistration


class JobSummary:
    """Per-job per-taskgroup alloc status counts (reference
    structs.JobSummary, maintained by state_store alloc writes)."""

    def __init__(self, job_id: str, namespace: str = "default"):
        self.job_id = job_id
        self.namespace = namespace
        self.summary: Dict[str, Dict[str, int]] = {}
        self.children = {"pending": 0, "running": 0, "dead": 0}
        self.create_index = 0
        self.modify_index = 0

    def group(self, tg: str) -> Dict[str, int]:
        return self.summary.setdefault(tg, {
            "queued": 0, "complete": 0, "failed": 0,
            "running": 0, "starting": 0, "lost": 0, "unknown": 0})

    def to_dict(self) -> dict:
        return {"job_id": self.job_id, "namespace": self.namespace,
                "summary": {k: dict(v) for k, v in self.summary.items()},
                "children": dict(self.children),
                "create_index": self.create_index,
                "modify_index": self.modify_index}


class StateSnapshot:
    """A consistent read-only view at one index."""

    def __init__(self, store: "StateStore"):
        # caller (StateStore.snapshot) holds store._lock while we copy
        self.index = store.latest_index
        self.nodes: Dict[str, Node] = dict(store._nodes)
        self.jobs: Dict[Tuple[str, str], Job] = dict(store._jobs)
        self.evals: Dict[str, Evaluation] = dict(store._evals)
        self.allocs: Dict[str, Allocation] = dict(store._allocs)
        self.deployments: Dict[str, Deployment] = dict(store._deployments)
        self._allocs_by_job = {k: set(v) for k, v in store._allocs_by_job.items()}
        self._allocs_by_node = {k: set(v) for k, v in store._allocs_by_node.items()}
        self.scheduler_config = store.scheduler_config
        # the matrix is shared (incremental); schedulers use it read-only
        # together with per-eval used_override deltas
        self.matrix = store.matrix
        self._store = store

    # --- read API mirroring the reference's State interface
    # (scheduler/scheduler.go:67-116)

    def node_by_id(self, node_id: str) -> Optional[Node]:
        return self.nodes.get(node_id)

    def job_by_id(self, namespace: str, job_id: str) -> Optional[Job]:
        return self.jobs.get((namespace, job_id))

    def ready_nodes_in_dcs(self, datacenters: List[str]) -> List[Node]:
        dcs = set(datacenters)
        return [n for n in self.nodes.values()
                if n.ready() and n.datacenter in dcs]

    def allocs_by_job(self, namespace: str, job_id: str,
                      all_allocs: bool = True) -> List[Allocation]:
        ids = self._allocs_by_job.get((namespace, job_id), ())
        return [self.allocs[i] for i in ids]

    def allocs_by_node(self, node_id: str) -> List[Allocation]:
        ids = self._allocs_by_node.get(node_id, ())
        return [self.allocs[i] for i in ids]

    def allocs_by_node_terminal(self, node_id: str, terminal: bool) -> List[Allocation]:
        return [a for a in self.allocs_by_node(node_id)
                if a.terminal_status() == terminal]

    def deployment_by_id(self, deployment_id: str) -> Optional[Deployment]:
        return self.deployments.get(deployment_id)

    def latest_deployment_by_job_id(self, namespace: str, job_id: str) -> Optional[Deployment]:
        best = None
        for d in self.deployments.values():
            if d.namespace == namespace and d.job_id == job_id:
                if best is None or d.create_index > best.create_index:
                    best = d
        return best

    def eval_by_id(self, eval_id: str) -> Optional[Evaluation]:
        return self.evals.get(eval_id)

    # CSI reads go through the live store: claims move through the
    # serialized applier/FSM, so the checker wants the freshest view
    # (the reference checker also re-reads state inside the worker's
    # snapshot, feasible.go:276-300)
    def csi_volume_by_id(self, namespace: str, vol_id: str):
        return self._store.csi_volume_by_id(namespace, vol_id)

    def csi_plugin_by_id(self, plugin_id: str):
        return self._store.csi_plugin_by_id(plugin_id)


class StateStore:
    # Lock discipline: every read/write of the store's tables happens
    # inside `with <store>._lock:` (the `*_locked` helpers and
    # StateSnapshot.__init__ expect the caller to hold it).

    def __init__(self):
        self._lock = threading.RLock()
        self._index_cv = threading.Condition(self._lock)
        self.latest_index = 0
        self._nodes: Dict[str, Node] = {}
        self._jobs: Dict[Tuple[str, str], Job] = {}
        self._job_versions: Dict[Tuple[str, str], List[Job]] = defaultdict(list)
        self._evals: Dict[str, Evaluation] = {}
        self._allocs: Dict[str, Allocation] = {}
        self._deployments: Dict[str, Deployment] = {}
        self._job_summaries: Dict[Tuple[str, str], JobSummary] = {}
        self._allocs_by_job: Dict[Tuple[str, str], Set[str]] = defaultdict(set)
        self._allocs_by_node: Dict[str, Set[str]] = defaultdict(set)
        self._allocs_by_eval: Dict[str, Set[str]] = defaultdict(set)
        # derived, never serialized: (namespace, job_id, name) -> ids of
        # non-terminal allocs holding that name (the plan-apply
        # duplicate-name guard reads it per placement, so it must be
        # O(1), not a scan of the job's alloc set)
        self._live_names: Dict[Tuple[str, str, str], Set[str]] = {}
        self._evals_by_job: Dict[Tuple[str, str], Set[str]] = defaultdict(set)
        self.scheduler_config = SchedulerConfiguration()
        # namespaces table (reference nomad/state/schema.go namespaces)
        self._namespaces: Dict[str, Namespace] = {
            "default": Namespace(name="default",
                                 description="Default shared namespace")}
        # quota specs + replicated usage accounting.  Usage is maintained
        # inside the same apply cone as `_live_names` (alloc liveness
        # transitions) so every replica derives byte-identical tables;
        # all-zero namespace entries are deleted for a canonical form.
        self._quota_specs: Dict[str, QuotaSpec] = {}
        self._quota_usage: Dict[str, Dict[str, int]] = {}
        # ACL tables (reference schema.go acl_policy / acl_token)
        self._acl_policies: Dict[str, object] = {}
        self._acl_tokens: Dict[str, object] = {}       # by accessor_id
        self._acl_by_secret: Dict[str, object] = {}
        # CSI tables (reference schema.go csi_volumes / csi_plugins)
        self._csi_volumes: Dict[Tuple[str, str], object] = {}   # (ns, id)
        self._csi_plugins: Dict[str, object] = {}
        # scaling event ring per (ns, job, group) (reference schema.go
        # scaling_event; capped like structs.JobTrackedScalingEvents)
        self._scaling_events: Dict[Tuple[str, str, str], List[object]] = {}
        # nomad-native service registrations, keyed by registration id
        # (reference schema.go service_registrations)
        self._services: Dict[str, ServiceRegistration] = {}
        self._services_by_alloc: Dict[str, Set[str]] = defaultdict(set)
        self.matrix = ClusterMatrix()
        # readers outside the store (the placement engine's basis copies)
        # take this lock to avoid tearing a half-applied commit
        self.matrix.lock = self._lock
        self._snapshot_cache: Optional[StateSnapshot] = None
        # watchers: fn(table: str, obj) called after commit, outside hot loops
        self._watchers: List[Callable[[str, object], None]] = []
        # plan-id dedup ring: APPLY_PLAN_RESULTS entries replayed after a
        # leader failover (raft log re-application onto a restored
        # snapshot) must commit at most once.  Bounded FIFO; old ids age
        # out long after any replay window.
        self._applied_plan_ids: List[str] = []
        self._applied_plan_ids_set: Set[str] = set()
        self._applied_plan_ids_cap = 8192

    # ------------------------------------------------------------ plumbing

    def watch(self, fn: Callable[[str, object], None]) -> None:
        self._watchers.append(fn)

    def _notify(self, table: str, obj) -> None:
        for fn in self._watchers:
            fn(table, obj)

    def _bump(self, index: int) -> None:
        if index <= self.latest_index:
            index = self.latest_index  # idempotent replay keeps max
        self.latest_index = max(self.latest_index, index)
        self._snapshot_cache = None
        self._index_cv.notify_all()

    def snapshot(self) -> StateSnapshot:
        """Memoized per index (reference Snapshot, state_store.go:190)."""
        with self._lock:
            if self._snapshot_cache is None:
                self._snapshot_cache = StateSnapshot(self)
            return self._snapshot_cache

    def snapshot_min_index(self, index: int, timeout: float = 5.0) -> Optional[StateSnapshot]:
        """Block until state has caught up to `index` (reference
        SnapshotMinIndex, state_store.go:217 — gates scheduling on Raft
        catch-up)."""
        with self._index_cv:
            if not self._index_cv.wait_for(
                    lambda: self.latest_index >= index, timeout=timeout):
                return None
            return self.snapshot()

    def wait_for_index(self, index: int, timeout: float = 5.0) -> bool:
        with self._index_cv:
            return self._index_cv.wait_for(
                lambda: self.latest_index >= index, timeout=timeout)

    # ------------------------------------------------------------ nodes

    def upsert_node(self, index: int, node: Node) -> None:
        with self._lock:
            node.modify_index = index
            if node.id not in self._nodes:
                node.create_index = index
            if not node.computed_class:
                node.computed_class = compute_node_class(node)
            self._nodes[node.id] = node
            self.matrix.upsert_node(node)
            self._update_csi_plugins_for_node(index, node)
            self._bump(index)
        self._notify("nodes", node)

    def delete_node(self, index: int, node_id: str) -> None:
        with self._lock:
            node = self._nodes.pop(node_id, None)
            self.matrix.remove_node(node_id)
            for plug in list(self._csi_plugins.values()):
                plug.nodes.pop(node_id, None)
                plug.controllers.pop(node_id, None)
                if not plug.nodes and not plug.controllers:
                    del self._csi_plugins[plug.id]
            self._bump(index)
        if node:
            self._notify("nodes", node)

    def _update_csi_plugins_for_node(self, index: int, node: Node) -> None:
        """Derive csi_plugins rows from node fingerprints (reference
        state_store.go updateNodeCSIPlugins)."""
        from nomad_tpu_torch.structs.csi import CSIPlugin
        seen = set()
        for pid, info in node.csi_node_plugins.items():
            plug = self._csi_plugins.get(pid)
            if plug is None:
                plug = self._csi_plugins[pid] = CSIPlugin(
                    id=pid, provider=info.get("provider", ""),
                    create_index=index)
            plug.nodes[node.id] = {
                "healthy": bool(info.get("healthy", False)),
                "max_volumes": int(info.get("max_volumes", 0) or 0),
            }
            plug.modify_index = index
            seen.add(pid)
        for pid, info in node.csi_controller_plugins.items():
            plug = self._csi_plugins.get(pid)
            if plug is None:
                plug = self._csi_plugins[pid] = CSIPlugin(
                    id=pid, provider=info.get("provider", ""),
                    create_index=index)
            plug.controllers[node.id] = {
                "healthy": bool(info.get("healthy", False))}
            plug.controller_required = True
            plug.modify_index = index
            seen.add(pid)
        # plugin rows this node no longer fingerprints
        for pid, plug in list(self._csi_plugins.items()):
            if pid in seen:
                continue
            plug.nodes.pop(node.id, None)
            plug.controllers.pop(node.id, None)
            if not plug.nodes and not plug.controllers:
                del self._csi_plugins[pid]

    def update_node_status(self, index: int, node_id: str, status: str,
                           updated_at: float = 0.0) -> None:
        with self._lock:
            old = self._nodes.get(node_id)
            if old is None:
                return
            node = _shallow_copy_node(old)
            node.status = status
            node.status_updated_at = updated_at
            node.modify_index = index
            self._nodes[node_id] = node
            self.matrix.upsert_node(node)
            self._bump(index)
        self._notify("nodes", node)

    def update_node_statuses_many(self, index: int, updates) -> None:
        """Batched status/liveness transitions — one lock pass for a
        whole heartbeat-coalescer flush (the node-plane analogue of
        upsert_plan_results_many), so a 10K-agent fleet's steady-state
        heartbeat writes cost O(batches), not O(nodes), store passes.
        Each update dict carries node_id/status/updated_at with the
        same per-node semantics as update_node_status."""
        changed = []
        with self._lock:
            for u in updates:
                old = self._nodes.get(u["node_id"])
                if old is None:
                    continue
                node = _shallow_copy_node(old)
                node.status = u["status"]
                node.status_updated_at = u.get("updated_at", 0.0)
                node.modify_index = index
                self._nodes[u["node_id"]] = node
                self.matrix.upsert_node(node)
                changed.append(node)
            if changed:
                self._bump(index)
        for node in changed:
            self._notify("nodes", node)

    def update_node_fingerprints_many(self, index: int, updates) -> None:
        """Batched device/attribute re-fingerprints — one lock pass for
        a whole coalescer flush (mirrors update_node_statuses_many), so
        a fleet-wide fingerprint storm costs O(batches) store passes
        and O(flush-ticks) raft entries, not O(changes) Node.Register
        round-trips.  Each update dict carries node_id plus optional
        devices / attributes deltas."""
        import copy as _copy
        changed = []
        with self._lock:
            for u in updates:
                old = self._nodes.get(u["node_id"])
                if old is None:
                    continue
                node = _shallow_copy_node(old)
                if "devices" in u:
                    # node_resources is shared by the shallow copy —
                    # copy it too or the old record aliases the new
                    # device list and MVCC readers see torn state.
                    node.node_resources = _copy.copy(old.node_resources)
                    node.node_resources.devices = u["devices"]
                if "attributes" in u:
                    attrs = dict(old.attributes)
                    attrs.update(u["attributes"])
                    node.attributes = attrs
                node.computed_class = compute_node_class(node)
                node.modify_index = index
                self._nodes[u["node_id"]] = node
                self.matrix.upsert_node(node)
                changed.append(node)
            if changed:
                self._bump(index)
        for node in changed:
            self._notify("nodes", node)

    def update_node_drain(self, index: int, node_id: str, drain_strategy,
                          mark_eligible: bool = False) -> None:
        with self._lock:
            old = self._nodes.get(node_id)
            if old is None:
                return
            node = _shallow_copy_node(old)
            node.drain_strategy = drain_strategy
            if drain_strategy is not None:
                node.scheduling_eligibility = "ineligible"
            elif mark_eligible:
                node.scheduling_eligibility = "eligible"
            node.modify_index = index
            self._nodes[node_id] = node
            self.matrix.upsert_node(node)
            self._bump(index)
        self._notify("nodes", node)

    def update_node_eligibility(self, index: int, node_id: str, eligibility: str) -> None:
        with self._lock:
            old = self._nodes.get(node_id)
            if old is None:
                return
            node = _shallow_copy_node(old)
            node.scheduling_eligibility = eligibility
            node.modify_index = index
            self._nodes[node_id] = node
            self.matrix.upsert_node(node)
            self._bump(index)
        self._notify("nodes", node)

    def nodes(self) -> List[Node]:
        with self._lock:
            return list(self._nodes.values())

    def node_by_id(self, node_id: str) -> Optional[Node]:
        with self._lock:
            return self._nodes.get(node_id)

    def nodes_by_ids(self, node_ids) -> List[Optional[Node]]:
        """The nodes of `node_ids` (None where unknown) in one lock pass:
        a fleet's batched heartbeat reads a chunk at once instead of
        taking the store's lock once a node."""
        with self._lock:
            return [self._nodes.get(n) for n in node_ids]

    # ------------------------------------------------------------ jobs

    def upsert_job(self, index: int, job: Job) -> None:
        with self._lock:
            job.canonicalize()
            # submit_time is stamped at PROPOSE time (Server.register_job)
            # and carried in the raft log payload: stamping it here would
            # run inside fsm.apply, where a wall-clock read makes every
            # replica/replay produce a different value.
            key = (job.namespace, job.id)
            existing = self._jobs.get(key)
            if existing is not None:
                job.create_index = existing.create_index
                job.version = existing.version + 1
            else:
                job.create_index = index
                job.version = 0
            job.modify_index = index
            job.job_modify_index = index
            if job.status not in (JobStatus.DEAD,):
                job.status = JobStatus.PENDING if not job.stop else JobStatus.DEAD
            self._jobs[key] = job
            self._job_versions[key].append(job)
            if len(self._job_versions[key]) > 6:   # JobTrackedVersions
                self._job_versions[key].pop(0)
            if key not in self._job_summaries:
                js = JobSummary(job.id, job.namespace)
                js.create_index = index
                self._job_summaries[key] = js
            for tg in job.task_groups:
                self._job_summaries[key].group(tg.name)
            self._bump(index)
        self._notify("jobs", job)

    def delete_job(self, index: int, namespace: str, job_id: str) -> None:
        with self._lock:
            job = self._jobs.pop((namespace, job_id), None)
            self._job_versions.pop((namespace, job_id), None)
            self._job_summaries.pop((namespace, job_id), None)
            self._bump(index)
        if job:
            self._notify("jobs_deregistered", job)

    def job_by_id(self, namespace: str, job_id: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get((namespace, job_id))

    def mark_job_stability(self, index: int, namespace: str, job_id: str,
                           version: int, stable: bool) -> None:
        """Job.Stability RPC / deployment success path: flip `stable` on a
        specific version WITHOUT bumping the job version (reference
        UpdateJobStability)."""
        with self._lock:
            key = (namespace, job_id)
            versions = self._job_versions.get(key, [])
            for i, j in enumerate(versions):
                if j.version == version:
                    u = j.copy()
                    u.stable = stable
                    u.version = j.version
                    u.create_index = j.create_index
                    u.modify_index = index
                    versions[i] = u
                    if self._jobs.get(key) is j or (
                            self._jobs.get(key) is not None
                            and self._jobs[key].version == version):
                        self._jobs[key] = u
                    break
            self._bump(index)

    def job_versions(self, namespace: str, job_id: str) -> List[Job]:
        """All tracked versions, newest first (reference JobVersionsByID)."""
        with self._lock:
            return sorted(self._job_versions.get((namespace, job_id), ()),
                          key=lambda j: j.version, reverse=True)

    def job_version(self, namespace: str, job_id: str, version: int) -> Optional[Job]:
        with self._lock:
            for j in self._job_versions.get((namespace, job_id), ()):
                if j.version == version:
                    return j
        return None

    def jobs(self) -> List[Job]:
        with self._lock:
            return list(self._jobs.values())

    def job_summary(self, namespace: str, job_id: str) -> Optional[JobSummary]:
        with self._lock:
            return self._job_summaries.get((namespace, job_id))

    # ------------------------------------------------------------ evals

    def upsert_evals(self, index: int, evals: Iterable[Evaluation]) -> None:
        # create_time/modify_time are stamped at propose time and ride in
        # the log payload — reading the clock here diverges replicas.
        out = []
        with self._lock:
            for e in evals:
                if e.id not in self._evals:
                    e.create_index = index
                if not e.modify_time:
                    e.modify_time = e.create_time
                e.modify_index = index
                self._evals[e.id] = e
                self._index_eval_locked(e)
                out.append(e)
            self._bump(index)
        for e in out:
            self._notify("evals", e)

    def delete_eval(self, index: int, eval_ids: Iterable[str],
                    alloc_ids: Iterable[str] = ()) -> None:
        with self._lock:
            for eid in eval_ids:
                e = self._evals.pop(eid, None)
                if e is not None:
                    self._evals_by_job[(e.namespace, e.job_id)].discard(eid)
            for aid in alloc_ids:
                self._drop_alloc(aid)
            self._bump(index)

    def eval_by_id(self, eval_id: str) -> Optional[Evaluation]:
        with self._lock:
            return self._evals.get(eval_id)

    def evals(self) -> List[Evaluation]:
        with self._lock:
            return list(self._evals.values())

    def allocs(self) -> List[Allocation]:
        with self._lock:
            return list(self._allocs.values())

    def evals_by_job(self, namespace: str, job_id: str) -> List[Evaluation]:
        with self._lock:
            return [self._evals[i]
                    for i in self._evals_by_job.get((namespace, job_id), ())]

    # ---------------------------------------------------- scaling events

    MAX_SCALING_EVENTS = 100   # reference structs.JobTrackedScalingEvents

    def upsert_scaling_event(self, index: int, namespace: str, job_id: str,
                             group: str, event) -> None:
        with self._lock:
            ring = self._scaling_events.setdefault(
                (namespace, job_id, group), [])
            ring.insert(0, event)
            del ring[self.MAX_SCALING_EVENTS:]
            self._bump(index)

    def scaling_events_by_job(self, namespace: str, job_id: str):
        """{group: [ScalingEvent, newest first]}"""
        with self._lock:
            return {g: list(ev) for (ns, jid, g), ev in
                    self._scaling_events.items()
                    if ns == namespace and jid == job_id}

    def scaling_policies(self, namespace: Optional[str] = None):
        """[(job, group, ScalingPolicy)] over live jobs (the reference
        stores policies in their own table; here they live on the job,
        the single source of truth)."""
        with self._lock:
            out = []
            for j in self._jobs.values():
                if namespace is not None and j.namespace != namespace:
                    continue
                if j.stopped():
                    continue
                for tg in j.task_groups:
                    if tg.scaling is not None:
                        out.append((j, tg.name, tg.scaling))
            return out

    # ----------------------------------------------- service registrations

    def upsert_service_registrations(
            self, index: int, services: List[ServiceRegistration]) -> None:
        """services: [ServiceRegistration] (reference
        state_store_service_registration.go UpsertServiceRegistrations)."""
        with self._lock:
            for sr in services:
                self._services[sr.id] = sr
                self._index_service_locked(sr)
            self._bump(index)
        for sr in services:
            self._notify("services", sr)

    def delete_service_registrations(self, index: int, ids=None,
                                     alloc_id: Optional[str] = None) -> None:
        with self._lock:
            doomed = set(ids or ())
            if alloc_id is not None:
                doomed |= self._services_by_alloc.get(alloc_id, set())
            removed = []
            # sorted: set order varies with hash randomization, and pop
            # order shapes dict layout -> snapshot bytes must not care
            for sid in sorted(doomed):
                sr = self._services.pop(sid, None)
                if sr is not None:
                    self._services_by_alloc[sr.alloc_id].discard(sid)
                    removed.append(sr)
            self._bump(index)
        for sr in removed:
            self._notify("services", sr)

    def services(self, namespace: Optional[str] = None):
        with self._lock:
            return [s for s in self._services.values()
                    if namespace is None or s.namespace == namespace]

    def services_by_name(self, namespace: str, name: str):
        with self._lock:
            return [s for s in self._services.values()
                    if s.namespace == namespace and s.service_name == name]

    def services_by_alloc(self, alloc_id: str):
        with self._lock:
            return [self._services[i]
                    for i in self._services_by_alloc.get(alloc_id, ())]

    # ------------------------------------------- derived index builders
    #
    # The ONLY row constructors for the derived index tables: the apply
    # path calls them incrementally, snapshot restore calls them per
    # restored row.  Keeping both paths on one function is what lets a
    # restored follower replay the rest of the log byte-identically to
    # a survivor that applied it live.

    def _index_eval_locked(self, e: Evaluation) -> None:
        self._evals_by_job[(e.namespace, e.job_id)].add(e.id)

    def _index_service_locked(self, sr) -> None:
        self._services_by_alloc[sr.alloc_id].add(sr.id)

    def _index_acl_token_locked(self, token) -> None:
        self._acl_by_secret[token.secret_id] = token

    def _index_alloc_locked(self, a: Allocation) -> None:
        self._allocs_by_job[(a.namespace, a.job_id)].add(a.id)
        self._allocs_by_node[a.node_id].add(a.id)
        self._allocs_by_eval[a.eval_id].add(a.id)
        if a.terminal_status():
            self._live_name_unset(a)
        else:
            self._live_names.setdefault(
                (a.namespace, a.job_id, a.name), set()).add(a.id)

    def _reindex_applied_plan_ids_locked(self) -> None:
        self._applied_plan_ids_set = set(self._applied_plan_ids)

    # ------------------------------------------------------------ allocs

    def _drop_alloc(self, alloc_id: str) -> None:
        a = self._allocs.pop(alloc_id, None)
        if a is None:
            return
        self._allocs_by_job[(a.namespace, a.job_id)].discard(alloc_id)
        self._allocs_by_node[a.node_id].discard(alloc_id)
        self._allocs_by_eval[a.eval_id].discard(alloc_id)
        self._live_name_unset(a)
        if not a.terminal_status():
            self._quota_usage_add(a.namespace, alloc_quota_usage(a), -1)
        self.matrix.remove_alloc(alloc_id)

    def _insert_alloc(self, index: int, a: Allocation) -> None:
        prev = self._allocs.get(a.id)
        if prev is not None:
            a.create_index = prev.create_index
            # client-set fields survive server-side rewrites (reference
            # UpsertAllocs keeps ClientStatus unless explicitly set)
        else:
            a.create_index = index
        if a.job is None:
            a.job = self._jobs.get((a.namespace, a.job_id))
        a.modify_index = index
        self._allocs[a.id] = a
        self._index_alloc_locked(a)
        # quota usage rides the same liveness transition as _live_names:
        # decrement with the PREVIOUS copy's resources (an in-place
        # update may have changed them), increment with the new one
        prior_live = prev is not None and not prev.terminal_status()
        new_live = not a.terminal_status()
        if prior_live:
            self._quota_usage_add(prev.namespace, alloc_quota_usage(prev), -1)
        if new_live:
            self._quota_usage_add(a.namespace, alloc_quota_usage(a), +1)
        self.matrix.upsert_alloc(a)
        self._update_summary(a, prev)

    def _live_name_unset(self, a: Allocation) -> None:
        key = (a.namespace, a.job_id, a.name)
        ids = self._live_names.get(key)
        if ids is not None:
            ids.discard(a.id)
            if not ids:
                del self._live_names[key]

    def _update_summary(self, a: Allocation, prev: Optional[Allocation]) -> None:
        key = (a.namespace, a.job_id)
        js = self._job_summaries.get(key)
        if js is None:
            js = JobSummary(a.job_id, a.namespace)
            self._job_summaries[key] = js
        g = js.group(a.task_group)

        def bucket(al: Optional[Allocation]) -> Optional[str]:
            if al is None:
                return None
            return {
                AllocClientStatus.PENDING: "starting",
                AllocClientStatus.RUNNING: "running",
                AllocClientStatus.COMPLETE: "complete",
                AllocClientStatus.FAILED: "failed",
                AllocClientStatus.LOST: "lost",
                AllocClientStatus.UNKNOWN: "unknown",
            }.get(al.client_status)

        pb, nb = bucket(prev), bucket(a)
        if pb == nb:
            return
        if pb and g.get(pb, 0) > 0:
            g[pb] -= 1
        if nb:
            g[nb] = g.get(nb, 0) + 1

    def upsert_allocs(self, index: int, allocs: Iterable[Allocation]) -> None:
        out = []
        with self._lock:
            for a in allocs:
                self._insert_alloc(index, a)
                out.append(a)
            self._bump(index)
        for a in out:
            self._notify("allocs", a)

    def update_allocs_from_client(self, index: int, updates: Iterable[Allocation]) -> None:
        """Client status updates merge onto the server copy (reference
        UpdateAllocsFromClient / nomadFSM ApplyAllocClientUpdate)."""
        out = []
        with self._lock:
            for u in updates:
                existing = self._allocs.get(u.id)
                if existing is None:
                    continue
                a = existing.copy()
                a.client_status = u.client_status
                a.client_description = u.client_description
                a.task_states = dict(u.task_states)
                if u.deployment_status is not None:
                    a.deployment_status = u.deployment_status
                a.modify_index = index
                self._insert_alloc(index, a)
                out.append(a)
            self._bump(index)
        for a in out:
            self._notify("allocs", a)

    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        with self._lock:
            return self._allocs.get(alloc_id)

    def allocs_by_job(self, namespace: str, job_id: str) -> List[Allocation]:
        with self._lock:
            return [self._allocs[i]
                    for i in self._allocs_by_job.get((namespace, job_id), ())]

    def allocs_by_node(self, node_id: str) -> List[Allocation]:
        with self._lock:
            return [self._allocs[i] for i in self._allocs_by_node.get(node_id, ())]

    def allocs_by_eval(self, eval_id: str) -> List[Allocation]:
        with self._lock:
            return [self._allocs[i] for i in self._allocs_by_eval.get(eval_id, ())]

    # ------------------------------------------------------------ deployments

    def upsert_deployment(self, index: int, d: Deployment) -> None:
        # timestamps stamped at propose time (core/deployments.py) and
        # carried in the log payload; no clock reads under fsm.apply
        with self._lock:
            if d.id not in self._deployments:
                d.create_index = index
            if not d.modify_time:
                d.modify_time = d.create_time
            d.modify_index = index
            self._deployments[d.id] = d
            self._bump(index)
        self._notify("deployments", d)

    def delete_deployment(self, index: int, deployment_id: str) -> None:
        with self._lock:
            self._deployments.pop(deployment_id, None)
            self._bump(index)

    def deployment_by_id(self, deployment_id: str) -> Optional[Deployment]:
        with self._lock:
            return self._deployments.get(deployment_id)

    def deployments(self) -> List[Deployment]:
        with self._lock:
            return list(self._deployments.values())

    def latest_deployment_by_job_id(self, namespace: str,
                                    job_id: str) -> Optional[Deployment]:
        with self._lock:
            best = None
            for d in self._deployments.values():
                if d.namespace == namespace and d.job_id == job_id:
                    if best is None or d.create_index > best.create_index:
                        best = d
            return best

    # ------------------------------------------------------------ config

    def set_scheduler_config(self, index: int, cfg: SchedulerConfiguration) -> None:
        with self._lock:
            cfg.modify_index = index
            self.scheduler_config = cfg
            self._bump(index)

    # ------------------------------------------------------------ namespaces

    def upsert_namespace(self, index: int, name: str, description: str = "",
                         quota: str = "") -> None:
        with self._lock:
            existing = self._namespaces.get(name)
            ns = Namespace(name=name, description=description, quota=quota)
            ns.create_index = existing.create_index if existing else index
            ns.modify_index = index
            self._namespaces[name] = ns
            self._bump(index)

    def delete_namespace(self, index: int, name: str) -> None:
        with self._lock:
            if name == "default":
                raise ValueError("default namespace cannot be deleted")
            for ns, _ in self._jobs:
                if ns == name:
                    raise ValueError(f"namespace {name!r} has jobs")
            self._namespaces.pop(name, None)
            self._bump(index)

    def namespaces(self) -> List[Namespace]:
        with self._lock:
            return list(self._namespaces.values())

    def namespace(self, name: str) -> Optional[Namespace]:
        with self._lock:
            return self._namespaces.get(name)

    # ------------------------------------------------------------ quotas

    def _quota_usage_add(self, namespace: str, vec: Dict[str, int],
                         sign: int) -> None:
        """Canonical-form usage accounting: an entry is either absent or
        a full {cpu, memory_mb, devices, allocs} dict, created with a
        fixed key order, deleted when it returns to all-zero — so the
        table is byte-identical across replicas that applied the same
        log, independent of the path taken."""
        u = self._quota_usage.get(namespace)
        if u is None:
            u = self._quota_usage[namespace] = {
                "cpu": 0, "memory_mb": 0, "devices": 0, "allocs": 0}
        usage_add(u, vec, sign)
        if not any(u.values()):
            del self._quota_usage[namespace]

    def _quota_admits_locked(self, a: Allocation) -> Tuple[bool, str]:
        """Would placing `a` keep its namespace inside its quota?
        Returns (admitted, quota_spec_name)."""
        ns = self._namespaces.get(a.namespace)
        if ns is None or not ns.quota:
            return True, ""
        spec = self._quota_specs.get(ns.quota)
        if spec is None:
            return True, ""
        would = dict(self._quota_usage.get(a.namespace) or {})
        usage_add(would, alloc_quota_usage(a), +1)
        return spec.admits(would), ns.quota

    def upsert_quota_spec(self, index: int, spec: QuotaSpec) -> None:
        with self._lock:
            existing = self._quota_specs.get(spec.name)
            spec.create_index = existing.create_index if existing else index
            spec.modify_index = index
            self._quota_specs[spec.name] = spec
            self._bump(index)

    def delete_quota_spec(self, index: int, name: str) -> None:
        with self._lock:
            for ns in self._namespaces.values():
                if ns.quota == name:
                    raise ValueError(
                        f"quota {name!r} referenced by namespace {ns.name!r}")
            self._quota_specs.pop(name, None)
            self._bump(index)

    def quota_spec(self, name: str) -> Optional[QuotaSpec]:
        with self._lock:
            return self._quota_specs.get(name)

    def quota_specs(self) -> List[QuotaSpec]:
        with self._lock:
            return list(self._quota_specs.values())

    def quota_usage(self, namespace: str) -> Dict[str, int]:
        with self._lock:
            return dict(self._quota_usage.get(namespace) or {})

    def quota_usages(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {ns: dict(u) for ns, u in self._quota_usage.items()}

    # ------------------------------------------------------------ ACL

    def upsert_acl_policy(self, index: int, policy) -> None:
        with self._lock:
            self._acl_policies[policy.name] = policy
            self._bump(index)

    def delete_acl_policy(self, index: int, name: str) -> None:
        with self._lock:
            self._acl_policies.pop(name, None)
            self._bump(index)

    def acl_policy(self, name: str):
        with self._lock:
            return self._acl_policies.get(name)

    def acl_policies(self) -> list:
        with self._lock:
            return list(self._acl_policies.values())

    def upsert_acl_token(self, index: int, token) -> None:
        with self._lock:
            token.modify_index = index
            if not token.create_index:
                token.create_index = index
            self._acl_tokens[token.accessor_id] = token
            self._index_acl_token_locked(token)
            self._bump(index)

    def delete_acl_token(self, index: int, accessor_id: str) -> None:
        with self._lock:
            t = self._acl_tokens.pop(accessor_id, None)
            if t is not None:
                self._acl_by_secret.pop(t.secret_id, None)
            self._bump(index)

    def acl_token(self, accessor_id: str):
        with self._lock:
            return self._acl_tokens.get(accessor_id)

    def acl_token_by_secret(self, secret_id: str):
        with self._lock:
            return self._acl_by_secret.get(secret_id)

    def acl_tokens(self) -> list:
        with self._lock:
            return list(self._acl_tokens.values())

    # ------------------------------------------------------------ plan results

    # ------------------------------------------------------------- CSI

    def upsert_csi_volume(self, index: int, vol) -> None:
        with self._lock:
            key = (vol.namespace, vol.id)
            existing = self._csi_volumes.get(key)
            if existing is None:
                vol.create_index = index
            elif existing.in_use():
                # re-registering an in-use volume must not drop its live
                # claims (the reference register path preserves claims;
                # losing them would admit a second writer immediately)
                vol.read_claims = existing.read_claims
                vol.write_claims = existing.write_claims
                vol.past_claims = existing.past_claims
                vol.access_mode = existing.access_mode or vol.access_mode
                vol.create_index = existing.create_index
            vol.modify_index = index
            self._csi_volumes[key] = vol
            self._refresh_volume_health(vol)
            self._bump(index)
        self._notify("csi_volumes", vol)

    def deregister_csi_volume(self, index: int, namespace: str,
                              vol_id: str, force: bool = False) -> None:
        with self._lock:
            vol = self._csi_volumes.get((namespace, vol_id))
            if vol is None:
                raise KeyError(f"volume {vol_id} not found")
            if vol.in_use() and not force:
                raise ValueError(f"volume {vol_id} in use")
            del self._csi_volumes[(namespace, vol_id)]
            self._bump(index)
        self._notify("csi_volumes", vol)

    def csi_volume_by_id(self, namespace: str, vol_id: str):
        with self._lock:
            vol = self._csi_volumes.get((namespace, vol_id))
            if vol is not None:
                self._refresh_volume_health(vol)
            return vol

    def csi_volumes(self, namespace: Optional[str] = None) -> List:
        with self._lock:
            vols = [v for (ns, _), v in sorted(self._csi_volumes.items())
                    if namespace in (None, ns)]
            for v in vols:
                self._refresh_volume_health(v)
            return vols

    def csi_volumes_by_plugin(self, plugin_id: str) -> List:
        with self._lock:
            return [v for v in self._csi_volumes.values()
                    if v.plugin_id == plugin_id]

    def csi_plugin_by_id(self, plugin_id: str):
        with self._lock:
            return self._csi_plugins.get(plugin_id)

    def csi_plugins(self) -> List:
        with self._lock:
            return [self._csi_plugins[k]
                    for k in sorted(self._csi_plugins)]

    def csi_volume_claim(self, index: int, namespace: str, vol_id: str,
                         claim) -> None:
        """Take or release a claim (reference CSIVolumeClaim FSM apply).
        A claim whose state is past 'taken' is a release step; fully
        released claims leave the claim maps."""
        from nomad_tpu_torch.structs import csi as csistructs
        with self._lock:
            vol = self._csi_volumes.get((namespace, vol_id))
            if vol is None:
                raise KeyError(f"volume {vol_id} not found")
            if claim.state == csistructs.CLAIM_STATE_TAKEN:
                vol.claim(claim)
            else:
                vol.release(claim.alloc_id)
            vol.modify_index = index
            self._bump(index)
        self._notify("csi_volumes", vol)

    def csi_volume_counts_by_node(self) -> Dict[str, Dict[str, int]]:
        """node_id -> {plugin id -> live-claim volume count}, one pass
        over the volumes table (dense-checker bulk variant of
        node_csi_volume_count)."""
        counts: Dict[str, Dict[str, int]] = {}
        with self._lock:
            for vol in self._csi_volumes.values():
                nodes = {c.node_id
                         for c in list(vol.read_claims.values()) +
                         list(vol.write_claims.values())}
                for nid in nodes:
                    per = counts.setdefault(nid, {})
                    per[vol.plugin_id] = per.get(vol.plugin_id, 0) + 1
        return counts

    def _refresh_volume_health(self, vol) -> None:
        """Denormalize plugin health onto the volume (reference
        CSIVolumeDenormalizePlugins): schedulable tracks node-plugin
        health, plus controller health when controllers are required."""
        plug = self._csi_plugins.get(vol.plugin_id)
        if plug is None:
            vol.schedulable = False
            vol.nodes_healthy = 0
            vol.controllers_healthy = 0
            return
        vol.nodes_healthy = plug.nodes_healthy
        vol.nodes_expected = len(plug.nodes)
        vol.controllers_healthy = plug.controllers_healthy
        vol.controllers_expected = len(plug.controllers)
        vol.controller_required = plug.controller_required
        ok = vol.nodes_healthy > 0
        if plug.controller_required:
            ok = ok and vol.controllers_healthy > 0
        vol.schedulable = ok

    def _take_csi_claims_for_alloc(self, index: int, alloc) -> None:
        """Claims for a placed allocation's CSI volume requests (the
        reference claims from the client csi_hook via the
        CSIVolume.Claim RPC; here the commit path takes them so the
        scheduler's view is updated atomically with the plan)."""
        from nomad_tpu_torch.structs import csi as csistructs
        job = alloc.job
        if job is None:
            return
        tg = next((t for t in job.task_groups
                   if t.name == alloc.task_group), None)
        if tg is None:
            return
        for req in tg.volumes.values():
            if req.type != "csi":
                continue
            vol = self._csi_volumes.get((job.namespace, req.source))
            if vol is None:
                continue
            mode = csistructs.CLAIM_READ if req.read_only \
                else csistructs.CLAIM_WRITE
            vol.claim(csistructs.CSIVolumeClaim(
                alloc_id=alloc.id, node_id=alloc.node_id, mode=mode,
                state=csistructs.CLAIM_STATE_TAKEN))
            vol.modify_index = index

    def _upsert_plan_result_locked(self, index: int,
                                   result: "AppliedPlanResults",
                                   touched: list) -> None:
        """One plan's writes; caller holds self._lock and notifies for
        `touched` after releasing it."""
        plan_id = getattr(result, "plan_id", "")  # pre-dedup pickles lack it
        if plan_id:
            if plan_id in self._applied_plan_ids_set:
                return
            self._applied_plan_ids.append(plan_id)
            self._applied_plan_ids_set.add(plan_id)
            if len(self._applied_plan_ids) > self._applied_plan_ids_cap:
                evicted = self._applied_plan_ids.pop(0)
                self._applied_plan_ids_set.discard(evicted)
        for a in result.alloc_updates:      # stops/evicts
            existing = self._allocs.get(a.id)
            if existing is not None and a.job is None:
                a.job = existing.job
            self._insert_alloc(index, a)
            touched.append(a)
        dropped = set()                     # placements this apply drops
        for a in result.allocs_to_place:    # placements
            # live-name guard: racing plans for one redelivered eval can
            # both pass the submit-time token gate (the lease expires
            # after the first enqueue but before its commit), and the
            # loser would duplicate a name the winner already placed.
            # Every legitimate same-name placement stops its predecessor
            # in the same plan (alloc_updates apply above) or replaces a
            # terminal alloc, so a live holder here is always a racer.
            # Updates of existing allocs (same id) always apply.  System
            # and sysbatch allocs all share one name by design (one per
            # node), so their duplicates are scoped to the node.
            if a.id not in self._allocs:
                holders = self._live_names.get(
                    (a.namespace, a.job_id, a.name))
                if holders:
                    per_node = a.job is not None and \
                        a.job.type in ("system", "sysbatch")
                    if not per_node:
                        dropped.add(a.id)
                        continue
                    if any(o is not None and o.node_id == a.node_id
                           for o in (self._allocs.get(i)
                                     for i in holders)):
                        dropped.add(a.id)
                        continue
                # quota guard: the authoritative, replica-deterministic
                # admission check.  The applier already checked at propose
                # time against its overlay, but two leaders across a churn
                # window can each propose within-budget plans that only
                # overflow combined — the log serializes them and the
                # SECOND one is dropped here, identically on every
                # replica.  Stops in this same plan applied above
                # (alloc_updates), so same-plan frees are counted.
                admitted, quota_name = self._quota_admits_locked(a)
                if not admitted:
                    # pre-quota pickles lack the attr; drop silently then
                    getattr(result, "quota_dropped", []).append(
                        (a.id, quota_name))
                    dropped.add(a.id)
                    continue
            self._insert_alloc(index, a)
            self._take_csi_claims_for_alloc(index, a)
            touched.append(a)
        for a in result.allocs_preempted:
            # a victim is evicted only with the placement that preempts
            # it, as the applier drops a rejected node's preemptions: a
            # racer's or an over-quota placement dropped above keeps its
            # victims running.  The JAX package evicts them (ROADMAP.md
            # queue C).
            if a.preempted_by_allocation in dropped:
                continue
            existing = self._allocs.get(a.id)
            if existing is not None and a.job is None:
                a.job = existing.job
            self._insert_alloc(index, a)
            touched.append(a)
        if result.deployment is not None:
            d = result.deployment
            # one deployment per job version: concurrent/redelivered evals
            # for the same registration can both carry a fresh deployment
            # (each planned against a snapshot that predates the other's
            # commit).  The first to apply wins; the loser's placements
            # join it, instead of stranding a duplicate RUNNING deployment
            # no allocs will ever report health for.
            winner = None
            if d.id not in self._deployments:
                for other in self._deployments.values():
                    if (other.id != d.id
                            and other.namespace == d.namespace
                            and other.job_id == d.job_id
                            and other.job_version == d.job_version
                            and other.job_create_index == d.job_create_index
                            and other.status not in (DeploymentStatus.FAILED,
                                                     DeploymentStatus.CANCELLED)):
                        winner = other
                        break
            if winner is not None:
                for a in (result.allocs_to_place + result.alloc_updates):
                    if a.deployment_id == d.id:
                        a.deployment_id = winner.id
            else:
                if d.id not in self._deployments:
                    d.create_index = index
                d.modify_index = index
                self._deployments[d.id] = d
        for upd in result.deployment_updates:
            d = self._deployments.get(upd["deployment_id"])
            if d is not None:
                d = d.copy()
                d.status = upd["status"]
                d.status_description = upd.get("description", "")
                d.modify_index = index
                self._deployments[d.id] = d

    def upsert_plan_results(self, index: int, result: "AppliedPlanResults") -> None:
        """Apply a committed plan (reference UpsertPlanResults,
        state_store.go:337): denormalize stopped/preempted allocs, insert
        placements, attach deployment updates."""
        touched: list = []
        with self._lock:
            self._upsert_plan_result_locked(index, result, touched)
            self._bump(index)
        for a in touched:
            self._notify("allocs", a)

    def upsert_plan_results_many(self, index: int,
                                 results) -> None:
        """Apply a coalesced batch of committed plans under ONE lock
        acquisition and ONE index bump — the applier's batch commit.
        Plans in a batch touch disjoint alloc ids (each scheduler eval
        owns its placements), so sharing an index is safe: upserts are
        keyed by alloc id and create_index is preserved on update."""
        touched: list = []
        with self._lock:
            for result in results:
                self._upsert_plan_result_locked(index, result, touched)
            self._bump(index)
        for a in touched:
            self._notify("allocs", a)


class AppliedPlanResults:
    """The payload of the ApplyPlanResults Raft message."""

    def __init__(self, alloc_updates=None, allocs_to_place=None,
                 allocs_preempted=None, deployment=None, deployment_updates=None,
                 eval_id: str = "", plan_id: str = ""):
        self.alloc_updates = alloc_updates or []
        self.allocs_to_place = allocs_to_place or []
        self.allocs_preempted = allocs_preempted or []
        self.deployment = deployment
        self.deployment_updates = deployment_updates or []
        self.eval_id = eval_id
        self.plan_id = plan_id
        # filled by the FSM when the authoritative quota check drops a
        # placement: [(alloc_id, quota_spec_name)]
        self.quota_dropped: list = []


def _shallow_copy_node(node: Node) -> Node:
    import copy as _copy
    return _copy.copy(node)
