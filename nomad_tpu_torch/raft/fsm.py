"""Replicated state machine (reference: nomad/fsm.go).

`NomadFSM.apply` is the message-type switch (`nomadFSM.Apply`
nomad/fsm.go:211-313) mapping log entries onto StateStore writes at the
entry's index; it handles every message type of `MessageType`.
`snapshot`/`restore` persist the full store (`nomadFSM.Snapshot/Restore`,
same file): the dev-mode server's operator snapshot save and restore
(core/server.py) go through them.

Leader-side hooks: when an eval lands in the store on the leader, it is
handed to the EvalBroker / BlockedEvals trackers (the reference FSM holds
the broker and enqueues when leadership is established — fsm.go eval
apply + leader.go:572 restore path).
"""
from __future__ import annotations

import copy
import pickle
from collections import defaultdict

from nomad_tpu_torch.encode import ClusterMatrix
from nomad_tpu_torch.state.store import StateStore
from nomad_tpu_torch.structs.namespace import Namespace


class MessageType:
    """Log entry types (reference: structs.MessageType constants,
    nomad/structs/structs.go:87-150)."""
    NODE_REGISTER = "NodeRegisterRequest"
    NODE_DEREGISTER = "NodeDeregisterRequest"
    NODE_UPDATE_STATUS = "NodeUpdateStatusRequest"
    NODE_HEARTBEAT_BATCH = "NodeHeartbeatBatchRequest"
    NODE_FINGERPRINT_BATCH = "NodeFingerprintBatchRequest"
    NODE_UPDATE_DRAIN = "NodeUpdateDrainRequest"
    NODE_UPDATE_ELIGIBILITY = "NodeUpdateEligibilityRequest"
    JOB_REGISTER = "JobRegisterRequest"
    JOB_DEREGISTER = "JobDeregisterRequest"
    JOB_STABILITY = "JobStabilityRequest"
    EVAL_UPDATE = "EvalUpdateRequest"
    EVAL_DELETE = "EvalDeleteRequest"
    ALLOC_UPDATE = "AllocUpdateRequest"
    ALLOC_CLIENT_UPDATE = "AllocClientUpdateRequest"
    ALLOC_UPDATE_DESIRED_TRANSITION = "AllocUpdateDesiredTransitionRequest"
    APPLY_PLAN_RESULTS = "ApplyPlanResultsRequest"
    DEPLOYMENT_UPSERT = "DeploymentUpsertRequest"
    DEPLOYMENT_DELETE = "DeploymentDeleteRequest"
    SCHEDULER_CONFIG = "SchedulerConfigRequest"
    NAMESPACE_UPSERT = "NamespaceUpsertRequest"
    NAMESPACE_DELETE = "NamespaceDeleteRequest"
    QUOTA_SPEC_UPSERT = "QuotaSpecUpsertRequest"
    QUOTA_SPEC_DELETE = "QuotaSpecDeleteRequest"
    CSI_VOLUME_REGISTER = "CSIVolumeRegisterRequest"
    CSI_VOLUME_DEREGISTER = "CSIVolumeDeregisterRequest"
    CSI_VOLUME_CLAIM = "CSIVolumeClaimRequest"
    ACL_POLICY_UPSERT = "ACLPolicyUpsertRequest"
    ACL_POLICY_DELETE = "ACLPolicyDeleteRequest"
    ACL_TOKEN_UPSERT = "ACLTokenUpsertRequest"
    ACL_TOKEN_DELETE = "ACLTokenDeleteRequest"
    SCALING_EVENT = "ScalingEventRequest"
    SERVICE_REGISTER = "ServiceRegistrationUpsertRequest"
    SERVICE_DEREGISTER = "ServiceRegistrationDeleteRequest"
    NOOP = "Noop"                  # leadership-establishment barrier entry
    STATE_CHECKPOINT = "StateCheckpointRequest"  # integrity digest stamp


# Snapshot tables each message type may touch (the reference's map, as
# data): the raft integrity plane's incremental digests recompute only
# the tables an entry dirtied.  Entries are SUPERSETS of what the
# handlers' store calls mutate.  The integrity plane that reads this map
# is not ported yet.
_APPLY_TOUCHES = {
    MessageType.NODE_REGISTER: ("nodes", "csi_plugins"),
    MessageType.NODE_DEREGISTER: ("nodes", "csi_plugins"),
    MessageType.NODE_UPDATE_STATUS: ("nodes",),
    MessageType.NODE_HEARTBEAT_BATCH: ("nodes",),
    MessageType.NODE_FINGERPRINT_BATCH: ("nodes",),
    MessageType.NODE_UPDATE_DRAIN: ("nodes",),
    MessageType.NODE_UPDATE_ELIGIBILITY: ("nodes",),
    MessageType.JOB_REGISTER:
        ("jobs", "job_versions", "job_summaries", "namespaces"),
    MessageType.JOB_DEREGISTER:
        ("jobs", "job_versions", "job_summaries", "scaling_events",
         "deployments", "evals", "allocs", "services", "quota_usage"),
    MessageType.JOB_STABILITY: ("jobs", "job_versions"),
    MessageType.EVAL_UPDATE: ("evals",),
    MessageType.EVAL_DELETE:
        ("evals", "allocs", "job_summaries", "quota_usage", "services"),
    MessageType.ALLOC_UPDATE:
        ("allocs", "job_summaries", "quota_usage", "services",
         "deployments"),
    MessageType.ALLOC_CLIENT_UPDATE:
        ("allocs", "job_summaries", "quota_usage", "services",
         "deployments"),
    MessageType.ALLOC_UPDATE_DESIRED_TRANSITION:
        ("allocs", "job_summaries", "quota_usage", "services",
         "deployments", "evals"),
    MessageType.APPLY_PLAN_RESULTS:
        ("allocs", "evals", "deployments", "job_summaries", "quota_usage",
         "applied_plan_ids", "services"),
    MessageType.DEPLOYMENT_UPSERT:
        ("deployments", "jobs", "job_versions", "allocs", "evals",
         "job_summaries"),
    MessageType.DEPLOYMENT_DELETE: ("deployments",),
    MessageType.SCHEDULER_CONFIG: ("scheduler_config",),
    MessageType.NAMESPACE_UPSERT: ("namespaces",),
    MessageType.NAMESPACE_DELETE: ("namespaces",),
    MessageType.QUOTA_SPEC_UPSERT: ("quota_specs", "quota_usage"),
    MessageType.QUOTA_SPEC_DELETE: ("quota_specs", "quota_usage"),
    MessageType.CSI_VOLUME_REGISTER: ("csi_volumes", "csi_plugins"),
    MessageType.CSI_VOLUME_DEREGISTER: ("csi_volumes", "csi_plugins"),
    MessageType.CSI_VOLUME_CLAIM: ("csi_volumes", "csi_plugins"),
    MessageType.ACL_POLICY_UPSERT: ("acl_policies",),
    MessageType.ACL_POLICY_DELETE: ("acl_policies",),
    MessageType.ACL_TOKEN_UPSERT: ("acl_tokens",),
    MessageType.ACL_TOKEN_DELETE: ("acl_tokens",),
    MessageType.SCALING_EVENT: ("scaling_events",),
    MessageType.SERVICE_REGISTER: ("services",),
    MessageType.SERVICE_DEREGISTER: ("services",),
    MessageType.NOOP: (),
    MessageType.STATE_CHECKPOINT: (),
}


class NomadFSM:
    """Applies committed log entries to a StateStore.

    `hooks` is the owning Server (or None): after an EVAL_UPDATE commit on
    the leader, pending evals are enqueued in the broker and blocked evals
    registered with the BlockedEvals tracker.
    """

    def __init__(self, store: StateStore, hooks=None):
        self.store = store
        self.hooks = hooks
        self._dispatch = {
            MessageType.NODE_REGISTER: self._apply_node_register,
            MessageType.NODE_DEREGISTER: self._apply_node_deregister,
            MessageType.NODE_UPDATE_STATUS: self._apply_node_update_status,
            MessageType.NODE_HEARTBEAT_BATCH:
                self._apply_node_heartbeat_batch,
            MessageType.NODE_FINGERPRINT_BATCH:
                self._apply_node_fingerprint_batch,
            MessageType.NODE_UPDATE_DRAIN: self._apply_node_update_drain,
            MessageType.NODE_UPDATE_ELIGIBILITY: self._apply_node_eligibility,
            MessageType.JOB_REGISTER: self._apply_job_register,
            MessageType.JOB_DEREGISTER: self._apply_job_deregister,
            MessageType.JOB_STABILITY: self._apply_job_stability,
            MessageType.EVAL_UPDATE: self._apply_eval_update,
            MessageType.EVAL_DELETE: self._apply_eval_delete,
            MessageType.ALLOC_UPDATE: self._apply_alloc_update,
            MessageType.ALLOC_CLIENT_UPDATE: self._apply_alloc_client_update,
            MessageType.ALLOC_UPDATE_DESIRED_TRANSITION:
                self._apply_alloc_desired_transition,
            MessageType.APPLY_PLAN_RESULTS: self._apply_plan_results,
            MessageType.DEPLOYMENT_UPSERT: self._apply_deployment_upsert,
            MessageType.DEPLOYMENT_DELETE: self._apply_deployment_delete,
            MessageType.SCHEDULER_CONFIG: self._apply_scheduler_config,
            MessageType.CSI_VOLUME_REGISTER: self._apply_csi_volume_register,
            MessageType.CSI_VOLUME_DEREGISTER: self._apply_csi_volume_deregister,
            MessageType.CSI_VOLUME_CLAIM: self._apply_csi_volume_claim,
            MessageType.NAMESPACE_UPSERT: self._apply_namespace_upsert,
            MessageType.NAMESPACE_DELETE: self._apply_namespace_delete,
            MessageType.QUOTA_SPEC_UPSERT: self._apply_quota_spec_upsert,
            MessageType.QUOTA_SPEC_DELETE: self._apply_quota_spec_delete,
            MessageType.ACL_POLICY_UPSERT: self._apply_acl_policy_upsert,
            MessageType.ACL_POLICY_DELETE: self._apply_acl_policy_delete,
            MessageType.ACL_TOKEN_UPSERT: self._apply_acl_token_upsert,
            MessageType.ACL_TOKEN_DELETE: self._apply_acl_token_delete,
            MessageType.SCALING_EVENT: self._apply_scaling_event,
            MessageType.SERVICE_REGISTER: self._apply_service_register,
            MessageType.SERVICE_DEREGISTER: self._apply_service_deregister,
            MessageType.NOOP: lambda index, p: None,
            # integrity checkpoints are deterministic no-ops in the FSM:
            # the digest walk happens outside the replicated-write cone,
            # and the entry is stamped at propose time so the FSM never
            # reads the clock
            MessageType.STATE_CHECKPOINT: lambda index, p: None,
        }

    def _leader_hooks(self):
        hooks = self.hooks
        if hooks is not None and getattr(hooks, "leader", False):
            return hooks
        return None

    # ------------------------------------------------------------- apply

    def apply(self, index: int, msg_type: str, payload: dict) -> None:
        fn = self._dispatch.get(msg_type)
        if fn is None:
            raise ValueError(f"unknown FSM message type {msg_type!r}")
        fn(index, payload)

    # --- nodes

    def _apply_node_register(self, index, p):
        # copy at the consensus boundary: dev mode shares objects with
        # the caller, and a caller later mutating its Node must not
        # bypass the FSM (the aliasing would desync the dense matrix
        # from the store)
        self.store.upsert_node(index, copy.deepcopy(p["node"]))
        hooks = self._leader_hooks()
        heartbeats = getattr(hooks, "heartbeats", None)
        if heartbeats is not None:
            # TTL timers live on the leader (nomad/heartbeat.go:56)
            heartbeats.heartbeat(p["node"].id)

    def _apply_node_deregister(self, index, p):
        self.store.delete_node(index, p["node_id"])

    def _apply_node_update_status(self, index, p):
        self.store.update_node_status(
            index, p["node_id"], p["status"], p.get("updated_at", 0.0))

    def _apply_node_heartbeat_batch(self, index, p):
        # the heartbeat coalescer flushes one entry per tick: revivals,
        # expiries and liveness stamps for a whole fleet batch land in a
        # single store write (updated_at was stamped at propose time —
        # the FSM never reads the clock)
        self.store.update_node_statuses_many(index, p["updates"])

    def _apply_node_fingerprint_batch(self, index, p):
        # device/attribute re-fingerprint deltas, one entry per flush
        # tick for a whole fleet (stamped at propose time)
        self.store.update_node_fingerprints_many(index, p["updates"])

    def _apply_node_update_drain(self, index, p):
        self.store.update_node_drain(
            index, p["node_id"], p.get("drain_strategy"),
            p.get("mark_eligible", False))

    def _apply_node_eligibility(self, index, p):
        self.store.update_node_eligibility(
            index, p["node_id"], p["eligibility"])

    # --- jobs

    def _apply_job_register(self, index, p):
        self.store.upsert_job(index, p["job"])

    def _apply_job_deregister(self, index, p):
        if p.get("purge"):
            self.store.delete_job(index, p["namespace"], p["job_id"])
        else:
            job = self.store.job_by_id(p["namespace"], p["job_id"])
            if job is not None:
                stopped = job.copy()
                stopped.stop = True
                self.store.upsert_job(index, stopped)

    def _apply_job_stability(self, index, p):
        self.store.mark_job_stability(
            index, p["namespace"], p["job_id"], p["version"], p["stable"])

    # --- evals

    def _apply_eval_update(self, index, p):
        evals = p["evals"]
        self.store.upsert_evals(index, evals)
        hooks = self._leader_hooks()
        if hooks is not None:
            for ev in evals:
                if ev.should_enqueue():
                    hooks.broker.enqueue(ev.copy())
                elif ev.should_block():
                    hooks.blocked_evals.block(ev.copy())

    def _apply_eval_delete(self, index, p):
        self.store.delete_eval(index, p["eval_ids"], p.get("alloc_ids", ()))

    # --- allocs

    def _apply_alloc_update(self, index, p):
        self.store.upsert_allocs(index, p["allocs"])

    def _apply_alloc_client_update(self, index, p):
        self.store.update_allocs_from_client(index, p["allocs"])

    def _apply_alloc_desired_transition(self, index, p):
        # reference AllocUpdateDesiredTransitionRequest carries Evals so
        # the transition and its follow-up eval commit atomically
        self.store.upsert_allocs(index, p["allocs"])
        evals = p.get("evals")
        if evals:
            self._apply_eval_update(index, {"evals": evals})

    # --- plans / deployments / config

    def _apply_plan_results(self, index, p):
        # the applier coalesces adjacent plans into one log entry: a
        # list payload commits the whole batch in one store write
        results = p["results"]
        if isinstance(results, list):
            self.store.upsert_plan_results_many(index, results)
        else:
            self.store.upsert_plan_results(index, results)

    def _apply_deployment_upsert(self, index, p):
        self.store.upsert_deployment(index, p["deployment"])

    def _apply_deployment_delete(self, index, p):
        self.store.delete_deployment(index, p["deployment_id"])

    def _apply_scheduler_config(self, index, p):
        self.store.set_scheduler_config(index, p["config"])
        # the broker's fair-dequeue knobs are live-tunable: push the
        # replicated config into the leader's broker on apply
        hooks = self._leader_hooks()
        if hooks is not None:
            hooks.broker.set_fair_config(p["config"])

    # --- CSI volumes

    def _apply_csi_volume_register(self, index, p):
        self.store.upsert_csi_volume(index, p["volume"])

    def _apply_csi_volume_deregister(self, index, p):
        self.store.deregister_csi_volume(
            index, p["namespace"], p["volume_id"], p.get("force", False))

    def _apply_csi_volume_claim(self, index, p):
        self.store.csi_volume_claim(
            index, p["namespace"], p["volume_id"], p["claim"])

    # --- namespaces / quotas / ACL

    def _apply_namespace_upsert(self, index, p):
        prev = self.store.namespace(p["name"])
        self.store.upsert_namespace(index, p["name"],
                                    p.get("description", ""),
                                    p.get("quota", ""))
        # re-pointing a namespace at a different (or no) quota spec can
        # free evals blocked on the OLD spec; one-shot unblock on the
        # leader, mirroring the class-eligibility unblock path
        hooks = self._leader_hooks()
        if hooks is not None:
            old_quota = getattr(prev, "quota", "") if prev else ""
            if old_quota and old_quota != p.get("quota", ""):
                hooks.blocked_evals.unblock_quota(old_quota, index)

    def _apply_namespace_delete(self, index, p):
        self.store.delete_namespace(index, p["name"])

    def _apply_quota_spec_upsert(self, index, p):
        self.store.upsert_quota_spec(index, p["spec"])
        # a raised quota must rescue evals blocked on it (quota-keyed
        # one-shot unblock on the leader)
        hooks = self._leader_hooks()
        if hooks is not None:
            hooks.blocked_evals.unblock_quota(p["spec"].name, index)

    def _apply_quota_spec_delete(self, index, p):
        self.store.delete_quota_spec(index, p["name"])

    def _apply_acl_policy_upsert(self, index, p):
        self.store.upsert_acl_policy(index, p["policy"])

    def _apply_acl_policy_delete(self, index, p):
        self.store.delete_acl_policy(index, p["name"])

    def _apply_acl_token_upsert(self, index, p):
        # replicated one-time-bootstrap invariant: a bootstrap-minted
        # management token is dropped if one already exists, so the check
        # is deterministic across the cluster (reference: ACL bootstrap
        # goes through Raft with a reset index guard)
        if p.get("bootstrap"):
            tok = p["token"]
            if any(t.type == "management"
                   for t in self.store.acl_tokens()
                   if t.accessor_id != tok.accessor_id):
                return
        self.store.upsert_acl_token(index, p["token"])

    def _apply_acl_token_delete(self, index, p):
        self.store.delete_acl_token(index, p["accessor_id"])

    # --- scaling events / services

    def _apply_scaling_event(self, index, p):
        self.store.upsert_scaling_event(
            index, p["namespace"], p["job_id"], p["group"], p["event"])

    def _apply_service_register(self, index, p):
        self.store.upsert_service_registrations(index, p["services"])

    def _apply_service_deregister(self, index, p):
        self.store.delete_service_registrations(
            index, p.get("ids"), alloc_id=p.get("alloc_id"))

    # ------------------------------------------------------------- snapshot

    def snapshot_tables(self) -> dict:
        """The snapshot record dict before pickling (the tables
        state/digest.py digests)."""
        s = self.store
        with s._lock:
            data = {
                "latest_index": s.latest_index,
                "nodes": list(s._nodes.values()),
                "jobs": dict(s._jobs),
                "job_versions": {k: list(v)
                                 for k, v in s._job_versions.items()},
                "evals": list(s._evals.values()),
                "allocs": list(s._allocs.values()),
                "deployments": list(s._deployments.values()),
                "job_summaries": dict(s._job_summaries),
                "scheduler_config": s.scheduler_config,
                "namespaces": dict(s._namespaces),
                "quota_specs": dict(s._quota_specs),
                # usage is restored verbatim (not rebuilt): entry
                # creation ORDER is part of the table's byte-identity,
                # and a rebuild from the alloc list could recreate
                # zeroed-then-repopulated entries out of order
                "quota_usage": {k: dict(v)
                                for k, v in s._quota_usage.items()},
                "acl_policies": dict(s._acl_policies),
                "acl_tokens": list(s._acl_tokens.values()),
                "csi_volumes": dict(s._csi_volumes),
                "csi_plugins": dict(s._csi_plugins),
                "scaling_events": {k: list(v) for k, v in
                                   s._scaling_events.items()},
                "services": list(s._services.values()),
                "applied_plan_ids": list(s._applied_plan_ids),
                # the reference's tables of periphery subsystems; no
                # ported subsystem registers one
                "extra": {},
            }
        return data

    def snapshot(self) -> bytes:
        """Serialize the full store (reference nomadFSM.Snapshot →
        nomadSnapshot.Persist, nomad/fsm.go).

        The tables are pickled, loaded and pickled again, so that a
        restored store snapshots to the same bytes: pickle writes an
        object once and refers back to it by identity, and a live
        store's equal strings (interned literals among them) share
        otherwise than the strings a load makes.  Past one round the
        bytes are a fixed point of load and dump (the reference pickles
        once, so its restored stores snapshot to other bytes)."""
        return pickle.dumps(pickle.loads(pickle.dumps(
            self.snapshot_tables())))

    def restore(self, blob: bytes) -> None:
        """Rebuild the store from a snapshot (reference nomadFSM.Restore).
        The derived indexes are rebuilt through the store's own row
        constructors (those the apply path uses) and the dense
        ClusterMatrix from the nodes and allocs."""
        data = pickle.loads(blob)
        s = self.store
        with s._lock:
            s._nodes = {n.id: n for n in data["nodes"]}
            s._jobs = dict(data["jobs"])
            s._job_versions = defaultdict(list)
            for k, v in data["job_versions"].items():
                s._job_versions[k] = list(v)
            s._evals = {e.id: e for e in data["evals"]}
            s._allocs = {}
            s._allocs_by_job = defaultdict(set)
            s._allocs_by_node = defaultdict(set)
            s._allocs_by_eval = defaultdict(set)
            s._evals_by_job = defaultdict(set)
            for e in data["evals"]:
                s._index_eval_locked(e)
            s._deployments = {d.id: d for d in data["deployments"]}
            s._job_summaries = dict(data["job_summaries"])
            s.scheduler_config = data["scheduler_config"]
            s._namespaces = dict(data["namespaces"])
            if "default" not in s._namespaces:
                s._namespaces["default"] = Namespace(name="default")
            s._quota_specs = dict(data["quota_specs"])
            # usage rows rebuilt with the same literal keys the store's
            # accounting uses, so a restored FSM re-snapshots to the
            # same bytes (pickle memoizes equal strings by identity)
            s._quota_usage = {
                k: {"cpu": v.get("cpu", 0),
                    "memory_mb": v.get("memory_mb", 0),
                    "devices": v.get("devices", 0),
                    "allocs": v.get("allocs", 0)}
                for k, v in data["quota_usage"].items()}
            s._acl_policies = dict(data["acl_policies"])
            s._acl_tokens = {}
            s._acl_by_secret = {}
            for t in data["acl_tokens"]:
                s._acl_tokens[t.accessor_id] = t
                s._index_acl_token_locked(t)
            s._csi_volumes = dict(data["csi_volumes"])
            s._csi_plugins = dict(data["csi_plugins"])
            s._scaling_events = {k: list(v) for k, v in
                                 data["scaling_events"].items()}
            s._services = {}
            s._services_by_alloc = defaultdict(set)
            for sr in data["services"]:
                s._services[sr.id] = sr
                s._index_service_locked(sr)
            s.matrix = ClusterMatrix()
            s.matrix.lock = s._lock
            for n in data["nodes"]:
                s.matrix.upsert_node(n)
            s._live_names = {}
            for a in data["allocs"]:
                s._allocs[a.id] = a
                s._index_alloc_locked(a)
                s.matrix.upsert_alloc(a)
            s._applied_plan_ids = list(data["applied_plan_ids"])
            s._reindex_applied_plan_ids_locked()
            s.latest_index = data["latest_index"]
            s._snapshot_cache = None
            s._index_cv.notify_all()
