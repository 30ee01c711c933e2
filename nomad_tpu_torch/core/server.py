"""Server: the control-plane spine wired together, dev mode.

Reference analog: nomad/server.go + leader.go establishLeadership — state
store, eval broker, blocked evals, plan queue, the serialized plan-apply
loop, N scheduler workers, heartbeats and their batcher, the drainer,
the deployment, volume and periodic watchers, core GC and the event
broker.  Writes apply straight through the NomadFSM under a lock (the
reference's '-dev agent' in-memory Raft); the server is its own leader
from `start` to `stop`, and `stop` joins every thread it started.

The control loops write only from their own threads: the store's watch
callbacks run inside the FSM write, under `_raft_lock`, so a callback
(the event broker, the drainer's and the deployment watcher's
`_on_change`, the volume watcher) only records or wakes, and never
writes back through `apply`.

`save_snapshot`/`restore_snapshot` write and read the FSM's snapshot
(raft/fsm.py) to and from a file, the operator's save and restore.

`device` (default "cuda") is where every scheduler the workers build
runs its kernels, where the placement engine and the preemption kernel
run, and whose engine the plan applier releases tickets on.  Without a
card, `Server()` raises; `device="cpu"` runs the plain PyTorch versions.

Not in this port yet (the constructor raises for the first three):
raft clusters and RPC endpoints (ROADMAP A4), gossip membership,
admission and brownout and the read gate (A5), ACLs (A6), the WAN pool
and federation (A7).
"""
from __future__ import annotations

import logging
import pickle
import threading
import time as _time
from typing import List, Optional

from nomad_tpu_torch import knobs
from nomad_tpu_torch.core.blocked import BlockedEvals
from nomad_tpu_torch.core.broker import FAILED_QUEUE, EvalBroker, EvalWaveFeeder
from nomad_tpu_torch.core.core_gc import CoreScheduler
from nomad_tpu_torch.core.deployments import DeploymentWatcher
from nomad_tpu_torch.core.drainer import NodeDrainer
from nomad_tpu_torch.core.events import EventBroker
from nomad_tpu_torch.core.heartbeat import HeartbeatBatcher, HeartbeatTracker
from nomad_tpu_torch.core.periodic import PeriodicDispatcher
from nomad_tpu_torch.core.plan_apply import PlanApplier
from nomad_tpu_torch.core.plan_queue import PlanQueue, StaleEvalTokenError
from nomad_tpu_torch.core.secrets import SecretsProvider
from nomad_tpu_torch.core.volumes import VolumeWatcher
from nomad_tpu_torch.core.worker import Worker
from nomad_tpu_torch.device import resolve_device
from nomad_tpu_torch.raft import MessageType, NomadFSM
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import (
    Evaluation,
    EvalStatus,
    Job,
    JobType,
    Node,
)
from nomad_tpu_torch.structs.evaluation import EvalTrigger

log = logging.getLogger(__name__)


class ServerConfig:
    def __init__(self, num_schedulers: int = 4,
                 enabled_schedulers: Optional[List[str]] = None,
                 heartbeat_ttl: float = 10.0,
                 heartbeat_batch_interval: float = 0.05,
                 gc_interval: float = 300.0,
                 region: str = "global",
                 failed_eval_followup_delay: float = 60.0):
        self.num_schedulers = num_schedulers
        self.enabled_schedulers = enabled_schedulers or \
            ["service", "batch", "system", "sysbatch"]
        self.heartbeat_ttl = heartbeat_ttl
        # flush cadence of the leader's heartbeat/node-status coalescer
        # (one NodeHeartbeatBatch entry per flush);
        # NOMAD_TPU_HEARTBEAT_BATCH_MS overrides
        self.heartbeat_batch_interval = knobs.get_float(
            "NOMAD_TPU_HEARTBEAT_BATCH_MS",
            default=heartbeat_batch_interval * 1000.0) / 1000.0
        self.gc_interval = gc_interval
        self.region = region
        self.failed_eval_followup_delay = failed_eval_followup_delay


class Server:
    def __init__(self, config: Optional[ServerConfig] = None,
                 name: str = "server-1", device=None,
                 raft_transport=None, membership=None, wan_pool=None):
        for what, arg in (("raft_transport", raft_transport),
                          ("membership", membership),
                          ("wan_pool", wan_pool)):
            if arg is not None:
                raise NotImplementedError(
                    f"nomad_tpu_torch.core.server: {what} is not ported; "
                    f"the port's server runs in dev mode only")
        self.config = config or ServerConfig()
        self.name = name
        self.region = self.config.region
        self.device = resolve_device(device)
        self.store = StateStore()
        self.broker = EvalBroker()
        self.blocked_evals = BlockedEvals(self.broker)
        self.plan_queue = PlanQueue()
        self.applier = PlanApplier(self.store, commit_fn=self._commit_plan,
                                   device=self.device)
        # PreemptionEvals are created by the applier AFTER the FSM apply
        # returns (reference plan_apply.go applyPlan) — creating them from
        # inside the state-change watcher would re-enter the write path
        # under its own lock
        self.applier.on_preempted = self._create_preemption_evals
        self.workers: List[Worker] = []
        # wave-aligned dequeue front of the local workers (set at
        # leadership)
        self.eval_feeder: Optional[EvalWaveFeeder] = None
        self._raft_lock = threading.Lock()     # serializes indexed writes
        self._stop = threading.Event()
        self._leader_stop = threading.Event()
        self._plan_stop = threading.Event()
        self._leader_lock = threading.Lock()
        self._plan_thread: Optional[threading.Thread] = None
        self._threads: List[threading.Thread] = []
        self._engine = None
        self.event_broker = EventBroker()
        self.heartbeats = HeartbeatTracker(self, ttl=self.config.heartbeat_ttl)
        self.heartbeat_batch = HeartbeatBatcher(
            self, interval=self.config.heartbeat_batch_interval)
        self.deployment_watcher = DeploymentWatcher(self)
        self.volume_watcher = VolumeWatcher(self)
        # Vault-shaped secrets (core/secrets.py): leases are leader-local
        # like the reference's external-Vault client state, not raft state
        self.secrets = SecretsProvider()
        self.drainer = NodeDrainer(self)
        self.periodic = PeriodicDispatcher(self)
        self.core_scheduler = CoreScheduler(self)
        self.store.watch(self.blocked_evals.watch_state)
        self.store.watch(self.event_broker.watch_state)
        self.store.watch(self._on_state_change)
        self.leader = False
        self._established = False
        self.fsm = NomadFSM(self.store, hooks=self)

    # ------------------------------------------------------------- writes

    def apply(self, msg_type: str, payload: dict) -> int:
        """The single write path: a (type, payload) log entry applied via
        the FSM (reference raft.Apply → nomadFSM.Apply; in dev mode
        straight into the FSM)."""
        return self.apply_local(msg_type, payload)

    def apply_local(self, msg_type: str, payload: dict) -> int:
        with self._raft_lock:
            index = self.store.latest_index + 1
            self.fsm.apply(index, msg_type, payload)
        return index

    def enqueue_plan(self, plan):
        """Plan-queue enqueue gated on the submitting worker still holding
        its eval lease (reference planner token check, plan_endpoint.go):
        if the lease expired (auto-nack) or moved to another worker, this
        plan is from a superseded scheduling pass and must not commit."""
        if plan.eval_id and plan.eval_token:
            if self.broker.outstanding(plan.eval_id) != plan.eval_token:
                raise StaleEvalTokenError(
                    f"eval {plan.eval_id}: lease expired or reassigned")
        return self.plan_queue.enqueue(plan)

    def _commit_plan(self, applied) -> int:
        """Commit applier output through the FSM write path.  `applied`
        is one AppliedPlanResults or a LIST of them — the applier
        coalesces adjacent plans from the queue into one log entry (one
        apply, one index) and the FSM fans the batch out to the store
        under a single lock acquisition."""
        return self.apply_local(MessageType.APPLY_PLAN_RESULTS,
                                {"results": applied})

    def next_index(self) -> int:
        with self._raft_lock:
            return self.store.latest_index + 1

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        # placements can fail against transient in-flight over-reservation
        # (the engine overlay's double-count window); once the overlay
        # drains, give blocked evals another chance
        from nomad_tpu_torch.parallel.engine import get_engine
        self._engine = get_engine(self.device)
        if self._engine is not None:
            self._engine.on_drain = lambda: self.blocked_evals.unblock_all(
                self.store.latest_index)
        self._establish_leadership()

    def _establish_leadership(self) -> None:
        """establishLeadership (reference nomad/leader.go:277-357), the
        parts this port runs: broker, blocked evals, plan queue and its
        applier loop, the workers behind the wave feeder, the restored
        evals, the two reapers, then the heartbeat batcher and tracker
        (every live node's TTL re-armed), the deployment and volume
        watchers, the drainer, the periodic dispatcher and core GC."""
        with self._leader_lock:
            if self._established:
                return
            self._established = True
            self.leader = True
            self._leader_stop = threading.Event()
            stop = self._leader_stop
            self.broker.set_enabled(True)
            # fairness knobs live in the replicated SchedulerConfiguration;
            # later changes arrive via the FSM's scheduler-config hook
            self.broker.set_fair_config(self.store.scheduler_config)
            self.blocked_evals.set_enabled(True)
            self.plan_queue.set_enabled(True)
            # the applier has its own stop: it keeps applying while the
            # workers settle on revoke, and stops after them
            self._plan_stop = threading.Event()
            self._plan_thread = threading.Thread(
                target=self.applier.run_loop,
                args=(self.plan_queue, self._plan_stop),
                name="plan-apply", daemon=True)
            self._plan_thread.start()
            # the wave feeder aligns the pool's dequeues: one broker lock
            # pass drains a whole ready wave so the engine coalesces
            # full-wave dispatch batches, one eval per worker
            self.eval_feeder = EvalWaveFeeder(self.broker,
                                              self.config.num_schedulers)
            for i in range(self.config.num_schedulers):
                w = Worker(self, i, self.config.enabled_schedulers)
                w.start()
                self.workers.append(w)
            self._restore_evals()
            for target, tname in ((self._failed_eval_reaper, "eval-reaper"),
                                  (self._dup_blocked_reaper,
                                   "dup-blocked-reaper")):
                t = threading.Thread(target=target, args=(stop,),
                                     name=tname, daemon=True)
                t.start()
                self._threads.append(t)
            self.heartbeat_batch.start()
            self.heartbeats.start()
            # initializeHeartbeatTimers (leader.go:347): nodes registered
            # before this tenure (a restored snapshot) get timers, so a
            # node that died meanwhile still expires
            for node in self.store.nodes():
                if not node.terminal_status():
                    self.heartbeats.heartbeat(node.id)
            self.deployment_watcher.start()
            self.volume_watcher.start()
            self.drainer.start()
            self.periodic.start()
            gc_t = threading.Thread(target=self._gc_loop, args=(stop,),
                                    name="core-gc", daemon=True)
            gc_t.start()
            self._threads.append(gc_t)

    def _revoke_leadership(self) -> None:
        """revokeLeadership (reference nomad/leader.go:1099-1132): the
        control loops stop first, the workers settle and exit while the
        applier still runs, then the queues close and every leader
        thread is joined."""
        with self._leader_lock:
            if not self._established:
                return
            self._established = False
            self.leader = False
            self._leader_stop.set()
            self.heartbeats.stop()
            self.heartbeat_batch.stop()
            self.deployment_watcher.stop()
            self.volume_watcher.stop()
            self.drainer.stop()
            self.periodic.stop()
            for w in self.workers:
                w.stop()
            for w in self.workers:
                w.join(60.0)
            self.workers = []
            if self.eval_feeder is not None:
                self.eval_feeder.close()
                self.eval_feeder = None
            self.plan_queue.set_enabled(False)
            self.broker.set_enabled(False)
            self.blocked_evals.set_enabled(False)
            self._plan_stop.set()
            if self._plan_thread:
                self._plan_thread.join(60.0)
                self._plan_thread = None
            for t in self._threads:
                t.join(60.0)
            self._threads = []

    def stop(self) -> None:
        """Stop the leader's threads and this server's placement engine."""
        self._stop.set()
        self._revoke_leadership()
        if self._engine is not None:
            self._engine.on_drain = None
            self._engine.stop()
            self._engine = None

    # ------------------------------------------------------------- snapshots

    def save_snapshot(self, path: str) -> None:
        """Operator snapshot save (reference `nomad operator snapshot save`,
        helper/snapshot/): the FSM's snapshot and the store's index."""
        blob = self.fsm.snapshot()
        with open(path, "wb") as fh:
            pickle.dump({"index": self.store.latest_index,
                         "data": blob}, fh)

    def restore_snapshot(self, path: str) -> None:
        """Operator snapshot restore: replace state wholesale.  The
        reference refuses it on a clustered server (its peers would
        diverge); the port's server runs in dev mode only, so it always
        restores.  Restore before `start()`, whose leadership re-enqueues
        the restored evals."""
        with open(path, "rb") as fh:
            rec = pickle.load(fh)
        self.fsm.restore(rec["data"])

    def _restore_evals(self) -> None:
        """On leadership: re-enqueue non-terminal evals (leader.go:572)."""
        for ev in self.store.evals():
            if ev.should_enqueue():
                self.broker.enqueue(ev.copy())
            elif ev.should_block():
                self.blocked_evals.block(ev.copy())
        # the missed-unblock indexes died with the old leader: give every
        # restored eval one clean re-evaluation; the still infeasible
        # ones re-block with a fresh snapshot_index that this leader's
        # capacity watch covers
        self.blocked_evals.unblock_once(self.store.latest_index)

    def _failed_eval_reaper(self, stop: threading.Event) -> None:
        """Mark dead-lettered evals failed and create follow-ups
        (leader.go:842-884)."""
        while not stop.is_set() and not self._stop.is_set():
            ev, token = self.broker.dequeue([FAILED_QUEUE], timeout=0.2)
            if ev is None:
                continue
            updated = ev.copy()
            updated.status = EvalStatus.FAILED
            updated.status_description = "maximum attempts reached"
            self.update_eval(updated)
            follow = Evaluation(
                namespace=ev.namespace, priority=ev.priority, type=ev.type,
                job_id=ev.job_id, triggered_by=EvalTrigger.FAILED_FOLLOW_UP,
                status=EvalStatus.PENDING,
                wait_until=_time.time() +
                self.config.failed_eval_followup_delay)
            self.create_evals([follow])
            self.broker.ack(ev.id, token)

    def _dup_blocked_reaper(self, stop: threading.Event) -> None:
        """Cancel duplicate blocked evals in the store (reference
        reapDupBlockedEvaluations, leader.go:815): the tracker keeps one
        blocked eval per job and drops the rest, but the dropped ones
        would otherwise sit BLOCKED in the state forever."""
        while not stop.wait(0.2):
            if self._stop.is_set():
                return
            for ev in self.blocked_evals.get_duplicates():
                cancelled = ev.copy()
                cancelled.status = EvalStatus.CANCELLED
                cancelled.status_description = \
                    "existing blocked evaluation exists for this job"
                self.update_eval(cancelled)

    def _gc_loop(self, stop: threading.Event) -> None:
        """Leader periodic GC timers (reference leader.go:782-810 core-job
        eval scheduling, here invoked directly)."""
        while not stop.wait(self.config.gc_interval):
            if self._stop.is_set():
                return
            try:
                self.core_scheduler.process("force-gc")
            except Exception:               # noqa: BLE001
                log.exception("core gc")

    # ------------------------------------------------------------- watches

    def _on_state_change(self, table: str, obj) -> None:
        # alloc terminations free capacity: unblock that node's class
        if table == "allocs":
            a = obj
            if a.terminal_status():
                node = self.store.node_by_id(a.node_id)
                if node is not None:
                    self.blocked_evals.unblock(node.computed_class,
                                               self.store.latest_index)

    # ------------------------------------------------------------- API ops
    # (reference nomad/job_endpoint.go, node_endpoint.go, eval_endpoint.go)

    def _create_preemption_evals(self, preempted) -> None:
        """One reschedule eval per job whose allocs were preempted
        (reference CreatePreemptionEvals, plan_apply.go:204+)."""
        seen = set()
        evals = []
        for a in preempted:
            key = (a.namespace, a.job_id)
            if key in seen:
                continue
            seen.add(key)
            job = a.job or self.store.job_by_id(a.namespace, a.job_id)
            if job is None or job.stopped():
                continue
            evals.append(Evaluation(
                namespace=a.namespace, priority=job.priority,
                type=job.type, job_id=job.id,
                triggered_by=EvalTrigger.PREEMPTION,
                status=EvalStatus.PENDING))
        if evals:
            self.create_evals(evals)

    def update_eval(self, ev: Evaluation) -> None:
        # timestamps ride in the log payload: the FSM never reads the
        # clock
        ev.modify_time = _time.time()
        if not ev.create_time:
            ev.create_time = ev.modify_time
        self.apply(MessageType.EVAL_UPDATE, {"evals": [ev]})

    def create_evals(self, evals: List[Evaluation]) -> None:
        # pending evals are enqueued / blocked by the FSM's leader hook
        now = _time.time()
        copies = []
        for e in evals:
            c = e.copy()
            c.modify_time = now
            if not c.create_time:
                c.create_time = now
            copies.append(c)
        self.apply(MessageType.EVAL_UPDATE, {"evals": copies})

    def register_job(self, job: Job) -> Evaluation:
        """Job.Register (nomad/job_endpoint.go:81): upsert + eval."""
        if job.region and job.region != self.region:
            raise NotImplementedError(
                f"job {job.id!r} is for region {job.region!r}; the port "
                f"does not federate regions yet")
        if job.multiregion is not None and job.multiregion.regions:
            raise NotImplementedError(
                f"job {job.id!r} is multiregion; the port does not "
                f"federate regions yet")
        ns = job.namespace or "default"
        if self.store.namespace(ns) is None:
            known = sorted(n.name for n in self.store.namespaces())
            raise ValueError(
                f"job {job.id!r} submitted to unknown namespace "
                f"{ns!r} (known namespaces: {', '.join(known)})")
        if not job.submit_time:
            job.submit_time = _time.time()   # propose-time, rides the log
        index = self.apply(MessageType.JOB_REGISTER, {"job": job})
        self.store.wait_for_index(index)
        stored = self.store.job_by_id(job.namespace, job.id)
        if stored is not None:
            job.create_index = stored.create_index
            job.modify_index = stored.modify_index
            job.job_modify_index = stored.job_modify_index
            job.version = stored.version
        ev = Evaluation(
            namespace=job.namespace, priority=job.priority, type=job.type,
            job_id=job.id, triggered_by=EvalTrigger.JOB_REGISTER,
            status=EvalStatus.PENDING,
            job_modify_index=job.job_modify_index)
        ev.modify_index = job.modify_index
        if not job.is_periodic() and not job.is_parameterized():
            self.create_evals([ev])
        return ev

    def deregister_job(self, namespace: str, job_id: str,
                       purge: bool = False) -> Optional[Evaluation]:
        job = self.store.job_by_id(namespace, job_id)
        if job is None:
            return None
        self.apply(MessageType.JOB_DEREGISTER,
                   {"namespace": namespace, "job_id": job_id, "purge": purge})
        self.blocked_evals.untrack(namespace, job_id)
        ev = Evaluation(
            namespace=namespace, priority=job.priority, type=job.type,
            job_id=job_id, triggered_by=EvalTrigger.JOB_DEREGISTER,
            status=EvalStatus.PENDING)
        self.create_evals([ev])
        return ev

    def scale_job(self, namespace: str, job_id: str, group: str,
                  count: Optional[int] = None, message: str = "",
                  error: bool = False, meta: Optional[dict] = None
                  ) -> Optional[Evaluation]:
        """Job.Scale (reference nomad/job_endpoint.go:967): adjust one
        task group's count within its scaling-policy bounds by
        registering the updated job (which creates the eval that
        reschedules), and record a ScalingEvent either way (error=True
        events are autoscaler annotations that never change counts)."""
        from nomad_tpu_torch.structs.job import ScalingEvent
        job = self.store.job_by_id(namespace, job_id)
        if job is None:
            raise ValueError(f"job {job_id!r} not found")
        tg = job.lookup_task_group(group)
        if tg is None:
            raise ValueError(
                f"task group {group!r} does not exist in job")
        prev = tg.count
        ev = None
        if count is not None and not error:
            if tg.scaling is not None and tg.scaling.enabled:
                if count < tg.scaling.min:
                    raise ValueError(
                        f"group count was less than scaling policy "
                        f"minimum: {count} < {tg.scaling.min}")
                if tg.scaling.max and count > tg.scaling.max:
                    raise ValueError(
                        f"group count was greater than scaling policy "
                        f"maximum: {count} > {tg.scaling.max}")
            new_job = job.copy()
            new_job.lookup_task_group(group).count = int(count)
            ev = self.register_job(new_job)
        event = ScalingEvent(
            time=_time.time(), previous_count=prev, count=count,
            message=message, error=error,
            eval_id=ev.id if ev is not None else "", meta=meta or {})
        self.apply(MessageType.SCALING_EVENT,
                   {"namespace": namespace, "job_id": job_id,
                    "group": group, "event": event})
        return ev

    def job_scale_status(self, namespace: str, job_id: str) -> Optional[dict]:
        """Job.ScaleStatus (job_endpoint.go:2038): desired vs placed vs
        healthy per group + the scaling-event log."""
        job = self.store.job_by_id(namespace, job_id)
        if job is None:
            return None
        allocs = self.store.allocs_by_job(namespace, job_id)
        events = self.store.scaling_events_by_job(namespace, job_id)
        groups = {}
        for tg in job.task_groups:
            live = [a for a in allocs if a.task_group == tg.name
                    and not a.terminal_status()]
            healthy = sum(1 for a in live if (a.deployment_status or {})
                          .get("healthy") is True)
            unhealthy = sum(1 for a in live if (a.deployment_status or {})
                            .get("healthy") is False)
            groups[tg.name] = {
                "desired": tg.count, "placed": len(live),
                "running": sum(1 for a in live
                               if a.client_status == "running"),
                "healthy": healthy, "unhealthy": unhealthy,
                "events": events.get(tg.name, []),
            }
        return {"job_id": job_id, "namespace": namespace,
                "job_modify_index": job.modify_index,
                "job_stopped": job.stopped(), "task_groups": groups}

    def set_job_stability(self, namespace: str, job_id: str, version: int,
                          stable: bool) -> None:
        self.apply(MessageType.JOB_STABILITY,
                   {"namespace": namespace, "job_id": job_id,
                    "version": version, "stable": stable})

    def register_node(self, node: Node) -> None:
        """Node.Register (nomad/node_endpoint.go:79).  The leader's FSM
        hook starts the node's TTL timer.  A re-registration
        whose device fingerprint marks instances unhealthy migrates the
        allocations holding those instances."""
        prev = self.store.node_by_id(node.id)
        if prev is not None and prev.secret_id and node.secret_id \
                and prev.secret_id != node.secret_id:
            # reference node_endpoint.go:141 — a re-registration may not
            # rotate another node's identity out from under it
            raise ValueError(f"node secret ID does not match: {node.id}")
        newly_bad: set = set()
        if prev is not None:
            prev_bad = {i for d in prev.node_resources.devices
                        for i in d.unhealthy_ids}
            now_bad = {i for d in node.node_resources.devices
                       for i in d.unhealthy_ids}
            newly_bad = now_bad - prev_bad
        self.apply(MessageType.NODE_REGISTER, {"node": node})
        if newly_bad:
            self._migrate_device_allocs(node.id, newly_bad)

    def _migrate_device_allocs(self, node_id: str, bad_ids: set) -> None:
        """DesiredTransition(force_reschedule) + eval for every alloc on
        the node holding a now-unhealthy device instance: the reconciler
        replaces it, and the replacement lands on healthy hardware
        because unhealthy instances carry no capacity."""
        from nomad_tpu_torch.structs.alloc import DesiredTransition
        doomed = []
        for a in self.store.allocs_by_node(node_id):
            if a.terminal_status():
                continue
            held = {i for tr in a.allocated_resources.tasks.values()
                    for d in tr.devices
                    for i in d.get("device_ids", ())}
            if held & bad_ids:
                doomed.append(a)
        if not doomed:
            return
        evs = []
        for (ns, job_id) in {(a.namespace, a.job_id) for a in doomed}:
            job = self.store.job_by_id(ns, job_id)
            if job is None:
                continue
            evs.append(Evaluation(
                namespace=ns, priority=job.priority, type=job.type,
                job_id=job_id, triggered_by=EvalTrigger.NODE_UPDATE,
                status=EvalStatus.PENDING))
        for a in doomed:
            u = a.copy()
            # force_reschedule: migrate only moves allocs on DRAINING
            # nodes; a dead device on a healthy node needs the
            # unconditional replace path
            u.desired_transition = DesiredTransition(force_reschedule=True)
            self.apply(MessageType.ALLOC_UPDATE_DESIRED_TRANSITION,
                       {"allocs": [u]})
        if evs:
            self.create_evals(evs)

    def node_heartbeat(self, node_id: str) -> float:
        """Node.UpdateStatus heartbeat path: reset TTL; a down node
        re-heartbeating is brought back to ready (init->ready handled by
        client re-registration)."""
        return self.node_heartbeats([node_id])

    def node_heartbeats(self, node_ids: List[str]) -> float:
        """Batched heartbeat for fleet-scale agent drivers: one call
        re-arms many TTLs.  A down or disconnected node's revival rides
        the heartbeat batch when it runs (one coalesced FSM entry per
        flush tick, not one per node); a live node gets a liveness stamp
        (rate-limited to half-TTL per node inside the batcher), so a
        restored leader sees reasonably fresh status_updated_at values.
        Unlike the reference, which runs the single-node path a node,
        the chunk takes the store's, the batcher's and the wheel's locks
        once each: a thread that takes a contended lock a node waits for
        the interpreter lock at every one, and among the workers a
        10,000-node pass then outlasts the TTL."""
        nodes = self.store.nodes_by_ids(node_ids)
        batching = self.heartbeat_batch.running
        stamps = []
        for nid, node in zip(node_ids, nodes):
            if node is None:
                continue
            if node.status in ("down", "disconnected"):
                if batching:
                    self.heartbeat_batch.note(nid, "ready")
                else:
                    self.update_node_status(nid, "ready")
            elif batching:
                stamps.append((nid, node.status))
        if stamps:
            self.heartbeat_batch.stamp_many(stamps)
        return self.heartbeats.heartbeat_many(node_ids)

    def node_update_fingerprint(self, node_id: str, update: dict) -> dict:
        """Node.UpdateFingerprint: a device/attribute re-fingerprint
        DELTA from a registered client.  Rides the heartbeat batcher's
        coalesced write path (one NodeFingerprintBatch entry per flush
        tick) instead of a full Node.Register per change; an unknown
        node returns known=False so the client falls back to a full
        re-register."""
        if self.store.node_by_id(node_id) is None:
            return {"known": False}
        payload = {k: v for k, v in update.items()
                   if k in ("devices", "attributes")}
        payload["node_id"] = node_id
        if self.heartbeat_batch.running:
            self.heartbeat_batch.note_fingerprint(node_id, payload)
        else:
            self.apply(MessageType.NODE_FINGERPRINT_BATCH,
                       {"updates": [payload]})
        return {"known": True}

    def update_node_status(self, node_id: str, status: str) -> List[Evaluation]:
        """Node.UpdateStatus: transition + evals for affected jobs."""
        self.apply(MessageType.NODE_UPDATE_STATUS,
                   {"node_id": node_id, "status": status,
                    "updated_at": _time.time()})
        return self.create_node_evals(node_id)

    def create_node_evals(self, node_id: str) -> List[Evaluation]:
        """Evaluate all jobs with allocs on the node plus system jobs
        (reference createNodeEvals, node_endpoint.go)."""
        evals = []
        seen = set()
        for a in self.store.allocs_by_node(node_id):
            job = a.job or self.store.job_by_id(a.namespace, a.job_id)
            if job is None or job.id in seen:
                continue
            seen.add(job.id)
            evals.append(Evaluation(
                namespace=a.namespace, priority=job.priority, type=job.type,
                job_id=job.id, triggered_by=EvalTrigger.NODE_UPDATE,
                node_id=node_id, status=EvalStatus.PENDING,
                modify_index=self.store.latest_index))
        for job in self.store.jobs():
            if job.type in (JobType.SYSTEM, JobType.SYSBATCH) \
                    and job.id not in seen and not job.stopped():
                seen.add(job.id)
                evals.append(Evaluation(
                    namespace=job.namespace, priority=job.priority,
                    type=job.type, job_id=job.id,
                    triggered_by=EvalTrigger.NODE_UPDATE, node_id=node_id,
                    status=EvalStatus.PENDING,
                    modify_index=self.store.latest_index))
        if evals:
            self.create_evals(evals)
        return evals

    # ------------------------------------------------------------- namespaces

    def namespaces(self):
        return self.store.namespaces()

    def namespace(self, name: str):
        return self.store.namespace(name)

    def upsert_namespace(self, name: str, description: str = "",
                         quota: str = "") -> None:
        if quota and self.store.quota_spec(quota) is None:
            raise ValueError(f"quota spec {quota!r} does not exist")
        self.apply(MessageType.NAMESPACE_UPSERT,
                   {"name": name, "description": description,
                    "quota": quota})

    def delete_namespace(self, name: str) -> None:
        self.apply(MessageType.NAMESPACE_DELETE, {"name": name})

    # ------------------------------------------------------------- quotas

    def upsert_quota_spec(self, spec) -> None:
        self.apply(MessageType.QUOTA_SPEC_UPSERT, {"spec": spec})

    def delete_quota_spec(self, name: str) -> None:
        # propose-time guard mirrors the FSM's authoritative check so the
        # caller gets the error without burning a log entry
        for ns in self.store.namespaces():
            if ns.quota == name:
                raise ValueError(
                    f"quota {name!r} referenced by namespace {ns.name!r}")
        self.apply(MessageType.QUOTA_SPEC_DELETE, {"name": name})

    def quota_specs(self):
        return self.store.quota_specs()

    def quota_spec(self, name: str):
        return self.store.quota_spec(name)

    def quota_usage(self, namespace: str):
        return self.store.quota_usage(namespace)

    def quota_usages(self):
        return self.store.quota_usages()

    # ------------------------------------------------------------- helpers

    def wait_for_idle(self, timeout: float = 10.0) -> bool:
        """Wait until no evals are queued or in flight."""
        deadline = _time.time() + timeout
        while _time.time() < deadline:
            if (self.broker.ready_count() == 0
                    and self.broker.unacked_count() == 0
                    and self.plan_queue.depth() == 0):
                return True
            _time.sleep(0.01)
        return False
