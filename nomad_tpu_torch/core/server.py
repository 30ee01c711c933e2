"""Server: the control-plane spine wired together, dev mode.

Reference analog: nomad/server.go + leader.go establishLeadership — state
store, eval broker, blocked evals, plan queue, the serialized plan-apply
loop and N scheduler workers.  Writes apply straight through the NomadFSM
under a lock (the reference's '-dev agent' in-memory Raft); the server
is its own leader from `start` to `stop`.

`save_snapshot`/`restore_snapshot` write and read the FSM's snapshot
(raft/fsm.py) to and from a file, the operator's save and restore.

`device` (default "cuda") is where every scheduler the workers build
runs its kernels, where the placement engine and the preemption kernel
run, and whose engine the plan applier releases tickets on.  Without a
card, `Server()` raises; `device="cpu"` runs the plain PyTorch versions.

Not in this port yet (the constructor raises for the first three):
raft clusters, gossip membership, the WAN pool and federation;
heartbeats, the deployment, volume and drain watchers, the periodic
dispatcher, core GC, the event broker, RPC endpoints, admission and
brownout, the read gate and ACLs.
"""
from __future__ import annotations

import pickle
import threading
import time as _time
from typing import List, Optional

from nomad_tpu_torch.core.blocked import BlockedEvals
from nomad_tpu_torch.core.broker import FAILED_QUEUE, EvalBroker, EvalWaveFeeder
from nomad_tpu_torch.core.plan_apply import PlanApplier
from nomad_tpu_torch.core.plan_queue import PlanQueue, StaleEvalTokenError
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


class ServerConfig:
    """`heartbeat_ttl` and `gc_interval` are kept for the heartbeat
    tracker and core GC, which the port does not run yet."""

    def __init__(self, num_schedulers: int = 4,
                 enabled_schedulers: Optional[List[str]] = None,
                 heartbeat_ttl: float = 10.0,
                 gc_interval: float = 300.0,
                 region: str = "global",
                 failed_eval_followup_delay: float = 60.0):
        self.num_schedulers = num_schedulers
        self.enabled_schedulers = enabled_schedulers or \
            ["service", "batch", "system", "sysbatch"]
        self.heartbeat_ttl = heartbeat_ttl
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
        self.store.watch(self.blocked_evals.watch_state)
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
        evals and the two reapers."""
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

    def _revoke_leadership(self) -> None:
        """revokeLeadership (reference nomad/leader.go:1099-1132): the
        workers settle and exit while the applier still runs, then the
        queues close and every leader thread is joined."""
        with self._leader_lock:
            if not self._established:
                return
            self._established = False
            self.leader = False
            self._leader_stop.set()
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

    def register_node(self, node: Node) -> None:
        """Node.Register (nomad/node_endpoint.go:79).  A re-registration
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
