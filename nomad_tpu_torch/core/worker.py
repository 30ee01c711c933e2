"""Scheduler worker (reference: nomad/worker.go — run:386,
dequeueEvaluation:437, snapshotMinIndex:537, invokeScheduler:553,
SubmitPlan:593-660).

Each worker loops: dequeue an eval (with lease token), wait for the state
store to catch up to the eval's index, invoke the scheduler via the
factory, then ack/nack.  The worker object is the scheduler's Planner:
plans go to the plan queue and the worker blocks on the applier's result.
"""
from __future__ import annotations

import concurrent.futures
import logging
import threading
import time
from collections import Counter, deque
from typing import List, Optional

from nomad_tpu_torch import knobs
from nomad_tpu_torch.core.plan_queue import (LeadershipLostError,
                                             StaleEvalTokenError)
from nomad_tpu_torch.scheduler import factory
from nomad_tpu_torch.structs import Evaluation, EvalStatus
from nomad_tpu_torch.structs.plan import Plan, PlanResult
from nomad_tpu_torch.telemetry import global_metrics

log = logging.getLogger(__name__)

# transient server errors: the eval should be redelivered, not failed.
# A commit timeout (futures.TimeoutError) belongs here: the write may or
# may not have landed, which is the same ambiguity as a leadership loss,
# and redelivery resolves both the same way (the worker re-snapshots
# past the eval's index before scheduling again).
TRANSIENT_ERRORS = (LeadershipLostError, StaleEvalTokenError,
                    concurrent.futures.TimeoutError, TimeoutError)


class Worker:
    def __init__(self, server, worker_id: int = 0,
                 enabled_schedulers: Optional[List[str]] = None):
        self.server = server
        self.id = worker_id
        self.enabled_schedulers = enabled_schedulers or \
            ["service", "batch", "system", "sysbatch"]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._snapshot = None
        # store index the scheduling snapshot must reach before this
        # worker's current eval may be processed (set at dequeue)
        self._wait_index = 0
        # double-buffered commit pipeline (plan_apply.go:71-178 carried
        # to the worker side): with depth > 0, submit_plan returns at
        # applier-EVALUATE time (the PlanResult is final then; only
        # alloc_index lands later) and the eval's COMPLETE/ack settle is
        # deferred until the FSM write lands — so wave N+1
        # schedules and dispatches on-device while commit(N) is durably
        # landing.  Depth bounds how many evals may be settle-deferred
        # at once; 0 restores strict blocking submits.
        self.pipeline_depth = max(0, knobs.get_int(
            "NOMAD_TPU_PIPELINE_DEPTH"))
        # (ev, token, [PendingPlan]) awaiting durable commit, oldest first
        self._deferred = deque()
        self._eval_pendings: List = []
        self.stats = {"processed": 0, "failed": 0,
                      "pipelined_evals": 0, "pipeline_discards": 0,
                      # dequeues served off the wave-aligned feeder
                      # buffer (vs direct broker passes): the supply
                      # side of the engine's wave-lane batching
                      "wave_dequeues": 0}
        # "ExceptionType: message" -> count of every error that failed an
        # eval, escaped process_eval or failed a pipelined commit (the
        # scheduler's errors and the kernels' launch errors alike);
        # transient errors are not counted
        self.failures: Counter = Counter()

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.run, name=f"worker-{self.id}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: float = 5.0) -> None:
        if self._thread:
            self._thread.join(timeout)

    def run(self) -> None:
        while not self._stop.is_set():
            got = self._dequeue()
            self._drain_deferred()
            if got is None:
                continue
            ev, token = got
            if self._stop.is_set():
                # stop() landed while the dequeue was in flight: hand the
                # lease back so a live worker gets the eval now rather
                # than after the nack timeout
                try:
                    self._nack(ev.id, token)
                except TRANSIENT_ERRORS:
                    pass
                break
            try:
                self.process_eval(ev, token)
            except TRANSIENT_ERRORS:
                # leadership moved mid-eval (reference: the worker's RPCs
                # start failing and the eval is nacked for redelivery);
                # nack best-effort — the lease expires server-side anyway
                try:
                    self._nack(ev.id, token)
                except TRANSIENT_ERRORS:
                    pass
            except Exception as e:                  # noqa: BLE001
                # never let the worker thread die (reference workers live
                # for the life of the server, worker.go:386) — and hand
                # the lease back so the eval redelivers now, not at the
                # nack timeout
                log.exception("worker %s: unhandled error", self.id)
                self.failures[f"{type(e).__name__}: {e}"] += 1
                try:
                    self._nack(ev.id, token)
                except TRANSIENT_ERRORS:
                    pass
        # settle every still-deferred eval before the thread exits —
        # a clean stop must not leave acked-nowhere leases to time out
        while self._deferred:
            self._settle_eval(*self._deferred.popleft())

    # ------------------------------------------------------ pipelined settle

    def _drain_deferred(self) -> None:
        """Settle deferred evals: everything whose commits already landed
        settles for free; beyond `pipeline_depth` outstanding, block on
        the oldest so the pipeline stays bounded."""
        while self._deferred:
            ev, token, pendings = self._deferred[0]
            if len(self._deferred) <= self.pipeline_depth and \
                    not all(p.future.done() for p in pendings):
                return
            self._deferred.popleft()
            self._settle_eval(ev, token, pendings)

    def _settle_eval(self, ev: Evaluation, token: str,
                     pendings: List) -> None:
        """Deferred tail of process_eval: wait for the durable commits
        backing this eval's plans, then publish COMPLETE and ack.  If a
        commit failed mid-flight, the speculative result is discarded —
        the eval is nacked for redelivery and the re-process snapshots
        past whatever DID commit (`_wait_index`), so a partial landing
        never double-places (same contract as crash-after-commit)."""
        try:
            for p in pendings:
                p.future.result(timeout=600.0)
        except Exception as e:                      # noqa: BLE001
            # transient or real commit failure: identical discard path
            self.stats["pipeline_discards"] += 1
            if not isinstance(e, TRANSIENT_ERRORS):
                self.failures[f"{type(e).__name__}: {e}"] += 1
            try:
                self._nack(ev.id, token)
            except TRANSIENT_ERRORS:
                pass
            return
        try:
            self.server.update_eval(ev)
            if self._ack(ev.id, token):
                self.stats["processed"] += 1
                self.stats["pipelined_evals"] += 1
        except TRANSIENT_ERRORS:
            try:
                self._nack(ev.id, token)
            except TRANSIENT_ERRORS:
                pass

    # -- broker ops

    def _dequeue(self):
        feeder = getattr(self.server, "eval_feeder", None)
        if feeder is not None:
            # wave-aligned path: one pool member drains a whole ready
            # wave in one broker pass; the rest pick from the buffer
            got = feeder.get(self.enabled_schedulers, timeout=0.1)
            if got is None:
                return None
            ev, token = got
            self.stats["wave_dequeues"] += 1
        else:
            ev, token = self.server.broker.dequeue(
                self.enabled_schedulers, timeout=0.1)
            if ev is None:
                return None
        self._wait_index = self.server.store.latest_index
        return ev, token

    def _ack(self, eval_id: str, token: str) -> bool:
        return self.server.broker.ack(eval_id, token)

    def _nack(self, eval_id: str, token: str) -> bool:
        return self.server.broker.nack(eval_id, token)

    # ------------------------------------------------------------- process

    def process_eval(self, ev: Evaluation, token: str) -> None:
        server = self.server
        # _wait_index covers redelivery: a plan may already have committed
        # for this eval (crash-after-commit nack, lease expiry, failover)
        # at an index past the eval's own, and scheduling from an older
        # snapshot would double-place the job
        snap = server.store.snapshot_min_index(
            max(ev.modify_index, ev.snapshot_index, self._wait_index))
        if snap is None:
            self._nack(ev.id, token)
            return
        self._snapshot = snap
        self._token = token
        self._eval_pendings = []
        ev = ev.copy()
        try:
            sched = factory.new_scheduler(ev.type, snap, self,
                                          device=server.device)
            sched.process(ev)
        except TRANSIENT_ERRORS:
            raise
        except Exception as e:                          # noqa: BLE001
            log.exception("eval %s failed", ev.id)
            self.stats["failed"] += 1
            self.failures[f"{type(e).__name__}: {e}"] += 1
            ev.status = EvalStatus.FAILED
            ev.status_description = str(e)
            server.update_eval(ev)  # raises TRANSIENT -> run() nacks
            self._nack(ev.id, token)
            return
        ev.status = EvalStatus.COMPLETE
        pendings, self._eval_pendings = self._eval_pendings, []
        if pendings:
            # pipelined submits are still committing: defer the
            # COMPLETE/ack settle and move on to the next eval now
            self._deferred.append((ev, token, pendings))
            self._drain_deferred()
            return
        server.update_eval(ev)
        if self._ack(ev.id, token):
            self.stats["processed"] += 1

    # ------------------------------------------------------------- planner

    def submit_plan(self, plan: Plan) -> PlanResult:
        t0 = time.time()
        res = self._submit(plan)
        global_metrics.measure_since("nomad.plan.submit", t0)
        # per-namespace latency, as the reference samples it
        ns = (plan.job.namespace or "default") if plan.job else "default"
        global_metrics.measure_since(f"nomad.plan.submit.ns.{ns}", t0)
        return res

    def _submit(self, plan: Plan) -> PlanResult:
        plan.eval_token = getattr(self, "_token", "")
        pending = self.server.enqueue_plan(plan)
        if self.pipeline_depth > 0:
            # pipelined: return as soon as the applier has validated the
            # plan and registered its overlay — the PlanResult's content
            # is final at evaluate time (only alloc_index lands
            # post-commit, and the scheduler never reads it).  The
            # durable commit settles later in _settle_eval; the applier
            # owns the engine-ticket release either way, so the
            # scheduler must skip its early free.
            res = pending.evaluated.result(timeout=600.0)
            plan.commit_inflight = True
            self._eval_pendings.append(pending)
            return res
        # generous: under full-cluster bursts the serialized applier
        # legitimately backs up for minutes; an eval failed on a
        # timed-out future gets retried from scratch even though its
        # plan still commits — pure wasted recompute
        return pending.future.result(timeout=600.0)

    def create_evals(self, evals: List[Evaluation]) -> None:
        self.server.create_evals(evals)

    def update_eval(self, ev: Evaluation) -> None:
        self.server.update_eval(ev)

    def reblock_eval(self, ev: Evaluation) -> None:
        self.server.blocked_evals.block(ev)

    def refresh_snapshot(self, min_index: int = 0):
        snap = self.server.store.snapshot_min_index(min_index)
        self._snapshot = snap
        return snap

