"""Evaluation broker (reference: nomad/eval_broker.go — EvalBroker:47,
Enqueue:182, Dequeue:335, Ack/Nack:537,601, delayed evals:758, priority
heap:888-925).

Semantics reproduced:
- priority queues per scheduler type; FIFO within a priority
- one eval per (namespace, job) outstanding; later ones wait in a per-job
  pending queue and are released on Ack (dedup of pending evals per job)
- dequeue hands out a lease token; Ack/Nack must present it
- Nack requeues with attempt count; after `delivery_limit` attempts the
  eval is routed to the `_failed` queue (reaped by the leader loop)
- `wait_until` evals sit in a delay heap until due
- expired leases auto-nack (checked lazily on broker operations)

Weighted fair dequeue (this repo's multi-tenant extension, following
stride scheduling — Waldspurger & Weihl, OSDI '95 — over per-namespace
queues, the broker-level analog of DRF's dominant-share ordering): the
ready queues are partitioned per (scheduler type, namespace); each
namespace carries a virtual-time `pass` advanced by `stride = K/weight`
on every dequeue, and the next eval comes from the runnable namespace
with the minimum pass.  A namespace that wakes from idle has its pass
floored to the runnable minimum, so sleeping never banks credit.  With
one namespace (or fairness disabled via the replicated
SchedulerConfiguration) the order degenerates to the global
(-priority, seq) order, byte-for-byte the pre-fairness behavior.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time as _time
import uuid
from collections import defaultdict, deque
from typing import Dict, List, Optional, Set, Tuple

from nomad_tpu_torch.structs import Evaluation

FAILED_QUEUE = "_failed"


class _Lease:
    __slots__ = ("eval", "token", "expires_at")

    def __init__(self, ev: Evaluation, token: str, expires_at: float):
        self.eval = ev
        self.token = token
        self.expires_at = expires_at


class EvalBroker:
    # the queue tables below are only touched under `self._lock` (the
    # *_locked helpers are called with it held)

    def __init__(self, nack_timeout: float = 60.0, delivery_limit: int = 3,
                 initial_nack_delay: float = 1.0, subsequent_nack_delay: float = 20.0):
        self._lock = threading.Condition()
        self.enabled = False
        self.nack_timeout = nack_timeout
        self.delivery_limit = delivery_limit
        self.initial_nack_delay = initial_nack_delay
        self.subsequent_nack_delay = subsequent_nack_delay
        self._counter = itertools.count()
        # scheduler type -> namespace -> heap of (-priority, seq, eval);
        # the per-namespace partition is what fair dequeue picks over
        self._ns_ready: Dict[str, Dict[str, List[Tuple[int, int, Evaluation]]]] = \
            defaultdict(dict)
        # scheduler type -> set of namespaces with a non-empty heap (the
        # dequeue scan walks only runnable namespaces)
        self._ns_nonempty: Dict[str, set] = defaultdict(set)
        # stride accounting: namespace -> virtual pass; weights come from
        # the replicated SchedulerConfiguration via set_fair_config
        self._fair_pass: Dict[str, float] = {}
        self._fair_enabled = True
        self._fair_default_weight = 1
        self._fair_weights: Dict[str, int] = {}
        self._unack: Dict[str, _Lease] = {}
        self._attempts: Dict[str, int] = defaultdict(int)
        # (namespace, job_id) -> deque of evals waiting for the active one.
        # A job is "active" from the moment one of its evals enters the
        # ready queue (not just at dequeue) until that eval is acked or
        # dead-lettered — the reference dedups at enqueue time across
        # ready+unack, preventing two schedulers from planning the same job
        # concurrently.
        self._pending: Dict[Tuple[str, str], deque] = defaultdict(deque)
        self._active_jobs: Set[Tuple[str, str]] = set()
        self._delayed: List[Tuple[float, int, Evaluation]] = []
        self._requeued: List[Tuple[float, int, Evaluation]] = []   # nack delay heap
        self.stats = defaultdict(int)

    # ------------------------------------------------------------- control

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self.enabled = enabled
            if not enabled:
                self.flush()

    def set_fair_config(self, cfg) -> None:
        """Adopt the replicated SchedulerConfiguration's fairness knobs
        (live-tunable: the FSM's leader hook pushes every applied
        config entry here)."""
        with self._lock:
            self._fair_enabled = bool(
                getattr(cfg, "fair_dequeue_enabled", True))
            self._fair_default_weight = max(
                1, int(getattr(cfg, "default_namespace_weight", 1) or 1))
            self._fair_weights = dict(
                getattr(cfg, "namespace_weights", None) or {})
            self._lock.notify_all()

    def _stride(self, namespace: str) -> float:
        weight = self._fair_weights.get(
            namespace, self._fair_default_weight)
        return 1000.0 / max(1, int(weight))

    def flush(self) -> None:
        self._ns_ready.clear()
        self._ns_nonempty.clear()
        self._fair_pass.clear()
        self._unack.clear()
        self._attempts.clear()
        self._pending.clear()
        self._active_jobs.clear()
        self._delayed = []
        self._requeued = []

    # ------------------------------------------------------------- enqueue

    def enqueue(self, ev: Evaluation) -> None:
        with self._lock:
            self._enqueue_locked(ev)
            self._lock.notify_all()

    def enqueue_all(self, evals: List[Evaluation]) -> None:
        with self._lock:
            for ev in evals:
                self._enqueue_locked(ev)
            self._lock.notify_all()

    def _enqueue_locked(self, ev: Evaluation) -> None:
        if not self.enabled:
            return
        now = _time.time()
        if ev.wait_until and ev.wait_until > now:
            heapq.heappush(self._delayed, (ev.wait_until, next(self._counter), ev))
            self.stats["delayed"] += 1
            return
        key = (ev.namespace, ev.job_id)
        if ev.job_id and key in self._active_jobs:
            self._pending[key].append(ev)
            self.stats["pending_dedup"] += 1
            return
        if ev.job_id:
            self._active_jobs.add(key)
        self._push_ready_locked(ev)
        self.stats["enqueued"] += 1

    def _push_ready_locked(self, ev: Evaluation) -> None:
        heap = self._ns_ready[ev.type].setdefault(ev.namespace, [])
        if not heap:
            # namespace becomes runnable for this scheduler type.  If it
            # was idle EVERYWHERE, floor its pass to the runnable
            # minimum: a sleeper must not bank virtual time and then
            # monopolize the broker on wake (stride scheduling's
            # standard re-admission rule).
            was_runnable = any(ev.namespace in nss
                               for nss in self._ns_nonempty.values())
            if not was_runnable:
                floor = min((self._fair_pass.get(ns, 0.0)
                             for nss in self._ns_nonempty.values()
                             for ns in nss), default=0.0)
                self._fair_pass[ev.namespace] = max(
                    self._fair_pass.get(ev.namespace, 0.0), floor)
            self._ns_nonempty[ev.type].add(ev.namespace)
        heapq.heappush(heap, (-ev.priority, next(self._counter), ev))

    # ------------------------------------------------------------- dequeue

    def _poll_timers_locked(self) -> None:
        now = _time.time()
        while self._delayed and self._delayed[0][0] <= now:
            _, _, ev = heapq.heappop(self._delayed)
            ev.wait_until = 0.0
            self._enqueue_locked(ev)
        while self._requeued and self._requeued[0][0] <= now:
            _, _, ev = heapq.heappop(self._requeued)
            self._push_ready_locked(ev)   # job stays active; no dedup
        # expire stale leases -> auto-nack
        expired = [t for t, l in self._unack.items() if l.expires_at <= now]
        for token in expired:
            lease = self._unack.pop(token)
            self._nack_locked(lease.eval, requeue_now=True)

    def _pick_locked(self, schedulers: List[str]
                     ) -> Optional[Tuple[Evaluation, str]]:
        """One fair pick + lease mint, or None when nothing is ready.
        Shared by dequeue (one pick per lock pass) and dequeue_batch
        (repeated picks draining a wave in one pass)."""
        # fair pick: the runnable namespace with the minimum
        # stride pass (ties broken by the global head order so
        # equal-pass namespaces keep FIFO-within-priority);
        # fairness off -> pure global (-priority, seq) order
        fair = self._fair_enabled
        best_q, best_ns, best_key = None, None, None
        for s in schedulers:
            for ns in self._ns_nonempty.get(s, ()):
                head = self._ns_ready[s][ns][0]
                key = (self._fair_pass.get(ns, 0.0),
                       head[0], head[1]) if fair \
                    else (head[0], head[1])
                if best_key is None or key < best_key:
                    best_q, best_ns, best_key = s, ns, key
        if best_ns is None:
            return None
        heap = self._ns_ready[best_q][best_ns]
        best = heapq.heappop(heap)
        if not heap:
            del self._ns_ready[best_q][best_ns]
            self._ns_nonempty[best_q].discard(best_ns)
        if self._fair_enabled:
            self._fair_pass[best_ns] = \
                self._fair_pass.get(best_ns, 0.0) + \
                self._stride(best_ns)
            self.stats["fair_picks"] += 1
        ev = best[2]
        token = str(uuid.uuid4())
        expires = _time.time() + self.nack_timeout
        self._unack[token] = _Lease(ev, token, expires)
        self.stats["dequeued"] += 1
        return ev, token

    def dequeue(self, schedulers: List[str], timeout: float = 0.0
                ) -> Tuple[Optional[Evaluation], str]:
        """-> (eval, token) or (None, '')."""
        deadline = _time.time() + timeout
        with self._lock:
            while True:
                self._poll_timers_locked()
                got = self._pick_locked(schedulers)
                if got is not None:
                    return got
                remaining = deadline - _time.time()
                if remaining <= 0:
                    return None, ""
                # wake early enough to serve delay heaps
                wake = min(remaining, 0.05)
                self._lock.wait(wake)

    def dequeue_batch(self, schedulers: List[str], max_n: int,
                      timeout: float = 0.0
                      ) -> List[Tuple[Evaluation, str]]:
        """Wave dequeue: block up to `timeout` for the FIRST ready eval,
        then drain up to max_n in the SAME lock pass — one fair pick and
        one lease per eval, so fairness accounting and job dedup are
        byte-identical to max_n sequential dequeues.  Never waits for
        the batch to fill: a shallow queue returns what exists so wave
        batching can't add latency when traffic is light."""
        deadline = _time.time() + timeout
        out: List[Tuple[Evaluation, str]] = []
        with self._lock:
            while True:
                self._poll_timers_locked()
                while len(out) < max_n:
                    got = self._pick_locked(schedulers)
                    if got is None:
                        break
                    out.append(got)
                if out:
                    return out
                remaining = deadline - _time.time()
                if remaining <= 0:
                    return out
                self._lock.wait(min(remaining, 0.05))

    # ------------------------------------------------------------- ack/nack

    def ack(self, eval_id: str, token: str) -> bool:
        with self._lock:
            lease = self._unack.get(token)
            if lease is None or lease.eval.id != eval_id:
                return False
            del self._unack[token]
            self._attempts.pop(eval_id, None)
            ev = lease.eval
            key = (ev.namespace, ev.job_id)
            self._active_jobs.discard(key)
            self._release_pending_locked(key)
            self.stats["acked"] += 1
            self._lock.notify_all()
            return True

    def nack(self, eval_id: str, token: str) -> bool:
        with self._lock:
            lease = self._unack.get(token)
            if lease is None or lease.eval.id != eval_id:
                return False
            del self._unack[token]
            ev = lease.eval
            # the job stays active: the eval will re-enter the ready queue
            # (or dead-letter, which releases it in _nack_locked)
            self._nack_locked(ev)
            self._lock.notify_all()
            return True

    def _nack_locked(self, ev: Evaluation, requeue_now: bool = False) -> None:
        self._attempts[ev.id] += 1
        attempts = self._attempts[ev.id]
        if attempts >= self.delivery_limit:
            # dead-letter: hand to the failed queue for the leader reaper
            # and release the job so a fresh eval can be scheduled
            self._active_jobs.discard((ev.namespace, ev.job_id))
            self._release_pending_locked((ev.namespace, ev.job_id))
            heap = self._ns_ready[FAILED_QUEUE].setdefault(ev.namespace, [])
            if not heap:
                self._ns_nonempty[FAILED_QUEUE].add(ev.namespace)
            heapq.heappush(heap, (-ev.priority, next(self._counter), ev))
            self.stats["failed"] += 1
            return
        delay = (self.initial_nack_delay if attempts == 1
                 else self.subsequent_nack_delay)
        if requeue_now:
            delay = 0.0
        heapq.heappush(self._requeued,
                       (_time.time() + delay, next(self._counter), ev))
        self.stats["nacked"] += 1

    def _release_pending_locked(self, key: Tuple[str, str]) -> None:
        pending = self._pending.get(key)
        if pending:
            nxt = pending.popleft()
            if not pending:
                del self._pending[key]
            self._enqueue_locked(nxt)

    # ------------------------------------------------------------- inspect

    def outstanding(self, eval_id: str) -> Optional[str]:
        with self._lock:
            # settle expired leases first so a stale token is never
            # reported as live (the plan-submit gate relies on this)
            self._poll_timers_locked()
            for token, lease in self._unack.items():
                if lease.eval.id == eval_id:
                    return token
        return None

    def outstanding_reset(self, eval_id: str, token: str) -> bool:
        """Extend the lease (reference OutstandingReset for long scheds)."""
        with self._lock:
            lease = self._unack.get(token)
            if lease is None or lease.eval.id != eval_id:
                return False
            lease.expires_at = _time.time() + self.nack_timeout
            return True

    def unacked_count(self) -> int:
        with self._lock:
            return len(self._unack)

    def ready_count(self) -> int:
        with self._lock:
            self._poll_timers_locked()
            return sum(len(q)
                       for s, per_ns in self._ns_ready.items()
                       if s != FAILED_QUEUE
                       for q in per_ns.values())

    def fair_stats(self) -> dict:
        """broker.fair_* telemetry snapshot: per-namespace pass/weight
        plus runnable namespace count.  `bypassed` counts picks that
        skipped the stride order; only the reference's chaos hook makes
        them, so it stays 0 here."""
        with self._lock:
            runnable = set()
            for nss in self._ns_nonempty.values():
                runnable |= nss
            return {
                "enabled": self._fair_enabled,
                "runnable_namespaces": len(runnable),
                "pass": dict(self._fair_pass),
                "weights": dict(self._fair_weights),
                "default_weight": self._fair_default_weight,
                "picks": self.stats["fair_picks"],
                "bypassed": self.stats["fair_bypassed"],
            }


class EvalWaveFeeder:
    """Wave-aligned front of `EvalBroker.dequeue` for a local worker
    pool.

    Whichever worker finds the shared buffer empty becomes the filler
    and drains a whole ready wave in ONE broker lock pass
    (`dequeue_batch`); its peers take from the buffered wave without
    touching the broker at all.  A burst of ready evals therefore
    reaches every scheduler at the same instant — instead of
    arrival-jittered single dequeues — so the PlacementEngine's
    dispatch coalescing sees full-wave batches end to end (broker wave
    -> scheduler pool -> one fused device dispatch).

    Buffered entries already hold their lease: the filler hands them to
    peers within one scheduling pass (the wave is bounded by the pool
    size), far inside the nack timeout, and `close()` nacks anything
    still buffered at teardown so shutdown never strands a lease.
    """

    def __init__(self, broker: EvalBroker, max_n: int = 48):
        self.broker = broker
        self.max_n = max(1, max_n)
        self._lock = threading.Condition()
        self._buf: Dict[tuple, deque] = {}
        self._filling: Set[tuple] = set()
        # wave_ns_max: peak count of DISTINCT namespaces in one wave —
        # the 2-D mesh's wave-lane parallelism feeds on exactly this
        # diversity (engine lane binning keys on the eval's namespace)
        self.stats = {"waves": 0, "wave_evals": 0, "max_wave": 0,
                      "wave_ns_max": 0}

    def get(self, schedulers: List[str], timeout: float = 0.1
            ) -> Optional[Tuple[Evaluation, str]]:
        key = tuple(schedulers)
        deadline = _time.time() + timeout
        with self._lock:
            while True:
                buf = self._buf.get(key)
                if buf:
                    return buf.popleft()
                if key not in self._filling:
                    self._filling.add(key)
                    break
                remaining = deadline - _time.time()
                if remaining <= 0:
                    return None
                self._lock.wait(min(remaining, 0.05))
        wave: List[Tuple[Evaluation, str]] = []
        try:
            wave = self.broker.dequeue_batch(
                list(key), self.max_n,
                timeout=max(0.0, deadline - _time.time()))
        finally:
            with self._lock:
                self._filling.discard(key)
                if len(wave) > 1:
                    self._buf.setdefault(key, deque()).extend(wave[1:])
                if wave:
                    self.stats["waves"] += 1
                    self.stats["wave_evals"] += len(wave)
                    self.stats["max_wave"] = max(self.stats["max_wave"],
                                                 len(wave))
                    self.stats["wave_ns_max"] = max(
                        self.stats["wave_ns_max"],
                        len({ev.namespace for ev, _ in wave}))
                self._lock.notify_all()
        return wave[0] if wave else None

    def close(self) -> None:
        """Nack every still-buffered lease (leadership loss / stop)."""
        with self._lock:
            bufs, self._buf = self._buf, {}
        for buf in bufs.values():
            for ev, token in buf:
                try:
                    self.broker.nack(ev.id, token)
                except Exception:                   # noqa: BLE001
                    pass
