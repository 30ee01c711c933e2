"""Node heartbeating (reference: nomad/heartbeat.go — nodeHeartbeater:34,
resetHeartbeatTimer, invalidateHeartbeat:135, disconnectState:177).

Each node has a TTL; a missed TTL transitions the node to `down` — or to
`disconnected` when any alloc on it uses max_client_disconnect — and
triggers evaluations for every affected job.

Fleet scale: TTLs live in a hashed timing wheel (one bucket per tick,
enough buckets that a full TTL fits in one rotation), so re-arming a
node is O(1) remove+insert and a 10K-agent fleet heartbeating every
interval never grows a stale-tuple backlog the way a lazy-deletion heap
does.  The status/liveness writes those heartbeats imply coalesce
through HeartbeatBatcher into ONE NodeHeartbeatBatch raft entry per
flush tick — the node-plane analogue of the plan applier's
APPLY_PLAN_RESULTS batching — so steady-state heartbeat cost is
O(batches), not O(nodes), log entries.

`HeartbeatTracker.expire(now)` and `HeartbeatBatcher.flush()` are the
loops' bodies, callable with a given clock.  `stop()` waits up to 60 s
for a loop's thread: it wakes on its stop event at once, and only a
write already under way delays it.
"""
from __future__ import annotations

import logging
import threading
import time as _time
from typing import Dict, List, Optional, Set, Tuple

from nomad_tpu_torch import knobs
from nomad_tpu_torch.structs.node import NodeStatus
from nomad_tpu_torch.telemetry import global_metrics

log = logging.getLogger(__name__)


class HeartbeatTracker:
    def __init__(self, server, ttl: float = 10.0, tick: float = 0.1):
        self.server = server
        self.ttl = ttl
        self.tick = tick
        self._lock = threading.Lock()
        # wheel geometry: one bucket per tick; a deadline at most
        # ttl+retry ahead always lands within a single rotation
        self._span = max(tick, 0.001)
        self._nslots = max(8, int(ttl / self._span) + 4)
        self._slots: list = [set() for _ in range(self._nslots)]
        self._where: Dict[str, Tuple[int, float]] = {}
        self._cursor = _time.time()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        with self._lock:
            # fresh per leadership tenure: deadlines armed under a
            # PREVIOUS tenure must not expire nodes out of this one —
            # the new leader re-arms every live node right after start()
            # (initializeHeartbeatTimers), and anything it does not
            # re-arm is by definition not its to expire
            self._slots = [set() for _ in range(self._nslots)]
            self._where.clear()
            self._cursor = _time.time()
        self._stop = threading.Event()   # fresh per leadership tenure
        self._thread = threading.Thread(target=self._run, name="heartbeat",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(60.0)

    def heartbeat(self, node_id: str) -> float:
        """Reset the node's TTL (Node.UpdateStatus/heartbeat RPC path).
        Returns the TTL so clients know their deadline."""
        return self.heartbeat_many([node_id])

    def heartbeat_many(self, node_ids) -> float:
        """`heartbeat` for a chunk of nodes in one lock pass."""
        deadline = _time.time() + self.ttl
        with self._lock:
            for node_id in node_ids:
                self._arm_locked(node_id, deadline)
        return self.ttl

    def _arm_locked(self, node_id: str, deadline: float) -> None:
        old = self._where.get(node_id)
        if old is not None:
            self._slots[old[0]].discard(node_id)
        slot = int(deadline / self._span) % self._nslots
        self._slots[slot].add(node_id)
        self._where[node_id] = (slot, deadline)

    def untrack(self, node_id: str) -> None:
        with self._lock:
            old = self._where.pop(node_id, None)
            if old is not None:
                self._slots[old[0]].discard(node_id)

    def tracked(self) -> int:
        """Number of armed TTLs (bench/telemetry)."""
        with self._lock:
            return len(self._where)

    def _run(self) -> None:
        while not self._stop.is_set():
            self.expire(_time.time())
            self._stop.wait(self.tick)

    def expire(self, now: float) -> List[str]:
        """Invalidate every node whose deadline is at or before `now`
        (one turn of the wheel, the loop's body); returns their ids."""
        expired = []
        with self._lock:
            start = int(self._cursor / self._span)
            end = int(now / self._span)
            if end - start >= self._nslots:
                # clock jumped past a full rotation: one pass over
                # every physical bucket covers all of it
                start = end - self._nslots + 1
            for b in range(start, end + 1):
                slot = self._slots[b % self._nslots]
                for node_id in list(slot):
                    _, deadline = self._where[node_id]
                    if deadline <= now:
                        slot.discard(node_id)
                        del self._where[node_id]
                        expired.append(node_id)
                    # else: re-armed into this bucket's next
                    # rotation — its own turn will catch it
            self._cursor = now
        for node_id in expired:
            try:
                self._invalidate(node_id)
            except Exception:           # noqa: BLE001
                # a failed write must not kill the heartbeat loop for
                # the whole tenure
                log.exception("invalidate")
                # the node was already dropped from the wheel; without
                # a retry deadline it would stay tracked-as-alive
                # forever despite the missed TTL.  Re-arm a short one
                # (unless the node re-heartbeated meanwhile).
                retry = _time.time() + min(self.ttl, 1.0)
                with self._lock:
                    if node_id not in self._where:
                        self._arm_locked(node_id, retry)
        return expired

    def _invalidate(self, node_id: str) -> None:
        """Missed TTL (reference invalidateHeartbeat + disconnectState)."""
        server = self.server
        node = server.store.node_by_id(node_id)
        if node is None or node.status == NodeStatus.DOWN:
            return
        # disconnected iff any alloc on the node tolerates disconnects
        new_status = NodeStatus.DOWN
        for a in server.store.allocs_by_node(node_id):
            if a.terminal_status() or a.job is None:
                continue
            tg = a.job.lookup_task_group(a.task_group)
            if tg is not None and tg.max_client_disconnect_s is not None:
                new_status = NodeStatus.DISCONNECTED
                break
        # a churn storm expires nodes in waves: ride the batcher (one
        # raft entry per flush) instead of one entry per expiry
        batcher = getattr(server, "heartbeat_batch", None)
        if batcher is not None and batcher.running:
            batcher.note(node_id, new_status)
        else:
            server.update_node_status(node_id, new_status)


class HeartbeatBatcher:
    """Leader-side coalescer for heartbeat-driven FSM writes.

    Revivals (down/disconnected node heartbeats again), TTL expirations
    and periodic liveness stamps collect in a pending table keyed by
    node and flush as ONE NodeHeartbeatBatch log entry per tick, with
    node evals created only for real status transitions.  Liveness
    stamps are rate-limited to one per node per half-TTL — fresh enough
    that a failed-over leader re-arms timers off recent stamps, cheap
    enough that a 10K-agent fleet costs O(batches) log entries per
    tick.  `updated_at` is stamped here, at propose time: the FSM never
    reads the clock."""

    def __init__(self, server, interval: float = 0.05):
        self.server = server
        self.interval = interval
        self._lock = threading.Lock()
        self._pending: Dict[str, Tuple[str, float]] = {}
        self._transitions: Set[str] = set()
        self._last_stamp: Dict[str, float] = {}
        # device/attribute re-fingerprint deltas (Node.UpdateFingerprint):
        # coalesce per node, flush as ONE NodeFingerprintBatch entry —
        # a 1K-node fingerprint storm commits O(flush-ticks) raft
        # entries, not O(changes) full Node.Register round-trips
        self._fp_pending: Dict[str, dict] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # bounded pending table: at the cap the writer forces a flush
        # instead of growing without limit — a churn storm must cost
        # O(cap) memory, not O(storm)
        self.pending_max = max(1, knobs.get_int(
            "NOMAD_TPU_HB_PENDING_MAX"))
        self._force = threading.Event()

    def start(self) -> None:
        with self._lock:
            self._pending.clear()
            self._transitions.clear()
            self._last_stamp.clear()
            self._fp_pending.clear()
        self._stop = threading.Event()   # fresh per leadership tenure
        self._force = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="heartbeat-batch", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._force.set()               # wake the flusher promptly
        if self._thread:
            self._thread.join(60.0)
        with self._lock:
            # a deposed leader's queued writes die with its tenure; the
            # successor's own expiry/revival pass re-derives them (a
            # dropped fingerprint delta re-sends on the client's next
            # fingerprint pass or full re-register)
            self._pending.clear()
            self._transitions.clear()
            self._fp_pending.clear()

    @property
    def running(self) -> bool:
        return (self._thread is not None and self._thread.is_alive()
                and not self._stop.is_set())

    def note(self, node_id: str, status: str) -> None:
        """Queue a status TRANSITION (revival, expiry) for the next
        flush; the flush creates the node's evals."""
        with self._lock:
            self._pending[node_id] = (status, _time.time())
            self._transitions.add(node_id)
            full = len(self._pending) >= self.pending_max
        if full:
            # never applies raft from the writer's thread (FSM watcher
            # re-entry): just wake the flusher out of its tick sleep
            self._force.set()

    def stamp_many(self, stamps) -> None:
        """Queue liveness stamps, (node_id, status) pairs (same status,
        fresh updated_at), at most one per node per half-TTL, in one
        lock pass."""
        now = _time.time()
        half = self.server.config.heartbeat_ttl / 2.0
        full = False
        with self._lock:
            for node_id, status in stamps:
                if now - self._last_stamp.get(node_id, 0.0) < half:
                    continue
                self._last_stamp[node_id] = now
                if node_id not in self._pending:
                    self._pending[node_id] = (status, now)
            full = len(self._pending) >= self.pending_max
        if full:
            self._force.set()

    def note_fingerprint(self, node_id: str, update: dict) -> None:
        """Queue a device/attribute re-fingerprint delta for the next
        flush (newest delta per node wins — the client sends its full
        current device list, so deltas are self-superseding)."""
        with self._lock:
            u = self._fp_pending.setdefault(node_id,
                                            {"node_id": node_id})
            u.update(update)
            full = len(self._fp_pending) >= self.pending_max
        if full:
            self._force.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            forced = self._force.wait(self.interval)
            if self._stop.is_set():
                break
            if forced:
                self._force.clear()
                global_metrics.incr("heartbeat.batch_forced")
            try:
                self.flush()
            except Exception:               # noqa: BLE001
                # a dev-mode server has no leadership to lose mid-flush,
                # so a failed flush is a fault: its transitions' node
                # evals are lost with it
                log.exception("heartbeat batch flush failed")

    def flush(self) -> None:
        """Drain the pending table into one batched FSM entry, then
        create the node evals of every status transition in it."""
        with self._lock:
            if not self._pending and not self._fp_pending:
                return
            pending = self._pending
            transitions = self._transitions
            fp_pending = self._fp_pending
            self._pending = {}
            self._transitions = set()
            self._fp_pending = {}
        from nomad_tpu_torch.raft.fsm import MessageType
        if pending:
            self.server.apply(MessageType.NODE_HEARTBEAT_BATCH, {
                "updates": [{"node_id": nid, "status": st,
                             "updated_at": ts}
                            for nid, (st, ts) in pending.items()]})
            global_metrics.incr("heartbeat.batch_flush")
            global_metrics.incr("heartbeat.batch_nodes",
                                float(len(pending)))
        if fp_pending:
            self.server.apply(MessageType.NODE_FINGERPRINT_BATCH, {
                "updates": list(fp_pending.values())})
            global_metrics.incr("heartbeat.fingerprint_flush")
            global_metrics.incr("heartbeat.fingerprint_nodes",
                                float(len(fp_pending)))
        for nid in transitions:
            self.server.create_node_evals(nid)
