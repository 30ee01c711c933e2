"""Event broker (reference: nomad/stream/event_broker.go:30 — pub/sub of
state-change events with per-topic filtering over a bounded ring buffer;
surfaced at /v1/event/stream as NDJSON; the port has no HTTP stream
yet, ROADMAP A8).

Backpressure model (reference stream/subscription.go): every subscriber
queue is bounded.  A consumer that stops draining hits the high-water
mark, its backlog is evicted in one shot, and the subscription falls
back to *catch-up mode*: the consumer re-reads the retained ring from
the last sequence number it actually consumed, then flips back to live
delivery once the ring is drained.  Events that age out of the ring
before a laggard catches up are permanently lost to it (at-most-once),
but broker memory stays bounded no matter how slow any consumer is.

Sequence numbers are broker-assigned and strictly monotonic per broker —
raft indexes cannot play this role because one plan apply emits many
events at a single index.  Dedup between live delivery and ring replay
keys on seq.

Knobs: ``NOMAD_TPU_SUB_QUEUE`` (per-subscriber queue bound, default
1024), ``NOMAD_TPU_EVENT_BUFFER`` (retained ring size, default 256).
"""
from __future__ import annotations

import threading
import time as _time
from collections import deque
from typing import Dict, List, Optional

from nomad_tpu_torch import knobs
from nomad_tpu_torch.telemetry import global_metrics


def _default_sub_queue() -> int:
    return max(2, knobs.get_int("NOMAD_TPU_SUB_QUEUE"))


def _default_buffer() -> int:
    return max(8, knobs.get_int("NOMAD_TPU_EVENT_BUFFER"))


class Event:
    __slots__ = ("topic", "type", "key", "namespace", "index", "payload",
                 "time", "seq")

    def __init__(self, topic: str, type_: str, key: str, namespace: str,
                 index: int, payload, seq: int = 0):
        self.topic = topic
        self.type = type_
        self.key = key
        self.namespace = namespace
        self.index = index
        self.payload = payload
        self.time = _time.time()
        self.seq = seq          # broker-assigned at publish; 0 = unpublished

    def to_dict(self) -> dict:
        return {"Topic": self.topic, "Type": self.type, "Key": self.key,
                "Namespace": self.namespace, "Index": self.index,
                "Payload": self.payload}


class Subscription:
    # queue + drop accounting are touched from the publisher, the
    # consumer, and the broker's catch-up replay — all under `cv`

    def __init__(self, broker: "EventBroker",
                 topics: Dict[str, List[str]], from_index: int = 0,
                 max_queue: Optional[int] = None):
        # NOTE: constructed by EventBroker.subscribe while holding
        # broker._lock, so replay + registration are atomic w.r.t. publish
        self.broker = broker
        self.topics = topics      # topic -> keys ("*" wildcard)
        self.from_index = from_index
        self.cv = threading.Condition()
        self.queue: deque = deque()
        self.max_queue = max_queue if max_queue else _default_sub_queue()
        self.closed = False
        # last_seq: last seq actually handed to the consumer.  _seen_seq:
        # highest seq queued-or-consumed in live mode (dedup vs replay);
        # reset to last_seq on eviction since the backlog was discarded.
        self.last_seq = 0
        self._seen_seq = 0
        self.delivered = 0
        self.dropped = 0          # evicted from the queue at the HWM
        self.evictions = 0        # HWM trips
        self.catching_up = False
        for ev in broker._buffer:
            if ev.index > from_index and self.matches(ev):
                if len(self.queue) >= self.max_queue:
                    # huge ring + small queue: start life in catch-up
                    self.catching_up = True
                    break
                self.queue.append(ev)
                self._seen_seq = ev.seq

    def matches(self, ev: Event) -> bool:
        for topic, keys in self.topics.items():
            if topic not in ("*", ev.topic):
                continue
            if "*" in keys or ev.key in keys or not keys:
                return True
        return False

    def deliver(self, ev: Event) -> None:
        with self.cv:
            if self.closed:
                return
            if self.catching_up:
                # the ring replay in next() covers this event; queueing it
                # here too would duplicate or reorder
                self.cv.notify_all()
                return
            if ev.seq <= self._seen_seq:
                return            # already seen via ring replay
            if len(self.queue) >= self.max_queue:
                # high-water mark: evict the whole backlog and fall back
                # to catch-up-from-ring — a stalled consumer costs
                # bounded memory, never an unbounded deque
                self.dropped += len(self.queue)
                self.evictions += 1
                global_metrics.incr("stream.dropped", len(self.queue))
                global_metrics.incr("stream.evictions")
                self.queue.clear()
                self.catching_up = True
                self._seen_seq = self.last_seq
                self.cv.notify_all()
                return
            self.queue.append(ev)
            self._seen_seq = ev.seq
            self.cv.notify_all()

    def next(self, timeout: float = 1.0) -> Optional[Event]:
        deadline = _time.monotonic() + timeout
        while True:
            with self.cv:
                if self.queue:
                    ev = self.queue.popleft()
                    self.last_seq = max(self.last_seq, ev.seq)
                    self.delivered += 1
                    return ev
                if self.closed:
                    return None
                if not self.catching_up:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        return None
                    self.cv.wait(remaining)
                    continue
                after = self.last_seq
            # catch-up pull runs outside cv: lock order is strictly
            # broker._lock -> sub.cv, never the reverse
            if self.broker.replay_from(self, after) == 0 \
                    and _time.monotonic() >= deadline:
                return None

    def lag(self) -> int:
        """Events published that this subscriber has not consumed."""
        with self.broker._lock:
            seq = self.broker._seq
        with self.cv:
            return max(0, seq - self.last_seq - len(self.queue))

    def close(self) -> None:
        with self.cv:
            self.closed = True
            self.cv.notify_all()
        self.broker.unsubscribe(self)


class EventBroker:
    """Bounded ring buffer + fan-out to bounded subscriptions."""

    def __init__(self, buffer_size: Optional[int] = None):
        self._lock = threading.Lock()
        self._buffer: deque = deque(maxlen=buffer_size or _default_buffer())
        self._subs: List[Subscription] = []
        self._seq = 0             # monotonic publish sequence (per broker)

    def publish(self, events: List[Event]) -> None:
        with self._lock:
            for ev in events:
                self._seq += 1
                ev.seq = self._seq
                self._buffer.append(ev)
            subs = list(self._subs)
        for sub in subs:
            for ev in events:
                if sub.matches(ev):
                    sub.deliver(ev)

    def subscribe(self, topics: Dict[str, List[str]],
                  from_index: int = 0,
                  max_queue: Optional[int] = None) -> Subscription:
        with self._lock:
            sub = Subscription(self, topics, from_index, max_queue)
            self._subs.append(sub)
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

    def replay_from(self, sub: Subscription, after_seq: int) -> int:
        """Catch-up pull: queue retained events newer than `after_seq`
        that match `sub`, up to its queue bound.  Flipping back to live
        mode happens here, under the broker lock, so no event published
        concurrently can fall between the ring and the live queue."""
        with self._lock:
            out = []
            for ev in self._buffer:
                if ev.seq > after_seq and ev.index > sub.from_index \
                        and sub.matches(ev):
                    out.append(ev)
                    if len(out) >= sub.max_queue:
                        break
            with sub.cv:
                if sub.closed:
                    return 0
                for ev in out:
                    sub.queue.append(ev)
                    sub._seen_seq = max(sub._seen_seq, ev.seq)
                if len(out) < sub.max_queue:
                    sub.catching_up = False   # ring drained: back to live
                sub.cv.notify_all()
        return len(out)

    def stats(self) -> dict:
        """Per-subscriber lag/drop telemetry (surfaced in bench + tests)."""
        with self._lock:
            subs = list(self._subs)
            seq = self._seq
        per_sub = []
        for sub in subs:
            with sub.cv:
                per_sub.append({
                    "queue_len": len(sub.queue),
                    "max_queue": sub.max_queue,
                    "delivered": sub.delivered,
                    "dropped": sub.dropped,
                    "evictions": sub.evictions,
                    "catching_up": sub.catching_up,
                    "lag": max(0, seq - sub.last_seq - len(sub.queue)),
                })
        return {"published": seq, "subscribers": len(per_sub),
                "subs": per_sub}

    # ------------------------------------------------------- state bridge

    def watch_state(self, table: str, obj) -> None:
        """StateStore watcher: convert writes to stream events (reference:
        state store event publishing into the broker)."""
        topic_map = {
            "nodes": ("Node", lambda o: (o.id, "")),
            "jobs": ("Job", lambda o: (o.id, o.namespace)),
            "jobs_deregistered": ("Job", lambda o: (o.id, o.namespace)),
            "evals": ("Evaluation", lambda o: (o.id, o.namespace)),
            "allocs": ("Allocation", lambda o: (o.id, o.namespace)),
            "deployments": ("Deployment", lambda o: (o.id, o.namespace)),
        }
        entry = topic_map.get(table)
        if entry is None:
            return
        topic, keyfn = entry
        key, ns = keyfn(obj)
        type_ = {"jobs": "JobRegistered",
                 "jobs_deregistered": "JobDeregistered",
                 "nodes": "NodeRegistration",
                 "evals": "EvaluationUpdated",
                 "allocs": "AllocationUpdated",
                 "deployments": "DeploymentStatusUpdate"}[table]
        self.publish([Event(topic, type_, key, ns,
                            getattr(obj, "modify_index", 0), obj)])
