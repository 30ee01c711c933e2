"""CSI volume watcher (reference nomad/volumewatcher/volumes_watcher.go +
volume_watcher.go): a leader-side control loop that releases volume
claims as their allocations terminate, so blocked single-writer volumes
become schedulable again without operator action.

The reference runs one goroutine per volume fed by blocking queries; here
one thread drains a queue fed by the store's watch hook (alloc and volume
table changes both trigger a sweep of the affected volume)."""
from __future__ import annotations

import logging
import threading
from typing import List, Optional

from nomad_tpu_torch.raft.fsm import MessageType
from nomad_tpu_torch.structs import csi as csistructs

log = logging.getLogger(__name__)


class VolumeWatcher:
    def __init__(self, server):
        self.server = server
        self._queue: List[object] = []     # volumes to (re)check
        self._cv = threading.Condition()
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        server.store.watch(self.watch_state)

    # ------------------------------------------------------------- wiring

    def watch_state(self, table: str, obj) -> None:
        if self._stop is None or self._stop.is_set():
            return
        if table == "csi_volumes":
            self._enqueue(obj)
        elif table == "allocs" and obj.terminal_status():
            # find volumes claimed by this alloc
            store = self.server.store
            with store._lock:
                vols = [v for v in store._csi_volumes.values()
                        if obj.id in v.read_claims
                        or obj.id in v.write_claims]
            for v in vols:
                self._enqueue(v)

    def _enqueue(self, vol) -> None:
        with self._cv:
            self._queue.append(vol)
            self._cv.notify()

    def start(self) -> None:
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="volume-watcher", daemon=True)
        self._thread.start()
        # initial sweep: claims whose allocs died while there was no leader
        for vol in self.server.store.csi_volumes():
            self._enqueue(vol)

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        with self._cv:
            self._cv.notify()
        if self._thread is not None:
            self._thread.join(60.0)
            self._thread = None

    # ------------------------------------------------------------- loop

    def _run(self) -> None:
        stop = self._stop
        while not stop.is_set():
            with self._cv:
                while not self._queue and not stop.is_set():
                    self._cv.wait(timeout=0.5)
                vols, self._queue = self._queue, []
            seen = set()
            for vol in vols:
                key = (vol.namespace, vol.id)
                if key in seen:
                    continue
                seen.add(key)
                try:
                    self._reap(vol)
                except Exception:               # noqa: BLE001
                    log.exception("volume watcher: reap %s failed", vol.id)

    def _reap(self, vol) -> None:
        """volumeReapImpl: release claims held by terminal or vanished
        allocations (volume_watcher.go)."""
        store = self.server.store
        fresh = store.csi_volume_by_id(vol.namespace, vol.id)
        if fresh is None:
            return
        for alloc_id in list(fresh.read_claims) + list(fresh.write_claims):
            alloc = store.alloc_by_id(alloc_id)
            if alloc is None or alloc.terminal_status():
                claim = fresh.read_claims.get(alloc_id) or \
                    fresh.write_claims.get(alloc_id)
                self.server.apply(MessageType.CSI_VOLUME_CLAIM, {
                    "namespace": fresh.namespace,
                    "volume_id": fresh.id,
                    "claim": csistructs.CSIVolumeClaim(
                        alloc_id=alloc_id,
                        node_id=claim.node_id if claim else "",
                        mode=claim.mode if claim else csistructs.CLAIM_READ,
                        state=csistructs.CLAIM_STATE_READY_TO_FREE),
                })
                # capacity change: a blocked single-writer job can go again
                self.server.blocked_evals.unblock_all(store.latest_index)
