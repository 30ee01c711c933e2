"""PlacementEngine: the batching dispatcher in front of the dense kernels.

Torch port of the reference's parallel/engine.py.
Scheduler workers block in `place()` / `place_bulk()`; one dispatcher
thread coalesces every request that arrived while the previous dispatch
was in flight into one chained kernel launch — K3 (`place_batch_packed`,
the slot scan chained over the eval axis) for scan requests, K4
(`place_bulk_batch`, the bulk wavefront chained over the eval axis) for
bulk requests — so a batch gives the same placements as sequential
processing and pays one host round trip per batch.

What stays on the device between dispatches:
- the world (`DeviceWorld`): capacity and usage basis, uploaded once per
  cluster epoch, then dirty-row scatters (K5);
- the per-eval heavy blocks, content-addressed in `_DeviceCache` (a hit
  ships zero bytes), and the stacked [E, 4N] chain of a bulk dispatch.

On CUDA every engine launch, upload and download runs on one stream the
engine owns; each dispatch records one event after its download, and
the resolve waits on that event.  Stream order is what keeps a later
scatter behind an earlier kernel, and what lets the overlap pipeline
(NOMAD_TPU_OVERLAP) hold one bulk dispatch in flight while the next one
is prepared.  With donation (NOMAD_TPU_DONATE) the bulk kernel writes
its exact carry into the loaned resident basis, which the world adopts.

An engine runs on one device: `get_engine(device)` keeps one per device,
and a caller passes the device it already holds, so a CPU scheduler gets
a CPU engine (on the plain versions) and nothing else ever does.

The serving mesh (parallel/sharded.py): when more than one device of the
engine's type is visible, or the engine was built with an explicit
`mesh_devices` list (which may repeat a device, e.g. `cuda:0` eight
times), dispatches whose node axis reaches `shard_min_nodes` and splits
over the mesh's node shards route over the ('node_shard', 'wave') mesh:
scan chains through `place_batch_sharded` (K7a/K7b), bulk parts through
`place_bulk_batch_sharded` (K7c-K7g) with requests binned into wave lanes
by `wave_key`, against a node-sharded world (K5').  NOMAD_TPU_SHARD=0
turns it off.  `install_engine` makes such an engine the one
`get_engine` (and so the scheduler and a `Server`) uses for its device.

Left out: the tracing spans.
"""
from __future__ import annotations

import atexit
import contextlib
import threading
import time as _time
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nomad_tpu_torch import knobs
from nomad_tpu_torch import native as _native
from nomad_tpu_torch.device import resolve_device
from nomad_tpu_torch.encode.matrixizer import NUM_RESOURCE_DIMS, pad_to_bucket
from nomad_tpu_torch.ops.place import (
    SPARSE_CAP,
    PlaceInputs,
    PlaceResult,
    bulk_heavy_digest,
    fill_grid_for,
    heavy_digest,
    heavy_dims,
    pack_bulk_heavy,
    pack_bulk_light,
    pack_heavy,
    pack_light,
    place_batch_packed,
    place_bulk_batch,
    unpack_bulk_batch,
    unpack_outputs,
)
from nomad_tpu_torch.parallel.sharded import (
    NODE_AXIS_NAME,
    SCAN_FIELDS,
    WAVE_AXIS_NAME,
    make_serving_mesh,
    mesh_key,
    place_batch_sharded,
    place_bulk_batch_sharded,
    put_bulk_lanes,
    put_scan_fields,
    visible_devices,
)
from nomad_tpu_torch.parallel.world import DeviceWorld, warm_scatter

# fixed sparse-delta slot count per eval; evals with more deltas fold
# them into a private basis copy and run alone
_DELTA_BUCKET = 64
# canonical slot-axis buckets: evals sharing a bucket batch together
_S_BUCKETS = (16, 128, 1024)


def _s_bucket(n: int) -> int:
    return next((b for b in _S_BUCKETS if b >= n), pad_to_bucket(n))


def _fold_overflow(basis: np.ndarray, deltas):
    """Apply an oversized delta list directly into a private basis copy.
    Returns the effective shipped delta list ([]): consumers must use it
    instead of the request's own deltas or the fold double-counts."""
    n = basis.shape[0]
    for row, vec in deltas:
        if row < n:
            basis[row] += vec
    return []


class _DeviceCache:
    """Content-addressed device-resident tensor cache (LRU).

    The G x N-scale placement tensors are identical across every eval of
    the same (job version, cluster epoch, alloc set), so a content
    fingerprint dedupes them and a hit ships zero bytes."""

    def __init__(self, device: torch.device, max_entries: int = 128):
        self.device = device
        self.max_entries = max_entries
        self._d: "OrderedDict" = OrderedDict()
        self._stacks: "OrderedDict" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def _get_or_put(self, key, build):
        """build() returns the host (numpy) value; a miss uploads it."""
        return self._get_or_put_device(
            key, lambda: torch.from_numpy(
                np.ascontiguousarray(build())).to(self.device))

    def _get_or_put_device(self, key, build_device):
        """build_device() returns the final device-resident value."""
        with self._lock:
            v = self._d.get(key)
            if v is not None:
                self._d.move_to_end(key)
                self.hits += 1
                return v
        arr = build_device()
        with self._lock:
            self._d[key] = arr
            self.misses += 1
            while len(self._d) > self.max_entries:
                self._d.popitem(last=False)
        return arr

    def sharded(self, tag, mesh, tree, place, key=None):
        """Content-addressed placement of host arrays on a mesh: a hit
        returns the device-resident shards with zero bytes shipped.
        `tree` may be a zero-arg callable, so a hit skips building the
        host arrays; `place(mesh, tree)` shards them.  `key` is a
        caller-computed content key; without it the arrays are hashed.
        Keyed on the mesh's grid (mesh_key), not on the object."""
        import hashlib
        build = tree if callable(tree) else (lambda: tree)
        if key is None:
            built = build()
            h = hashlib.blake2b(digest_size=16)
            for name in sorted(built):
                h.update(name.encode())
                h.update(np.ascontiguousarray(built[name]).tobytes())
            key = h.digest()
            build = lambda: built                # noqa: E731
        return self._get_or_put_device(("sh", tag, mesh_key(mesh), key),
                                       lambda: place(mesh, build()))

    def heavy(self, inputs: PlaceInputs) -> torch.Tensor:
        """Device-resident packed heavy block for one eval's inputs."""
        key = (heavy_dims(inputs), heavy_digest(inputs))
        return self._get_or_put(key, lambda: pack_heavy(inputs))

    def bulk_heavy(self, r, digest: Optional[bytes] = None) -> torch.Tensor:
        """Device-resident packed node-axis block of one bulk request."""
        if digest is None:
            digest = bulk_heavy_digest(r.feasible, r.affinity, r.penalty,
                                       r.coll0)
        key = ("bulk", r.feasible.shape[0], digest)
        return self._get_or_put(
            key, lambda: pack_bulk_heavy(r.feasible, r.affinity,
                                         r.penalty, r.coll0))

    def stack(self, key, build_device):
        """Device-resident stacked [E, ...] chain of a whole bulk
        dispatch, in its own short LRU."""
        with self._lock:
            v = self._stacks.get(key)
            if v is not None:
                self._stacks.move_to_end(key)
                self.hits += 1
                return v
        arr = build_device()
        with self._lock:
            self._stacks[key] = arr
            self.misses += 1
            while len(self._stacks) > 4:
                self._stacks.popitem(last=False)
        return arr


@dataclass
class _Request:
    cm: object                      # ClusterMatrix the inputs were built from
    inputs: PlaceInputs             # numpy-backed; .used already has deltas applied
    deltas: List[Tuple[int, np.ndarray]]   # (row, f32[R]) sparse usage deltas
    spread_algorithm: bool
    future: Future

    def shape_key(self):
        i = self.inputs
        # the slot axis pads to a canonical bucket at dispatch, so evals
        # sharing a bucket batch together regardless of raw slot count
        return (id(self.cm), self.spread_algorithm, i.feasible.shape,
                i.spread_vidx.shape, i.spread_desired.shape,
                _s_bucket(i.demand.shape[0]), i.demand.shape[1])


@dataclass
class _BulkRequest:
    """One wavefront bulk eval (many identical slots of one task group,
    spreads/distinct/ports/devices inactive) for the batched bulk kernel."""
    cm: object
    feasible: np.ndarray            # bool[N]
    affinity: np.ndarray            # f32[N]
    has_affinity: bool
    desired: int
    penalty: np.ndarray             # bool[N]
    coll0: np.ndarray               # i32[N] existing co-placements
    demand: np.ndarray              # f32[R]
    count: int
    deltas: List[Tuple[int, np.ndarray]]
    spread_algorithm: bool
    future: Future
    # wave-lane key on the 2-D mesh (the eval's namespace): requests
    # sharing it chain in one lane, distinct keys score concurrently
    wave_key: str = ""

    def shape_key(self):
        return ("bulk", id(self.cm), self.spread_algorithm,
                self.feasible.shape[0])


@dataclass
class _PendingBulk:
    """One in-flight bulk dispatch: its output is on its way to the
    host; _drain_record waits on `event`, then resolves it."""
    reqs: List
    out: object                     # host output(s) (pinned on CUDA)
    event: Optional[object]         # torch.cuda.Event after the download
    world: object                   # DeviceWorld the dispatch scored on
    deltas_per: List
    donated: bool
    t_dispatch: float
    mapping: Optional[List] = None  # sharded: each request's (lane, slot)


class PlacementEngine:
    """One per device.  Thread-safe; callers block in `place()`.

    In-flight usage overlay: the basis each dispatch starts from is
    `cm.used + overlay`, where the overlay sums the placements (and
    sticky pre-placement adds) of every eval whose plan has not yet
    committed.  Callers release their contribution via `complete(ticket)`
    once their plan has been applied or abandoned."""

    # eval-axis buckets: the kernels take any E, so these only set the
    # chunk caps (scan chains at E_BUCKETS[-1], bulk chains at the byte
    # budget's largest bucket), which bound memory
    E_BUCKETS = (1, 8, 16, 48)
    BULK_E_BUCKETS = (1, 8, 16, 48, 128, 512)

    def __init__(self, max_batch: int = 512, device=None,
                 shard_min_nodes: Optional[int] = None, mesh_devices=None):
        if mesh_devices is not None:
            mesh_devices = [resolve_device(d) for d in mesh_devices]
            if device is None:
                device = mesh_devices[0]
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        # the serving mesh: over `mesh_devices` when given, else over every
        # visible device of the engine's type (this one first); dispatches
        # shard when the node axis reaches shard_min_nodes (NOMAD_TPU_SHARD=0
        # disables, NOMAD_TPU_SHARD_MIN tunes)
        self._mesh_devices = mesh_devices
        self._serving_mesh = None
        self._mesh_checked = False
        if shard_min_nodes is None:
            shard_min_nodes = knobs.get_int("NOMAD_TPU_SHARD_MIN")
        self.shard_min_nodes = shard_min_nodes
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.max_batch = min(max_batch, self.BULK_E_BUCKETS[-1])
        self.scan_max_batch = self.E_BUCKETS[-1]
        # per-eval bulk heavy block is f32[4N]: cap the eval-axis chain so
        # one dispatch's stacked tensors stay under this byte budget
        self.bulk_bytes_budget = knobs.get_int("NOMAD_TPU_BULK_BYTES")
        # one device call per bulk wave (NOMAD_TPU_FUSE=0 splits by
        # output format and delta use)
        self.fuse = knobs.get_bool("NOMAD_TPU_FUSE")
        # donated-carry bulk dispatch: the resident basis is loaned to
        # the kernel and its exact carry adopted (world.loan/adopt)
        self.donate = knobs.get_bool("NOMAD_TPU_DONATE")
        # upload/compute overlap: hold ONE bulk dispatch in flight and
        # prepare the next against the adopted carry (requires donation)
        self.overlap = self.donate and knobs.get_bool("NOMAD_TPU_OVERLAP")
        self._pending: Optional[_PendingBulk] = None
        # (t0, t1) wall windows of in-flight device work and of host-side
        # dispatch preparation
        self.device_windows = deque(maxlen=8192)
        self.upload_windows = deque(maxlen=8192)
        self._queue: List = []
        self._cv = threading.Condition()
        self._stop = False
        self._overlay_lock = threading.Lock()
        # serializes device-requesting evals' basis-read -> placement ->
        # register windows
        self.bulk_gate = threading.RLock()
        self._overlays: Dict[int, np.ndarray] = {}   # id(cm) -> f32[N, R]
        # id(cm) -> {device gid -> i32[N] in-flight instance counts}
        self._dev_overlays: Dict[int, Dict[str, np.ndarray]] = {}
        self._tickets: Dict[int, tuple] = {}
        self._dev_tickets: Dict[int, tuple] = {}
        self._next_ticket = 1
        # called (outside locks) whenever the in-flight overlay drains
        self.on_drain = None
        self.stats = {"dispatches": 0, "batched_evals": 0, "single_evals": 0,
                      "max_batch_seen": 0, "tickets_open": 0,
                      "stack_s": 0.0, "put_s": 0.0, "device_s": 0.0,
                      "resolve_s": 0.0, "cache_hits": 0, "cache_misses": 0,
                      "bulk_evals": 0, "waves": 0, "max_waves_seen": 0,
                      # bulk wave groups and the device calls they took
                      "bulk_groups": 0, "bulk_parts": 0,
                      # dispatches whose basis was donated; the peak count
                      # of concurrently scoring mesh lanes, and the laned
                      # occupancy (evals shipped vs W x E lane slots)
                      "donated_carries": 0, "wave_lanes": 0,
                      "lane_evals": 0, "lane_slots": 0,
                      # evals dispatched over the serving mesh
                      "sharded_evals": 0,
                      # bulk dispatches issued while the previous one was
                      # still in flight
                      "overlap_chained": 0}
        self._cache = _DeviceCache(self.device)
        # device-resident worlds: (id(cm), N, mesh identity) -> DeviceWorld
        # (LRU)
        self._worlds: "OrderedDict[tuple, DeviceWorld]" = OrderedDict()
        self._worlds_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._run, name="placement-engine", daemon=True)
        self._thread.start()

    def _on_stream(self):
        """Context that makes the engine's stream current (CUDA)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _to_host(self, t):
        """Start the download of `t` (a tensor, or a tuple of them):
        (host tensor(s), event or None).  On CUDA the copies are
        asynchronous into pinned memory on the engine's stream, and the
        event marks their end."""
        if isinstance(t, tuple):
            if self._stream is None:
                return t, None
            hosts = tuple(self._to_host_one(x) for x in t)
        else:
            if self._stream is None:
                return t, None
            hosts = self._to_host_one(t)
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return hosts, ev

    @staticmethod
    def _to_host_one(t: torch.Tensor) -> torch.Tensor:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    @staticmethod
    def _wait(host, event):
        if event is not None:
            event.synchronize()
        if isinstance(host, tuple):
            return tuple(h.numpy() for h in host)
        return host.numpy()

    # ------------------------------------------------------------- public

    def _enqueue(self, reqs: List) -> None:
        with self._cv:
            if self._stop:
                raise RuntimeError("placement engine stopped")
            self._queue.extend(reqs)
            self._cv.notify()

    def place(self, cm, inputs: PlaceInputs,
              deltas: Optional[Sequence[Tuple[int, np.ndarray]]] = None,
              spread_algorithm: bool = False) -> Tuple[PlaceResult, int]:
        """Returns (result, ticket).  `inputs` are numpy-backed
        (DenseStack.build_host_inputs).  The caller must call
        `complete(ticket)` once the resulting plan has been submitted (or
        will never be), releasing its in-flight usage contribution."""
        req = _Request(cm=cm, inputs=inputs, deltas=list(deltas or ()),
                       spread_algorithm=spread_algorithm, future=Future())
        self._enqueue([req])
        return req.future.result()

    def _bulk_request(self, cm, *, feasible, affinity, has_affinity, desired,
                      penalty, coll0, demand, count, deltas=None,
                      spread_algorithm: bool = False,
                      wave_key: str = "") -> _BulkRequest:
        return _BulkRequest(
            cm=cm, feasible=np.asarray(feasible, bool),
            affinity=np.asarray(affinity, np.float32),
            has_affinity=bool(has_affinity), desired=int(desired),
            penalty=np.asarray(penalty, bool),
            coll0=np.asarray(coll0, np.int32),
            demand=np.asarray(demand, np.float32), count=int(count),
            deltas=list(deltas or ()), spread_algorithm=spread_algorithm,
            future=Future(), wave_key=str(wave_key))

    def place_bulk_begin(self, cm, **spec) -> Future:
        """Enqueue a bulk wavefront placement and return its Future
        (result tuple = place_bulk's).  `spec`: feasible, affinity,
        has_affinity, desired, penalty, coll0, demand, count and
        optionally deltas, spread_algorithm and wave_key (the eval's
        namespace: the request's lane on a 2-D mesh)."""
        return self.place_bulk_begin_many(cm, [spec])[0]

    def place_bulk_begin_many(self, cm, specs: Sequence[dict]) -> List[Future]:
        """place_bulk_begin for every group of one eval, enqueued together
        so the engine chains them into one dispatch (FIFO order and the
        resolve-before-next-dispatch discipline keep group g+1 scoring
        against group g's placements either way)."""
        reqs = [self._bulk_request(cm, **s) for s in specs]
        self._enqueue(reqs)
        return [r.future for r in reqs]

    def place_bulk(self, cm, **spec):
        """Wavefront bulk placement of `count` identical slots, batched
        with concurrent bulk evals into one chained dispatch.  Blocks;
        returns (assign i32[N], placed, nodes_evaluated, nodes_exhausted,
        scores f32[N], ticket).  The caller must `complete(ticket)` once
        the plan is submitted (ticket is None if nothing placed)."""
        return self.place_bulk_begin(cm, **spec).result()

    def warmup(self, cm, inputs: Optional[PlaceInputs] = None,
               bulk: Optional[dict] = None) -> None:
        """Build the kernels and run each dispatch path once before a
        measured window, so the window pays neither a build nor a first
        launch: a scan-path E=1 dispatch of `inputs` (numpy-backed), the
        bulk kernel in its sparse and dense formats with and without
        deltas for `bulk` (a place_bulk field dict), each against a
        throwaway world, and the row scatter's buckets.  Then the real
        world's epoch is uploaded, so the window's first dispatch pays a
        dirty-row diff.  Nothing registers in the overlay; stats are
        restored afterwards."""
        if self.device.type == "cuda":
            from nomad_tpu_torch.ops import _build
            _build.build_all()
        stats_before = dict(self.stats)
        cache_before = (self._cache.hits, self._cache.misses)
        mesh = self._mesh_for(cm.n_rows)
        with self._on_stream():
            if inputs is not None:
                r = _Request(cm=cm, inputs=inputs, deltas=[],
                             spread_algorithm=False, future=Future())
                if mesh is not None:
                    packed = self._dispatch_group_sharded([r], mesh)
                else:
                    packed = self._dispatch_packed(
                        [r], basis=np.asarray(inputs.used, np.float32),
                        deltas_per_req=[[]],
                        capacity=np.asarray(inputs.capacity),
                        world=DeviceWorld(device=self.device))
                self._wait(*self._to_host(packed))
            if bulk is not None:
                dummy = [(0, np.zeros(NUM_RESOURCE_DIMS, np.float32))]
                for count in (min(bulk["count"], SPARSE_CAP),
                              max(bulk["count"], SPARSE_CAP + 1)):
                    for deltas in ([], dummy):
                        spec = dict(bulk, count=count, deltas=deltas)
                        breqs = [self._bulk_request(cm, **spec)]
                        # a throwaway world: the donated carry must never
                        # land in the resident one
                        if mesh is not None:
                            out = self._dispatch_bulk_group_sharded(
                                breqs, mesh, world=DeviceWorld(mesh=mesh))[0]
                        else:
                            out = self._dispatch_bulk_group(
                                breqs, world=DeviceWorld(device=self.device))[0]
                        self._wait(*out)
            cap = np.asarray(cm.capacity)
            warm_scatter(cap.shape, self.device)
            if mesh is not None:
                warm_scatter(cap.shape, mesh=mesh)
            if bulk is not None:
                N = cm.n_rows
                self._world(cm, N, mesh).update(np.asarray(cm.capacity)[:N],
                                                self._basis_for(cm)[:N])
        self.stats.update(stats_before)
        self._cache.hits, self._cache.misses = cache_before

    def _overlay_for(self, cm) -> np.ndarray:
        """The in-flight overlay of `cm`, grown to its row count; caller
        holds _overlay_lock."""
        key = id(cm)
        overlay = self._overlays.get(key)
        n = cm.used.shape[0]
        if overlay is None or overlay.shape[0] < n:
            grown = np.zeros((n, NUM_RESOURCE_DIMS), np.float32)
            if overlay is not None:
                grown[:overlay.shape[0]] = overlay
            overlay = self._overlays[key] = grown
        return overlay

    def _new_ticket(self, key, contrib) -> int:
        """Record a ticket; caller holds _overlay_lock."""
        ticket = self._next_ticket
        self._next_ticket += 1
        self._tickets[ticket] = (key, contrib)
        self.stats["tickets_open"] = len(self._tickets)
        return ticket

    def register_external(self, cm, contributions) -> int:
        """Record usage scheduled outside the engine in the in-flight
        overlay so engine dispatches see it before the plan commits.
        `contributions`: [(row, f32[R])].  Returns a ticket."""
        with self._overlay_lock:
            overlay = self._overlay_for(cm)
            contribs = []
            for row, vec in contributions:
                if row < overlay.shape[0]:
                    vec = np.asarray(vec, np.float32)
                    overlay[row] += vec
                    contribs.append((row, vec))
            return self._new_ticket(id(cm), contribs)

    def register_external_sparse(self, cm, rows: np.ndarray,
                                 counts: np.ndarray,
                                 demand: np.ndarray) -> int:
        """register_external for a resolved bulk eval: overlay[rows[k]]
        += counts[k] * demand in one scatter; complete() reverses it with
        the same rank-1 scatter."""
        rows = np.ascontiguousarray(rows, np.int32)
        counts = np.ascontiguousarray(counts, np.int32)
        with self._overlay_lock:
            overlay = self._overlay_for(cm)
            keep = rows < overlay.shape[0]
            if not keep.all():
                rows, counts = rows[keep], counts[keep]
            d = np.zeros(overlay.shape[1], np.float32)
            d[:min(len(demand), len(d))] = \
                np.asarray(demand, np.float32)[:len(d)]
            _native.scatter_add_rank1(overlay, rows, counts, d)
            return self._new_ticket(id(cm), ("rank1", rows, counts, d))

    def basis_for(self, cm) -> np.ndarray:
        """Committed usage + in-flight overlay (a copy)."""
        return self._basis_for(cm)

    def register_devices(self, cm, contributions) -> int:
        """In-flight device instance counts: [(gid, row, count)]."""
        with self._overlay_lock:
            key = id(cm)
            per = self._dev_overlays.setdefault(key, {})
            n = cm.n_rows
            kept = []
            for gid, row, count in contributions:
                col = per.get(gid)
                if col is None or col.shape[0] < n:
                    grown = np.zeros(n, np.int32)
                    if col is not None:
                        grown[:col.shape[0]] = col
                    col = per[gid] = grown
                if row < col.shape[0]:
                    col[row] += count
                    kept.append((gid, row, count))
            ticket = self._next_ticket
            self._next_ticket += 1
            self._dev_tickets[ticket] = (key, kept)
        return ticket

    def device_overlay(self, cm, gid: str):
        """i32[N] in-flight instance counts for a device group, or None."""
        with self._overlay_lock:
            per = self._dev_overlays.get(id(cm))
            if not per:
                return None
            col = per.get(gid)
            return None if col is None else col.copy()

    def complete(self, ticket) -> None:
        """Release a placement's in-flight usage (its plan is now either
        committed or abandoned)."""
        if ticket is not None:
            self.complete_many((ticket,))

    def complete_many(self, tickets) -> None:
        """complete() for a whole batch of tickets under one lock
        acquisition (idempotent per ticket)."""
        drained = False
        with self._overlay_lock:
            for ticket in tickets:
                if ticket is None:
                    continue
                dev_entry = self._dev_tickets.pop(ticket, None)
                if dev_entry is not None:
                    key, contribs = dev_entry
                    per = self._dev_overlays.get(key, {})
                    for gid, row, count in contribs:
                        col = per.get(gid)
                        if col is not None and row < col.shape[0]:
                            col[row] -= count
                    if not self._dev_tickets:
                        self._dev_overlays.clear()
                        drained = drained or not self._tickets
                    continue
                entry = self._tickets.pop(ticket, None)
                if entry is None:
                    continue
                cm_key, contrib = entry
                overlay = self._overlays.get(cm_key)
                if overlay is not None:
                    if isinstance(contrib, tuple) and contrib[0] == "rank1":
                        _, rows, counts, d = contrib
                        keep = rows < overlay.shape[0]
                        _native.scatter_add_rank1(
                            overlay, rows[keep], -counts[keep],
                            d[:overlay.shape[1]])
                    else:
                        for row, vec in contrib:
                            if row < overlay.shape[0]:
                                overlay[row] -= vec
                self.stats["tickets_open"] = len(self._tickets)
                if not self._tickets:
                    # nothing in flight: drop overlays so numerical
                    # residue never accumulates
                    self._overlays.clear()
                    drained = drained or not self._dev_tickets
        if drained and self.on_drain is not None:
            try:
                self.on_drain()
            except Exception:                   # noqa: BLE001
                pass

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=5.0)

    # ------------------------------------------------------------- overlay

    def _world(self, cm, N: int, mesh=None) -> DeviceWorld:
        """The device-resident world for (matrix, padded node axis, mesh),
        node-sharded over the mesh when there is one; LRU over stale
        matrix epochs."""
        key = (id(cm), N, mesh_key(mesh))
        with self._worlds_lock:
            w = self._worlds.get(key)
            if w is None:
                w = self._worlds[key] = DeviceWorld(mesh=mesh,
                                                    device=self.device)
            self._worlds.move_to_end(key)
            while len(self._worlds) > 4:
                self._worlds.popitem(last=False)
            return w

    def world_stats(self) -> Dict[str, int]:
        """DeviceWorld.stats summed over every resident world."""
        agg: Dict[str, int] = {}
        with self._worlds_lock:
            worlds = list(self._worlds.values())
        for w in worlds:
            with w.lock:
                for k, v in w.stats.items():
                    agg[k] = agg.get(k, 0) + int(v)
        return agg

    def _basis_for(self, cm) -> np.ndarray:
        """cm.used + in-flight overlay (copy), the committed matrix read
        under its owner's lock if it has one."""
        cm_lock = getattr(cm, "lock", None) or contextlib.nullcontext()
        with self._overlay_lock:
            with cm_lock:
                used = np.array(cm.used, dtype=np.float32)
            overlay = self._overlays.get(id(cm))
            if overlay is not None:
                n = min(overlay.shape[0], used.shape[0])
                used[:n] += overlay[:n]
            return used

    def _register(self, req: _Request, result: PlaceResult) -> Optional[int]:
        """Record an eval's in-flight usage contribution; returns ticket
        (None when nothing was placed)."""
        contrib: List[Tuple[int, np.ndarray]] = []
        S = req.inputs.demand.shape[0]
        for si in range(S):
            row = int(result.node[si])
            if row >= 0:
                contrib.append((row, req.inputs.demand[si]))
        for row, vec in req.deltas:
            if vec.max(initial=0.0) > 0.0 and (vec >= 0.0).all():
                contrib.append((row, vec))    # sticky pre-placement adds
        if not contrib:
            return None
        with self._overlay_lock:
            overlay = self._overlay_for(req.cm)
            for row, vec in contrib:
                if row < overlay.shape[0]:
                    overlay[row] += vec
            return self._new_ticket(id(req.cm), contrib)

    # ------------------------------------------------------------- loop

    def _run(self) -> None:
        # torch's current stream is per thread: set the engine's here
        with self._on_stream():
            while True:
                with self._cv:
                    while not self._queue and not self._stop \
                            and self._pending is None:
                        self._cv.wait()
                    if self._stop and not self._queue:
                        break
                    batch, self._queue = (self._queue[:self.max_batch],
                                          self._queue[self.max_batch:])
                if not batch:
                    # idle with a bulk dispatch in flight: fetch + resolve
                    self._drain_pending()
                    continue
                try:
                    self._dispatch(batch)
                except Exception as e:          # noqa: BLE001
                    self._drain_pending()
                    for r in batch:
                        if not r.future.done():
                            r.future.set_exception(e)
            # stop: settle any in-flight dispatch so its futures resolve
            self._drain_pending()

    # ------------------------------------------------------------- dispatch

    def _dispatch(self, batch: List) -> None:
        groups: Dict[tuple, List] = {}
        for r in batch:
            groups.setdefault(r.shape_key(), []).append(r)
        self.stats["dispatches"] += 1
        self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"],
                                           len(batch))
        # groups resolve sequentially: each group's results register in
        # the overlay before the next group's basis is read
        with self._on_stream():
            for reqs in groups.values():
                try:
                    self._dispatch_one_group(reqs)
                except Exception as e:          # noqa: BLE001
                    for r in reqs:
                        if not r.future.done():
                            r.future.set_exception(e)

    def _dispatch_one_group(self, reqs: List) -> None:
        if isinstance(reqs[0], _BulkRequest):
            cm = reqs[0].cm
            N = reqs[0].feasible.shape[0]
            mesh = self._mesh_for(N)
            world = self._world(cm, N, mesh)
            lanes = mesh.shape[WAVE_AXIS_NAME] if mesh is not None else 1
            expected_shape = ((N, cm.capacity.shape[1]),
                              (N, cm.used.shape[1]))
            parts = 0
            for part in self._split_bulk(reqs, sharded=mesh is not None,
                                         lanes=lanes):
                parts += 1
                # chaining behind an in-flight dispatch is sound only when
                # this part scores against the same world via the adopted
                # donated carry and update() can proceed by scatter
                chained = (self.overlap and self.donate
                           and self._pending is not None
                           and self._pending.world is world
                           and self._pending.donated
                           and world.shape == expected_shape)
                if self._pending is not None and not chained:
                    self._drain_pending()
                tp0 = _time.time()
                if mesh is not None:
                    (out, ev), _w, dper, mapping, donated = \
                        self._dispatch_bulk_group_sharded(
                            part, mesh, world=world, force_scatter=chained)
                else:
                    (out, ev), _w, dper, donated = self._dispatch_bulk_group(
                        part, world=world, force_scatter=chained)
                    mapping = None
                tp1 = _time.time()
                self.upload_windows.append((tp0, tp1))
                if chained:
                    self.stats["overlap_chained"] += 1
                prev, self._pending = self._pending, _PendingBulk(
                    reqs=part, out=out, event=ev, world=world,
                    deltas_per=dper, donated=donated, t_dispatch=tp1,
                    mapping=mapping)
                if prev is not None:
                    self._drain_record(prev)
                if not (self.overlap and donated):
                    self._drain_pending()
            self.stats["bulk_groups"] += 1
            self.stats["bulk_parts"] += parts
            self.stats["bulk_evals"] += len(reqs)
            return

        # scan-path groups resolve against the overlay basis: a pending
        # bulk dispatch must land before this group's basis read
        self._drain_pending()
        rebucketed = (reqs[0].cm.capacity.shape[0]
                      != reqs[0].inputs.capacity.shape[0])
        mesh = None if rebucketed else \
            self._mesh_for(reqs[0].inputs.capacity.shape[0])
        # evals whose delta list exceeds the fixed bucket run alone with
        # the deltas folded into a private basis (on a mesh, sharded)
        overflow = [r for r in reqs if len(r.deltas) > _DELTA_BUCKET]
        if overflow:
            reqs = [r for r in reqs if len(r.deltas) <= _DELTA_BUCKET]
            for r in overflow:
                if mesh is not None:
                    packed = self._dispatch_group_sharded([r], mesh,
                                                          fold_deltas=True)
                    self._fetch_resolve_scan([r], packed)
                else:
                    self._run_single(r)
            self.stats["single_evals"] += len(overflow)
            if not reqs:
                return
        if mesh is None and (len(reqs) == 1 or rebucketed):
            # single path also when the matrix has grown since these
            # inputs were built
            for r in reqs:
                self._run_single(r)
            self.stats["single_evals"] += len(reqs)
            return
        # scan chains cap at their own bucket; chunks chain through the
        # overlay between dispatches
        for i in range(0, len(reqs), self.scan_max_batch):
            chunk = reqs[i:i + self.scan_max_batch]
            if mesh is not None:
                packed = self._dispatch_group_sharded(chunk, mesh)
            else:
                packed = self._dispatch_group(chunk)
            self.stats["batched_evals"] += len(chunk)
            self._fetch_resolve_scan(chunk, packed)

    def _drain_pending(self) -> None:
        """Fetch + resolve the in-flight bulk dispatch, if any."""
        p, self._pending = self._pending, None
        if p is not None:
            self._drain_record(p)

    def _drain_record(self, p: _PendingBulk) -> None:
        t0 = _time.time()
        try:
            fetched = self._wait(p.out, p.event)
        except Exception as e:                  # noqa: BLE001
            if p.donated and p.world is not None:
                # the adopted carry is suspect: the next update()
                # re-uploads from the host snapshot
                p.world.invalidate_basis()
            for r in p.reqs:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        t1 = _time.time()
        self.stats["device_s"] += t1 - t0
        self.device_windows.append((p.t_dispatch, t1))
        t0 = _time.time()
        try:
            self._resolve_bulk(p.reqs, fetched, p.world, p.deltas_per,
                               mapping=p.mapping, donated=p.donated)
        except Exception as e:                  # noqa: BLE001
            for r in p.reqs:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        self.stats["resolve_s"] += _time.time() - t0
        if len(p.reqs) > 1:
            self.stats["batched_evals"] += len(p.reqs)
        else:
            self.stats["single_evals"] += 1

    def _fetch_resolve_scan(self, reqs: List[_Request], packed) -> None:
        t0 = _time.time()
        fetched = self._wait(*self._to_host(packed))
        t1 = _time.time()
        self.stats["device_s"] += t1 - t0
        self.device_windows.append((t0, t1))
        t0 = _time.time()
        node, score, fit_s, n_eval, n_exh, top_n, top_s = \
            unpack_outputs(fetched)
        for i, r in enumerate(reqs):
            res = PlaceResult(
                node=node[i], score=score[i], fit_score=fit_s[i],
                nodes_evaluated=n_eval[i], nodes_exhausted=n_exh[i],
                top_nodes=top_n[i], top_scores=top_s[i], used=None)
            ticket = self._register(r, res)
            r.future.set_result((res, ticket))
        self.stats["resolve_s"] += _time.time() - t0

    # ------------------------------------------------------- sharded path

    def _mesh_for(self, N: int):
        """The ('node_shard', 'wave') serving mesh when sharding applies to
        this node axis, else None."""
        if not knobs.get_bool("NOMAD_TPU_SHARD"):
            return None
        if not self._mesh_checked:
            devices = self._mesh_devices
            if devices is None:
                others = [d for d in visible_devices(self.device.type)
                          if d != self.device]
                devices = [self.device] + others
            if len(devices) > 1:
                self._serving_mesh = make_serving_mesh(devices)
            self._mesh_checked = True
        mesh = self._serving_mesh
        if mesh is None or N < self.shard_min_nodes:
            return None
        # the node axis splits over 'node_shard' only; a shard needs >= 2
        # rows (the wave's local top-2)
        n_shard = mesh.shape[NODE_AXIS_NAME]
        if N % n_shard != 0 or N < 2 * n_shard:
            return None
        return mesh

    # per-eval PlaceInputs fields shipped to the sharded scan kernels
    _SHARD_FIELDS = SCAN_FIELDS

    @staticmethod
    def _stack_deltas(deltas_per_req, E: int, N: int):
        D = _DELTA_BUCKET
        drows = np.full((E, D), N, np.int32)
        dvals = np.zeros((E, D, NUM_RESOURCE_DIMS), np.float32)
        for i, ds in enumerate(deltas_per_req):
            for d, (row, vec) in enumerate(ds[:D]):
                drows[i, d] = row
                dvals[i, d] = vec
        return drows, dvals

    def _dispatch_group_sharded(self, reqs: List[_Request], mesh,
                                fold_deltas: bool = False) -> torch.Tensor:
        """Scan-path dispatch over the node-sharded serving mesh: one
        chained `place_batch_sharded` of the group.  `fold_deltas`
        (overflow singletons only) folds the request's oversized delta
        list into the basis copy.  Returns the device-side packed output
        f32[E, S, 5 + 2*TOP_K]."""
        cm = reqs[0].cm
        N = reqs[0].inputs.capacity.shape[0]
        E = len(reqs)
        S = _s_bucket(reqs[0].inputs.demand.shape[0])
        t0 = _time.time()
        fields = {}
        for f in self._SHARD_FIELDS:
            arrs = [np.asarray(getattr(r.inputs, f)) for r in reqs]
            if f in ("demand", "slot_tg", "slot_active"):
                # slot axis padded to the canonical bucket (pads inactive)
                arrs = [np.concatenate(
                    [a, np.zeros((S - a.shape[0],) + a.shape[1:], a.dtype)])
                    if a.shape[0] < S else a for a in arrs]
            fields[f] = np.stack(arrs)
        basis = self._basis_for(cm)
        deltas_per = [r.deltas for r in reqs]
        if fold_deltas:
            deltas_per = [_fold_overflow(basis, reqs[0].deltas)]
        drows, dvals = self._stack_deltas(deltas_per, E, N)
        self.stats["stack_s"] += _time.time() - t0
        t0 = _time.time()
        # content-addressed shards: identical job-state batches ship zero
        # bytes; basis and deltas always ship (they change every dispatch)
        fields_dev = self._cache.sharded("scan", mesh, fields,
                                         put_scan_fields)
        t1 = _time.time()
        cap_dev, basis_dev = self._world(cm, N, mesh).update(cm.capacity,
                                                            basis)
        self.stats["put_basis_s"] = self.stats.get("put_basis_s", 0.0) \
            + (_time.time() - t1)
        packed, _used = place_batch_sharded(
            mesh, cap_dev, basis_dev, fields_dev, drows, dvals,
            spread_algorithm=reqs[0].spread_algorithm)
        self.stats["put_s"] += _time.time() - t0
        self.stats["sharded_evals"] += len(reqs)
        return packed

    @staticmethod
    def _lane_bins(reqs: List[_BulkRequest], W: int):
        """Deterministic wave-lane binning: distinct wave_keys spread
        round-robin over the W lanes in sorted-key order; requests sharing
        a key stay in one lane, so their chain is untouched.  Returns (W
        per-lane request lists, mapping[i] = (lane, slot) per input
        order).  One distinct key (or W == 1) gives one active lane."""
        keys = sorted({r.wave_key for r in reqs})
        if W <= 1 or len(keys) <= 1:
            bins = [list(reqs)] + [[] for _ in range(max(0, W - 1))]
            return bins, [(0, i) for i in range(len(reqs))]
        lane_of = {k: i % W for i, k in enumerate(keys)}
        bins: List[List[_BulkRequest]] = [[] for _ in range(W)]
        mapping = []
        for r in reqs:
            lane = lane_of[r.wave_key]
            mapping.append((lane, len(bins[lane])))
            bins[lane].append(r)
        return bins, mapping

    def _dispatch_bulk_group_sharded(self, reqs: List[_BulkRequest], mesh,
                                     world=None, donate=None,
                                     force_scatter: bool = False):
        """One bulk part -> one laned `place_bulk_batch_sharded` over the
        mesh.  Returns ((host outputs, event), world, shipped deltas per
        request, lane mapping, donated?)."""
        cm = reqs[0].cm
        N = reqs[0].feasible.shape[0]
        donate = self.donate if donate is None else donate
        W = mesh.shape[WAVE_AXIS_NAME]
        capacity = cm.capacity[:N]
        basis = self._basis_for(cm)[:N]
        deltas_per = [r.deltas for r in reqs]
        if len(reqs) == 1 and len(reqs[0].deltas) > _DELTA_BUCKET:
            deltas_per = [_fold_overflow(basis, reqs[0].deltas)]
            bins = [[reqs[0]]] + [[] for _ in range(W - 1)]
            mapping = [(0, 0)]
            deltas_bins = [deltas_per] + [[] for _ in range(W - 1)]
        else:
            bins, mapping = self._lane_bins(reqs, W)
            dp = {id(r): d for r, d in zip(reqs, deltas_per)}
            deltas_bins = [[dp[id(r)] for r in b] for b in bins]
        # the lane eval extent: the fullest lane (shorter lanes pad with
        # count-0 evals, which end inside their first launch)
        E = max(len(b) for b in bins)
        self.stats["wave_lanes"] = max(self.stats["wave_lanes"],
                                       sum(1 for b in bins if b))
        self.stats["lane_evals"] += len(reqs)
        self.stats["lane_slots"] += W * E

        t0 = _time.time()
        r00 = reqs[0]
        digs = tuple(tuple(
            bulk_heavy_digest(r.feasible, r.affinity, r.penalty, r.coll0)
            for r in b) for b in bins)
        meta = tuple(tuple(
            (np.asarray(r.demand, np.float32).tobytes(), bool(r.has_affinity),
             int(r.desired)) for r in b) for b in bins)

        def build_stacks():
            def lane_stack(get, dt, pad=None):
                rows = []
                for b in bins:
                    fill = b[0] if b else r00
                    lane = [np.asarray(get(r), dt) for r in b]
                    pad_a = np.asarray(get(fill), dt) if pad is None \
                        else np.asarray(pad, dt)
                    lane += [pad_a] * (E - len(b))
                    rows.append(np.stack(lane))
                return np.stack(rows)
            return dict(
                feasible=lane_stack(lambda r: r.feasible, bool),
                affinity=lane_stack(lambda r: r.affinity, np.float32),
                penalty=lane_stack(lambda r: r.penalty, bool),
                coll0=lane_stack(lambda r: r.coll0, np.int32),
                demand=lane_stack(lambda r: r.demand, np.float32),
                has_affinity=lane_stack(lambda r: r.has_affinity, bool,
                                        False),
                desired=lane_stack(lambda r: r.desired, np.int32, 1))

        # pads have count 0: their wavefront ends at once
        cnt = np.stack([np.array([r.count for r in b] + [0] * (E - len(b)),
                                 np.int32) for b in bins])
        lane_d = [self._stack_deltas(list(db) + [[]] * (E - len(db)), E, N)
                  for db in deltas_bins]
        drows = np.stack([d[0] for d in lane_d])
        dvals = np.stack([d[1] for d in lane_d])
        self.stats["stack_s"] += _time.time() - t0
        t0 = _time.time()
        st = self._cache.sharded("bulk", mesh, build_stacks, put_bulk_lanes,
                                 key=("bulkstack", N, W, E, digs, meta))
        self.stats["put_heavy_s"] = self.stats.get("put_heavy_s", 0.0) \
            + (_time.time() - t0)
        t1 = _time.time()
        world = world if world is not None else self._world(cm, N, mesh)
        cap_dev, basis_dev = world.update(capacity, basis,
                                          force_scatter=force_scatter)
        if donate:
            loaned = world.loan_basis()
            if loaned is not None:
                basis_dev = loaned
            else:
                donate = False
        self.stats["put_basis_s"] = self.stats.get("put_basis_s", 0.0) \
            + (_time.time() - t1)
        t1 = _time.time()
        assign, scores, placed, n_eval, n_exh, waves, used_tot = \
            place_bulk_batch_sharded(
                mesh, cap_dev, basis_dev, st["feasible"], st["affinity"],
                st["has_affinity"], st["desired"], st["penalty"],
                st["coll0"], st["demand"], cnt, drows, dvals,
                spread_algorithm=reqs[0].spread_algorithm,
                fill_grid=fill_grid_for(max(r.count for r in reqs)),
                donate=donate)
        if donate:
            # the merged basis u0 + psum_wave(exact - u0), written into
            # the loaned shards, is the new resident basis
            world.adopt_basis(used_tot)
            self.stats["donated_carries"] += 1
        counts = torch.stack([placed, n_eval, n_exh, waves], dim=-1)
        out = self._to_host((assign, scores, counts))
        self.stats["put_kernel_s"] = self.stats.get("put_kernel_s", 0.0) \
            + (_time.time() - t1)
        self.stats["put_s"] += _time.time() - t0
        self.stats["sharded_evals"] += len(reqs)
        return out, world, deltas_per, mapping, donate

    # ---------------------------------------------------------- bulk path

    def _split_bulk(self, reqs: List[_BulkRequest], sharded: bool = False,
                    lanes: int = 1):
        # oversized-delta requests go alone so their deltas can fold into
        # the part's private basis copy
        overflow = [r for r in reqs if len(r.deltas) > _DELTA_BUCKET]
        rest = [r for r in reqs if len(r.deltas) <= _DELTA_BUCKET]
        for r in overflow:
            yield [r]
        chunk = self._bulk_chunk(reqs[0].feasible.shape[0], lanes)
        if self.fuse or sharded:
            # the whole wave is one device call (modulo the byte budget);
            # the sharded kernels have one format, so they always fuse
            for i in range(0, len(rest), chunk):
                yield rest[i:i + chunk]
            return
        # NOMAD_TPU_FUSE=0: split by output format and delta use
        fits_s0, fits_s, fits_d = [], [], []
        for r in rest:
            if r.count <= SPARSE_CAP:
                (fits_s0 if not r.deltas else fits_s).append(r)
            else:
                fits_d.append(r)
        for fits in (fits_s0, fits_s, fits_d):
            for i in range(0, len(fits), chunk):
                yield fits[i:i + chunk]

    def _bulk_chunk(self, N: int, lanes: int = 1) -> int:
        """Largest bulk E bucket whose stacked per-eval heavy blocks
        (f32[4N] each) fit the NOMAD_TPU_BULK_BYTES budget; on a laned
        mesh the stacks are [W, E, ...], so the budget divides by W."""
        cap = max(1, self.bulk_bytes_budget // (4 * N * 4 * max(1, lanes)))
        allowed = [b for b in self.BULK_E_BUCKETS if b <= cap]
        return min(self.max_batch, allowed[-1] if allowed else 1)

    def _dispatch_bulk_group(self, reqs: List[_BulkRequest], world=None,
                             force_scatter: bool = False):
        """One bulk part -> one K4 launch.  Returns ((host packed, event),
        world, shipped deltas per request, donated?)."""
        cm = reqs[0].cm
        N = reqs[0].feasible.shape[0]
        donate = self.donate
        E = len(reqs)
        # rows are stable across matrix re-bucketing (growth only pads
        # the node axis), so the enqueue-time world is the prefix slice
        capacity = cm.capacity[:N]
        basis = self._basis_for(cm)[:N]
        deltas_per = [r.deltas for r in reqs]
        if len(reqs) == 1 and len(reqs[0].deltas) > _DELTA_BUCKET:
            deltas_per = [_fold_overflow(basis, reqs[0].deltas)]
        D = _DELTA_BUCKET if any(deltas_per) else 0

        t0 = _time.time()
        dyn = np.concatenate([
            pack_bulk_light(r.has_affinity, r.desired, r.count, r.demand,
                            ds, N, D)
            for r, ds in zip(reqs, deltas_per)])
        self.stats["stack_s"] += _time.time() - t0
        t0 = _time.time()
        world = world if world is not None else self._world(cm, N)
        cap_dev, used_dev = world.update(capacity, basis,
                                         force_scatter=force_scatter)
        if donate:
            loaned = world.loan_basis()
            if loaned is not None:
                used_dev = loaned
            else:
                donate = False
        self.stats["put_basis_s"] = self.stats.get("put_basis_s", 0.0) \
            + (_time.time() - t0)
        t1 = _time.time()
        digs = tuple(bulk_heavy_digest(r.feasible, r.affinity, r.penalty,
                                       r.coll0) for r in reqs)
        heavy = [self._cache.bulk_heavy(r, dig)
                 for r, dig in zip(reqs, digs)]
        # the stacked [E, 4N] chain is itself content-addressed
        hstack = self._cache.stack(("hstack", N, E, digs),
                                   lambda: torch.stack(heavy))
        self.stats["put_heavy_s"] = self.stats.get("put_heavy_s", 0.0) \
            + (_time.time() - t1)
        self.stats["cache_hits"] = self._cache.hits
        self.stats["cache_misses"] = self._cache.misses
        t1 = _time.time()
        dyn_dev = self._put(dyn)
        sparse = all(r.count <= SPARSE_CAP for r in reqs)
        fill_grid = fill_grid_for(max(r.count for r in reqs))
        if donate:
            # exact_out: the adopted basis is the rank-1 reconstruction
            # (bitwise what apply_rank1 would have scattered), written
            # into the loaned buffer; the chain carry keeps scoring parity
            packed, _used_final, used_exact = place_bulk_batch(
                cap_dev, used_dev, hstack, dyn_dev, D, sparse_out=sparse,
                spread_algorithm=reqs[0].spread_algorithm,
                fill_grid=fill_grid, exact_out=True)
            world.adopt_basis(used_exact)
            self.stats["donated_carries"] += 1
        else:
            packed, _used_final = place_bulk_batch(
                cap_dev, used_dev, hstack, dyn_dev, D, sparse_out=sparse,
                spread_algorithm=reqs[0].spread_algorithm,
                fill_grid=fill_grid)
        out = self._to_host(packed)
        self.stats["put_kernel_s"] = self.stats.get("put_kernel_s", 0.0) \
            + (_time.time() - t1)
        self.stats["put_s"] += _time.time() - t0
        return out, world, deltas_per, donate

    def _resolve_bulk(self, reqs: List[_BulkRequest], packed, world,
                      deltas_per, mapping=None, donated: bool = False) -> None:
        """Register each eval's placements in the overlay and hand them to
        the world (apply_rank1, or on the donated path apply_rank1_host:
        the adopted carry already holds them on the device), so the next
        dispatch's update() diff is clean.  `deltas_per` is what the
        dispatch actually shipped per eval.  A sharded dispatch's output
        is (assign [W, E, N], scores [W, E, N], counts [W, E, 4]) and
        `mapping` gives each request's (lane, slot) in it."""
        N = reqs[0].feasible.shape[0]
        if isinstance(packed, tuple):
            assign, scores, counts = packed
            lane = np.array([ln for ln, _ in mapping])
            slot = np.array([sl for _, sl in mapping])
            assign, scores = assign[lane, slot], scores[lane, slot]
            placed, n_eval, n_exh, waves = counts[lane, slot].T
        else:
            sparse = all(r.count <= SPARSE_CAP for r in reqs)
            assign, scores, placed, n_eval, n_exh, waves = \
                unpack_bulk_batch(packed, N, sparse=sparse)
        self.stats["waves"] += int(np.sum(waves))
        self.stats["max_waves_seen"] = max(self.stats["max_waves_seen"],
                                           int(np.max(waves, initial=0)))
        for i, r in enumerate(reqs):
            rows = np.flatnonzero(assign[i])
            ticket = self.register_external_sparse(
                r.cm, rows, assign[i][rows], r.demand) \
                if rows.size else None
            if ticket is not None and world is not None:
                if donated:
                    world.apply_rank1_host(rows, assign[i][rows], r.demand)
                else:
                    world.apply_rank1(rows, assign[i][rows], r.demand)
            r.future.set_result(
                (assign[i], int(placed[i]), int(n_eval[i]),
                 int(n_exh[i]), scores[i], ticket))

    # ---------------------------------------------------------- scan path

    def _run_single(self, r: _Request) -> None:
        """Lone request: an E=1 chain through the same device cache,
        scored against the in-flight overlay basis."""
        try:
            if r.cm.used.shape[0] == r.inputs.used.shape[0]:
                basis = self._basis_for(r.cm)
                deltas = r.deltas
                cap_src = r.cm.capacity
                if len(deltas) > _DELTA_BUCKET:
                    deltas = _fold_overflow(basis, deltas)
            else:
                # matrix re-bucketed since the inputs were built:
                # inputs.used already carries the deltas
                basis = np.asarray(r.inputs.used, np.float32)
                deltas = []
                cap_src = r.inputs.capacity
            packed = self._dispatch_packed(
                [r], basis=basis, deltas_per_req=[deltas], capacity=cap_src)
            node, score, fit_s, n_eval, n_exh, top_n, top_s = \
                unpack_outputs(self._wait(*self._to_host(packed)))
            res = PlaceResult(
                node=node[0], score=score[0], fit_score=fit_s[0],
                nodes_evaluated=n_eval[0], nodes_exhausted=n_exh[0],
                top_nodes=top_n[0], top_scores=top_s[0], used=None)
            ticket = self._register(r, res)
            r.future.set_result((res, ticket))
        except Exception as e:                  # noqa: BLE001
            r.future.set_exception(e)

    def _dispatch_group(self, reqs: List[_Request]) -> torch.Tensor:
        """One shape group -> one K3 launch against the overlay basis."""
        cm = reqs[0].cm
        return self._dispatch_packed(
            reqs, basis=self._basis_for(cm),
            deltas_per_req=[r.deltas for r in reqs], capacity=cm.capacity)

    def _dispatch_packed(self, reqs: List[_Request], basis: np.ndarray,
                         deltas_per_req, capacity: np.ndarray,
                         world: Optional[DeviceWorld] = None) -> torch.Tensor:
        """Heavy blocks resolve through the device cache (hits ship
        nothing) and stack on the device; light blocks ship as one
        buffer; the basis syncs through the resident world.  Returns the
        device-side packed output f32[E, S, 5 + 2*TOP_K]."""
        i0 = reqs[0].inputs
        G, N, K, Vp1 = heavy_dims(i0)
        S = _s_bucket(i0.demand.shape[0])
        D = _DELTA_BUCKET

        t0 = _time.time()
        dyn = np.concatenate([pack_light(r.inputs, d, D, S)
                              for r, d in zip(reqs, deltas_per_req)])
        basis = np.ascontiguousarray(basis, dtype=np.float32)
        self.stats["stack_s"] += _time.time() - t0
        t0 = _time.time()
        world = world if world is not None \
            else self._world(reqs[0].cm, basis.shape[0])
        cap_dev, used_dev = world.update(capacity, basis)
        heavy = torch.stack([self._cache.heavy(r.inputs) for r in reqs])
        self.stats["cache_hits"] = self._cache.hits
        self.stats["cache_misses"] = self._cache.misses
        packed, _used_final = place_batch_packed(
            cap_dev, used_dev, heavy, self._put(dyn), (G, N, K, Vp1, S, D),
            spread_algorithm=reqs[0].spread_algorithm)
        self.stats["put_s"] += _time.time() - t0
        return packed


_engines: Dict[torch.device, PlacementEngine] = {}
_engines_lock = threading.Lock()


def get_engine(device=None) -> Optional[PlacementEngine]:
    """The engine of `device` (default "cuda"; raises where there is no
    card), one per device; None when NOMAD_TPU_ENGINE=0."""
    if not knobs.get_bool("NOMAD_TPU_ENGINE"):
        return None
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _engines_lock:
        eng = _engines.get(dev)
        if eng is None or eng._stop:
            eng = _engines[dev] = PlacementEngine(device=dev)
        return eng


def install_engine(engine: PlacementEngine) -> PlacementEngine:
    """Make `engine` the one `get_engine` returns for its device, until it
    stops: how the scheduler and a `Server(device=...)` get an engine
    built with an explicit device list (`PlacementEngine(mesh_devices=
    ...)`, e.g. one card repeated as a serving mesh).  An engine already
    kept for that device is stopped."""
    with _engines_lock:
        old = _engines.get(engine.device)
        _engines[engine.device] = engine
    if old is not None and old is not engine:
        old.stop()
    return engine


def stop_engines() -> None:
    """Stop every engine get_engine made (tests, end of a run)."""
    with _engines_lock:
        engines = list(_engines.values())
        _engines.clear()
    for eng in engines:
        eng.stop()


# a dispatcher thread still alive when the interpreter finalizes can
# abort the process ("terminate called without an active exception"):
# join them first
atexit.register(stop_engines)
