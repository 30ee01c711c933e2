"""Device-resident world state: the node x resource matrices live on the
device across dispatches, and changes scatter in as row deltas.

Torch port of the reference's parallel/world.py.

`DeviceWorld` keeps one (capacity, basis) pair resident per cluster
epoch; an epoch is a shape pair, so the matrix growing starts a new
epoch with one full upload, while routine churn and plan commits flow in
as bucketed dirty-row scatters:

- `update(capacity, basis)` diffs both matrices against the host
  snapshot shipped last time and scatters only the changed rows (padded
  to a ROW_BUCKET with pad rows = N, which the scatter drops; >25% churn
  or a shape change falls back to one full upload).
- `apply_rank1(rows, counts, demand)` lands the same rank-1 update in
  the host snapshot (native.scatter_add_rank1) and in the device basis
  (the add_rank1 kernel) in one call, so the next update()'s diff sees
  those rows clean.
- `loan_basis()` / `adopt_basis()` hand the resident basis to a
  donating kernel and install what it leaves (the exact carry, written
  into the same buffer); `invalidate_basis()` forgets a suspect one.

On a serving mesh (`DeviceWorld(mesh=...)`) each matrix lives as a list
of node-shard tensors, shard i (rows [i*n, (i+1)*n)) on the mesh's
device (i, 0); each shard scatters with its row offset (K5',
`set_rows_local` / `add_rank1_local`, the reference's
`serving_update_fns`), so it writes only the rows it owns.

The scatters (K5, K5') are one hand-written CUDA kernel pair
(csrc/world_scatter.cu) that takes a table of segments, with plain
PyTorch versions beside it.  A world update stages everything it
scatters on one card (both matrices' dirty rows, every shard's) in one
buffer, uploads it without blocking and launches once on that card.
Both update the resident tensor in place: every use of it is ordered on
the engine's one stream, so a kernel that read the old rows has
finished before a scatter rewrites them.
"""
from __future__ import annotations

import struct
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from nomad_tpu_torch import native as _native
from nomad_tpu_torch.device import resolve_device
from nomad_tpu_torch.ops import _build
from nomad_tpu_torch.ops.place import _on_card, _stream

# dirty-row buckets of the row scatter
ROW_BUCKETS = (64, 512, 4096)
# resources a world row holds (the kernel moves a row as one float4)
R = 4
# segments one launch takes (csrc/world_scatter.cu MAX_SEGS); a call
# with more launches once per MAX_SEGMENTS
MAX_SEGMENTS = 32
# byte alignment of every part of a staged operand buffer, and of the
# destinations and values the kernel reads as float4
ALIGN = 16

# kernel launches per wrapper (the plain versions never count); the
# *_local names are the sharded world's (K5')
launches = {"set_rows": 0, "add_rank1": 0, "set_rows_local": 0,
            "add_rank1_local": 0}
# staged operand buffers per name, on every device: one a card a world
# update or rank-1 apply touches
staged = dict.fromkeys(launches, 0)

_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32}
# the C entry points, (set_rows_launch, add_rank1_launch), taken once
_entries: list = []


def _live_rows(d: torch.Tensor, rows: torch.Tensor,
               row_offset: int = 0) -> torch.Tensor:
    """Indices k of rows[k] inside [off, off + N) (pad rows and other
    shards' rows drop); asserts the kept rows are unique, which is what
    lets the kernel skip atomics."""
    N = d.shape[0]
    local = rows - row_offset
    keep = torch.nonzero((local >= 0) & (local < N)).flatten()
    live = rows[keep]
    if torch.unique(live).numel() != live.numel():
        raise ValueError("world scatter: rows must be unique")
    return keep


def set_rows_plain(d: torch.Tensor, rows: torch.Tensor,
                   vals: torch.Tensor, row_offset: int = 0,
                   olds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of set_rows: d[rows - off] = vals in place, rows
    outside [off, off + N) dropped (`d.at[r].set(v, mode="drop")`, and on
    a shard `_set_rows_local`).  With `olds` (f32[B, R], the rows' old
    host values) each row becomes vals + (d - olds): what the device row
    holds beyond the host snapshot stays.  Returns d."""
    keep = _live_rows(d, rows, row_offset)
    r = rows[keep].long() - row_offset
    d[r] = vals[keep] if olds is None else vals[keep] + (d[r] - olds[keep])
    return d


def add_rank1_plain(d: torch.Tensor, rows: torch.Tensor,
                    counts: torch.Tensor, dem: torch.Tensor,
                    row_offset: int = 0) -> torch.Tensor:
    """Plain version of add_rank1: d[rows[k] - off] += f32(counts[k]) *
    dem in place, rows outside [off, off + N) dropped.  The product is
    rounded before the add, as native.scatter_add_rank1 does.  Returns
    d."""
    keep = _live_rows(d, rows, row_offset)
    r = rows[keep].long() - row_offset
    inc = counts[keep].to(torch.float32)[:, None] * dem
    d[r] = d[r] + inc
    return d


def scatter_segments_plain(name: str, segs) -> None:
    """Plain version of scatter_segments: each segment in order through
    set_rows_plain, or add_rank1_plain for the add_rank1* names."""
    add = name.startswith("add")
    for d, off, rows, *ops in segs:
        if add:
            add_rank1_plain(d, rows, *ops, off)
        else:
            set_rows_plain(d, rows, ops[0], off, *ops[1:])


_F32, _I32 = torch.float32, torch.int32
_ROW_STRIDES = (R, 1)           # a contiguous f32[n, R] (or [B, R])
_DEM_SHAPE = (R,)
_pack_record = struct.Struct("9q").pack


def _rows_of(v: torch.Tensor, B: int, dev: int) -> bool:
    """v is a contiguous f32[B, R] on device index `dev`."""
    return v.dtype is _F32 and v.stride() == _ROW_STRIDES \
        and v.shape == (B, R) and v.get_device() == dev


def _record(name: str, seg, add: bool, dev: int) -> bytes:
    """One segment's launch record (csrc/world_scatter.cu `fill`: d, rows,
    vals, olds, counts, dem, B, n, off), checked: raises on anything the
    kernel does not take.  `dev` is the first destination's
    get_device(); each check is one attribute read, since the wrapper's
    host time is most of what a launch costs."""
    if len(seg) != 5 and (add or len(seg) != 4):
        raise ValueError(f"{name}: a segment is (d, off, rows, counts, dem)"
                         if add else f"{name}: a segment is (d, off, rows, "
                         f"vals[, olds])")
    d, rows, x = seg[0], seg[2], seg[3]
    if d.dtype is not _F32 or d.stride() != _ROW_STRIDES \
            or d.shape[1] != R:
        raise ValueError(f"{name}: destination must be contiguous "
                         f"f32[N, {R}]")
    if rows.dtype is not _I32 or rows.stride() != (1,):
        raise ValueError(f"{name}: rows must be contiguous i32[B]")
    B = rows.shape[0]
    pd = d.data_ptr()
    if add:
        dem = seg[4]
        if x.dtype is not _I32 or x.shape != (B,) or x.stride() != (1,) \
                or dem.dtype is not _F32 or dem.shape != _DEM_SHAPE \
                or dem.stride() != (1,):
            raise ValueError(f"{name}: counts must be i32[B], dem f32[R]")
        if d.get_device() != dev or rows.get_device() != dev \
                or x.get_device() != dev or dem.get_device() != dev:
            raise ValueError(f"{name}: segments on more than one device")
        if pd % ALIGN:
            raise ValueError(f"{name}: destination must be {ALIGN}-byte "
                             f"aligned")
        return _pack_record(pd, rows.data_ptr(), 0, 0, x.data_ptr(),
                            dem.data_ptr(), B, d.shape[0], seg[1])
    if not _rows_of(x, B, dev):
        raise ValueError(f"{name}: vals must be contiguous f32[B, R] on "
                         f"the destination's device")
    if d.get_device() != dev or rows.get_device() != dev:
        raise ValueError(f"{name}: segments on more than one device")
    pv, po = x.data_ptr(), 0
    if len(seg) == 5:
        if not _rows_of(seg[4], B, dev):
            raise ValueError(f"{name}: olds must be contiguous f32[B, R] "
                             f"on the destination's device")
        po = seg[4].data_ptr()
    if (pd | pv | po) % ALIGN:
        raise ValueError(f"{name}: destination and values must be "
                         f"{ALIGN}-byte aligned")
    return _pack_record(pd, rows.data_ptr(), pv, po, 0, 0, B, d.shape[0],
                        seg[1])


def scatter_segments(name: str, segs) -> None:
    """K5/K5' (csrc/world_scatter.cu): every segment of `segs`, all on one
    device, in one launch (one per MAX_SEGMENTS), in place.  A segment is
    (d, off, rows, vals[, olds]) for the set_rows* names or (d, off,
    rows, counts, dem) for the add_rank1* names: d f32[n, 4] holds global
    rows [off, off + n), rows i32[B] (pad rows and rows outside d drop),
    vals and olds f32[B, 4] (see set_rows_plain), counts i32[B], dem
    f32[4].  `name` is the launch counter.
    CUDA tensors launch the kernel; CPU tensors take
    scatter_segments_plain."""
    add = name.startswith("add")
    if not segs:
        raise ValueError(f"{name}: no segments")
    d0 = segs[0][0]
    dev = d0.get_device()
    recs = [_record(name, seg, add, dev) for seg in segs]
    if not d0.is_cuda:
        if d0.device.type != "cpu":
            raise ValueError(f"{name}: unsupported device {d0.device}")
        scatter_segments_plain(name, segs)
        return
    if not _entries:
        lib = _build.load("world_scatter")
        _entries[:] = [lib.set_rows_launch, lib.add_rank1_launch]
    fn = _entries[add]
    stream = _stream(dev)
    for k in range(0, len(recs), MAX_SEGMENTS):
        part = recs[k:k + MAX_SEGMENTS]
        rc = _on_card(dev, fn, part[0] if len(part) == 1 else
                      b"".join(part), len(part), stream)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
        launches[name] += 1


def shard_offsets(m) -> list:
    """(tensor, global row offset) of each node shard of a resident
    matrix: a tensor is one shard at offset 0, a mesh world's list its
    shards in order."""
    if isinstance(m, torch.Tensor):
        return [(m, 0)]
    out, off = [], 0
    for t in m:
        out.append((t, off))
        off += t.shape[0]
    return out


def scatter_shards(name: str, pieces) -> None:
    """Scatter `pieces`, each (resident matrix, its operands for each node
    shard: (rows, vals[, olds]) or (rows, counts, dem), on that shard's
    device).  Every node shard is a segment holding its global rows
    (rows outside it drop), and all the segments on one device go in one
    scatter_segments call: a mesh of one card repeated launches once for
    every shard of every piece.  DeviceWorld's updates and the sharded
    serving_update_fns both scatter through here."""
    by_dev: dict = {}
    for m, ops in pieces:
        for (d, off), o in zip(shard_offsets(m), ops, strict=True):
            by_dev.setdefault(d.device, []).append((d, off, *o))
    for segs in by_dev.values():
        scatter_segments(name, segs)


def set_rows(d: torch.Tensor, rows: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """K5 set_rows: one segment of scatter_segments (in place, returns
    d)."""
    scatter_segments("set_rows", [(d, 0, rows, vals)])
    return d


def add_rank1(d: torch.Tensor, rows: torch.Tensor, counts: torch.Tensor,
              dem: torch.Tensor) -> torch.Tensor:
    """K5 add_rank1: one segment of scatter_segments (in place, returns
    d)."""
    scatter_segments("add_rank1", [(d, 0, rows, counts, dem)])
    return d


def set_rows_local(d: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
                   row_offset: int) -> torch.Tensor:
    """K5' set_rows on one node shard holding global rows [row_offset,
    row_offset + N): global `rows` translate to local ones, the rest
    drop.  One segment of scatter_segments."""
    scatter_segments("set_rows_local", [(d, int(row_offset), rows, vals)])
    return d


def add_rank1_local(d: torch.Tensor, rows: torch.Tensor, counts: torch.Tensor,
                    dem: torch.Tensor, row_offset: int) -> torch.Tensor:
    """K5' add_rank1 on one node shard (see set_rows_local)."""
    scatter_segments("add_rank1_local",
                     [(d, int(row_offset), rows, counts, dem)])
    return d


def pack_offsets(arrays) -> Tuple[list, int]:
    """Byte offset of each array in one staged buffer, each at an
    ALIGN-byte boundary, and the buffer's size."""
    offs, end = [], 0
    for a in arrays:
        offs.append(end)
        end += -(-a.nbytes // ALIGN) * ALIGN
    return offs, end


def stage(name: str, arrays, device: torch.device) -> list:
    """Upload numpy `arrays` (i32 or f32) to `device` as one buffer;
    returns a tensor for each, a view of that buffer.  On CUDA the host
    buffer is pinned and the copy non-blocking on the current stream, so
    nothing waits for the work already queued there; PyTorch's caching
    host allocator keeps the pinned block from reuse until the copy has
    run.  On the CPU the buffer is a private copy.  Counted in
    `staged[name]`."""
    offs, size = pack_offsets(arrays)
    host = torch.empty(size, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    hb = host.numpy()
    for a, o in zip(arrays, offs):
        hb[o:o + a.nbytes] = np.ascontiguousarray(a).view(np.uint8).ravel()
    buf = host.to(device, non_blocking=True)
    staged[name] += 1
    return [buf[o:o + a.nbytes].view(_TORCH_DTYPES[a.dtype]).view(a.shape)
            for a, o in zip(arrays, offs)]


def warm_scatter(shape: tuple, device=None, mesh=None) -> None:
    """Build the row-scatter kernel and run it once per ROW_BUCKET for a
    world of `shape` (N, R) (sharded over `mesh` when given: one staged
    upload and one launch a card), so a measured window's first
    dirty-row update pays neither.  Every row index is N (dropped),
    against a throwaway zero world, never a resident one."""
    n, r = shape
    w = DeviceWorld(mesh=mesh, device=device)
    dev = w._put_full(np.zeros((n, r), np.float32))
    for b in ROW_BUCKETS:
        w._scatter(w._names[0], [(dev, (np.full(b, n, np.int32),
                                        np.zeros((b, r), np.float32)))])


class DeviceWorld:
    """One epoch's device-resident (capacity, basis) pair.

    Thread-safe: every read-modify-write of the resident pair happens
    under `self.lock`."""

    def __init__(self, mesh=None, device=None):
        from nomad_tpu_torch.parallel.sharded import Mesh
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"DeviceWorld: mesh must be a "
                            f"parallel.sharded.Mesh, got {type(mesh)!r}")
        self.mesh = mesh
        self.device = mesh.device(0, 0) if mesh is not None \
            else resolve_device(device)
        # the launch counters of its (set, add) scatters
        self._names = ("set_rows", "add_rank1") if mesh is None \
            else ("set_rows_local", "add_rank1_local")
        self.lock = threading.Lock()
        self.shape: Optional[tuple] = None       # shapes of current epoch
        self._cap_last: Optional[np.ndarray] = None
        # tensors, or lists of node-shard tensors on a mesh
        self._cap_dev = None
        self._basis_last: Optional[np.ndarray] = None
        self._basis_dev = None
        self.stats = {"full_uploads": 0, "rows_scattered": 0,
                      "clean_hits": 0, "rank1_applies": 0,
                      # full uploads after the epoch's first one
                      "steady_reuploads": 0,
                      # donated-carry lifecycle (loan_basis/adopt_basis)
                      "basis_loans": 0, "basis_adopts": 0}

    # ------------------------------------------------------------ helpers

    def _put_full(self, host: np.ndarray):
        """A private device copy of `host` (on the CPU torch.from_numpy
        would alias the numpy buffer, which apply_rank1's host scatter
        mutates); on a mesh, the list of node-shard tensors."""
        arr = np.array(host, dtype=np.float32)
        if self.mesh is not None:
            from nomad_tpu_torch.parallel.sharded import put
            return put(self.mesh, arr, 0)
        return torch.from_numpy(arr).to(self.device)

    def _scatter(self, name: str, pieces) -> None:
        """Scatter `pieces`, each (resident matrix, its numpy operands:
        rows and vals, or rows, counts and demand) through scatter_shards,
        with the operands of every piece staged in one upload a card.
        Caller holds self.lock."""
        arrays = [a for _, ops in pieces for a in ops]
        views: dict = {}
        shard_ops = []
        k = 0
        for m, ops in pieces:
            per = []
            for d, _ in shard_offsets(m):
                v = views.get(d.device)
                if v is None:
                    v = views[d.device] = stage(name, arrays, d.device)
                per.append(v[k:k + len(ops)])
            shard_ops.append((m, per))
            k += len(ops)
        scatter_shards(name, shard_ops)

    def _diff(self, host: np.ndarray, last: Optional[np.ndarray], dev,
              force_scatter: bool = False
              ) -> Tuple[np.ndarray, Optional[list]]:
        """Diff one matrix against the snapshot shipped last; returns (new
        snapshot, the (rows, vals) chunks to scatter), chunks None when
        the matrix ships in full and [] when it is clean.  Caller holds
        self.lock.  `force_scatter` (the chained donated-carry
        pipeline): the device array holds in-flight placements the host
        snapshot lacks, so a full upload would erase them — large churn
        scatters in bucket-sized chunks instead, and each chunk is
        (rows, vals, olds) with the rows' old snapshot values, so the
        scatter keeps a dirty row's in-flight part (vals + (device -
        olds)) where a set, as the reference's, would erase it."""
        N = host.shape[0]
        if last is None or last.shape != host.shape or dev is None:
            return np.array(host, dtype=np.float32), None
        # a row's R == 4 compare flags read as one uint32: np.any(axis=1)
        # without numpy's slow reduction over a 4-wide axis
        changed = np.flatnonzero(
            np.ascontiguousarray(last != host).view(np.uint32))
        if changed.size == 0:
            self.stats["clean_hits"] += 1
            return last, []
        Bmax = ROW_BUCKETS[-1]
        if not force_scatter and changed.size > min(N // 4, Bmax):
            return np.array(host, dtype=np.float32), None
        # read the dirty rows once: `host` may be live and the snapshot
        # must equal what shipped
        changed_vals = np.array(host[changed], dtype=np.float32)
        snap = last.copy()
        snap[changed] = changed_vals
        chunks = []
        for off in range(0, changed.size, Bmax):
            cr = changed[off:off + Bmax]
            b = next(b for b in ROW_BUCKETS if b >= cr.size)
            rows = np.full(b, N, np.int32)           # pad slots drop
            rows[:cr.size] = cr
            vals = np.zeros((b, host.shape[1]), np.float32)
            vals[:cr.size] = changed_vals[off:off + Bmax]
            if not force_scatter:
                chunks.append((rows, vals))
                continue
            olds = np.zeros_like(vals)
            olds[:cr.size] = last[cr]
            chunks.append((rows, vals, olds))
        self.stats["rows_scattered"] += int(changed.size)
        return snap, chunks

    # ------------------------------------------------------------- public

    def update(self, capacity: np.ndarray, basis: np.ndarray,
               force_scatter: bool = False):
        """Bring the resident pair up to date with the host truth;
        returns (capacity_dev, basis_dev).  `capacity` may be the live
        matrix (it is copied before any caching decision); `basis` must
        already be a private copy.  `force_scatter` (chained
        donated-carry dispatches) forbids the basis full-upload fallback
        and keeps the in-flight placements of its dirty rows (`_diff`).
        Both matrices' dirty rows go up in one staged buffer a card and
        scatter in one launch a card, and nothing waits for the work
        already queued on the stream."""
        with self.lock:
            shape = (capacity.shape, basis.shape)
            if shape != self.shape:              # new cluster epoch
                self.shape = shape
                self._cap_last = np.array(capacity, dtype=np.float32)
                self._cap_dev = self._put_full(self._cap_last)
                self._basis_last = np.array(basis, dtype=np.float32)
                self._basis_dev = self._put_full(self._basis_last)
                self.stats["full_uploads"] += 1
                return self._cap_dev, self._basis_dev
            cap_last, cap_chunks = self._diff(capacity, self._cap_last,
                                              self._cap_dev)
            basis_last, basis_chunks = self._diff(
                basis, self._basis_last, self._basis_dev, force_scatter)
            if cap_chunks is None:
                self._cap_dev = self._put_full(cap_last)
            if basis_chunks is None:
                self._basis_dev = self._put_full(basis_last)
            # both matrices' dirty rows: one upload and one launch a card
            pieces = [(self._cap_dev, c) for c in cap_chunks or ()] + \
                [(self._basis_dev, c) for c in basis_chunks or ()]
            if pieces:
                self._scatter(self._names[0], pieces)
            self._cap_last, self._basis_last = cap_last, basis_last
            if cap_chunks is None or basis_chunks is None:
                self.stats["full_uploads"] += 1
                self.stats["steady_reuploads"] += 1
            return self._cap_dev, self._basis_dev

    def loan_basis(self):
        """Transfer exclusive ownership of the resident basis buffer to a
        donating kernel.  The world forgets it; the caller follows the
        dispatch with `adopt_basis(...)`, or leaves the world
        invalidated on a failed dispatch so the next update() re-uploads
        from the host snapshot.  None if no basis is resident."""
        with self.lock:
            dev, self._basis_dev = self._basis_dev, None
            if dev is not None:
                self.stats["basis_loans"] += 1
            return dev

    def adopt_basis(self, dev) -> None:
        """Install a kernel's donated-carry output as the resident basis
        (paired with `apply_rank1_host` at resolve time: the carry
        already holds the placements on the device)."""
        with self.lock:
            self._basis_dev = dev
            if dev is not None:
                self.stats["basis_adopts"] += 1

    def invalidate_basis(self) -> None:
        """Forget the resident basis (failed donated dispatch): the next
        update() ships a full upload from the host snapshot."""
        with self.lock:
            self._basis_dev = None

    def _rank1_host_locked(self, rows: np.ndarray, counts: np.ndarray,
                           demand: np.ndarray) -> Optional[tuple]:
        """Rank-1 update of the host snapshot; caller holds self.lock.
        Returns the clipped (rows, counts, d) for the device twin, or
        None if there is nothing to scatter."""
        if self._basis_last is None:
            return None                          # next update ships full
        n, r = self._basis_last.shape
        rows = np.ascontiguousarray(rows, np.int32)
        counts = np.ascontiguousarray(counts, np.int32)
        keep = rows < n
        if not keep.all():
            rows, counts = rows[keep], counts[keep]
        if rows.size == 0:
            return None
        d = np.zeros(r, np.float32)
        d[:min(len(demand), r)] = np.asarray(demand, np.float32)[:r]
        _native.scatter_add_rank1(self._basis_last, rows, counts, d)
        return rows, counts, d

    def apply_rank1(self, rows: np.ndarray, counts: np.ndarray,
                    demand: np.ndarray) -> None:
        """Scatter `counts[k] * demand` into basis row `rows[k]` on both
        copies (host snapshot, device basis), keeping them in lockstep."""
        with self.lock:
            clipped = self._rank1_host_locked(rows, counts, demand)
            if clipped is None:
                return
            if self._basis_dev is None:
                return                   # loaned out: next update ships
            self._scatter(self._names[1], [(self._basis_dev, clipped)])
            self.stats["rank1_applies"] += 1

    def apply_rank1_host(self, rows: np.ndarray, counts: np.ndarray,
                         demand: np.ndarray) -> None:
        """Host-snapshot-only rank-1 twin for the donated-carry path: the
        adopted device basis already contains these placements, so only
        the host snapshot catches up."""
        with self.lock:
            if self._rank1_host_locked(rows, counts, demand) is None:
                return
            self.stats["rank1_applies"] += 1

    def host_basis(self) -> Optional[np.ndarray]:
        """Copy of the host-side basis snapshot (tests / debugging)."""
        with self.lock:
            return None if self._basis_last is None \
                else self._basis_last.copy()

    def device_arrays(self):
        """(capacity_dev, basis_dev) as currently resident (no sync)."""
        with self.lock:
            return self._cap_dev, self._basis_dev
