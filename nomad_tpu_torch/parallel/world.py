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
device (i, 0); the scatters run per shard with the shard's row offset
(K5', `set_rows_local` / `add_rank1_local`, the reference's
`serving_update_fns`), so each shard writes only the rows it owns.

The scatters (K5, K5') are hand-written CUDA (csrc/world_scatter.cu)
with plain PyTorch versions beside them.  Both update the resident
tensor in place: every use of it is ordered on the engine's one stream,
so a kernel that read the old rows has finished before a scatter
rewrites them.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from nomad_tpu_torch import native as _native
from nomad_tpu_torch.device import resolve_device
from nomad_tpu_torch.ops import _build

# dirty-row buckets of the row scatter
ROW_BUCKETS = (64, 512, 4096)

# kernel launches per wrapper (the plain versions never count); the
# *_local wrappers are the sharded world's (K5')
launches = {"set_rows": 0, "add_rank1": 0, "set_rows_local": 0,
            "add_rank1_local": 0}


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check_scatter(d: torch.Tensor, rows: torch.Tensor, *others) -> None:
    if d.dtype != torch.float32 or d.dim() != 2 or not d.is_contiguous():
        raise ValueError("world scatter: basis must be contiguous f32[N, R]")
    if rows.dtype != torch.int32 or rows.dim() != 1:
        raise ValueError("world scatter: rows must be i32[B]")
    for t in (rows,) + others:
        if t.device != d.device:
            raise ValueError(f"world scatter: operand on {t.device}, "
                             f"basis on {d.device}")
        if not t.is_contiguous():
            raise ValueError("world scatter: operand not contiguous")


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
                   vals: torch.Tensor, row_offset: int = 0) -> torch.Tensor:
    """Plain version of set_rows: d[rows - off] = vals in place, rows
    outside [off, off + N) dropped (`d.at[r].set(v, mode="drop")`, and on
    a shard `_set_rows_local`).  Returns d."""
    keep = _live_rows(d, rows, row_offset)
    d[rows[keep].long() - row_offset] = vals[keep]
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


def _set_rows(name: str, d, rows, vals, row_offset: int):
    _check_scatter(d, rows, vals)
    B, R = vals.shape
    if rows.shape[0] != B or R != d.shape[1] or vals.dtype != torch.float32:
        raise ValueError(f"{name}: vals must be f32[B, R]")
    if d.device.type == "cpu":
        return set_rows_plain(d, rows, vals, row_offset)
    if d.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {d.device}")
    lib = _build.load("world_scatter")
    rc = lib.set_rows_launch(_ptr(d), _ptr(rows), _ptr(vals), B, d.shape[0],
                             int(row_offset), ctypes.c_void_p(
                                 torch.cuda.current_stream(d.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1
    return d


def _add_rank1(name: str, d, rows, counts, dem, row_offset: int):
    _check_scatter(d, rows, counts, dem)
    B = rows.shape[0]
    if counts.shape != (B,) or counts.dtype != torch.int32 \
            or dem.shape != (d.shape[1],) or dem.dtype != torch.float32:
        raise ValueError(f"{name}: counts must be i32[B], dem f32[R]")
    if d.device.type == "cpu":
        return add_rank1_plain(d, rows, counts, dem, row_offset)
    if d.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {d.device}")
    lib = _build.load("world_scatter")
    rc = lib.add_rank1_launch(_ptr(d), _ptr(rows), _ptr(counts), _ptr(dem),
                              B, d.shape[0], int(row_offset),
                              ctypes.c_void_p(
                                  torch.cuda.current_stream(d.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1
    return d


def set_rows(d: torch.Tensor, rows: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """K5 set_rows wrapper (in place, returns d).  CUDA tensors launch
    csrc/world_scatter.cu; CPU tensors take the plain version."""
    return _set_rows("set_rows", d, rows, vals, 0)


def add_rank1(d: torch.Tensor, rows: torch.Tensor, counts: torch.Tensor,
              dem: torch.Tensor) -> torch.Tensor:
    """K5 add_rank1 wrapper (in place, returns d).  CUDA tensors launch
    csrc/world_scatter.cu; CPU tensors take the plain version."""
    return _add_rank1("add_rank1", d, rows, counts, dem, 0)


def set_rows_local(d: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
                   row_offset: int) -> torch.Tensor:
    """K5' set_rows on one node shard holding global rows [row_offset,
    row_offset + N): global `rows` translate to local ones, the rest
    drop.  CUDA tensors launch csrc/world_scatter.cu; CPU tensors take
    the plain version."""
    return _set_rows("set_rows_local", d, rows, vals, row_offset)


def add_rank1_local(d: torch.Tensor, rows: torch.Tensor, counts: torch.Tensor,
                    dem: torch.Tensor, row_offset: int) -> torch.Tensor:
    """K5' add_rank1 on one node shard (see set_rows_local)."""
    return _add_rank1("add_rank1_local", d, rows, counts, dem, row_offset)


def warm_scatter(shape: tuple, device=None, mesh=None) -> None:
    """Build the row-scatter kernel and run it once per ROW_BUCKET for a
    world of `shape` (N, R) (sharded over `mesh` when given), so a
    measured window's first dirty-row update pays neither.  Every row
    index is N (dropped), against a throwaway zero world, never a
    resident one."""
    N, R = shape
    w = DeviceWorld(mesh=mesh, device=device)
    dev = w._put_full(np.zeros((N, R), np.float32))
    for b in ROW_BUCKETS:
        w._set_rows(dev, np.full(b, N, np.int32), np.zeros((b, R), np.float32))


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

    def _put_operands(self, *arrays):
        """Upload of scatter operands (rows/counts/values), private
        copies as for _put_full; on a mesh, one upload to each distinct
        shard device and a list over the shards for each operand."""
        if self.mesh is None:
            return tuple(torch.from_numpy(np.array(a)).to(self.device)
                         for a in arrays)
        devs = self.mesh.column(0)
        per = {d: [torch.tensor(np.array(a), device=d) for a in arrays]
               for d in dict.fromkeys(devs)}
        return tuple([per[d][k] for d in devs] for k in range(len(arrays)))

    def _set_rows(self, dev, rows: np.ndarray, vals: np.ndarray):
        rows_dev, vals_dev = self._put_operands(rows, vals)
        if self.mesh is None:
            return set_rows(dev, rows_dev, vals_dev)
        from nomad_tpu_torch.parallel.sharded import serving_update_fns
        set_fn, _ = serving_update_fns(self.mesh)
        return set_fn(dev, rows_dev, vals_dev)

    def _update_one(self, host: np.ndarray, last: Optional[np.ndarray],
                    dev, force_scatter: bool = False
                    ) -> Tuple[np.ndarray, object, bool]:
        """Sync one matrix; returns (new snapshot, new device array,
        full-upload?).  Caller holds self.lock.  `force_scatter` (the
        chained donated-carry pipeline): the device array holds in-flight
        placements the host snapshot lacks, so a full upload would erase
        them — large churn scatters in bucket-sized chunks instead."""
        N = host.shape[0]
        B = None
        changed = None
        if last is not None and last.shape == host.shape and \
                dev is not None:
            changed = np.nonzero(np.any(last != host, axis=1))[0]
            if changed.size == 0:
                self.stats["clean_hits"] += 1
                return last, dev, False
            if changed.size <= N // 4 or force_scatter:
                B = next((b for b in ROW_BUCKETS if b >= changed.size),
                         None)
            if B is None and force_scatter:
                # churn beyond the largest bucket: chunked scatters
                Bmax = ROW_BUCKETS[-1]
                changed_vals = np.array(host[changed], dtype=np.float32)
                snap = last.copy()
                snap[changed] = changed_vals
                for off in range(0, changed.size, Bmax):
                    cr = changed[off:off + Bmax]
                    cv = changed_vals[off:off + Bmax]
                    b = next(b for b in ROW_BUCKETS if b >= cr.size)
                    rows = np.full(b, N, np.int32)
                    rows[:cr.size] = cr
                    vals = np.zeros((b, host.shape[1]), np.float32)
                    vals[:cr.size] = cv
                    dev = self._set_rows(dev, rows, vals)
                self.stats["rows_scattered"] += int(changed.size)
                return snap, dev, False
        if B is None:
            snap = np.array(host, dtype=np.float32)
            return snap, self._put_full(snap), True
        # read the dirty rows once: `host` may be live and the snapshot
        # must equal what shipped
        changed_vals = np.array(host[changed], dtype=np.float32)
        rows = np.full(B, N, np.int32)           # pad slots drop
        rows[:changed.size] = changed
        vals = np.zeros((B, host.shape[1]), np.float32)
        vals[:changed.size] = changed_vals
        snap = last.copy()
        snap[changed] = changed_vals
        self.stats["rows_scattered"] += int(changed.size)
        return snap, self._set_rows(dev, rows, vals), False

    # ------------------------------------------------------------- public

    def update(self, capacity: np.ndarray, basis: np.ndarray,
               force_scatter: bool = False):
        """Bring the resident pair up to date with the host truth;
        returns (capacity_dev, basis_dev).  `capacity` may be the live
        matrix (it is copied before any caching decision); `basis` must
        already be a private copy.  `force_scatter` forbids the basis
        full-upload fallback (chained donated-carry dispatches)."""
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
            self._cap_last, self._cap_dev, full_c = self._update_one(
                capacity, self._cap_last, self._cap_dev)
            self._basis_last, self._basis_dev, full_b = self._update_one(
                basis, self._basis_last, self._basis_dev,
                force_scatter=force_scatter)
            if full_c or full_b:
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
            rows_dev, counts_dev, d_dev = self._put_operands(*clipped)
            if self.mesh is None:
                self._basis_dev = add_rank1(self._basis_dev, rows_dev,
                                            counts_dev, d_dev)
            else:
                from nomad_tpu_torch.parallel.sharded import \
                    serving_update_fns
                _, add_fn = serving_update_fns(self.mesh)
                self._basis_dev = add_fn(self._basis_dev, rows_dev,
                                         counts_dev, d_dev)
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
