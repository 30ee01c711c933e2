"""The port's segmented world scatter (K5/K5', `scatter_segments`), its
staged operand buffer, and the bench's basis gate on a mesh world.

The same numpy inputs, made from a seed, go through the reference's
jitted scatters (`parallel.world._single_device_fns`, JAX on the CPU)
and the port's `scatter_segments` on CPU tensors (its plain version):
several segments in one call, with different buckets, pad rows and rows
outside a node shard's range.  Floats are compared bit for bit (uint32
view).  Then `DeviceWorld` stages what one update or rank-1 apply
scatters on a card in one buffer and scatters it in one call: counted
on the CPU as one staged buffer and one segmented scatter per call, on
an unsharded world and on CPU meshes (one distinct device), with the
reference's world (or the unsharded world) as the truth.  A `cuda` case
holds the kernel to its plain version on the card and skips here.
"""
import numpy as np
import pytest
import torch

try:
    import jax

    from nomad_tpu.parallel import world as rw
except ImportError:     # a machine with a card and no JAX runs the cuda
    jax = None          # case only (-m cuda)
from nomad_tpu_torch import bench, mock
from nomad_tpu_torch.parallel import engine as eng_mod
from nomad_tpu_torch.parallel import sharded as ps
from nomad_tpu_torch.parallel import world as tw
from nomad_tpu_torch.parallel.engine import PlacementEngine
from nomad_tpu_torch.scheduler.testing import Harness

torch.set_num_threads(1)

R = 4
CPU8 = ["cpu"] * 8


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint32)


def _assert_bits(got, ref):
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def _matrix(rng, n):
    m = np.zeros((n, R), np.float32)
    m[:, 0] = rng.integers(0, 40, n) * 100
    m[:, 1] = rng.integers(0, 40, n) * 256
    m[:, 2] = rng.random(n).astype(np.float32) * 1000    # non-integer too
    return m


def _rows(rng, n_total, live, bucket):
    rows = np.full(bucket, n_total, np.int32)             # pad rows drop
    rows[:live] = rng.choice(n_total, live, replace=False)
    return rows


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------- the segmented scatter

@pytest.mark.parametrize("op", ["set", "add"])
@pytest.mark.parametrize("buckets", [(64, 512), (512, 4096), (4096, 64)])
def test_segments_match_reference_scatters(op, buckets):
    """Two segments in one call: a whole capacity matrix, and one node
    shard [off, off + n) of a basis whose global rows partly fall
    outside it; each equals the reference's scatter (on the whole
    matrix, then cut to the shard) bit for bit."""
    rng = np.random.default_rng(sum(buckets) + len(op))
    b_cap, b_basis = buckets
    n_cap, n_basis, off, n_shard = 300, 6000, 1500, 1500
    cap, basis = _matrix(rng, n_cap), _matrix(rng, n_basis)
    rows_c = _rows(rng, n_cap, min(n_cap, b_cap) // 2 + 1, b_cap)
    rows_b = _rows(rng, n_basis, b_basis * 3 // 4, b_basis)
    assert ((rows_b >= off) & (rows_b < off + n_shard)).any()
    assert ((rows_b < off) | (rows_b >= off + n_shard)).any()
    set_fn, add_fn = rw._single_device_fns()
    d_cap, d_shard = _t(cap), _t(basis[off:off + n_shard])
    if op == "set":
        vc = rng.random((b_cap, R)).astype(np.float32) * 5000
        vb = rng.random((b_basis, R)).astype(np.float32) * 5000
        ref_c = set_fn(cap, rows_c, vc)
        ref_b = set_fn(basis, rows_b, vb)
        name = "set_rows_local"
        segs = [(d_cap, 0, _t(rows_c), _t(vc)),
                (d_shard, off, _t(rows_b), _t(vb))]
    else:
        cc = rng.integers(-3, 40, b_cap).astype(np.int32)
        cb = rng.integers(-3, 40, b_basis).astype(np.int32)
        dem = np.array([150.0, 0.1, 33.3, 7.0], np.float32)
        ref_c = add_fn(cap, rows_c, cc, dem)
        ref_b = add_fn(basis, rows_b, cb, dem)
        name = "add_rank1_local"
        segs = [(d_cap, 0, _t(rows_c), _t(cc), _t(dem)),
                (d_shard, off, _t(rows_b), _t(cb), _t(dem))]
    before = dict(tw.launches)
    tw.scatter_segments(name, segs)
    assert tw.launches == before
    _assert_bits(d_cap, np.asarray(jax.device_get(ref_c)))
    _assert_bits(d_shard, np.asarray(jax.device_get(ref_b))[off:off + n_shard])
    # the plain version is the same function
    again = [(_t(cap), 0, *segs[0][2:]),
             (_t(basis[off:off + n_shard]), off, *segs[1][2:])]
    tw.scatter_segments_plain(name, again)
    _assert_bits(again[0][0], d_cap)
    _assert_bits(again[1][0], d_shard)


@pytest.mark.parametrize("off", [0, 40])
def test_set_with_old_values_keeps_what_the_device_holds_beyond_them(off):
    """A set segment with the rows' old host values writes vals + (d -
    olds): equal to the set where d holds the old values, and keeping
    the difference (in-flight placements) where it holds more."""
    rng = np.random.default_rng(31 + off)
    n = 100
    host_old = _matrix(rng, 140)[off:off + n]
    extra = np.zeros((n, R), np.float32)
    extra[rng.choice(n, 10, replace=False)] = [30.0, 60.0, 0.0, 0.0]
    rows = _rows(rng, 140, 50, 64)                    # some outside d
    vals = (rng.integers(0, 40, (64, R)) * 10).astype(np.float32)
    local = rows - off
    live = (local >= 0) & (local < n)
    olds = np.zeros((64, R), np.float32)
    olds[live] = host_old[local[live]]
    d = _t(host_old + extra)
    tw.scatter_segments("set_rows_local", [(d, off, _t(rows), _t(vals),
                                            _t(olds))])
    want = host_old + extra
    want[local[live]] = vals[live] + extra[local[live]]
    _assert_bits(d, want)
    # with the device row equal to the old values it is the plain set
    d2 = _t(host_old)
    tw.scatter_segments("set_rows_local", [(d2, off, _t(rows), _t(vals),
                                            _t(olds))])
    _assert_bits(d2, tw.set_rows_plain(_t(host_old), _t(rows), _t(vals),
                                       off))


@pytest.mark.parametrize("mesh_shape", [None, (4, 2)])
def test_chained_update_keeps_in_flight_placements_where_the_reference_loses_them(
        mesh_shape):
    """A donated dispatch's placements are on the device but not yet in
    the host snapshot when the next chained dispatch updates the world
    (force_scatter) with a row that also changed on the host (a rejected
    plan released one alloc there).  The reference's update sets the row
    and erases the in-flight placements, so after the first dispatch
    resolves its device basis differs from its host snapshot; the port
    keeps them and stays bit-equal (ROADMAP queue C)."""
    n = 64
    cap = np.full((n, R), 1000.0, np.float32)
    basis = np.zeros((n, R), np.float32)
    basis[5] = [60.0, 120.0, 0.0, 0.0]
    dem = np.array([30.0, 60.0, 0.0, 0.0], np.float32)
    mesh = None if mesh_shape is None else \
        ps.make_mesh(mesh_shape[1], mesh_shape[0], devices=CPU8)
    port = tw.DeviceWorld(mesh=mesh) if mesh else tw.DeviceWorld(device="cpu")
    for w in (rw.DeviceWorld(mesh=None), port):
        w.update(cap, basis)
        loaned = w.loan_basis()
        if w is port:                 # the kernel's donated carry: 2 allocs
            shard = loaned[0] if mesh else loaned
            shard[5] += torch.from_numpy(2 * dem)
        else:
            loaned = loaned.at[5].add(2 * dem)
        w.adopt_basis(loaned)
        released = basis.copy()
        released[5] -= dem
        w.update(cap, released, force_scatter=True)
        w.apply_rank1_host(np.array([5], np.int32), np.array([2], np.int32),
                           dem)
        dev = w.device_arrays()[1]
        dev = torch.cat(dev) if isinstance(dev, list) else dev
        np.testing.assert_array_equal(w.host_basis()[5], [90, 180, 0, 0])
        if w is port:
            _assert_bits(dev, w.host_basis())
        else:
            np.testing.assert_array_equal(np.asarray(dev)[5], [30, 60, 0, 0])


def test_segments_past_one_launch_match_one_at_a_time():
    """More segments than one launch takes (the kernel splits them into
    ceil(k / MAX_SEGMENTS) launches) give the result of one segment at a
    time."""
    rng = np.random.default_rng(5)
    k = tw.MAX_SEGMENTS + 7
    mats = [_matrix(rng, 70) for _ in range(k)]
    rows = [_rows(rng, 70, 20, 64) for _ in range(k)]
    vals = [rng.random((64, R)).astype(np.float32) for _ in range(k)]
    got = [_t(m) for m in mats]
    tw.scatter_segments("set_rows", [(got[i], 0, _t(rows[i]), _t(vals[i]))
                                     for i in range(k)])
    for i in range(k):
        _assert_bits(got[i], tw.set_rows_plain(_t(mats[i]), _t(rows[i]),
                                               _t(vals[i])))


def _misaligned(shape):
    n = int(np.prod(shape))
    return torch.zeros(n + 1)[1:].view(shape)


@pytest.mark.parametrize("case", ["dest_unaligned", "vals_unaligned",
                                  "olds_unaligned", "olds_shape",
                                  "dest_width", "rows_dtype",
                                  "counts_shape", "segment_arity",
                                  "no_segments"])
def test_segments_refuse_what_the_kernel_does_not_take(case):
    d = torch.zeros((16, R))
    rows = torch.arange(4, dtype=torch.int32)
    vals = torch.ones((4, R))
    name, segs = "set_rows", [(d, 0, rows, vals)]
    if case == "dest_unaligned":
        segs = [(_misaligned((16, R)), 0, rows, vals)]
    elif case == "vals_unaligned":
        segs = [(d, 0, rows, _misaligned((4, R)))]
    elif case == "olds_unaligned":
        segs = [(d, 0, rows, vals, _misaligned((4, R)))]
    elif case == "olds_shape":
        segs = [(d, 0, rows, vals, torch.ones((3, R)))]
    elif case == "dest_width":
        segs = [(torch.zeros((16, 3)), 0, rows, torch.ones((4, 3)))]
    elif case == "rows_dtype":
        segs = [(d, 0, rows.long(), vals)]
    elif case == "counts_shape":
        name = "add_rank1"
        segs = [(d, 0, rows, torch.ones(3, dtype=torch.int32),
                 torch.ones(R))]
    elif case == "segment_arity":
        name = "add_rank1"
    else:
        segs = []
    before = d.clone()
    with pytest.raises(ValueError):
        tw.scatter_segments(name, segs)
    assert torch.equal(d, before)


# --------------------------------------------------- the staged buffer

@pytest.mark.parametrize("sizes", [(1,), (5, 3), (64, 64, 4), (4096, 7)])
def test_staged_buffer_layout_round_trips(sizes):
    """Every part starts on an ALIGN-byte boundary, the parts do not
    overlap, and each view reads back its array exactly."""
    rng = np.random.default_rng(len(sizes))
    arrays = []
    for k, n in enumerate(sizes):
        arrays.append(rng.integers(-9, 9, n).astype(np.int32) if k % 2 == 0
                      else rng.random((n, R)).astype(np.float32))
    offs, size = tw.pack_offsets(arrays)
    assert all(o % tw.ALIGN == 0 for o in offs)
    ends = [o + a.nbytes for o, a in zip(offs, arrays)]
    assert all(e <= o for e, o in zip(ends, offs[1:])) and ends[-1] <= size
    assert size % tw.ALIGN == 0
    before = dict(tw.staged)
    views = tw.stage("add_rank1", arrays, torch.device("cpu"))
    assert tw.staged["add_rank1"] == before["add_rank1"] + 1
    base = views[0].data_ptr() - offs[0]
    for v, a, o in zip(views, arrays, offs):
        assert v.data_ptr() - base == o and v.data_ptr() % tw.ALIGN == 0
        assert v.shape == a.shape
        np.testing.assert_array_equal(v.numpy(), a)
    # a private copy: the numpy arrays can change under it
    arrays[0][...] = 99
    assert not np.array_equal(views[0].numpy(), arrays[0])


# -------------------------------------------------------- DeviceWorld

@pytest.fixture
def calls(monkeypatch):
    """Segmented scatter calls per name (a kernel launch each on a card;
    here each runs the plain version)."""
    n = dict.fromkeys(tw.launches, 0)
    real = tw.scatter_segments

    def counted(name, segs):
        n[name] += 1
        return real(name, segs)
    monkeypatch.setattr(tw, "scatter_segments", counted)
    return n


def _counts(calls):
    return dict(tw.staged), dict(calls), dict(tw.launches)


def _moved(before, calls, name):
    """(staged buffers, segmented scatter calls, no kernel launched)
    since `before`."""
    staged, n, launches = before
    return (tw.staged[name] - staged[name], calls[name] - n[name],
            tw.launches == launches)


def _dirty(rng, m, k, col):
    m = m.copy()
    m[rng.choice(m.shape[0], k, replace=False), col] += 100
    return m


@pytest.mark.parametrize("cap_rows,basis_rows,force", [
    (3, 40, False), (60, 500, False), (1, 3000, True), (200, 5000, True)])
def test_world_update_stages_once_and_matches_reference(cap_rows, basis_rows,
                                                        force, calls):
    """Both matrices dirty (and force_scatter's chunks past the largest
    bucket): one staged buffer and one segmented scatter per update, the
    resident pair and the stats equal to the reference's world."""
    rng = np.random.default_rng(cap_rows + basis_rows)
    n = 8192
    cap, basis = _matrix(rng, n), _matrix(rng, n)
    ref_w, port_w = rw.DeviceWorld(mesh=None), tw.DeviceWorld(device="cpu")
    for w in (ref_w, port_w):
        w.update(cap, basis)
    cap2, basis2 = _dirty(rng, cap, cap_rows, 0), _dirty(rng, basis,
                                                         basis_rows, 1)
    before = _counts(calls)
    for w in (ref_w, port_w):
        w.update(cap2, basis2, force_scatter=force)
    assert _moved(before, calls, "set_rows") == (1, 1, True)
    assert port_w.stats == {k: ref_w.stats[k] for k in port_w.stats}
    assert port_w.stats["rows_scattered"] == cap_rows + basis_rows
    assert port_w.stats["full_uploads"] == 1
    rc, rb = ref_w.device_arrays()
    pc, pb = port_w.device_arrays()
    _assert_bits(pc, np.asarray(rc))
    _assert_bits(pb, np.asarray(rb))
    _assert_bits(port_w.host_basis(), ref_w.host_basis())


def test_world_clean_or_full_update_stages_nothing(calls):
    rng = np.random.default_rng(3)
    n = 256
    cap, basis = _matrix(rng, n), _matrix(rng, n)
    w = tw.DeviceWorld(device="cpu")
    w.update(cap, basis)
    before = _counts(calls)
    w.update(cap, basis)                                  # clean
    w.update(cap, _dirty(rng, basis, n // 2, 0))          # > N/4: full
    assert _moved(before, calls, "set_rows") == (0, 0, True)
    # two clean matrices, then a clean capacity beside a full basis
    assert w.stats["clean_hits"] == 3 and w.stats["steady_reuploads"] == 1


def test_world_apply_rank1_stages_once_and_matches_reference(calls):
    rng = np.random.default_rng(4)
    n = 512
    cap, basis = _matrix(rng, n), _matrix(rng, n)
    ref_w, port_w = rw.DeviceWorld(mesh=None), tw.DeviceWorld(device="cpu")
    for w in (ref_w, port_w):
        w.update(cap, basis)
    rows = np.append(rng.choice(n, 37, replace=False), n + 3).astype(np.int32)
    counts = rng.integers(-2, 9, rows.size).astype(np.int32)
    dem = np.array([33.3, 70.7, 0.1, 5.0], np.float32)
    before = _counts(calls)
    for w in (ref_w, port_w):
        w.apply_rank1(rows, counts, dem)
    assert _moved(before, calls, "add_rank1") == (1, 1, True)
    _assert_bits(port_w.device_arrays()[1],
                 np.asarray(ref_w.device_arrays()[1]))
    _assert_bits(port_w.host_basis(), ref_w.host_basis())


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_mesh_world_scatters_once_per_device(shape, calls):
    """On a CPU mesh (eight entries of one device) every update and
    rank-1 apply stages one buffer and runs one segmented scatter for
    all its shards and both matrices; the shards concatenated equal the
    unsharded world bit for bit."""
    rng = np.random.default_rng(shape[0])
    n = 1024
    mesh = ps.make_mesh(shape[1], shape[0], devices=CPU8)
    sharded, single = tw.DeviceWorld(mesh=mesh), tw.DeviceWorld(device="cpu")
    cap, basis = _matrix(rng, n), _matrix(rng, n)
    for w in (sharded, single):
        w.update(cap, basis)
    for step in range(4):
        cap = _dirty(rng, cap, 3 + step, 0)
        basis = _dirty(rng, basis, 20 + 50 * step, 1)
        before = _counts(calls)
        sharded.update(cap, basis, force_scatter=step == 3)
        assert _moved(before, calls, "set_rows_local") == (1, 1, True)
        single.update(cap, basis, force_scatter=step == 3)
        rows = rng.choice(n, 9, replace=False).astype(np.int32)
        counts = rng.integers(1, 5, 9).astype(np.int32)
        dem = rng.random(R).astype(np.float32) * 50
        before = _counts(calls)
        sharded.apply_rank1(rows, counts, dem)
        assert _moved(before, calls, "add_rank1_local") == (1, 1, True)
        single.apply_rank1(rows, counts, dem)
        sc, sb = sharded.device_arrays()
        uc, ub = single.device_arrays()
        assert len(sb) == shape[0]
        _assert_bits(torch.cat(sc), uc)
        _assert_bits(torch.cat(sb), ub)
        _assert_bits(sharded.host_basis(), single.host_basis())


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_serving_update_fns_scatter_once_per_device(shape, calls):
    rng = np.random.default_rng(11)
    n = 256
    mesh = ps.make_mesh(shape[1], shape[0], devices=CPU8)
    base = _matrix(rng, n)
    rows = _rows(rng, n, 40, 64)
    vals = rng.random((64, R)).astype(np.float32)
    set_fn, _ = ps.serving_update_fns(mesh)
    dev = ps.put(mesh, base, 0)
    set_fn(dev, [_t(rows)] * shape[0], [_t(vals)] * shape[0])
    assert calls["set_rows_local"] == 1
    _assert_bits(torch.cat(dev), tw.set_rows_plain(_t(base), _t(rows),
                                                   _t(vals)))


@pytest.mark.parametrize("op", ["set", "add"])
def test_serving_update_fns_and_world_share_one_grouping(op, monkeypatch):
    """serving_update_fns and DeviceWorld's updates hand scatter_shards
    the same segments for the same operands, so the mesh check of one
    covers the other."""
    rng = np.random.default_rng(12 + len(op))
    n = 256
    mesh = ps.make_mesh(2, 4, devices=CPU8)
    base = _matrix(rng, n)
    rows = _rows(rng, n, 40, 64)
    ops = [rows, rng.random((64, R)).astype(np.float32)] if op == "set" \
        else [rows, rng.integers(-3, 40, 64).astype(np.int32),
              np.array([33.3, 70.7, 0.1, 5.0], np.float32)]
    name = "set_rows_local" if op == "set" else "add_rank1_local"
    seen = []
    real = tw.scatter_shards

    def spy(nm, pieces):
        seen.append([(nm, off, *[_bits(o).copy() for o in (d, *rest)])
                     for m, per in pieces
                     for (d, off), rest in zip(tw.shard_offsets(m), per)])
        return real(nm, pieces)
    monkeypatch.setattr(tw, "scatter_shards", spy)
    fns = ps.serving_update_fns(mesh)
    dev = ps.put(mesh, base, 0)
    fns[op == "add"](dev, *[[_t(a)] * 4 for a in ops])
    w = tw.DeviceWorld(mesh=mesh)
    with w.lock:
        w._scatter(name, [(w._put_full(base), ops)])
    assert len(seen) == 2 and len(seen[0]) == len(seen[1]) == 4
    for a, b in zip(*seen):
        assert a[:2] == b[:2]
        for x, y in zip(a[2:], b[2:]):
            np.testing.assert_array_equal(x, y)


def test_warm_scatter_stages_once_per_bucket(calls):
    mesh = ps.make_mesh(2, 4, devices=CPU8)
    before = _counts(calls)
    tw.warm_scatter((64, R), mesh=mesh)
    n = len(tw.ROW_BUCKETS)
    assert _moved(before, calls, "set_rows_local") == (n, n, True)


# ------------------------------------------------ the bench's basis gate

def _c2m_job():
    j = mock.batch_job()
    base = j.task_groups[0]
    base.count = 4
    base.tasks[0].resources.cpu = 30
    base.tasks[0].resources.memory_mb = 60
    base.ephemeral_disk.size_mb = 0
    tgs = []
    for k in range(3):
        tg = base.copy() if k else base
        tg.name = f"g{k}"
        tgs.append(tg)
    j.task_groups = tgs
    return j


def test_bench_basis_gate_on_a_mesh_world():
    """An engine over a CPU (4, 2) mesh, installed for the scheduler,
    places a small C2M stream; the bench's gate sees the sharded basis
    equal to the host snapshot, and unequal after one element of one
    shard is flipped."""
    eng_mod.stop_engines()
    eng = eng_mod.install_engine(PlacementEngine(
        device="cpu", shard_min_nodes=8, mesh_devices=CPU8))
    try:
        h = Harness(device="cpu")
        for i in range(64):
            node = mock.node()
            node.attributes["rack"] = f"r{i % 4}"
            h.store.upsert_node(h.next_index(), node)
        jobs = [_c2m_job() for _ in range(6)]
        for job in jobs:
            h.store.upsert_job(h.next_index(), job)
            ev = mock.eval(job_id=job.id, type="batch",
                           priority=job.priority)
            h.store.upsert_evals(h.next_index(), [ev])
            h.process("batch", ev)
        placed = sum(len(h.store.allocs_by_job(j.namespace, j.id))
                     for j in jobs)
        assert placed == 6 * 12
        assert eng.stats["sharded_evals"] >= len(jobs)
        worlds = [w for w in eng._worlds.values() if w.mesh is not None]
        assert worlds
        assert bench._basis_matches_host(eng)
        _, basis = worlds[0].device_arrays()
        assert isinstance(basis, list) and len(basis) == 4
        flip = basis[2].view(torch.int32)
        flip[3, 0] ^= 1
        assert not bench._basis_matches_host(eng)
        flip[3, 0] ^= 1
        assert bench._basis_matches_host(eng)
    finally:
        eng.stop()
        eng_mod.stop_engines()


# -------------------------------------------------------- on the card

@pytest.mark.cuda
def test_segmented_kernel_matches_plain_on_the_card():
    """Two segments at every bucket (a set segment with old values among
    them), more segments than one launch takes, and all four shards of a
    (4, 2) mesh of the card repeated in one launch, bit-equal to the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.default_rng(21)
    n = 16384
    base = _matrix(rng, n)
    for b in tw.ROW_BUCKETS:
        rows = [_rows(rng, n, b * 3 // 4, b), _rows(rng, n, b // 2, b)]
        vals = [rng.random((b, R)).astype(np.float32) for _ in range(2)]
        counts = rng.integers(-3, 40, b).astype(np.int32)
        dem = np.array([33.3, 70.7, 0.1, 5.0], np.float32)
        for name in ("set_rows", "add_rank1"):
            outs = []
            for dev in ("cuda", "cpu"):
                ds = [_t(base).to(dev), _t(base * 0.5).to(dev)]
                if name == "set_rows":             # the second with olds
                    segs = [(ds[i], 0, _t(rows[i]).to(dev),
                             _t(vals[i]).to(dev)) for i in range(2)]
                    segs[1] += (_t(vals[0] * 0.5).to(dev),)
                else:
                    segs = [(ds[i], 0, _t(rows[i]).to(dev), _t(counts).to(dev),
                             _t(dem).to(dev)) for i in range(2)]
                before = tw.launches[name]
                tw.scatter_segments(name, segs)
                assert tw.launches[name] == before + (dev == "cuda")
                outs.append([d.cpu() for d in ds])
            for k, p in zip(*outs):
                _assert_bits(k, p)
    # more segments than one launch takes: two launches
    k = tw.MAX_SEGMENTS + 7
    mats = [_matrix(rng, 70) for _ in range(k)]
    rs = [_rows(rng, 70, 20, 64) for _ in range(k)]
    vs = [rng.random((64, R)).astype(np.float32) for _ in range(k)]
    got = [_t(m).cuda() for m in mats]
    before = tw.launches["set_rows"]
    tw.scatter_segments("set_rows", [(got[i], 0, _t(rs[i]).cuda(),
                                      _t(vs[i]).cuda()) for i in range(k)])
    assert tw.launches["set_rows"] == before + 2
    for i in range(k):
        _assert_bits(got[i].cpu(), tw.set_rows_plain(_t(mats[i]), _t(rs[i]),
                                                     _t(vs[i])))
    mesh = ps.make_mesh(2, 4, devices=["cuda:0"] * 8)
    rows = _rows(rng, n, 3000, 4096)
    vals = rng.random((4096, R)).astype(np.float32)
    dev = ps.put(mesh, base, 0)
    set_fn, _ = ps.serving_update_fns(mesh)
    before = tw.launches["set_rows_local"]
    set_fn(dev, [_t(rows).cuda()] * 4, [_t(vals).cuda()] * 4)
    assert tw.launches["set_rows_local"] == before + 1
    _assert_bits(torch.cat(dev).cpu(),
                 tw.set_rows_plain(_t(base), _t(rows), _t(vals)))
