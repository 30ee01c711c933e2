"""The port's sharded serving path (K7) on CPU meshes, held against the
reference's on conftest.py's eight virtual CPU devices.

The same numpy inputs, made from a seed (or by the reference's
DenseStack on a seeded world), go through the reference's
parallel/sharded.py functions on a JAX mesh and through the port's on a
mesh of eight "cpu" entries of the same shape, (4, 2) and (8, 1).  Each
port function runs in both of its CPU forms: `*_plain` (the reference's
function as explicit loops over the shards) and `*_staged` (the
sequence of shard-local kernels that a CUDA mesh launches, each taking
its own plain version on CPU shards).  Integer outputs (node rows,
counts, placed/n_eval/n_exh/waves, top-K rows) must be equal; scores
and usage agree within rtol 1e-5, as in the port's other tests (the
reference's XLA CPU build contracts multiply-adds and evaluates pow with
its own routine); the two port forms agree bit for bit.

Then the sharded world (K5') against the reference's scatters and a
from-scratch truth, the port's engine over a mesh against its
single-device engine (and the reference's), and the dev-mode Server on a
(4, 2) mesh against the single-device Server.  Cases marked `cuda` hold
the kernels to the plain versions on a mesh of one card repeated and
skip here.
"""
import dataclasses
from concurrent.futures import Future

import numpy as np
import pytest
import torch

try:
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import nomad_tpu.mock as ref_mock
    from nomad_tpu.encode import ClusterMatrix as RefClusterMatrix
    from nomad_tpu.ops import place as rp
    from nomad_tpu.parallel import sharded as rs
    from nomad_tpu.scheduler.stack import DenseStack as RefDenseStack
    from nomad_tpu.structs.job import Affinity, Operand, Spread
    from test_torch_place_scan import cluster_matrix_arrays
except ImportError:     # a machine with a card and no JAX runs the cuda
    jax = None          # tests only (-m cuda)
from nomad_tpu_torch.convert import cluster_matrix_from_numpy
from nomad_tpu_torch.ops import place as tp
from nomad_tpu_torch.ops import sharded as k7
from nomad_tpu_torch.parallel import engine as eng_mod
from nomad_tpu_torch.parallel import sharded as ps
from nomad_tpu_torch.parallel import world as tw
from nomad_tpu_torch.parallel.engine import PlacementEngine, _Request
from test_torch_place_batch import _bulk_eval, _deltas, _scan_eval, _world

torch.set_num_threads(1)

RTOL = 1e-5
SHAPES = [(4, 2), (8, 1)]
FORMS = ["plain", "staged"]
CPU8 = ["cpu"] * 8


def _ref_mesh(shape):
    return rs.make_mesh(n_wave_shards=shape[1], n_node_shards=shape[0])


def _port_mesh(shape):
    return ps.make_mesh(shape[1], shape[0], devices=CPU8)


def _fn(name, form):
    return getattr(ps, f"{name}_{form}")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, ref, what=""):
    """Integers equal; floats equal in where they are finite, and within
    RTOL there."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, what
    if ref.dtype.kind in "iub":
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL, err_msg=what)


def _mixed_world(n_nodes, racks=8, seed=3):
    rng = np.random.default_rng(seed)
    cm = RefClusterMatrix(initial_rows=n_nodes)
    for i in range(n_nodes):
        n = ref_mock.node()
        n.attributes["rack"] = f"r{i % racks}"
        n.node_resources.cpu.cpu_shares = int(rng.integers(3000, 8000))
        cm.upsert_node(n)
    return cm


def _mixed_job(count):
    j = ref_mock.job()
    tg = j.task_groups[0]
    tg.count = count
    tg.spreads = [Spread("${attr.rack}", 60, ())]
    j.affinities.append(Affinity("${attr.rack}", "r2", Operand.EQ,
                                 weight=40))
    return j


def _scan_inputs(cm, job, count):
    st = RefDenseStack(cm)
    groups = [st.compile_group(job, tg) for tg in job.task_groups]
    inp = st.build_inputs(job, groups, [0] * count, {})
    return inp, {f.name: np.asarray(getattr(inp, f.name))
                 for f in dataclasses.fields(inp)}


# ------------------------------------------------------------ the mesh

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 9, 12])
@pytest.mark.parametrize("wave", [None, 1, 2, 3])
def test_wave_mesh_shape_matches_reference(n, wave):
    assert ps.wave_mesh_shape(n, wave) == rs.wave_mesh_shape(n, wave)


def test_wave_mesh_shape_knob(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_WAVE_SHARDS", "4")
    assert ps.wave_mesh_shape(8) == rs.wave_mesh_shape(8) == (2, 4)
    monkeypatch.setenv("NOMAD_TPU_WAVE_SHARDS", "3")
    assert ps.wave_mesh_shape(8) == (8, 1)
    with pytest.raises(ValueError):
        ps.wave_mesh_shape(0)


def test_mesh_key_keys_on_axes_and_grid_positions():
    m1 = ps.make_serving_mesh(CPU8)
    m2 = ps.make_serving_mesh(CPU8)
    assert m1 is not m2 and ps.mesh_key(m1) == ps.mesh_key(m2)
    assert m1.shape == {"node_shard": 4, "wave": 2}
    assert ps.mesh_key(None) is None
    # the same devices on another grid are another mesh
    assert ps.mesh_key(ps.make_mesh(1, 8, devices=CPU8)) != ps.mesh_key(m1)
    assert ps.mesh_key(ps.make_serving_mesh(CPU8[:4])) != ps.mesh_key(m1)
    assert ps.make_serving_mesh(CPU8[:4]).shape == {"node_shard": 2,
                                                    "wave": 2}
    # a device may repeat; positions are part of the key
    key = ps.mesh_key(m1)
    assert len(key[1]) == 8 and key[1][0] == (0, 0, "cpu")


def test_mesh_refuses_mixed_or_ragged_grids():
    with pytest.raises(ValueError):
        ps.Mesh([["cpu", "cpu"], ["cpu"]])
    with pytest.raises(ValueError):
        ps.Mesh([["cpu", "meta"]])


# ---------------------------------------------- place_eval_batch_sharded

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", SHAPES)
def test_place_eval_batch_sharded_matches_reference(shape, form):
    cm = _mixed_world(64)
    inp, fields = _scan_inputs(cm, _mixed_job(12), 12)
    B = shape[1]
    ref = rs.place_eval_batch_sharded(_ref_mesh(shape), rs.stack_inputs(
        [inp] * B), True)
    got = _fn("place_eval_batch_sharded", form)(
        _port_mesh(shape), ps.stack_inputs([tp.PlaceInputs(**fields)] * B),
        True)
    names = ("node", "score", "fit", "n_eval", "n_exh", "top_nodes",
             "top_scores", "used")
    for name, g, r in zip(names, got, ref):
        _same(g, r, name)
    assert (_np(got[0])[:, :12] >= 0).all()


def test_place_eval_batch_forms_agree_bitwise_with_lane_batch():
    cm = _mixed_world(32, racks=4)
    inp, fields = _scan_inputs(cm, _mixed_job(6), 6)
    mesh = _port_mesh((4, 2))
    stacked = ps.stack_inputs([tp.PlaceInputs(**fields)] * 4)
    a = ps.place_eval_batch_sharded_plain(mesh, stacked)
    b = ps.place_eval_batch_sharded_staged(mesh, stacked)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        ps.place_eval_batch_sharded(mesh, ps.stack_inputs(
            [tp.PlaceInputs(**fields)] * 3))


# --------------------------------------------------- place_batch_sharded

def _scan_chain(n, E, with_deltas, seed):
    """E chained scan evals (a mixed spread+affinity job each, some slots
    placed already) on a seeded world, and their stacked fields."""
    cm = _mixed_world(n, seed=seed)
    rng = np.random.default_rng(seed)
    evals = []
    for e in range(E):
        count = int(rng.integers(3, 10))
        _inp, fields = _scan_inputs(cm, _mixed_job(count), count)
        evals.append(fields)
    S = max(f["demand"].shape[0] for f in evals)
    stacked = {}
    for name in ps.SCAN_FIELDS:
        arrs = []
        for f in evals:
            a = f[name]
            if name in ("demand", "slot_tg", "slot_active") and \
                    a.shape[0] < S:
                a = np.concatenate([a, np.zeros((S - a.shape[0],)
                                                + a.shape[1:], a.dtype)])
            arrs.append(a)
        stacked[name] = np.stack(arrs)
    N = cm.n_rows
    D = 64
    drows = np.full((E, D), N, np.int32)
    dvals = np.zeros((E, D, 4), np.float32)
    if with_deltas:
        for e in range(E):
            for d, (row, vec) in enumerate(_deltas(rng, N, 3)):
                drows[e, d] = row
                dvals[e, d] = vec
    cap = np.asarray(cm.capacity, np.float32)
    used = np.asarray(cm.used, np.float32)
    return cap, used, stacked, drows, dvals


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", SHAPES)
def test_place_batch_sharded_with_deltas_matches_reference(shape, form):
    cap, used, fields, drows, dvals = _scan_chain(64, 3, True, seed=11)
    ref_packed, ref_used = rs.place_batch_sharded(
        _ref_mesh(shape), cap, used, fields, drows, dvals, False)
    packed, used_sh = _fn("place_batch_sharded", form)(
        _port_mesh(shape), cap, used, fields, drows, dvals, False)
    ref = tp.unpack_outputs(np.asarray(ref_packed))
    got = tp.unpack_outputs(packed.numpy())
    for g, r in zip(got, ref):
        _same(g, r)
    _same(torch.cat(used_sh), np.asarray(ref_used), "used")
    # the chain carries the deltas: equal to the single-device K3
    heavy = np.stack([tp.pack_heavy(_eval_inputs(fields, e, cap, used))
                      for e in range(3)])
    S = fields["demand"].shape[1]
    dyn = np.concatenate([tp.pack_light(
        _eval_inputs(fields, e, cap, used),
        [(int(r), dvals[e, d]) for d, r in enumerate(drows[e]) if r < 64],
        64, S) for e in range(3)])
    k3, k3_used = tp.place_batch_packed(
        torch.from_numpy(cap), torch.from_numpy(used), torch.from_numpy(heavy),
        torch.from_numpy(dyn), (fields["feasible"].shape[1], 64,
                                fields["spread_wfrac"].shape[2],
                                fields["spread_desired"].shape[3], S, 64))
    single = tp.unpack_outputs(k3.numpy())
    for i in (0, 3, 4, 5):
        np.testing.assert_array_equal(got[i], single[i])


def _eval_inputs(fields, e, cap, used):
    return tp.PlaceInputs(capacity=cap, used=used,
                          **{k: v[e] for k, v in fields.items()})


# ---------------------------------------------- place_bulk_batch_sharded

BULK_ORDER = ("feasible", "affinity", "has_affinity", "desired", "penalty",
              "coll0", "demand", "count", "delta_rows", "delta_vals")


def _lane_inputs(n, W, counts, with_deltas, extras, seed, D=64):
    """[W, E, ...] bulk operands: lane w chains counts[w] (count-0 pads
    after), `_bulk_eval` fields and `_deltas` from one seeded stream."""
    rng = np.random.default_rng(seed)
    cap, used = _world(rng, n)
    E = max(len(c) for c in counts)
    f = dict(feasible=np.zeros((W, E, n), bool),
             affinity=np.zeros((W, E, n), np.float32),
             has_affinity=np.zeros((W, E), bool),
             desired=np.ones((W, E), np.int32),
             penalty=np.zeros((W, E, n), bool),
             coll0=np.zeros((W, E, n), np.int32),
             demand=np.zeros((W, E, 4), np.float32),
             count=np.zeros((W, E), np.int32),
             delta_rows=np.full((W, E, D), n, np.int32),
             delta_vals=np.zeros((W, E, D, 4), np.float32))
    for w in range(W):
        for e in range(E):
            c = counts[w][e] if e < len(counts[w]) else 0
            ev = _bulk_eval(rng, n, c, extras)
            for k in ("feasible", "affinity", "penalty", "coll0", "demand",
                      "has_affinity", "desired", "count"):
                f[k][w, e] = ev[k]
            if with_deltas and c:
                for d, (r, v) in enumerate(_deltas(rng, n, 3)):
                    f["delta_rows"][w, e, d] = r
                    f["delta_vals"][w, e, d] = v
    return cap, used, f


def _ref_bulk(shape, cap, used, f, spread, fill_grid):
    return rs.place_bulk_batch_sharded(
        _ref_mesh(shape), cap, used, *[f[k] for k in BULK_ORDER],
        spread_algorithm=spread, fill_grid=fill_grid)


def _same_bulk(got, ref):
    for name, g, r in zip(("assign", "scores", "placed", "n_eval", "n_exh",
                           "waves"), got[:6], ref[:6]):
        _same(g, r, name)
    _same(torch.cat(got[6]), np.asarray(ref[6]), "used_tot")


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("spread", [False, True], ids=["binpack", "spread"])
@pytest.mark.parametrize("shape", SHAPES)
def test_place_bulk_batch_sharded_matches_reference(shape, spread, form):
    W = shape[1]
    counts = [[10, 30, 0, 120], [4, 60]] if W == 2 else [[10, 30, 120, 4]]
    cap, used, f = _lane_inputs(256, W, counts, True, True, seed=7)
    ref = _ref_bulk(shape, cap, used, f, spread, 64)
    got = _fn("place_bulk_batch_sharded", form)(
        _port_mesh(shape), cap, used, *[f[k] for k in BULK_ORDER],
        spread_algorithm=spread, fill_grid=64)
    _same_bulk(got, ref)
    placed = _np(got[2])
    for w in range(W):
        assert placed[w].tolist() == counts[w] + [0] * (placed.shape[1]
                                                        - len(counts[w]))


def test_place_bulk_batch_sharded_small_grid_and_donation():
    """fill_grid 16 and donation: the merged basis lands in the used0
    shards themselves, bit-equal between the two forms."""
    cap, used, f = _lane_inputs(64, 2, [[8, 3], [16]], False, False, seed=2)
    ref = _ref_bulk((4, 2), cap, used, f, False, 16)
    mesh = _port_mesh((4, 2))
    outs = []
    for form in FORMS:
        u0 = ps.put(mesh, used, 0)
        out = _fn("place_bulk_batch_sharded", form)(
            mesh, cap, u0, *[f[k] for k in BULK_ORDER], fill_grid=16,
            donate=True)
        assert all(a is b for a, b in zip(out[6], u0))
        _same_bulk(out, ref)
        outs.append(out)
    for x, y in zip(outs[0][:6], outs[1][:6]):
        assert torch.equal(x, y)
    assert torch.equal(torch.cat(outs[0][6]), torch.cat(outs[1][6]))


def test_bulk_chain_with_deltas_splits_from_unsharded_only_in_the_carry():
    """The sharded chain backs an eval's deltas out as `used_f - (used -
    used_in)` (reference sharded.py:539, :625), K4 as `used_f - delta_mat`
    (ops/place.py:793-828).  The two round differently: on non-integer
    usage the carries differ in the last bits of delta rows.  On this
    input that changes no placement in either package; the reference's
    sharded and unsharded scores split in the last bit of one row (a
    reference split, ROADMAP queue C), the port's do not."""
    n, E, D = 64, 4, 64
    rng = np.random.default_rng(3)
    cap, used = _world(rng, n)
    used = used + rng.random((n, 4)).astype(np.float32) * np.float32(0.37)
    cap[:, 0], cap[:, 1] = 1000, 2048
    evs = [_bulk_eval(rng, n, 20, True) for _ in range(E)]
    drows = np.full((1, E, D), n, np.int32)
    dvals = np.zeros((1, E, D, 4), np.float32)
    for e in range(E):
        drows[0, e, :5] = rng.choice(n, 5, replace=False)
        dvals[0, e, :5, 0] = (rng.random(5) * 300 - 150).astype(np.float32)
        dvals[0, e, :5, 1] = (rng.random(5) * 500 - 250).astype(np.float32)
    f = {k: np.stack([np.asarray(ev[k]) for ev in evs])[None]
         for k in ("feasible", "affinity", "has_affinity", "desired",
                   "penalty", "coll0", "demand", "count")}
    f["delta_rows"], f["delta_vals"] = drows, dvals
    f["has_affinity"] = f["has_affinity"].astype(bool)
    f["desired"] = f["desired"].astype(np.int32)
    f["count"] = f["count"].astype(np.int32)
    # the two back-out expressions on this input's first eval
    u_in, d = used.copy(), np.zeros_like(used)
    for k in range(5):
        d[drows[0, 0, k]] += dvals[0, 0, k]
    sharded_back = (u_in + d) - ((u_in + d) - u_in)
    unsharded_back = (u_in + d) - d
    assert not np.array_equal(sharded_back, unsharded_back)
    # ... and the kernels' outputs
    ref = _ref_bulk((8, 1), cap, used, f, False, 64)
    heavy = np.stack([tp.pack_bulk_heavy(ev["feasible"], ev["affinity"],
                                         ev["penalty"], ev["coll0"])
                      for ev in evs])
    dyn = np.concatenate([tp.pack_bulk_light(
        ev["has_affinity"], ev["desired"], ev["count"], ev["demand"],
        [(int(drows[0, e, k]), dvals[0, e, k]) for k in range(5)], n, D)
        for e, ev in enumerate(evs)])
    ref_k4, _ = rp.place_bulk_batch_jit(cap, used, heavy, dyn, D)
    ref_k4 = tp.unpack_bulk_batch(np.asarray(ref_k4), n)
    t = torch.from_numpy
    k4, _ = tp.place_bulk_batch(t(cap), t(used.copy()), t(heavy), t(dyn), D)
    k4 = tp.unpack_bulk_batch(k4.numpy(), n)
    got = ps.place_bulk_batch_sharded_plain(
        _port_mesh((8, 1)), cap, used, *[f[k] for k in BULK_ORDER])
    _same_bulk(got, ref)
    # sharded vs unsharded, each package against itself: the same rows
    # and counts; scores within RTOL (the reference's split in the last
    # bit of one row's score here, eval 2 row 59; the port's are equal)
    for sharded, single in ((ref, ref_k4), (got, k4)):
        np.testing.assert_array_equal(_np(sharded[0])[0], single[0])
        np.testing.assert_array_equal(_np(sharded[2])[0], single[2])
        _same(_np(sharded[1])[0], single[1])


# --------------------------------------------------------- sharded world

def test_local_scatters_match_reference():
    """K5' (set_rows_local / add_rank1_local through serving_update_fns)
    against the reference's shard_map scatters, bit for bit."""
    rng = np.random.default_rng(9)
    N, R = 64, 4
    base = (rng.integers(0, 40, (N, R)) * 100).astype(np.float32)
    base[:, 2] = rng.random(N).astype(np.float32) * 1000
    rows = np.full(16, N, np.int32)
    rows[:10] = rng.choice(N, 10, replace=False)
    vals = rng.random((16, R)).astype(np.float32) * 500
    counts = rng.integers(-2, 4, 16).astype(np.int32)
    dem = rng.random(R).astype(np.float32) * 50
    for shape in SHAPES:
        rmesh = _ref_mesh(shape)
        sh = NamedSharding(rmesh, P("node_shard", None))
        set_fn, add_fn = rs.serving_update_fns(rmesh)
        ref_set = np.asarray(set_fn(jax.device_put(base, sh), rows, vals))
        ref_add = np.asarray(add_fn(jax.device_put(base, sh), rows, counts,
                                    dem))
        mesh = _port_mesh(shape)
        p_set, p_add = ps.serving_update_fns(mesh)
        NS = shape[0]
        t = torch.from_numpy
        got_set = p_set(ps.put(mesh, base, 0), [t(rows)] * NS,
                        [t(vals)] * NS)
        got_add = p_add(ps.put(mesh, base, 0), [t(rows)] * NS,
                        [t(counts)] * NS, [t(dem)] * NS)
        np.testing.assert_array_equal(torch.cat(got_set).numpy(), ref_set)
        np.testing.assert_array_equal(torch.cat(got_add).numpy(), ref_add)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_device_world_parity_randomized(shape):
    """tests/test_sharded.py test_device_world_parity_randomized[use_mesh]
    for the port: the node-sharded world equals a from-scratch rebuild,
    bit for bit, after randomized rank-1 commits, preemptions, row churn
    and an epoch change; no scatter launches a kernel on CPU shards."""
    rng = np.random.default_rng(7)
    N, R = 64, 4
    mesh = _port_mesh(shape)
    world = tw.DeviceWorld(mesh=mesh)
    before = dict(tw.launches)
    capacity = rng.uniform(100, 1000, (N, R)).astype(np.float32)
    truth = np.zeros((N, R), np.float32)
    world.update(capacity, truth.copy())

    def check():
        cap_dev, basis_dev = world.device_arrays()
        assert len(basis_dev) == shape[0]
        np.testing.assert_array_equal(torch.cat(basis_dev).numpy(), truth)
        np.testing.assert_array_equal(torch.cat(cap_dev).numpy(), capacity)
        np.testing.assert_array_equal(world.host_basis(), truth)

    for _ in range(60):
        op = rng.integers(0, 4)
        if op == 0:
            k = int(rng.integers(1, 9))
            rows = rng.choice(N, k, replace=False).astype(np.int32)
            counts = rng.integers(1, 4, k).astype(np.int32)
            demand = rng.uniform(0, 50, R).astype(np.float32)
            world.apply_rank1(rows, counts, demand)
            truth[rows] += counts[:, None].astype(np.float32) * demand
        elif op == 1:
            k = int(rng.integers(1, 5))
            rows = rng.choice(N, k, replace=False).astype(np.int32)
            demand = rng.uniform(0, 20, R).astype(np.float32)
            world.apply_rank1(rows, np.full(k, -1, np.int32), demand)
            truth[rows] -= demand
        elif op == 2:
            k = int(rng.integers(1, 6))
            rows = rng.choice(N, k, replace=False)
            capacity[rows] = rng.uniform(100, 1000, (k, R))
            truth[rows] = 0.0
            world.update(capacity, truth.copy())
        else:
            world.update(capacity, truth.copy())
        check()
    cap2 = rng.uniform(100, 1000, (2 * N, R)).astype(np.float32)
    cap2[:N] = capacity
    truth2 = np.zeros((2 * N, R), np.float32)
    truth2[:N] = truth
    capacity, truth = cap2, truth2
    world.update(capacity, truth.copy())
    rows = rng.choice(2 * N, 5, replace=False).astype(np.int32)
    demand = rng.uniform(0, 50, R).astype(np.float32)
    world.apply_rank1(rows, np.ones(5, np.int32), demand)
    truth[rows] += demand
    check()
    assert world.stats["full_uploads"] >= 2
    assert world.stats["rows_scattered"] > 0
    assert tw.launches == before
    tw.warm_scatter((N, R), mesh=mesh)
    assert tw.launches == before


def test_sharded_world_loan_adopt_and_force_scatter():
    mesh = _port_mesh((4, 2))
    w = tw.DeviceWorld(mesh=mesh)
    N = 64
    cap = np.full((N, 4), 100.0, np.float32)
    host = np.zeros((N, 4), np.float32)
    _, basis = w.update(cap, host.copy())
    loaned = w.loan_basis()
    assert loaned is basis and w.device_arrays()[1] is None
    w.adopt_basis(loaned)
    # churn past a quarter of the rows with force_scatter scatters in
    # chunks instead of uploading in full
    host[: N // 2] = 7.0
    w.update(cap, host.copy(), force_scatter=True)
    np.testing.assert_array_equal(torch.cat(w.device_arrays()[1]).numpy(),
                                  host)
    assert w.stats["full_uploads"] == 1
    with pytest.raises(TypeError):
        tw.DeviceWorld(mesh=object())


# ---------------------------------------------------------------- engine

def _port_cm(ref_cm):
    return cluster_matrix_from_numpy(cluster_matrix_arrays(ref_cm))


def _port_request(cm, fields):
    return _Request(cm=cm, inputs=tp.PlaceInputs(**fields), deltas=[],
                    spread_algorithm=False, future=Future())


def _bulk_spec(ref_cm, count, wave_key=""):
    bj = ref_mock.batch_job()
    btg = bj.task_groups[0]
    btg.count = count
    btg.ephemeral_disk.size_mb = 0
    g = RefDenseStack(ref_cm).compile_group(bj, btg)
    N = ref_cm.n_rows
    return dict(feasible=g.feasible, affinity=g.affinity.astype(np.float32),
                has_affinity=bool(g.has_affinity), desired=count,
                penalty=np.zeros(N, bool), coll0=np.zeros(N, np.int32),
                demand=g.demand.astype(np.float32), count=count,
                wave_key=wave_key)


@pytest.fixture
def engines():
    made = []

    def make(**kw):
        e = PlacementEngine(device="cpu", **kw)
        made.append(e)
        return e
    yield make
    for e in made:
        e.stop()
    eng_mod.stop_engines()


def _sharded_engine(make, shape=(4, 2)):
    return make(shard_min_nodes=8,
                mesh_devices=CPU8[:shape[0] * shape[1]])


def test_engine_sharded_serving_parity(engines):
    """tests/test_sharded.py test_engine_sharded_serving_parity for the
    port: the chained scan and a bulk eval over the (4, 2) mesh give the
    single-device engine's placements (and the reference's)."""
    ref_cm = _mixed_world(1024)
    cm = _port_cm(ref_cm)
    count = 12
    inp, fields = _scan_inputs(ref_cm, _mixed_job(count), count)
    single = rp.place_eval(inp, False)
    sh = _sharded_engine(engines)
    one = engines()
    assert sh._mesh_for(cm.n_rows) is not None
    assert one._mesh_for(cm.n_rows) is None
    for eng in (sh, one):
        reqs = [_port_request(cm, fields) for _ in range(2)]
        eng._dispatch(reqs)
        res, ticket = reqs[0].future.result(timeout=60)
        np.testing.assert_array_equal(res.node[:count], single.node[:count])
        np.testing.assert_allclose(res.score[:count], single.score[:count],
                                   rtol=RTOL)
        eng.complete(ticket)
        eng.complete(reqs[1].future.result(timeout=60)[1])
    assert sh.stats["sharded_evals"] == 2 and one.stats["sharded_evals"] == 0
    spec = _bulk_spec(ref_cm, 30)
    outs = []
    for eng in (sh, one):
        assign, placed, n_eval, n_exh, scores, tkt = eng.place_bulk(cm, **spec)
        outs.append((assign, placed, n_eval, n_exh, scores))
        eng.complete(tkt)
    (a1, p1, e1, x1, s1), (a2, p2, e2, x2, s2) = outs
    np.testing.assert_array_equal(a1, a2)
    assert p1 == p2 == 30 and (e1, x1) == (e2, x2)
    # the single-device kernel's sparse output keeps the scores of the
    # assigned rows only (-inf elsewhere); the sharded output is dense
    rows = np.flatnonzero(a2)
    _same(s1[rows], s2[rows])
    assert sh.stats["sharded_evals"] == 3


def test_engine_sharded_c2m_scale_mixed_batch(engines):
    """tests/test_sharded.py test_engine_sharded_c2m_scale_mixed_batch for
    the port, cut to 1,024 nodes: a small-count bulk, a large-count bulk
    and a spread scan eval through the (8, 1) mesh give the single-device
    engine's placements."""
    ref_cm = _mixed_world(1024)
    cm = _port_cm(ref_cm)
    small, large = _bulk_spec(ref_cm, 10), _bulk_spec(ref_cm, 200)
    count = 40
    _inp, fields = _scan_inputs(ref_cm, _mixed_job(count), count)

    def run(eng):
        out = {}
        a1, p1, *_r, t1 = eng.place_bulk(cm, **small)
        eng.complete(t1)
        a2, p2, *_r, t2 = eng.place_bulk(cm, **large)
        eng.complete(t2)
        req = _port_request(cm, fields)
        eng._dispatch([req])
        res, t3 = req.future.result(timeout=120)
        eng.complete(t3)
        out.update(a1=a1, p1=p1, a2=a2, p2=p2, nodes=res.node[:count].copy(),
                   scores=res.score[:count].copy(),
                   sharded=eng.stats["sharded_evals"])
        return out

    sharded = run(_sharded_engine(engines, (8, 1)))
    single = run(engines())
    assert sharded["sharded"] == 3 and single["sharded"] == 0
    assert sharded["p1"] == single["p1"] == 10
    assert sharded["p2"] == single["p2"] == 200
    np.testing.assert_array_equal(sharded["a1"], single["a1"])
    np.testing.assert_array_equal(sharded["a2"], single["a2"])
    np.testing.assert_array_equal(sharded["nodes"], single["nodes"])
    np.testing.assert_allclose(sharded["scores"], single["scores"], rtol=RTOL)


def test_engine_wave_lanes_score_independent_namespaces(engines):
    """Requests of two namespaces in one dispatch run in two lanes, each
    against the shared basis, so each equals its own single-device run;
    the donated merged basis equals the host snapshot bit for bit."""
    ref_cm = _mixed_world(256)
    cm = _port_cm(ref_cm)
    sa, sb = _bulk_spec(ref_cm, 12, "ns-a"), _bulk_spec(ref_cm, 9, "ns-b")
    alone = []
    for spec in (sa, sb):
        eng = engines()
        alone.append(eng.place_bulk(cm, **spec))
        eng.complete(alone[-1][5])
    sh = _sharded_engine(engines)
    futs = sh.place_bulk_begin_many(cm, [sa, sb])
    got = [f.result(timeout=60) for f in futs]
    for g, a in zip(got, alone):
        np.testing.assert_array_equal(g[0], a[0])
        assert g[1:4] == a[1:4]
    assert sh.stats["wave_lanes"] == 2 and sh.stats["lane_evals"] == 2
    assert sh.stats["lane_slots"] == 2
    assert sh.stats["donated_carries"] == sh.stats["bulk_parts"] == 1
    world = next(iter(sh._worlds.values()))
    assert world.mesh is not None
    np.testing.assert_array_equal(torch.cat(world.device_arrays()[1]).numpy(),
                                  world.host_basis())
    for g in got:
        sh.complete(g[5])
    assert sh.stats["tickets_open"] == 0


def test_engine_lane_bins_match_reference():
    from nomad_tpu.parallel.engine import PlacementEngine as RefEngine

    class R:
        def __init__(self, k):
            self.wave_key = k
    reqs = [R(k) for k in ("b", "a", "c", "a", "", "b")]
    for W in (1, 2, 4):
        got = PlacementEngine._lane_bins(reqs, W)
        ref = RefEngine._lane_bins(reqs, W)
        assert got[1] == ref[1]
        assert [[id(r) for r in b] for b in got[0]] == \
            [[id(r) for r in b] for b in ref[0]]


def test_engine_mesh_rules(engines, monkeypatch):
    sh = _sharded_engine(engines, (4, 2))
    assert sh._mesh_for(1024) is not None
    assert sh._mesh_for(6) is None                 # under shard_min_nodes
    assert sh._mesh_for(1026) is None              # not divisible by 4
    monkeypatch.setenv("NOMAD_TPU_SHARD", "0")
    assert sh._mesh_for(1024) is None
    # one visible CPU device: no mesh unless a device list is given
    monkeypatch.delenv("NOMAD_TPU_SHARD")
    assert engines(shard_min_nodes=8)._mesh_for(1024) is None
    assert sh._bulk_chunk(1024, 2) <= sh._bulk_chunk(1024, 1)


def test_install_engine_serves_get_engine(engines):
    sh = _sharded_engine(engines)
    assert eng_mod.install_engine(sh) is sh
    assert eng_mod.get_engine("cpu") is sh
    sh.stop()
    assert eng_mod.get_engine("cpu") is not sh


# ----------------------------------------------------------------- spine

def test_e2e_spine_sharded_matches_single_device(monkeypatch):
    """tests/test_sharded.py test_e2e_spine_sharded_matches_single_device
    for the port: Server(device="cpu") with a (4, 2) serving mesh against
    the single-device Server, one worker, identical per-job row maps."""
    from test_torch_server import _e2e
    monkeypatch.setenv("NOMAD_TPU_PIPELINE_DEPTH", "0")
    eng_mod.stop_engines()
    eng = eng_mod.install_engine(PlacementEngine(device="cpu",
                                                 mesh_devices=CPU8))
    try:
        sharded = _e2e("nomad_tpu_torch", {"device": "cpu"})
        assert eng.stats["sharded_evals"] >= 10
    finally:
        eng.stop()
        eng_mod.stop_engines()
    single = _e2e("nomad_tpu_torch", {"device": "cpu"})
    assert sharded[0] == single[0]
    np.testing.assert_array_equal(sharded[1], single[1])
    assert sum(sum(per.values()) for per in sharded[0].values()) == 1000


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return ps.make_mesh(2, 4, devices=["cuda:0"] * 8)


def _numpy_scan_chain(n, E, seed):
    """E chained scan evals from `_scan_eval` (numpy only), with deltas."""
    rng = np.random.default_rng(seed)
    cap, used = _world(rng, n)
    evals = [_scan_eval(rng, n, 2, 16, 2, 5) for _ in range(E)]
    fields = {name: np.stack([np.asarray(getattr(ev, name)) for ev in evals])
              for name in ps.SCAN_FIELDS}
    drows = np.full((E, 64), n, np.int32)
    dvals = np.zeros((E, 64, 4), np.float32)
    for e in range(E):
        for d, (row, vec) in enumerate(_deltas(rng, n, 3)):
            drows[e, d], dvals[e, d] = row, vec
    return cap, used, fields, drows, dvals


def test_numpy_scan_chain_forms_agree():
    """The cuda case's inputs through both CPU forms, bit for bit."""
    ops = _numpy_scan_chain(64, 2, seed=5)
    mesh = _port_mesh((4, 2))
    a, ua = ps.place_batch_sharded_plain(mesh, *ops)
    b, ub = ps.place_batch_sharded_staged(mesh, *ops)
    assert torch.equal(a, b) and torch.equal(torch.cat(ua), torch.cat(ub))
    assert (a[..., 0] >= 0).sum() > 0


@pytest.mark.cuda
def test_scan_kernels_match_plain_on_repeated_card(cuda_mesh):
    cap, used, fields, drows, dvals = _numpy_scan_chain(256, 3, seed=11)
    before = dict(k7.launches)
    packed, used_sh = ps.place_batch_sharded(cuda_mesh, cap, used, fields,
                                             drows, dvals)
    torch.cuda.synchronize()
    assert k7.launches["scan_local"] > before["scan_local"]
    cpu_mesh = _port_mesh((4, 2))
    plain, plain_used = ps.place_batch_sharded_staged(
        cpu_mesh, cap, used, fields, drows, dvals)
    assert torch.equal(packed.cpu(), plain)
    assert torch.equal(torch.cat(used_sh).cpu(), torch.cat(plain_used))


@pytest.mark.cuda
def test_eval_batch_kernels_match_plain_on_repeated_card(cuda_mesh):
    rng = np.random.default_rng(3)
    cap, used = _world(rng, 256)
    evals = []
    for _ in range(2):
        ev = _scan_eval(rng, 256, 2, 16, 2, 5)
        evals.append(dataclasses.replace(ev, capacity=cap, used=used))
    stacked = ps.stack_inputs(evals)
    got = ps.place_eval_batch_sharded(cuda_mesh, stacked)
    torch.cuda.synchronize()
    plain = ps.place_eval_batch_sharded_staged(_port_mesh((4, 2)), stacked)
    for x, y in zip(got, plain):
        assert torch.equal(x.cpu(), y)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 32768])
def test_bulk_kernels_match_plain_on_repeated_card(cuda_mesh, n):
    cap, used, f = _lane_inputs(n, 2, [[10, 30, 0, 120], [4, 60]], True,
                                True, seed=7)
    before = dict(k7.launches)
    got = ps.place_bulk_batch_sharded(cuda_mesh, cap, used,
                                      *[f[k] for k in BULK_ORDER])
    torch.cuda.synchronize()
    for name in ("bulk_stats", "bulk_run", "bulk_order", "basis_merge"):
        assert k7.launches[name] > before[name], name
    # K7f's counts come from node shard 0's K7g launch: bulk_counts
    # launched 0 times, K7g once a node shard
    assert k7.launches.get("bulk_counts", 0) == 0
    assert k7.launches["basis_merge"] - before["basis_merge"] == \
        cuda_mesh.shape[ps.NODE_AXIS_NAME]
    plain = ps.place_bulk_batch_sharded_staged(
        _port_mesh((4, 2)), cap, used, *[f[k] for k in BULK_ORDER])
    for x, y in zip(got[:6], plain[:6]):
        assert torch.equal(x.cpu(), y)
    assert torch.equal(torch.cat(got[6]).cpu(), torch.cat(plain[6]))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["scan", "eval_batch", "bulk", "scatter"])
def test_kernels_match_plain_on_a_mesh_of_four_cards(path):
    """A (4, 2) mesh over four cards, each card two shards (node shards
    and lanes across cards, most of them away from card 0, the card
    current at the call): each path's outputs bit-equal to its plain
    form on the CPU mesh, and the row scatter on each card bit-equal to
    its plain version."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four or more NVIDIA cards")
    mesh = ps.make_mesh(2, 4, devices=[f"cuda:{k % 4}" for k in range(8)])
    bits = lambda t: t.cpu().view(torch.int32)  # noqa: E731
    if path == "scan":
        ops = _numpy_scan_chain(256, 3, seed=11)
        got = ps.place_batch_sharded(mesh, *ops)
        want = ps.place_batch_sharded_staged(_port_mesh((4, 2)), *ops)
        got, want = [got[0], *got[1]], [want[0], *want[1]]
    elif path == "eval_batch":
        rng = np.random.default_rng(3)
        cap, used = _world(rng, 256)
        stacked = ps.stack_inputs([dataclasses.replace(
            _scan_eval(rng, 256, 2, 16, 2, 5), capacity=cap, used=used)
            for _ in range(2)])
        got = ps.place_eval_batch_sharded(mesh, stacked)
        want = ps.place_eval_batch_sharded_staged(_port_mesh((4, 2)), stacked)
    elif path == "bulk":
        cap, used, f = _lane_inputs(256, 2, [[10, 30, 0, 120], [4, 60]],
                                    True, True, seed=7)
        args = [f[k] for k in BULK_ORDER]
        got = ps.place_bulk_batch_sharded(mesh, cap, used, *args)
        want = ps.place_bulk_batch_sharded_staged(_port_mesh((4, 2)), cap,
                                                  used, *args)
        got, want = [*got[:6], *got[6]], [*want[:6], *want[6]]
    else:
        rng = np.random.default_rng(5)
        rows = torch.from_numpy(rng.permutation(64)[:16].astype(np.int32))
        vals = torch.from_numpy(rng.random((16, 4)).astype(np.float32))
        got, want = [], []
        for k in range(4):
            for dev, out in ((f"cuda:{k}", got), ("cpu", want)):
                d = torch.zeros((64, 4), device=dev)
                tw.scatter_segments("set_rows",
                                    [(d, 0, rows.to(dev), vals.to(dev))])
                out.append(d)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for k, (x, y) in enumerate(zip(got, want)):
        assert torch.equal(bits(x), bits(y)), k
