"""The port's PlacementEngine on the CPU, held against the reference's.

Counterparts of tests/test_engine.py, tests/test_bulk.py's engine cases
and tests/test_wave_pipeline.py's stats-shape check: each builds one world
in the reference (nomad_tpu.encode.ClusterMatrix) and carries it into the
port (convert.cluster_matrix_from_numpy), sends the same requests to the
reference engine (single-device: shard_min_nodes=1 << 30) and to the
port's engine (device="cpu", the plain versions), and compares.  Node
rows, counts, placed and eval counts must be equal; scores agree within
rtol 1e-5 (the reference's XLA CPU build contracts multiply-adds and
evaluates pow with its own routine).

Then the scheduler with both packages engine-on (the reference with
NOMAD_TPU_SHARD=0, so its engine stays single-device on conftest.py's
eight virtual CPU devices): the 1,000-node parity stream and the 64-node
C2M filling stream must give identical per-job row/count maps and equal
committed usage.

Every engine a test makes is stopped by a fixture.
"""
import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import nomad_tpu.mock as ref_mock
import nomad_tpu.scheduler.testing as ref_testing
import nomad_tpu.structs.job as ref_job
import nomad_tpu_torch.mock as port_mock
import nomad_tpu_torch.scheduler.testing as port_testing
import nomad_tpu_torch.structs.job as port_job
from nomad_tpu.encode import ClusterMatrix as RefClusterMatrix
from nomad_tpu.ops.place import place_bulk_jit, place_eval as ref_place_eval
from nomad_tpu.ops.place import unpack_bulk as ref_unpack_bulk
from nomad_tpu.parallel import engine as ref_engine_mod
from nomad_tpu.scheduler.stack import DenseStack as RefDenseStack
from nomad_tpu_torch.convert import cluster_matrix_from_numpy
from nomad_tpu_torch.ops import place as tp
from nomad_tpu_torch.parallel import engine as eng_mod
from nomad_tpu_torch.parallel.engine import (
    _DELTA_BUCKET,
    PlacementEngine,
    _Request,
    get_engine,
)
from test_torch_place_scan import cluster_matrix_arrays
from test_torch_scheduler import _c2m_filling, _drive

torch.set_num_threads(1)

RTOL = 1e-5


@pytest.fixture
def engines():
    """(port engine on the CPU, single-device reference engine); both
    stopped after the test, with any engine get_engine made."""
    made = []

    def make(port_kw=None):
        pe = PlacementEngine(device="cpu", **(port_kw or {}))
        re_ = ref_engine_mod.PlacementEngine(shard_min_nodes=1 << 30)
        made.extend([pe, re_])
        return pe, re_
    yield make
    for e in made:
        e.stop()
    eng_mod.stop_engines()


def _worlds(n_nodes=16, heterogeneous=False, seed=0):
    rng = np.random.default_rng(seed)
    ref = RefClusterMatrix(initial_rows=n_nodes)
    for i in range(n_nodes):
        nd = ref_mock.node()
        nd.attributes["rack"] = f"r{i % 4}"
        if heterogeneous:
            nd.node_resources.cpu.cpu_shares = int(rng.integers(2000, 8000))
            nd.node_resources.memory_mb = int(rng.integers(4096, 16384))
        ref.upsert_node(nd)
    return ref, cluster_matrix_from_numpy(cluster_matrix_arrays(ref))


def _requests(ref_cm, port_cm, count=5, deltas=()):
    """The same scan request for both engines: reference DenseStack
    inputs (numpy), and the same arrays as the port's host inputs."""
    job = ref_mock.batch_job()
    job.task_groups[0].count = count
    stack = RefDenseStack(ref_cm)
    groups = [stack.compile_group(job, tg) for tg in job.task_groups]
    used = ref_cm.used.copy()
    for row, vec in deltas:
        used[row] += vec
    inputs = stack.build_inputs(job, groups, [0] * count, {},
                                used_override=used)
    fields = {f: np.array(getattr(inputs, f)) for f in tp.PLACE_INPUT_DTYPES}
    ref = ref_engine_mod._Request(cm=ref_cm, inputs=inputs,
                                  deltas=list(deltas), spread_algorithm=False,
                                  future=Future())
    port = _Request(cm=port_cm, inputs=tp.PlaceInputs(**fields),
                    deltas=list(deltas), spread_algorithm=False,
                    future=Future())
    return ref, port


def _serial_reference(cm, reqs):
    """tests/test_engine.py's sequential processing with the chained
    semantics the batch kernel implements (deltas stay in the carry)."""
    used = cm.used.copy()
    results = []
    for r in reqs:
        u = used.copy()
        for row, vec in r.deltas:
            u[row] += vec
        inp = r.inputs
        inp.used = u
        res = ref_place_eval(inp, r.spread_algorithm)
        results.append(res)
        used = u
        for si in range(inp.demand.shape[0]):
            row = int(res.node[si])
            if row >= 0:
                used[row] += inp.demand[si]
    return results


def _dispatch_both(pe, re_, pairs):
    re_._dispatch([r for r, _ in pairs])
    pe._dispatch([p for _, p in pairs])
    out = []
    for r, p in pairs:
        ref_res, ref_ticket = r.future.result(timeout=60)
        got, ticket = p.future.result(timeout=60)
        out.append((ref_res, got))
        re_.complete(ref_ticket)
        pe.complete(ticket)
    return out


def _same_result(got, ref, s):
    np.testing.assert_array_equal(got.node[:s], np.asarray(ref.node)[:s])
    np.testing.assert_allclose(got.score[:s], np.asarray(ref.score)[:s],
                               rtol=RTOL)
    np.testing.assert_array_equal(got.nodes_evaluated[:s],
                                  np.asarray(ref.nodes_evaluated)[:s])
    np.testing.assert_array_equal(got.top_nodes[:s],
                                  np.asarray(ref.top_nodes)[:s])


# ------------------------------------------------- tests/test_engine.py

def test_batch_matches_serial_chained(engines):
    pe, re_ = engines()
    ref_cm, port_cm = _worlds()
    pairs = [_requests(ref_cm, port_cm, count=3) for _ in range(4)]
    expected = _serial_reference(
        ref_cm, [_requests(ref_cm, port_cm, count=3)[0] for _ in range(4)])
    for (ref_res, got), exp in zip(_dispatch_both(pe, re_, pairs), expected):
        _same_result(got, ref_res, 3)
        _same_result(got, exp, 3)
    assert pe.stats["batched_evals"] == 4
    assert tp.launches["place_batch"] == 0        # CPU: the plain version
    assert not pe._tickets and not pe._overlays


def test_batch_applies_deltas(engines):
    pe, re_ = engines()
    ref_cm, port_cm = _worlds(n_nodes=8)
    free = np.array([-2000.0, -2000.0, 0.0, 0.0], np.float32)
    eat = np.array([3500.0, 7500.0, 0.0, 0.0], np.float32)
    pairs = [_requests(ref_cm, port_cm, count=2, deltas=[(0, free)]),
             _requests(ref_cm, port_cm, count=2, deltas=[(1, eat)])]
    expected = _serial_reference(
        ref_cm, [_requests(ref_cm, port_cm, count=2, deltas=[(0, free)])[0],
                 _requests(ref_cm, port_cm, count=2, deltas=[(1, eat)])[0]])
    for (ref_res, got), exp in zip(_dispatch_both(pe, re_, pairs), expected):
        _same_result(got, ref_res, 2)
        _same_result(got, exp, 2)


def test_concurrent_callers_coalesce(engines):
    pe, _ = engines()
    ref_cm, cm = _worlds()
    n_callers = 6
    barrier = threading.Barrier(n_callers)
    results = [None] * n_callers
    errors, tickets = [], []
    resolved_on = []

    def call(i):
        try:
            _, r = _requests(ref_cm, cm, count=3)
            barrier.wait()
            res, ticket = pe.place(cm, r.inputs, r.deltas,
                                   r.spread_algorithm)
            results[i] = res
            tickets.append(ticket)
        except Exception as e:                  # noqa: BLE001
            errors.append(e)

    orig = PlacementEngine._fetch_resolve_scan

    def spy(self, reqs, packed):
        resolved_on.append(threading.current_thread().name)
        return orig(self, reqs, packed)

    PlacementEngine._fetch_resolve_scan = spy
    try:
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(n_callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        PlacementEngine._fetch_resolve_scan = orig
    for t_ in tickets:
        pe.complete(t_)
    assert not errors
    assert all(r is not None for r in results)
    for r in results:
        assert (r.node[:3] >= 0).all()
    # futures resolve on the dispatcher thread, never the callers'
    assert set(resolved_on) <= {"placement-engine"}
    total = cm.used.copy()
    demand = _requests(ref_cm, cm, count=3)[1].inputs.demand
    for r in results:
        for si in range(3):
            total[int(r.node[si])] += demand[si]
    assert (total <= cm.capacity + 1e-3).all()


def test_packed_cache_hits_and_single_path(engines):
    pe, re_ = engines()
    ref_cm, port_cm = _worlds()
    pair = _requests(ref_cm, port_cm, count=3)
    (ref_res, got), = _dispatch_both(pe, re_, [pair])
    _same_result(got, ref_res, 3)
    exp = tp.place_eval(tp.PlaceInputs(**{
        f: torch.from_numpy(np.ascontiguousarray(getattr(pair[1].inputs, f)))
        for f in tp.PLACE_INPUT_DTYPES}))
    np.testing.assert_array_equal(got.node[:3], exp.node[:3])
    assert pe._cache.misses >= 1
    assert pe.stats["single_evals"] == 1
    misses0 = pe._cache.misses
    pairs = [_requests(ref_cm, port_cm, count=3) for _ in range(4)]
    _dispatch_both(pe, re_, pairs)
    assert pe._cache.misses == misses0            # all heavy blocks cached
    assert pe._cache.hits >= 4


def test_device_world_upload_never_aliases_host_snapshot(engines):
    """The engine's world (tests/test_engine.py's regression): the device
    basis must own its bytes, or the host scatter would reach it too."""
    pe, _ = engines()
    _, cm = _worlds(n_nodes=16)
    world = pe._world(cm, 16)
    N, R = 16, 4
    world.update(np.full((N, R), 100.0, np.float32),
                 np.zeros((N, R), np.float32))
    rows = np.array([0, 3], np.int32)
    demand = np.array([5.0, 2.0, 0.0, 0.0], np.float32)
    world.apply_rank1(rows, np.ones(2, np.int32), demand)
    expect = np.zeros((N, R), np.float32)
    expect[rows] = demand
    np.testing.assert_array_equal(world.device_arrays()[1].numpy(), expect)
    np.testing.assert_array_equal(world.host_basis(), expect)


def _bulk_fields(ref_cm, count, cpu=None, mem=None):
    j = ref_mock.batch_job()
    tg = j.task_groups[0]
    tg.count = count
    if cpu is not None:
        tg.tasks[0].resources.cpu = cpu
        tg.tasks[0].resources.memory_mb = mem
        tg.ephemeral_disk.size_mb = 0
    g = RefDenseStack(ref_cm).compile_group(j, tg)
    N = ref_cm.n_rows
    return dict(feasible=g.feasible, affinity=g.affinity.astype(np.float32),
                has_affinity=bool(g.has_affinity), desired=count,
                penalty=np.zeros(N, bool), coll0=np.zeros(N, np.int32),
                demand=g.demand.astype(np.float32), count=count)


@pytest.mark.parametrize("donate", ["1", "0"])
def test_engine_single_device_world_resident_across_evals(engines,
                                                          monkeypatch, donate):
    """The world stays device-resident: the second eval's dispatch diffs
    clean against the post-commit snapshot (zero rows scattered, one full
    upload), the device basis equals the host snapshot bitwise, and the
    placements match the reference engine's and a fresh engine's."""
    monkeypatch.setenv("NOMAD_TPU_DONATE", donate)
    pe, re_ = engines()
    ref_cm, port_cm = _worlds(n_nodes=32)
    bulk = _bulk_fields(ref_cm, 8)
    demand = bulk["demand"]

    def one_eval(eng, cm):
        assign, placed, _e, _x, _s, ticket = eng.place_bulk(cm, **bulk)
        for r in np.flatnonzero(assign):
            cm.used[r] += assign[r] * demand
        if ticket is not None:
            eng.complete(ticket)
        return np.asarray(assign).copy(), placed

    used0 = port_cm.used.copy()
    a1, _ = one_eval(pe, port_cm)
    a2, placed = one_eval(pe, port_cm)
    r1, _ = one_eval(re_, ref_cm)
    r2, _ = one_eval(re_, ref_cm)
    np.testing.assert_array_equal(a1, r1)
    np.testing.assert_array_equal(a2, r2)
    world = next(iter(pe._worlds.values()))
    assert world.stats["full_uploads"] == 1
    assert world.stats["rows_scattered"] == 0
    assert world.stats["rank1_applies"] >= 1
    np.testing.assert_array_equal(world.device_arrays()[1].numpy(),
                                  world.host_basis())
    assert pe.stats["donated_carries"] == (pe.stats["bulk_parts"]
                                           if donate == "1" else 0)
    committed = port_cm.used.copy()
    port_cm.used[:] = used0
    for r in np.flatnonzero(a1):
        port_cm.used[r] += a1[r] * demand
    fresh = PlacementEngine(device="cpu")
    try:
        a2_fresh, _ = one_eval(fresh, port_cm)
    finally:
        fresh.stop()
    np.testing.assert_array_equal(a2, a2_fresh)
    np.testing.assert_array_equal(port_cm.used, committed)
    assert placed == 8


# ------------------------------------------------- tests/test_bulk.py

def test_engine_bulk_batch_matches_serial(engines):
    """tests/test_bulk.py:128: concurrent place_bulk calls coalesce into
    chained dispatches and equal sequential bulk processing; the port's
    totals equal the reference engine's and the serial K1 chain's."""
    pe, re_ = engines()
    ref_cm, port_cm = _worlds(32, heterogeneous=True)
    bulk = _bulk_fields(ref_cm, 12, cpu=700, mem=900)
    N = ref_cm.n_rows
    used = ref_cm.used.astype(np.float32).copy()
    serial = []
    for _ in range(4):
        assign, placed, *_, used_f = ref_unpack_bulk(np.asarray(place_bulk_jit(
            np.ascontiguousarray(ref_cm.capacity), used, bulk["feasible"],
            bulk["affinity"], False, np.int32(12), bulk["penalty"],
            bulk["coll0"], bulk["demand"], np.int32(12))))
        serial.append(assign.copy())
        used = np.array(used_f)

    def run(eng, cm):
        results = [None] * 4
        barrier = threading.Barrier(4)

        def call(i):
            barrier.wait()
            results[i] = eng.place_bulk(cm, **bulk)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        total = np.zeros(N, np.int64)
        for assign, placed, n_eval, n_exh, scores, ticket in results:
            assert placed == 12
            total += assign
            eng.complete(ticket)
        return total

    total = run(pe, port_cm)
    np.testing.assert_array_equal(total, sum(serial))
    np.testing.assert_array_equal(total, run(re_, ref_cm))
    over = port_cm.used + total[:, None] * bulk["demand"][None, :]
    assert (over <= port_cm.capacity + 1e-3).all()
    assert pe.stats["bulk_evals"] >= 4
    assert not pe._tickets


def test_engine_bulk_overflow_deltas_not_double_counted(engines):
    """tests/test_bulk.py:202: an eval with more deltas than the bucket
    runs alone with them folded into a private basis; the overlay holds
    its placements only."""
    pe, re_ = engines()
    ref_cm, port_cm = _worlds(128)
    N = ref_cm.n_rows
    demand = np.array([100.0, 64.0, 0.0, 0.0], np.float32)
    vec = np.array([50.0, 10.0, 0.0, 0.0], np.float32)
    deltas = [(i, vec) for i in range(_DELTA_BUCKET + 8)]
    spec = dict(feasible=np.ones(N, bool), affinity=np.zeros(N, np.float32),
                has_affinity=False, desired=4, penalty=np.zeros(N, bool),
                coll0=np.zeros(N, np.int32), demand=demand, count=4,
                deltas=deltas)
    got = pe.place_bulk(port_cm, **spec)
    ref = re_.place_bulk(ref_cm, **spec)
    assign, placed, n_eval, n_exh, scores, ticket = got
    np.testing.assert_array_equal(assign, ref[0])
    assert (placed, n_eval, n_exh) == tuple(ref[1:4]) and placed == 4
    overlay = pe._overlays[id(port_cm)]
    expected = np.outer(assign.astype(np.float32), demand)
    np.testing.assert_allclose(overlay[:, :expected.shape[1]], expected,
                               rtol=1e-6)
    assert pe.stats["single_evals"] == 1
    pe.complete(ticket)
    re_.complete(ref[5])


def test_engine_bulk_overlap_chains_behind_inflight_dispatch(engines,
                                                            monkeypatch):
    """The overlap pipeline (NOMAD_TPU_OVERLAP, on with donation): a byte
    budget of one group per bulk part splits every batch into parts, and
    each part after the first is issued while the one before it is still
    pending (overlap_chained), scoring against its adopted carry.  Three
    threads submit a three-group eval at once, each adding usage on rows
    no group may use before and after it, so the chained world updates
    carry rows.  The groups' placements (identical groups: the k-th
    issued gets the k-th serial result) equal a serial replay's on the
    port and on the reference engine, and the resident basis equals the
    host snapshot bit for bit."""
    ref_cm, port_cm = _worlds(32, heterogeneous=True)
    N = port_cm.n_rows
    monkeypatch.setenv("NOMAD_TPU_BULK_BYTES", str(4 * N * 4))
    pe, re_ = engines()
    assert pe.overlap and pe._bulk_chunk(N) == 1
    threads_n, groups = 3, 3
    side = np.arange(2 * threads_n)
    spec = _bulk_fields(ref_cm, 4, cpu=700, mem=900)
    spec["feasible"] = spec["feasible"].copy()
    spec["feasible"][side] = False
    side_dem = np.array([10.0, 20.0, 0.0, 0.0], np.float32)

    def key(res):
        rows = np.flatnonzero(res[0])
        return tuple(rows.tolist()), tuple(res[0][rows].tolist())

    def serial(eng, cm):
        results = [eng.place_bulk(cm, **spec)
                   for _ in range(threads_n * groups)]
        eng.complete_many([r[5] for r in results])
        return [key(r) for r in results]

    want = serial(pe, port_cm)
    assert want == serial(re_, ref_cm)
    before = pe.stats["overlap_chained"]
    barrier = threading.Barrier(threads_n)
    got, tickets, errors = [], [], []
    lock = threading.Lock()

    def side_ticket(row):
        return pe.register_external_sparse(
            port_cm, np.array([row]), np.array([1]), side_dem)

    def call(i):
        try:
            barrier.wait()
            t_a = side_ticket(side[2 * i])
            futs = pe.place_bulk_begin_many(port_cm, [spec] * groups)
            res = [f.result(timeout=60) for f in futs]
            t_b = side_ticket(side[2 * i + 1])
            with lock:
                got.extend(key(r) for r in res)
                tickets.extend([r[5] for r in res] + [t_a, t_b])
        except Exception as e:                  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(threads_n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(got) == threads_n * groups
    assert pe.stats["overlap_chained"] - before >= threads_n * (groups - 1)
    assert sorted(got) == sorted(want)
    pe.complete_many(tickets)
    assert not pe._tickets
    world = next(iter(pe._worlds.values()))
    np.testing.assert_array_equal(world.device_arrays()[1].numpy(),
                                  world.host_basis())
    assert pe.stats["donated_carries"] == pe.stats["bulk_parts"]


# ------------------------------------------- tests/test_wave_pipeline.py

def test_engine_stats_shape_and_live_counters(engines):
    pe, _ = engines()
    expected = {"dispatches", "batched_evals", "single_evals",
                "max_batch_seen", "tickets_open", "stack_s", "put_s",
                "device_s", "resolve_s", "cache_hits", "cache_misses",
                "bulk_evals", "waves", "max_waves_seen",
                "bulk_groups", "bulk_parts", "donated_carries",
                "wave_lanes", "lane_evals", "lane_slots",
                "overlap_chained"}
    assert expected <= set(pe.stats)
    for key in expected:
        assert pe.stats[key] == 0, key
    ref_cm, cm = _worlds(8)
    batch = [_requests(ref_cm, cm, count=2)[1] for _ in range(3)]
    pe._dispatch(batch)
    for r in batch:
        _res, ticket = r.future.result(timeout=30)
        pe.complete(ticket)
    assert pe.stats["batched_evals"] == 3
    assert pe.stats["single_evals"] == 0
    solo = [_requests(ref_cm, cm, count=2)[1]]
    pe._dispatch(solo)
    _res, ticket = solo[0].future.result(timeout=30)
    pe.complete(ticket)
    assert pe.stats["single_evals"] == 1
    assert pe.stats["batched_evals"] == 3
    bulk = _bulk_fields(ref_cm, 4)
    futs = pe.place_bulk_begin_many(cm, [bulk, bulk])
    for f in futs:
        pe.complete(f.result(timeout=30)[5])
    assert pe.stats["bulk_groups"] == pe.stats["bulk_parts"] == 1
    assert pe.stats["bulk_evals"] == 2


# ------------------------------------------------- engine and device

def test_get_engine_needs_a_card_or_cpu(monkeypatch, engines):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("NOMAD_TPU_ENGINE", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        get_engine()
    with pytest.raises(RuntimeError, match="cuda"):
        get_engine("cuda")
    eng = get_engine("cpu")
    assert eng.device.type == "cpu" and get_engine("cpu") is eng
    monkeypatch.setenv("NOMAD_TPU_ENGINE", "0")
    assert get_engine("cpu") is None


def test_cpu_harness_never_gets_a_cuda_engine(monkeypatch, engines):
    monkeypatch.delenv("NOMAD_TPU_ENGINE", raising=False)
    made = []
    orig = PlacementEngine.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        made.append(self.device)

    monkeypatch.setattr(PlacementEngine, "__init__", spy)
    eng_mod.stop_engines()
    h = port_testing.Harness(device="cpu")
    for _ in range(4):
        h.store.upsert_node(h.next_index(), port_mock.node())
    for count in (1, 6):
        job = port_mock.batch_job()
        job.task_groups[0].count = count
        h.store.upsert_job(h.next_index(), job)
        ev = port_mock.eval(job_id=job.id, type="batch")
        h.store.upsert_evals(h.next_index(), [ev])
        h.process("batch", ev)
        assert len(h.store.allocs_by_job("default", job.id)) == count
    assert made and all(d.type == "cpu" for d in made)
    assert get_engine("cpu").stats["tickets_open"] == 0


# ------------------------------------------- scheduler parity, engine on

@pytest.fixture(scope="module")
def engine_on_runs():
    mp = pytest.MonkeyPatch()
    mp.setenv("NOMAD_TPU_ENGINE", "1")
    mp.setenv("NOMAD_TPU_SHARD", "0")
    try:
        ref_before = dict(ref_engine_mod.get_engine().stats)
        ref = _drive(ref_mock, ref_job, ref_testing.Harness, {})
        ref_stats = ref_engine_mod.get_engine().stats
        port = _drive(port_mock, port_job, port_testing.Harness,
                      {"device": "cpu"})
        stats = get_engine("cpu").stats
        # both runs went through their engines' bulk and scan paths, the
        # reference's on one device
        assert stats["bulk_evals"] > 0 and stats["dispatches"] > 0
        assert ref_stats["bulk_evals"] > ref_before["bulk_evals"]
        assert ref_stats.get("sharded_evals", 0) == \
            ref_before.get("sharded_evals", 0)
    finally:
        mp.undo()
        eng_mod.stop_engines()
    return ref, port


def test_scheduler_parity_engine_on_row_counts(engine_on_runs):
    ref, port = engine_on_runs
    assert port[0] == ref[0]
    assert sum(c for m in port[0].values() for tg in m.values()
               for c in tg.values()) == 3 * 100 + 20 + 10 + 1 + 4


def test_scheduler_parity_engine_on_failures_and_usage(engine_on_runs):
    ref, port = engine_on_runs
    assert port[1] == ref[1]
    assert (port[2], port[3]) == (ref[2], ref[3])
    np.testing.assert_allclose(port[4], ref[4], rtol=1e-6)


def test_c2m_filling_engine_on_matches_reference(engines):
    mp = pytest.MonkeyPatch()
    mp.setenv("NOMAD_TPU_ENGINE", "1")
    mp.setenv("NOMAD_TPU_SHARD", "0")
    try:
        ref_h, ref_maps = _c2m_filling(ref_mock, ref_job,
                                       ref_testing.Harness, {})
        h, maps = _c2m_filling(port_mock, port_job, port_testing.Harness,
                               {"device": "cpu"})
        eng = get_engine("cpu")
        world = next(iter(eng._worlds.values()))
        np.testing.assert_array_equal(world.device_arrays()[1].numpy(),
                                      world.host_basis())
        assert eng.stats["donated_carries"] == eng.stats["bulk_parts"] > 0
        assert eng.stats["tickets_open"] == 0
    finally:
        mp.undo()
    assert sum(c for m in maps.values() for tg in m.values()
               for c in tg.values()) == 2000
    assert maps == ref_maps
    np.testing.assert_array_equal(h.store.matrix.used, ref_h.store.matrix.used)
    assert (h.store.matrix.used <= h.store.matrix.capacity).all()


def test_unfused_bulk_split_matches_reference(engines, monkeypatch):
    """NOMAD_TPU_FUSE=0 splits a bulk wave by output format and delta use
    (three parts here: sparse without deltas, sparse with, dense), which
    reorders the chain; the parts chain through the overlay.  The port
    and the reference engine place the same on the same requests."""
    monkeypatch.setenv("NOMAD_TPU_FUSE", "0")
    pe, re_ = engines()
    ref_cm, cm = _worlds(64)
    vec = np.array([-100.0, 0.0, 0.0, 0.0], np.float32)
    specs = [dict(_bulk_fields(ref_cm, c, cpu=100, mem=64), deltas=d)
             for c, d in ((10, []), (20, [(3, vec)]), (200, []), (5, []))]
    futs = pe.place_bulk_begin_many(cm, specs)
    got = [f.result(timeout=60) for f in futs]
    # the reference has no multi-submit: hold its dispatcher on its queue
    # lock so the four requests enter one batch, as they do in the port
    with re_._cv:
        ref_futs = [re_.place_bulk_begin(ref_cm, **s) for s in specs]
    ref = [f.result(timeout=60) for f in ref_futs]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[0], r[0])
        assert g[1:4] == r[1:4]
        pe.complete(g[5])
        re_.complete(r[5])
    assert pe.stats["bulk_parts"] == re_.stats["bulk_parts"] == 3
    assert sum(g[1] for g in got) == 235
