"""Parity of the port's bulk wavefront kernel (K1) with the reference.

The same numpy inputs go through the reference's `place_bulk_jit` (JAX on
the CPU platform of conftest.py) and the port's `place_bulk` on CPU
tensors (its plain PyTorch version).  Integer outputs (assign, placed,
n_eval, n_exh, waves) must be equal; used and scores agree within rtol
1e-5 (the reference's XLA CPU build contracts `used + m * demand` into an
FMA and evaluates pow with its own routine, so floats may differ in the
last bits; the worlds use integer resource sizes, as real nodes and jobs
do, for which both roundings are exact).
"""
import numpy as np
import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.encode import ClusterMatrix
from nomad_tpu.ops.place import place_bulk_jit, unpack_bulk as ref_unpack_bulk
from nomad_tpu.scheduler.stack import DenseStack
from nomad_tpu_torch.ops import place as tp

# one intra-op thread: the suite runs test files in parallel worker
# processes, and these small tensors gain nothing from more threads
torch.set_num_threads(1)

RTOL = 1e-5


def _both(capacity, used, feasible, affinity, has_aff, desired, penalty,
          coll0, demand, count, spread=False, fill_grid=64):
    ref = ref_unpack_bulk(np.asarray(place_bulk_jit(
        capacity, used, feasible, affinity, bool(has_aff), np.int32(desired),
        penalty, coll0, demand, np.int32(count), spread_algorithm=spread,
        fill_grid=fill_grid)))
    t = torch.from_numpy
    packed = tp.place_bulk(
        t(capacity), t(used), t(feasible), t(affinity), bool(has_aff),
        int(desired), t(penalty), t(coll0), t(demand), int(count),
        spread_algorithm=spread, fill_grid=fill_grid)
    assert packed.dtype == torch.float32 and packed.device.type == "cpu"
    got = tp.unpack_bulk(packed.numpy())
    return ref, got


def _assert_same(ref, got):
    r_assign, r_placed, r_eval, r_exh, r_scores, r_waves, r_used = ref
    assign, placed, n_eval, n_exh, scores, waves, used = got
    np.testing.assert_array_equal(assign, r_assign)
    assert (placed, n_eval, n_exh, waves) == (r_placed, r_eval, r_exh, r_waves)
    np.testing.assert_allclose(used, r_used, rtol=RTOL)
    np.testing.assert_allclose(scores, r_scores, rtol=RTOL)


def _seeded(n, count, extras, spread, seed):
    """A seeded world: integer capacities/usage/demand; `extras` turns on
    reschedule penalties, affinities and existing co-placements."""
    rng = np.random.default_rng(seed)
    cap = np.zeros((n, 4), np.float32)
    cap[:, 0] = rng.choice([2000, 4000, 8000], n)
    cap[:, 1] = rng.choice([4096, 8192, 16384], n)
    cap[:, 2] = 100000
    cap[:, 3] = 1000
    used = np.zeros((n, 4), np.float32)
    busy = rng.random(n) < 0.3
    used[busy, 0] = rng.integers(0, 10, busy.sum()) * 100
    used[busy, 1] = rng.integers(0, 10, busy.sum()) * 256
    feasible = rng.random(n) < 0.9
    if count == "over":
        demand = np.array([1500, 3000, 0, 0], np.float32)
        count = 4 * n
    else:
        demand = np.array([100, 256, 0, 0], np.float32)
    affinity = np.zeros(n, np.float32)
    penalty = np.zeros(n, bool)
    coll0 = np.zeros(n, np.int32)
    if extras:
        affinity = rng.choice(np.array([-1.0, -0.5, 0.0, 0.0, 0.5, 1.0],
                                       np.float32), n)
        penalty = rng.random(n) < 0.05
        coll0 = (rng.random(n) < 0.1).astype(np.int32) * rng.integers(1, 3, n,
                                                                      dtype=np.int32)
    return (cap, used, feasible, affinity, extras, max(count, 1), penalty,
            coll0, demand, count, spread)


@pytest.mark.parametrize("spread", [False, True], ids=["binpack", "spread"])
@pytest.mark.parametrize("extras", [False, True], ids=["plain", "pen_aff"])
@pytest.mark.parametrize("count", [2, 10, 200, "over"])
@pytest.mark.parametrize("n", [64, 1000, 4096])
def test_bulk_matches_reference_seeded(n, count, extras, spread):
    args = _seeded(n, count, extras, spread, seed=n + (7 if extras else 0))
    ref, got = _both(*args)
    _assert_same(ref, got)
    if count == "over":
        assert got[1] < args[9]          # partial placement


def _mock_world(n_nodes, seed=0, heterogeneous=True):
    rng = np.random.default_rng(seed)
    cm = ClusterMatrix(initial_rows=n_nodes)
    for _ in range(n_nodes):
        nd = mock.node()
        if heterogeneous:
            nd.node_resources.cpu.cpu_shares = int(rng.integers(2000, 8000))
            nd.node_resources.memory_mb = int(rng.integers(4096, 16384))
        cm.upsert_node(nd)
    return cm


def _mock_args(cm, count, cpu=500, mem=256, existing=()):
    job = mock.batch_job()
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = cpu
    tg.tasks[0].resources.memory_mb = mem
    tg.ephemeral_disk.size_mb = 0
    g = DenseStack(cm).compile_group(job, tg)
    coll0 = np.zeros(cm.n_rows, np.int32)
    nodes = list(cm.row_of)
    for i in existing:
        coll0[cm.row_of[nodes[i]]] += 1
    return (np.ascontiguousarray(cm.capacity),
            np.ascontiguousarray(cm.used.astype(np.float32)),
            g.feasible, g.affinity.astype(np.float32), bool(g.has_affinity),
            max(tg.count, 1), np.zeros(cm.n_rows, bool), coll0,
            g.demand.astype(np.float32), count)


# the worlds of tests/test_bulk.py: bulk vs scan shapes, existing
# collisions, overflow partial placement, the filling regime
@pytest.mark.parametrize("case", [
    dict(n=8, seed=1, count=12), dict(n=16, seed=2, count=40),
    dict(n=32, seed=3, count=100), dict(n=16, seed=4, count=7),
    dict(n=8, seed=5, count=20, het=False, existing=(0, 0)),
    dict(n=4, seed=6, count=200, het=False, cpu=900, mem=2000),
    dict(n=4, seed=7, count=64, het=False, cpu=50, mem=100),
], ids=["scan8", "scan16", "scan32", "scan16b", "collisions", "overflow",
        "filling"])
def test_bulk_matches_reference_on_bulk_worlds(case):
    cm = _mock_world(case["n"], seed=case["seed"],
                     heterogeneous=case.get("het", True))
    args = _mock_args(cm, case["count"], cpu=case.get("cpu", 500),
                      mem=case.get("mem", 256),
                      existing=case.get("existing", ()))
    ref, got = _both(*args)
    _assert_same(ref, got)


@pytest.mark.parametrize("fill_grid", list(tp.FILL_GRID_BUCKETS))
def test_bulk_fill_grid_buckets(fill_grid):
    args = _seeded(256, 10, True, False, seed=11)
    ref, got = _both(*args, fill_grid=fill_grid)
    _assert_same(ref, got)
    assert tp.fill_grid_for(10) == 16 and tp.fill_grid_for(17) == 64


def test_bulk_plain_never_counts_launches():
    before = dict(tp.launches)
    args = _seeded(64, 10, False, False, seed=3)
    _both(*args)
    assert tp.launches == before
