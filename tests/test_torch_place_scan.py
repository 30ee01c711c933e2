"""Parity of the port's scan placement kernel (K2) with the reference.

Inputs are assembled by the reference's DenseStack (numpy), or drawn from
a seeded generator, and go through the reference's `place_eval_jit` (JAX
on the CPU platform of conftest.py) and the port's `place_eval` on CPU
tensors (its plain PyTorch version).  node, n_eval, n_exh and top_nodes
must be equal; score, fit_score and top_scores agree within rtol 1e-5
(pow and contraction differ in the last bits between the two builds),
plus an absolute 1.2e-7 — one float32 ulp at 1.0, the scale of every
score — for composite scores that cancel to nearly 0, where a relative
bound means nothing.
"""
import numpy as np
import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.encode import ClusterMatrix
from nomad_tpu.ops.place import PlaceInputs as RefPlaceInputs, place_eval_jit
from nomad_tpu.scheduler.stack import DenseStack
from nomad_tpu.structs.config import SchedulerConfiguration
from nomad_tpu.structs.job import Affinity, Constraint, Operand, Spread, SpreadTarget
from nomad_tpu.structs.node import NodeCpuResources, NodeReservedResources, NodeResources
from nomad_tpu_torch.convert import cluster_matrix_from_numpy, place_inputs_from_numpy
from nomad_tpu_torch.scheduler.stack import DenseStack as PortDenseStack
from nomad_tpu_torch.ops import place as tp

# one intra-op thread: the suite runs test files in parallel worker
# processes, and these small tensors gain nothing from more threads
torch.set_num_threads(1)

RTOL = 1e-5
ATOL = 1.2e-7   # one f32 ulp at 1.0 (scores lie in [-2, 1])
FIELDS = list(tp.PLACE_INPUT_DTYPES)


def _fields(inp) -> dict:
    return {f: np.asarray(getattr(inp, f)) for f in FIELDS}


def _compare(fields: dict, spread: bool = False):
    ref = place_eval_jit(RefPlaceInputs(**fields), spread_algorithm=spread)
    got = tp.place_eval(place_inputs_from_numpy(fields, "cpu"),
                        spread_algorithm=spread)
    np.testing.assert_array_equal(got.node, np.asarray(ref.node))
    np.testing.assert_array_equal(got.nodes_evaluated,
                                  np.asarray(ref.nodes_evaluated))
    np.testing.assert_array_equal(got.nodes_exhausted,
                                  np.asarray(ref.nodes_exhausted))
    np.testing.assert_array_equal(got.top_nodes, np.asarray(ref.top_nodes))
    np.testing.assert_allclose(got.score, np.asarray(ref.score), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.fit_score, np.asarray(ref.fit_score),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.top_scores, np.asarray(ref.top_scores),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.used.numpy(), np.asarray(ref.used),
                               rtol=RTOL)
    return got


def _node(cpu, mem, res_cpu=0, res_mem=0, **over):
    n = mock.node(**over)
    n.node_resources = NodeResources(
        cpu=NodeCpuResources(cpu_shares=cpu, total_core_count=4,
                             reservable_cores=[0, 1, 2, 3]),
        memory_mb=mem, disk_mb=100_000)
    n.reserved_resources = NodeReservedResources(cpu_shares=res_cpu,
                                                 memory_mb=res_mem)
    return n


def _inputs(cm, job, count=None, allocs_by_tg=None, config=None, penalty=None):
    """A scenario: the world and job, kept so that both packages' stacks
    can compile it (see `_compile`)."""
    return dict(cm=cm, job=job, count=count, allocs_by_tg=allocs_by_tg or {},
                config=config, penalty=penalty)


def _compile(stack_cls, sc, cm, **kw):
    stack = stack_cls(cm, sc["config"], **kw)
    job = sc["job"]
    groups = [stack.compile_group(job, tg) for tg in job.task_groups]
    slots = []
    for gi, g in enumerate(groups):
        slots += [gi] * (sc["count"] if sc["count"] is not None else g.tg.count)
    # the port's stack builds host numpy inputs; the reference's, jnp
    build = (stack.build_host_inputs if stack_cls is PortDenseStack
             else stack.build_inputs)
    inp = build(job, groups, slots, sc["allocs_by_tg"],
                penalty_nodes=sc["penalty"])
    return inp, stack.spread_algorithm


def _ref_fields(sc):
    inp, spread = _compile(DenseStack, sc, sc["cm"])
    return _fields(inp), spread


def cluster_matrix_arrays(cm) -> dict:
    """The arrays `cluster_matrix_from_numpy` takes, read off the
    reference's ClusterMatrix."""
    return {
        "capacity": cm.capacity, "used": cm.used, "ready": cm.ready,
        "port_words": cm.port_words, "dyn_port_lo": cm.dyn_port_lo,
        "dyn_port_hi": cm.dyn_port_hi, "class_codes": cm.class_codes,
        "class_names": list(cm.class_names), "node_ids": list(cm.node_ids),
        "attrs": {name: list(col.values)
                  for name, col in cm.attrs.columns.items()},
        "device_caps": dict(cm.device_caps),
        "device_used": dict(cm.device_used),
    }


def _cm(nodes):
    cm = ClusterMatrix(initial_rows=len(nodes))
    for n in nodes:
        cm.upsert_node(n)
    return cm


# ------------------------------------------------------------- scenarios
# The cases of tests/test_place.py and tests/test_parity_golden.py, each
# returning (fields, spread_algorithm).

def _basic():
    j = mock.job()
    j.task_groups[0].count = 4
    return _inputs(_cm([mock.node() for _ in range(4)]), j)


def _constraint():
    nodes = [mock.node() for _ in range(4)]
    special = mock.node()
    special.attributes["rack"] = "r1"
    j = mock.job()
    j.task_groups[0].count = 1
    j.constraints.append(Constraint("${attr.rack}", "r1", Operand.EQ))
    return _inputs(_cm(nodes + [special]), j)


def _infeasible():
    j = mock.job()
    j.constraints.append(Constraint("${attr.rack}", "nope", Operand.EQ))
    return _inputs(_cm([mock.node() for _ in range(2)]), j, count=1)


def _exhaustion():
    j = mock.job()
    j.task_groups[0].tasks[0].resources.cpu = 3000
    return _inputs(_cm([mock.node()]), j, count=2)


def _binpack_loaded(spread_cfg=False):
    nodes = [mock.node() for _ in range(2)]
    cm = _cm(nodes)
    cm.upsert_alloc(mock.alloc_for(mock.job(), nodes[0].id))
    cfg = SchedulerConfiguration(scheduler_algorithm="spread") if spread_cfg else None
    return _inputs(cm, mock.job(), count=1, config=cfg)


def _penalty():
    nodes = [mock.node() for _ in range(2)]
    return _inputs(_cm(nodes), mock.job(), count=1,
                   penalty={"web": {nodes[0].id}})


def _affinity(weight):
    nodes = [mock.node() for _ in range(3)]
    target = mock.node()
    target.attributes["rack"] = "fast"
    j = mock.job()
    j.affinities.append(Affinity("${attr.rack}", "fast", Operand.EQ,
                                 weight=weight))
    return _inputs(_cm(nodes + [target]), j, count=1)


def _targeted_spread():
    nodes = []
    for rack in ("r1", "r1", "r2", "r2"):
        n = mock.node()
        n.attributes["rack"] = rack
        nodes.append(n)
    j = mock.job()
    j.task_groups[0].count = 4
    j.task_groups[0].spreads = [Spread(
        "${attr.rack}", 100, (SpreadTarget("r1", 75), SpreadTarget("r2", 25)))]
    return _inputs(_cm(nodes), j)


def _even_spread():
    nodes = [mock.node(datacenter=dc) for dc in ("dc1", "dc1", "dc2", "dc2")]
    j = mock.job()
    j.datacenters = ["dc1", "dc2"]
    j.task_groups[0].count = 4
    j.task_groups[0].spreads = [Spread("${node.datacenter}", 100, ())]
    return _inputs(_cm(nodes), j)


def _distinct_hosts():
    nodes = [mock.node() for _ in range(3)]
    j = mock.job()
    j.constraints.append(Constraint(operand=Operand.DISTINCT_HOSTS))
    existing = mock.alloc_for(j, nodes[0].id)
    return _inputs(_cm(nodes), j, count=3, allocs_by_tg={"web": [existing]})


def _golden_binpack():
    cm = _cm([_node(2048, 2048, 1024, 1024), _node(1024, 1024, 512, 512),
              _node(4096, 4096, 1024, 1024)])
    j = mock.job()
    tg = j.task_groups[0]
    tg.tasks[0].resources.cpu = 1024
    tg.tasks[0].resources.memory_mb = 1024
    tg.ephemeral_disk.size_mb = 0
    return _inputs(cm, j, count=1)


def _golden_anti_affinity(penalty):
    n0, n1 = _node(4000, 8192), _node(4000, 8192)
    cm = _cm([n0, n1])
    j = mock.job()
    tg = j.task_groups[0]
    tg.count = 4
    tg.tasks[0].resources.cpu = 1000
    tg.tasks[0].resources.memory_mb = 2048
    tg.ephemeral_disk.size_mb = 0
    a1 = mock.alloc_for(j, node_id=n0.id)
    a2 = mock.alloc_for(j, node_id=n0.id, index=1)
    cm.upsert_alloc(a1)
    cm.upsert_alloc(a2)
    return _inputs(cm, j, count=4, allocs_by_tg={tg.name: [a1, a2]},
                   penalty={tg.name: {n0.id}} if penalty else None)


def _golden_node_affinity():
    n0 = mock.node()
    n0.attributes["kernel.version"] = "4.9"
    nodes = [n0, mock.node(datacenter="dc2"),
             mock.node(datacenter="dc2", node_class="large"), mock.node()]
    j = mock.job()
    j.datacenters = ["dc1", "dc2"]
    tg = j.task_groups[0]
    tg.affinities = [
        Affinity("${node.datacenter}", "dc1", "=", 100),
        Affinity("${node.datacenter}", "dc2", "=", -100),
        Affinity("${attr.kernel.version}", ">4.0", "version", 50),
        Affinity("${node.class}", "large", "is", 50),
    ]
    return _inputs(_cm(nodes), j, count=6)


def _golden_spread(even):
    dcs = ("dc1", "dc2") if even else ("dc1", "dc2", "dc1", "dc1")
    nodes = [mock.node(datacenter=dc) for dc in dcs]
    j = mock.job()
    j.datacenters = ["dc1", "dc2"]
    tg = j.task_groups[0]
    tg.count = 10
    tg.tasks[0].resources.cpu = 100
    tg.tasks[0].resources.memory_mb = 100
    tg.ephemeral_disk.size_mb = 0
    if even:
        tg.spreads = [Spread("${node.datacenter}", 100, ())]
        existing = [mock.alloc(job=j, node_id=nodes[0].id)]
    else:
        tg.spreads = [Spread("${node.datacenter}", 100,
                             (SpreadTarget("dc1", 80),))]
        existing = [mock.alloc(job=j, node_id=nodes[0].id),
                    mock.alloc(job=j, node_id=nodes[2].id)]
    return _inputs(_cm(nodes), j, count=10, allocs_by_tg={tg.name: existing})


SCENARIOS = {
    "basic": _basic, "constraint": _constraint, "infeasible": _infeasible,
    "exhaustion": _exhaustion, "binpack_loaded": _binpack_loaded,
    "spread_algorithm": lambda: _binpack_loaded(True), "penalty": _penalty,
    "affinity": lambda: _affinity(100), "anti_affinity": lambda: _affinity(-100),
    "targeted_spread": _targeted_spread, "even_spread": _even_spread,
    "distinct_hosts": _distinct_hosts, "golden_binpack": _golden_binpack,
    "golden_job_anti_affinity": lambda: _golden_anti_affinity(False),
    "golden_normalization": lambda: _golden_anti_affinity(True),
    "golden_node_affinity": _golden_node_affinity,
    "golden_spread_targeted": lambda: _golden_spread(False),
    "golden_spread_even": lambda: _golden_spread(True),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scan_matches_reference_on_scenarios(name):
    fields, spread = _ref_fields(SCENARIOS[name]())
    _compare(fields, spread)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_port_stack_compiles_the_reference_world(name):
    """The reference's ClusterMatrix carried into the port
    (convert.cluster_matrix_from_numpy) and compiled by the port's
    DenseStack gives the reference stack's inputs, field for field, and
    the same placements."""
    sc = SCENARIOS[name]()
    fields, spread = _ref_fields(sc)
    cm = cluster_matrix_from_numpy(cluster_matrix_arrays(sc["cm"]))
    inp, port_spread = _compile(PortDenseStack, sc, cm, device="cpu")
    assert port_spread == spread
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(inp, f), fields[f],
                                      err_msg=f)
    _compare(fields, spread)


# ------------------------------------------------------------- seeded worlds

def _seeded(n, g, s, k, v, seed, spread_alg):
    """Every feature of the kernel at once: several groups, targeted and
    even spreads, affinity, penalty, existing co-placements, per-node
    instance budgets, inactive padding slots.  Integer resource sizes."""
    rng = np.random.default_rng(seed)
    cap = np.zeros((n, 4), np.float32)
    cap[:, 0] = rng.choice([2000, 4000, 8000], n)
    cap[:, 1] = rng.choice([4096, 8192, 16384], n)
    cap[:, 2] = 100000
    cap[:, 3] = 1000
    used = np.zeros((n, 4), np.float32)
    used[:, 0] = rng.integers(0, 8, n) * 100
    used[:, 1] = rng.integers(0, 8, n) * 256
    vidx = rng.integers(0, v + 1, (g, k, n)).astype(np.int32)  # v = missing
    desired = np.full((g, k, v + 1), -1.0, np.float32)
    targeted = rng.random((g, k)) < 0.5
    for gi in range(g):
        for ki in range(k):
            if targeted[gi, ki]:
                desired[gi, ki, :v] = rng.integers(0, 6, v)
    counts = np.zeros((g, k, v + 1), np.float32)
    counts[..., :v] = rng.integers(0, 3, (g, k, v))
    wfrac = rng.choice(np.array([0.25, 0.5, 1.0], np.float32), (g, k))
    active = rng.random((g, k)) < 0.8
    slot_active = np.ones(s, bool)
    slot_active[-2:] = False
    demand = np.zeros((s, 4), np.float32)
    slot_tg = rng.integers(0, g, s).astype(np.int32)
    per_group = rng.integers(1, 6, (g, 2)) * np.array([100, 256])
    demand[:, :2] = per_group[slot_tg]
    return dict(
        capacity=cap, used=used, feasible=rng.random((g, n)) < 0.9,
        affinity=rng.choice(np.array([-1.0, -0.5, 0.0, 0.0, 0.5, 1.0],
                                     np.float32), (g, n)),
        has_affinity=rng.random(g) < 0.5,
        desired_count=rng.integers(1, 20, g).astype(np.int32),
        penalty=rng.random((g, n)) < 0.05,
        tg_count=(rng.random((g, n)) < 0.1).astype(np.int32),
        spread_vidx=vidx, spread_desired=desired, spread_targeted=targeted,
        spread_wfrac=wfrac, spread_counts=counts, spread_active=active,
        place_cap=np.where(rng.random((g, n)) < 0.2,
                           rng.integers(0, 3, (g, n)), -1).astype(np.int32),
        demand=demand, slot_tg=slot_tg, slot_active=slot_active,
    ), spread_alg


@pytest.mark.parametrize("spread_alg", [False, True], ids=["binpack", "spread"])
@pytest.mark.parametrize("n,g,s,k,v", [
    (64, 1, 16, 1, 4), (64, 3, 32, 2, 5), (1000, 2, 64, 2, 8),
    (4096, 2, 32, 3, 50),
])
def test_scan_matches_reference_seeded(n, g, s, k, v, spread_alg):
    fields, spread = _seeded(n, g, s, k, v, seed=n + g + s, spread_alg=spread_alg)
    got = _compare(fields, spread)
    assert (got.node[:-2] >= 0).any()
    assert (got.node[-2:] == -1).all()


def test_scan_plain_never_counts_launches():
    before = dict(tp.launches)
    fields, spread = _ref_fields(_basic())
    _compare(fields, spread)
    assert tp.launches == before


def test_place_inputs_from_numpy_dtypes_and_device():
    fields, _ = _ref_fields(_basic())
    inp = place_inputs_from_numpy(fields, "cpu")
    for name, dtype in tp.PLACE_INPUT_DTYPES.items():
        t = getattr(inp, name)
        assert t.dtype == dtype and t.device.type == "cpu", name
        np.testing.assert_array_equal(t.numpy(), fields[name])
