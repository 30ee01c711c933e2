"""K6, the preemption victim selection, against the reference.

The plain PyTorch version (`preempt_for_task_group` on CPU tensors) is
held against the reference's jitted `preempt_for_task_group` (JAX on the
CPU) and its numpy twin `preempt_for_task_group_np`, on the same seeded
numpy inputs.  Each input mixes the cases the scheduler's path meets:
rows of identical candidates (the filler allocs of one job, which tie on
every step), rows with no valid candidate, rows met before any pick,
rows that cannot be met, and zero-ask dimensions.

`met` and `picked` must be equal.  `avail` must be equal too, with a
tolerance of zero: it is `remaining` plus the picked candidates'
resources, added in pick order, and every version performs those same
float32 additions once the picks agree.

The port sums the squared coordinates in dimension order, as the numpy
twin does (the function the reference's scheduler calls).  The jitted
JAX function sums them in another order, so where two candidates' sums
are equal in exact arithmetic (their coordinates are a permutation of
each other) rounding can break the tie the other way, and the
reference's two forms then pick different victims.  The port is held
against the numpy twin on every row, and against the JAX function on
every row where the reference's two forms agree; the rows where they do
not must stay rare, and `test_reference_forms_split_on_permuted_ties`
shows one such tie (ROADMAP.md queue C).

Further cases: A = 4, 8 and 32 at R = 1 and 8 (every lane width the
kernel gives a node, its smallest and largest state); rows whose lowest
tier's distances are all +inf (argmin then picks off the tier, as an
in-tier +inf sorts above an off-tier 3.4e38) and rows with NaN
resources (NaN wins, at its lowest index); and a Python mirror of the
kernel's argmin key, reduced as the kernel reduces it, against
`torch.argmin`.

The reference is imported inside the tests, so that the one test that
needs a card (marked `cuda`; it holds the CUDA kernel against the plain
version) also runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from nomad_tpu_torch.ops import preempt as tp

torch.set_num_threads(1)


def _ref():
    return pytest.importorskip("nomad_tpu.ops.preempt")


def _inputs(seed, N, A, R):
    """Seeded candidate matrices with every row kind of the path."""
    rng = np.random.default_rng(seed)
    res = rng.choice([0.0, 100.0, 210.0, 420.0, 850.0, 1700.0],
                     size=(N, A, R)).astype(np.float32)
    res += rng.integers(0, 3, size=(N, A, R)).astype(np.float32) * 0.5
    prio = rng.choice([10, 20, 30, 40], size=(N, A)).astype(np.int32)
    valid = rng.random((N, A)) < 0.85
    rem = rng.uniform(-300.0, 600.0, size=(N, R)).astype(np.float32)
    kind = np.arange(N) % 5
    tie = kind == 1                    # identical candidates: ties
    res[tie] = res[tie][:, :1]
    prio[tie] = prio[tie][:, :1]
    valid[kind == 2] = False           # no valid candidate
    rem[kind == 3] = 5000.0            # met before any pick
    short = kind == 4                  # cannot be met
    res[short] = np.minimum(res[short], 10.0)
    rem[short] = -2000.0
    ask = rng.choice([0.0, 300.0, 420.0, 850.0], size=R).astype(np.float32)
    ask[0] = 420.0
    return res, prio, valid, rem, ask


def _port(res, prio, valid, rem, ask, max_steps):
    out = tp.preempt_for_task_group(
        *(torch.from_numpy(np.ascontiguousarray(x))
          for x in (res, prio, valid, rem, ask)), max_steps=max_steps)
    return [t.numpy() for t in out]


def _assert_same(got, want, rows=slice(None)):
    met, picked, avail = got
    np.testing.assert_array_equal(met[rows], np.asarray(want[0])[rows])
    np.testing.assert_array_equal(picked[rows], np.asarray(want[1])[rows])
    np.testing.assert_array_equal(avail[rows], np.asarray(want[2])[rows])


def _agree(a, b):
    """Rows where two results are identical in all three outputs (NaN
    avail where both have one)."""
    a2, b2 = np.asarray(a[2]), np.asarray(b[2])
    return ((np.asarray(a[0]) == np.asarray(b[0]))
            & (np.asarray(a[1]) == np.asarray(b[1])).all(axis=1)
            & ((a2 == b2) | (np.isnan(a2) & np.isnan(b2))).all(axis=1))


SHAPES = [(N, A, R) for N in (1, 64, 1024) for A in (1, 4, 16, 64)
          for R in (3, 4)]


@pytest.mark.parametrize("steps", ["full", "short"])
@pytest.mark.parametrize("N,A,R", SHAPES)
def test_plain_matches_reference_kernel_and_numpy_twin(N, A, R, steps):
    ref = _ref()
    seed = N * 1000 + A * 10 + R
    x = _inputs(seed, N, A, R)
    # the scheduler's own step count, and one shorter than some rows need
    max_steps = min(A, 32) if steps == "full" else max(1, min(A, 32) // 4)
    got = _port(*x, max_steps)
    twin = ref.preempt_for_task_group_np(*x, max_steps=max_steps)
    _assert_same(got, twin)
    jitted = ref.preempt_for_task_group(*x, max_steps=max_steps)
    same = _agree(jitted, twin)
    assert same.sum() >= N - max(1, N // 100)
    _assert_same(got, jitted, same)
    if steps == "full" and N >= 64:
        met, picked, _ = got
        kind = np.arange(N) % 5
        # the row kinds came out as built
        assert not picked[kind == 2].any() and not picked[kind == 3].any()
        assert met[kind == 3].all() and not met[kind == 4].any()


@pytest.mark.parametrize("R", [1, 8])
@pytest.mark.parametrize("A", [4, 8, 32])
def test_plain_matches_reference_at_every_segment_width(A, R):
    """The kernel gives a node 4, 8 or 32 lanes at these A; R = 1 and 8
    are its smallest and largest state."""
    ref = _ref()
    x = _inputs(7000 + A * 10 + R, 256, A, R)
    got = _port(*x, min(A, 32))
    twin = ref.preempt_for_task_group_np(*x, max_steps=min(A, 32))
    _assert_same(got, twin)
    jitted = ref.preempt_for_task_group(*x, max_steps=min(A, 32))
    same = _agree(jitted, twin)
    assert same.sum() >= 256 - 2
    _assert_same(got, jitted, same)


def _special_inputs(seed, N=96, A=16, R=4):
    """Rows whose lowest tier's distances are all +inf behind two invalid
    candidates (argmin then picks off the tier: an in-tier +inf sorts
    above an off-tier 3.4e38), and rows with NaN resources in the first
    tier and the second, in turn with `_inputs`' rows."""
    res, prio, valid, rem, ask = _inputs(seed, N, A, R)
    rng = np.random.default_rng(seed + 1)
    kind = np.arange(N) % 3
    inf = kind == 0
    valid[inf, :2] = False
    res[inf, :2] = rng.choice([105.5, 210.0, 420.0], size=(inf.sum(), 2, R))
    valid[inf, 2:6] = True
    prio[inf, 2:6] = 5
    res[inf, 2:6, 0] = 1e37
    rem[inf] = -200.0
    nan = kind == 1
    valid[nan, :6] = True
    prio[nan, :6] = [10, 10, 10, 20, 20, 20]
    res[nan, 1, 0] = np.nan
    res[nan, 2, 1 % R] = np.nan
    res[nan, 4, 0] = np.nan
    rem[nan] = -200.0
    return res, prio, valid, rem, ask


@pytest.mark.parametrize("A,R", [(16, 4), (64, 3), (8, 1)])
def test_plain_matches_reference_on_inf_and_nan_distances(A, R):
    """Against the numpy twin on every row, and against the jitted
    function on every row but, at R = 1, the +inf rows: there XLA
    rewrites sqrt(x * x) as |x|, so the jitted form scores a finite
    distance where the square overflows (ROADMAP.md queue C)."""
    ref = _ref()
    x = _special_inputs(31 + A + R, A=A, R=R)
    with np.errstate(over="ignore", invalid="ignore"):
        twin = ref.preempt_for_task_group_np(*x, max_steps=min(A, 32))
    got = _port(*x, min(A, 32))
    _assert_same(got, twin)
    jitted = ref.preempt_for_task_group(*x, max_steps=min(A, 32))
    same = _agree(jitted, twin)
    kind = np.arange(96) % 3
    if R == 1:
        assert not same[kind == 0].any() and same[kind != 0].all()
    else:
        assert same.all()
    _assert_same(got, jitted, same)
    met, picked, avail = got
    assert picked[kind == 0, 0].all()      # off the +inf tier, invalid
    assert picked[kind == 1, 1].all()      # the first NaN
    assert np.isnan(avail[kind == 1]).any(axis=1).all()
    assert not met[kind == 1].any()


def _key(d):
    """Python mirror of csrc/preempt.cu `dist_key`."""
    d = np.float32(d)
    if np.isnan(d):
        return 0
    u = int((d + np.float32(0.0)).view(np.uint32))
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)


def _kernel_argmin(dist):
    """The kernel's argmin of one node's distances, reduced as it reduces
    them: W lanes (32 for more than 32 candidates, candidate i in slot
    i // 32 of lane i % 32), each lane's least key at its lowest index,
    the segment's least key, then the least index among the lanes
    holding it."""
    A = len(dist)
    W = 32 if A > 32 else 1 << (A - 1).bit_length()
    none = 0xFFFFFFFF
    best = []
    for lane in range(W):
        bk, bi = none, none
        for i in range(lane, A, W):
            k = _key(dist[i])
            if k < bk:
                bk, bi = k, i
        best.append((bk, bi))
    kmin = min(k for k, _ in best)
    return min(i for k, i in best if k == kmin)


def test_argmin_key_orders_as_torch_argmin():
    edge = [
        [3.4e38, np.inf, np.nan, 1.0],
        [0.0, 0.0, 0.0],
        [np.inf, 3.4e38, np.inf],
        [2.0, 0.0, np.nan, np.nan, 0.0],
        [5.0, 5.0, 1.0, 1.0, 3.4e38],
        [-0.0, 0.0, 1.0],
        [0.0, -0.0],
        [np.inf] * 3,
        [3.4e38] * 40 + [1.0] + [1.0] * 30,
        [np.nan] * 70,
    ]
    rng = np.random.default_rng(0)
    for A in (1, 3, 4, 8, 16, 17, 32, 33, 64, 100):
        v = rng.choice([0.0, 0.5, 1.0, 2.5, 3.4e38, np.inf], size=A)
        edge.append(v)
        w = v.copy()
        w[rng.random(A) < 0.1] = np.nan
        edge.append(w)
        edge.append(rng.random(A) * 4.0)
    for vec in edge:
        d = np.asarray(vec, np.float32)
        want = int(torch.argmin(torch.from_numpy(d)))
        assert _kernel_argmin(d) == want, vec
        assert want == int(np.argmin(d))


def test_ties_take_the_lowest_index():
    """Identical candidates: each step picks the lowest open index."""
    res = np.full((2, 8, 4), [420.0, 850.0, 0.0, 0.0], np.float32)
    prio = np.full((2, 8), 20, np.int32)
    valid = np.ones((2, 8), bool)
    valid[1, :3] = False
    rem = np.array([[-400.0, 0.0, 0.0, 0.0]] * 2, np.float32)
    ask = np.array([420.0, 850.0, 0.0, 0.0], np.float32)
    met, picked, _ = _port(res, prio, valid, rem, ask, 8)
    assert met.all()
    assert picked[0].tolist() == [True, True] + [False] * 6
    assert picked[1].tolist() == [False] * 3 + [True, True] + [False] * 3
    _assert_same([met, picked, _],
                 _ref().preempt_for_task_group(res, prio, valid, rem, ask,
                                               max_steps=8))


def test_reference_forms_split_on_permuted_ties():
    """Two candidates whose coordinates are a permutation of each other
    have equal distances in exact arithmetic; the port and the numpy
    twin sum in dimension order and pick the same one."""
    ref = _ref()
    res = np.array([[[10, 100, 100, 100], [100, 100, 100, 10]]], np.float32)
    x = (res, np.array([[20, 20]], np.int32), np.ones((1, 2), bool),
         np.array([[-2000] * 4], np.float32),
         np.array([420, 850, 300, 420], np.float32))
    got = _port(*x, 1)
    _assert_same(got, ref.preempt_for_task_group_np(*x, max_steps=1))
    assert got[1][0].tolist() == [True, False]
    # the jitted form breaks the same tie the other way
    assert np.asarray(ref.preempt_for_task_group(
        *x, max_steps=1)[1])[0].tolist() == [False, True]


# the three kernel cases of tests/test_preemption.py, through both packages

def _case_lowest_priority_first():
    return (np.array([[[2000, 2000, 0], [1000, 1000, 0], [3000, 3000, 0]]],
                     np.float32), np.array([[20, 10, 40]], np.int32),
            np.ones((1, 3), bool), np.array([[0, 0, 0]], np.float32),
            np.array([800, 800, 0], np.float32), 4)


def _case_spans_priority_tiers():
    return (np.array([[[500, 500, 0], [600, 600, 0]]], np.float32),
            np.array([[10, 20]], np.int32), np.ones((1, 2), bool),
            np.array([[0, 0, 0]], np.float32),
            np.array([1000, 1000, 0], np.float32), 4)


def _case_unmet_when_insufficient():
    return (np.array([[[100, 100, 0]]], np.float32),
            np.array([[10]], np.int32), np.ones((1, 1), bool),
            np.array([[0, 0, 0]], np.float32),
            np.array([1000, 1000, 0], np.float32), 2)


@pytest.mark.parametrize("case,met,picked", [
    (_case_lowest_priority_first, True, [False, True, False]),
    (_case_spans_priority_tiers, True, [True, True]),
    (_case_unmet_when_insufficient, False, None),
])
def test_reference_kernel_cases(case, met, picked):
    *x, steps = case()
    got = _port(*x, steps)
    assert bool(got[0][0]) is met
    if picked is not None:
        assert got[1][0].tolist() == picked
    _assert_same(got, _ref().preempt_for_task_group(*x, max_steps=steps))


def test_wrapper_refuses_other_devices():
    x = [torch.zeros((4, 4, 4), device="meta"),
         torch.zeros((4, 4), dtype=torch.int32, device="meta"),
         torch.zeros((4, 4), dtype=torch.bool, device="meta"),
         torch.zeros((4, 4), device="meta"), torch.zeros(4, device="meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        tp.preempt_for_task_group(*x)


def test_cpu_run_counts_no_launch():
    before = tp.launches["preempt"]
    _port(*_inputs(3, 64, 16, 4), 16)
    assert tp.launches["preempt"] == before


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """csrc/preempt.cu against the plain version on the card, bit for
    bit, at the scheduler path's shape, at A = 4, 8 and 32 (a node on 4,
    8 and 32 lanes) and at A = 64, R = 3 (two slots a lane)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    for N, A, R, steps in ((16384, 16, 4, 16), (4096, 4, 4, 4),
                           (4096, 8, 4, 8), (4096, 32, 4, 32),
                           (4096, 64, 3, 32)):
        x = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
             for a in _inputs(11, N, A, R)]
        before = tp.launches["preempt"]
        got = tp.preempt_for_task_group(*x, max_steps=steps)
        torch.cuda.synchronize()
        assert tp.launches["preempt"] == before + 1
        want = tp.preempt_for_task_group_plain(*x, max_steps=steps)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
