"""The bulk kernels' selection (K1/K4, csrc/place_bulk.cu) on the CPU.

The kernel does not sort a wave: only the first k = min(remaining,
|wave|) keys of the greedy order (score desc, row asc) can take
instances, so it selects them in rounds of at most KMAX keys (the rows at
the top score in row order when there are k of them, else a radix select
for the threshold score), sorts only the selected keys, computes runs for
the selected rows only and caps them cumulatively.
`bulk_wave_select_model` is that algorithm in numpy; it must give every
wave exactly the per-node instances of the plain version's full argsort
(`bulk_wave_allocs`, the step `place_bulk_plain` takes each wave), on
grids drawn by hypothesis (derandomized, so every run draws the same
examples) for each path of the selection, and along the waves of whole
placements.  Then K1 and K4 (their plain versions, which the kernels are
held to bit for bit on the card) against the reference on a strict wave
with ties at the threshold score, and on counts past the fill grid with
deltas and the exact carry.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

try:
    import jax
    import jax.numpy as jnp
    from nomad_tpu.ops import place as rp
except ImportError:     # a machine with a card and no JAX runs the cuda
    jax = jnp = rp = None   # tests only (-m cuda)
from nomad_tpu_torch.ops import place as tp

torch.set_num_threads(1)

RTOL = 1e-5
ATOL = 1.2e-7
EXAMPLES = settings(max_examples=60, derandomize=True, deadline=None,
                    database=None)
# a few scores, so that rows tie (+0.0 and -0.0 compare equal)
SCORES = np.array([-0.5, -0.0, 0.0, 0.1, 0.25, 0.5, 0.7], np.float32)


@st.composite
def grids(draw, kind):
    """(ms, fits_m, score_m, remaining, kmax) of one wave, shaped so that
    the wave takes the selection path `kind`."""
    n = draw(st.integers(2, 48))
    m = draw(st.sampled_from([2, 4, 16]))
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 32 - 1)))
    score = rng.choice(SCORES, (n, m)).astype(np.float32)
    fit_p = 1.0 if kind in ("tie", "rounds") else 0.8
    fits = np.cumprod(rng.random((n, m)) < fit_p, axis=1).astype(bool)
    fits[0, 0] = True                   # some row fits
    remaining = draw(st.integers(1, 2 * n))
    kmax = tp.BULK_KMAX
    if kind == "tie":
        # every m = 2 score beats every m = 1 score: no strict row
        score[:, 1:] = score[:, :1].max() + 1.0 + score[:, 1:]
    elif kind == "threshold":
        # a strict wave (m = 2 scores low) whose k-th key ties others
        score[:, 1:] -= 2.0
        remaining = draw(st.integers(2, n))
    elif kind == "k_ge_wave":
        remaining = draw(st.integers(n * m, 4 * n * m))
    elif kind == "rounds":
        score[:, 1:] -= 2.0
        remaining = draw(st.integers(4, 2 * n))
        kmax = draw(st.integers(1, 3))
    elif kind == "count0":
        remaining = 0
    elif kind == "neg_inf":
        fits[rng.random(n) < 0.5, 0] = False    # rows at -inf
        fits[:, 1:] &= fits[:, :1]
        if draw(st.booleans()):
            fits[:, 0] = False                  # no row fits: stuck
            fits[:, 1:] = False
    elif kind == "neg_inf_top":
        # every fitting row scores -inf (an affinity of -inf): the wave is
        # the tie set of the fitting rows at -inf, the others stay out
        fits[rng.random(n) < 0.4, 0] = False
        fits[:, 1:] &= fits[:, :1]
        fits[n - 1, 0] = True
        score[:] = -np.inf
    ms = torch.arange(1, m + 1, dtype=torch.float32)
    return (ms, torch.from_numpy(fits), torch.from_numpy(score), remaining,
            kmax)


def _same_wave(grid):
    ms, fits_m, score_m, remaining, kmax = grid
    want, want_fit = tp.bulk_wave_allocs(ms, fits_m, score_m, remaining)
    got, got_fit, info = tp.bulk_wave_select_model(ms, fits_m, score_m,
                                                   remaining, kmax)
    assert got_fit == want_fit
    assert torch.equal(got, want)
    assert int(got.sum()) <= remaining
    return info


@EXAMPLES
@given(grids("tie"))
def test_select_tie_wave_takes_the_first_rows_at_the_top(grid):
    info = _same_wave(grid)
    assert info["path"] == "top"


@EXAMPLES
@given(grids("threshold"))
def test_select_strict_wave_with_ties_at_the_threshold(grid):
    _same_wave(grid)


@EXAMPLES
@given(grids("k_ge_wave"))
def test_select_k_at_least_the_wave(grid):
    _same_wave(grid)


@EXAMPLES
@given(grids("rounds"))
def test_select_k_spanning_several_kmax_rounds(grid):
    _same_wave(grid)


@EXAMPLES
@given(grids("count0"))
def test_select_count_zero_takes_nothing(grid):
    info = _same_wave(grid)
    assert info["rounds"] == 0


@EXAMPLES
@given(grids("neg_inf"))
def test_select_rows_at_minus_infinity(grid):
    _same_wave(grid)


@EXAMPLES
@given(grids("neg_inf_top"))
def test_select_tie_wave_at_minus_infinity_takes_fitting_rows_only(grid):
    info = _same_wave(grid)
    assert info["path"] == "top"


def test_select_paths_are_all_drawn():
    """Each path of the selection on a fixed strict wave: the rows at the
    top score, and the radix select in one round and in several."""
    rng = np.random.default_rng(3)
    n, m = 40, 4
    ms = torch.arange(1, m + 1, dtype=torch.float32)
    fits = torch.ones((n, m), dtype=torch.bool)
    score = rng.choice(SCORES, (n, m)).astype(np.float32)
    score[:, 1:] -= 2.0
    score = torch.from_numpy(score)
    cur = score[:, 0]
    top = int((cur == cur.max()).sum())
    kmax = tp.BULK_KMAX
    assert _same_wave((ms, fits, score, top, kmax))["path"] == "top"
    info = _same_wave((ms, fits, score, top + 1, kmax))
    assert info["path"] == "radix" and info["rounds"] == 1
    info = _same_wave((ms, fits, score, 30, 4))
    assert info["path"] == "radix" and info["rounds"] > 1


def _world(seed, n, levels):
    """Uniform nodes with integer usage levels: many rows share a score."""
    rng = np.random.default_rng(seed)
    cap = np.tile(np.array([4000, 8192, 102400, 1000], np.float32), (n, 1))
    used = np.zeros((n, 4), np.float32)
    used[:, 0] = rng.integers(0, levels, n) * 100
    used[:, 1] = used[:, 0] * 2
    return rng, cap, used


@pytest.mark.parametrize("count", [40, 90, 200])
@pytest.mark.parametrize("spread", [False, True], ids=["binpack", "spread"])
def test_select_along_every_wave_of_a_placement(count, spread):
    """Count past the fill grid (several waves): at every wave of a whole
    placement the model's instances equal the argsort's."""
    rng, cap, used = _world(count, 24, 5)
    t = torch.from_numpy
    feas = t(rng.random(24) < 0.9)
    aff = torch.zeros(24)
    pen = torch.zeros(24, dtype=torch.bool)
    coll = t((rng.random(24) < 0.2).astype(np.int32))
    demand = t(np.array([300, 600, 0, 0], np.float32))
    used_t = t(used)
    placed = waves = 0
    while placed < count and waves < 100:
        grid = tp.bulk_wave_grid(t(cap), used_t, demand, feas, aff, False,
                                 4.0, pen, coll, spread, 4)
        _same_wave(grid + (count - placed, 2))
        per_node, any_fit = tp.bulk_wave_allocs(*grid, count - placed)
        if not any_fit:
            break
        used_t = used_t + per_node[:, None].float() * demand
        coll = coll + per_node.to(torch.int32)
        placed += int(per_node.sum())
        waves += 1
    assert waves > 1


def test_bulk_k1_strict_wave_with_threshold_ties_matches_reference():
    """K1 (its plain version on the CPU) against the reference's
    `place_bulk_jit` on a worst-fit wave whose threshold score is shared
    by several rows, and the kernel's model takes the radix path there."""
    n, count = 64, 40
    rng, cap, used = _world(7, n, 4)
    feasible = rng.random(n) < 0.95
    affinity = np.zeros(n, np.float32)
    penalty = np.zeros(n, bool)
    coll0 = np.zeros(n, np.int32)
    demand = np.array([100, 200, 0, 0], np.float32)
    t = torch.from_numpy
    grid = tp.bulk_wave_grid(t(cap), t(used), t(demand), t(feasible),
                             t(affinity), False, float(count), t(penalty),
                             t(coll0), True, 64)
    info = _same_wave(grid + (count, tp.BULK_KMAX))
    assert info["path"] == "radix"
    ref = tp.unpack_bulk(np.asarray(rp.place_bulk_jit(
        cap, used, feasible, affinity, False, np.int32(count), penalty, coll0,
        demand, np.int32(count), spread_algorithm=True, fill_grid=64)))
    got = tp.unpack_bulk(tp.place_bulk(
        t(cap), t(used), t(feasible), t(affinity), False, count, t(penalty),
        t(coll0), t(demand), count, spread_algorithm=True).numpy())
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:4] + (got[5],) == ref[1:4] + (ref[5],)
    assert got[1] == count
    np.testing.assert_allclose(got[4], ref[4], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[6], ref[6], rtol=RTOL)


@pytest.mark.parametrize("spread", [False, True], ids=["binpack", "spread"])
def test_bulk_k4_counts_past_the_fill_grid_with_deltas_match_reference(
        spread):
    """K4 (plain, CPU) against `place_bulk_batch_donate_jit`: counts past
    the fill grid (several waves an eval), D > 0 with a pair of deltas that
    cancel, a count-0 pad and the exact carry."""
    n, D, fill_grid = 48, 8, 16
    rng, cap, used = _world(11, n, 6)
    demand = np.array([100, 200, 0, 0], np.float32)
    heavy, lights = [], []
    for e, count in enumerate([40, 0, 25, 60]):
        feas = rng.random(n) < 0.9
        coll = (rng.random(n) < 0.2).astype(np.int32)
        heavy.append(tp.pack_bulk_heavy(feas, np.zeros(n, np.float32),
                                        np.zeros(n, bool), coll))
        r = int(rng.integers(0, n))
        v = np.array([100, 200, 0, 0], np.float32)
        deltas = [(int(rng.integers(0, n)), -v), (r, v), (r, -v)]
        lights.append(tp.pack_bulk_light(False, max(count, 1), count, demand,
                                         deltas if e % 2 == 0 else [], n, D))
    heavy, dyn = np.stack(heavy), np.concatenate(lights)
    kw = dict(sparse_out=False, spread_algorithm=spread, fill_grid=fill_grid)
    ref_packed, ref_used, ref_exact = rp.place_bulk_batch_donate_jit(
        cap, jnp.asarray(used), heavy, dyn, D, exact_out=True, **kw)
    t = torch.from_numpy
    packed, used_f, exact = tp.place_bulk_batch(
        t(cap), t(used.copy()), t(heavy), t(dyn), D, exact_out=True, **kw)
    got = tp.unpack_bulk_batch(packed.numpy(), n)
    ref = tp.unpack_bulk_batch(np.asarray(ref_packed), n)
    for i in (0, 2, 3, 4, 5):
        np.testing.assert_array_equal(got[i], ref[i])
    np.testing.assert_array_equal(got[2], [40, 0, 25, 60])
    assert got[5].max() > 1                      # several waves an eval
    np.testing.assert_allclose(got[1], ref[1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(used_f.numpy(), np.asarray(ref_used),
                               rtol=RTOL)
    np.testing.assert_allclose(exact.numpy(), np.asarray(ref_exact),
                               rtol=RTOL)


def _nan_world(kind, n=64):
    """A fitting row that scores NaN (+inf capacity and usage), built as
    tests/_sharded_cases.py builds the sharded NaN cases: "m = 1" row
    n // 2 + 3 at +inf capacity and usage (1 - inf / inf: -NaN on the
    CPU, +NaN on the card) between rows of integer usage levels; "m = 2"
    cpu in units of 1e38 on capacities of the largest f32, row n // 2 + 2
    at +inf capacity and 2e38 usage, which fits m = 1 at a finite score
    and m = 2 at NaN (4e38 rounds to +inf), and after one instance scores
    NaN at m = 1 too.  Either NaN at m = 2 makes s* NaN (jnp.max), so
    every wave is a tie wave.  Returns (cap, used, demand, coll0)."""
    rng, cap, used = _world(17, n, 5)
    demand = np.array([300, 600, 0, 0], np.float32)
    if kind == "m = 1":
        r = n // 2 + 3
        cap[r, 0] = used[r, 0] = np.inf
    else:
        demand[0] = 1e38
        cap[:, 0] = np.finfo(np.float32).max
        used[:, 0] = rng.choice(np.float32([0.0, 0.5e38, 1e38]), n)
        r = n // 2 + 2
        cap[r, 0], used[r, 0] = np.inf, 2e38
    coll0 = (rng.random(n) < 0.2).astype(np.int32)
    return cap, used, demand, coll0


NAN_KINDS = ["m = 1", "m = 2"]
NAN_WAVES = 40          # the runaway guard of both packages on these cases


def _waves_of(select, cap, used, demand, coll0, count, spread,
              affinity=None):
    """A whole placement of one eval, wave by wave, each wave's instances
    from `select(grid..., remaining)` (the plain version's argsort or the
    kernel's model): (per-node counts, placed, waves), as `_bulk_loop`;
    with `affinity`, has_affinity is on."""
    t = torch.from_numpy
    n = cap.shape[0]
    feas = torch.ones(n, dtype=torch.bool)
    aff = torch.zeros(n) if affinity is None else t(affinity)
    pen = torch.zeros(n, dtype=torch.bool)
    used_t, coll = t(used.copy()), t(coll0.copy())
    assign = np.zeros(n, np.int64)
    placed = waves = 0
    while placed < count and waves < NAN_WAVES:
        grid = tp.bulk_wave_grid(t(cap), used_t, t(demand), feas, aff,
                                 affinity is not None, float(count), pen,
                                 coll, spread, 16)
        per_node, any_fit = select(*grid, count - placed)[:2]
        used_t = used_t + per_node[:, None].float() * t(demand)
        coll = coll + per_node.to(torch.int32)
        assign += per_node.numpy()
        placed += int(per_node.sum())
        waves += 1
        if not any_fit:
            break
    return assign, placed, waves


@pytest.mark.parametrize("spread", [False, True], ids=["binpack", "spread"])
@pytest.mark.parametrize("kind", NAN_KINDS)
def test_nan_rows_place_as_the_reference(kind, spread):
    """A fitting row that scores NaN: the wave's top-2 ranks it as
    lax.top_k does (the CPU's -NaN below every score), so the tie set is
    the rows at the finite top and every count places.  The plain
    version's argsort (`bulk_wave_allocs`) and the kernels' model
    (`bulk_wave_select_model`) give the reference's per-node counts,
    placed and wave totals, wave by wave through a whole placement, and
    equal each other at every wave; K1 (`place_bulk`, its plain version
    here) gives the reference's packed outputs."""
    cap, used, demand, coll0 = _nan_world(kind)
    n, count = cap.shape[0], 40
    feasible = np.ones(n, bool)
    affinity = np.zeros(n, np.float32)
    penalty = np.zeros(n, bool)
    ref = tp.unpack_bulk(np.asarray(rp.place_bulk_jit(
        cap, used, feasible, affinity, False, np.int32(count), penalty,
        coll0, demand, np.int32(count), spread_algorithm=spread,
        max_waves=NAN_WAVES, fill_grid=16)))
    assert ref[1] == count and ref[5] < NAN_WAVES

    def model(*a):
        got = tp.bulk_wave_select_model(*a)
        want = tp.bulk_wave_allocs(*a)
        assert got[1] == want[1] and torch.equal(got[0], want[0])
        return got
    for select in (tp.bulk_wave_allocs, model):
        assign, placed, waves = _waves_of(select, cap, used, demand, coll0,
                                          count, spread)
        np.testing.assert_array_equal(assign, ref[0])
        assert (placed, waves) == (ref[1], ref[5])
    t = torch.from_numpy
    got = tp.unpack_bulk(tp.place_bulk(
        t(cap), t(used), t(feasible), t(affinity), False, count, t(penalty),
        t(coll0), t(demand), count, spread_algorithm=spread,
        max_waves=NAN_WAVES, fill_grid=16).numpy())
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:4] + (got[5],) == ref[1:4] + (ref[5],)
    np.testing.assert_allclose(got[4], ref[4], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[6], ref[6], rtol=RTOL)
    # the case is what it is named for: the row's m = 2 cell is NaN at the
    # first wave (s* NaN), and where it takes instances (spread ranks the
    # row at +inf capacity first) it scores NaN at m = 1 after
    grid = tp.bulk_wave_grid(t(cap), t(used), t(demand), t(feasible),
                             t(affinity), False, float(count), t(penalty),
                             t(coll0), spread, 16)
    rows = np.flatnonzero(np.isinf(cap[:, 0]))
    assert grid[1][rows, 1].all() and torch.isnan(grid[2][rows, 1]).all()
    assert np.isnan(got[4][rows]).all() == (kind == "m = 1" or
                                            bool(got[0][rows].all()))
    if kind == "m = 2" and spread:
        assert got[0][rows].all()


@pytest.mark.parametrize("kind", NAN_KINDS)
def test_nan_rows_k4_chain_matches_reference(kind):
    """K4 (plain, CPU) against `place_bulk_batch_donate_jit` on the NaN
    worlds: a chain of three evals and a count-0 pad, dense, with the
    exact carry."""
    cap, used, demand, coll0 = _nan_world(kind)
    n, D = cap.shape[0], 8
    heavy, lights = [], []
    for count in (30, 0, 12, 25):
        heavy.append(tp.pack_bulk_heavy(np.ones(n, bool),
                                        np.zeros(n, np.float32),
                                        np.zeros(n, bool), coll0))
        lights.append(tp.pack_bulk_light(False, max(count, 1), count,
                                         demand, [], n, D))
    heavy, dyn = np.stack(heavy), np.concatenate(lights)
    kw = dict(sparse_out=False, spread_algorithm=False, fill_grid=16,
              max_waves=NAN_WAVES)
    ref_packed, ref_used, ref_exact = rp.place_bulk_batch_donate_jit(
        cap, jnp.asarray(used), heavy, dyn, D, exact_out=True, **kw)
    t = torch.from_numpy
    packed, used_f, exact = tp.place_bulk_batch(
        t(cap), t(used.copy()), t(heavy), t(dyn), D, exact_out=True, **kw)
    got = tp.unpack_bulk_batch(packed.numpy(), n)
    ref = tp.unpack_bulk_batch(np.asarray(ref_packed), n)
    for i in (0, 2, 3, 4, 5):
        np.testing.assert_array_equal(got[i], ref[i])
    np.testing.assert_array_equal(got[2], [30, 0, 12, 25])
    np.testing.assert_allclose(got[1], ref[1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(used_f.numpy(), np.asarray(ref_used),
                               rtol=RTOL)
    np.testing.assert_allclose(exact.numpy(), np.asarray(ref_exact),
                               rtol=RTOL)


def _neg_inf_world(n=64):
    """Every row at an affinity of -inf, so every fitting row scores -inf
    at every m; rows 0, 1, 3, n // 2 and n - 2 at full usage do not fit
    and score -inf too.  The top score and s* are -inf: the wave is the
    tie set of the fitting rows (`fits & (cur == top1)`), one instance a
    row in row order.  Returns (cap, used, demand, coll0, affinity)."""
    rng, cap, used = _world(19, n, 5)
    full = [0, 1, 3, n // 2, n - 2]
    used[full, :2] = cap[full, :2]
    demand = np.array([300, 600, 0, 0], np.float32)
    coll0 = (rng.random(n) < 0.2).astype(np.int32)
    return cap, used, demand, coll0, np.full(n, -np.inf, np.float32)


@pytest.mark.parametrize("count", [5, 40, 150])
def test_neg_inf_tie_places_as_the_reference(count):
    """A tie wave at a top score of -inf takes the fitting rows only (the
    rows that do not fit also score -inf): the plain version's argsort
    and the kernels' model give the reference's per-node counts, placed
    and wave totals at every wave, and K1's plain version its packed
    outputs (the exhausted count included)."""
    cap, used, demand, coll0, aff = _neg_inf_world()
    n = cap.shape[0]
    feasible = np.ones(n, bool)
    penalty = np.zeros(n, bool)
    ref = tp.unpack_bulk(np.asarray(rp.place_bulk_jit(
        cap, used, feasible, aff, True, np.int32(count), penalty, coll0,
        demand, np.int32(count), max_waves=NAN_WAVES, fill_grid=16)))
    assert ref[1] == count and ref[3] == 5

    def model(*a):
        got = tp.bulk_wave_select_model(*a)
        want = tp.bulk_wave_allocs(*a)
        assert got[1] == want[1] and torch.equal(got[0], want[0])
        return got
    for select in (tp.bulk_wave_allocs, model):
        assign, placed, waves = _waves_of(select, cap, used, demand, coll0,
                                          count, False, affinity=aff)
        np.testing.assert_array_equal(assign, ref[0])
        assert (placed, waves) == (ref[1], ref[5])
    t = torch.from_numpy
    got = tp.unpack_bulk(tp.place_bulk(
        t(cap), t(used), t(feasible), t(aff), True, count, t(penalty),
        t(coll0), t(demand), count, max_waves=NAN_WAVES,
        fill_grid=16).numpy())
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:4] + (got[5],) == ref[1:4] + (ref[5],)
    np.testing.assert_array_equal(got[4], ref[4])
    np.testing.assert_allclose(got[6], ref[6], rtol=RTOL)


def test_neg_inf_tie_k4_chain_matches_reference():
    """K4 (plain, CPU) against `place_bulk_batch_donate_jit` on the -inf
    world: three evals and a count-0 pad, dense, with the exact carry."""
    cap, used, demand, coll0, aff = _neg_inf_world()
    n, D = cap.shape[0], 8
    heavy, lights = [], []
    for count in (30, 0, 12, 70):
        heavy.append(tp.pack_bulk_heavy(np.ones(n, bool), aff,
                                        np.zeros(n, bool), coll0))
        lights.append(tp.pack_bulk_light(True, max(count, 1), count,
                                         demand, [], n, D))
    heavy, dyn = np.stack(heavy), np.concatenate(lights)
    kw = dict(sparse_out=False, spread_algorithm=False, fill_grid=16,
              max_waves=NAN_WAVES)
    ref_packed, ref_used, ref_exact = rp.place_bulk_batch_donate_jit(
        cap, jnp.asarray(used), heavy, dyn, D, exact_out=True, **kw)
    t = torch.from_numpy
    packed, used_f, exact = tp.place_bulk_batch(
        t(cap), t(used.copy()), t(heavy), t(dyn), D, exact_out=True, **kw)
    got = tp.unpack_bulk_batch(packed.numpy(), n)
    ref = tp.unpack_bulk_batch(np.asarray(ref_packed), n)
    for i in (0, 1, 2, 3, 4, 5):
        np.testing.assert_array_equal(got[i], ref[i])
    np.testing.assert_array_equal(got[2], [30, 0, 12, 70])
    np.testing.assert_allclose(used_f.numpy(), np.asarray(ref_used),
                               rtol=RTOL)
    np.testing.assert_allclose(exact.numpy(), np.asarray(ref_exact),
                               rtol=RTOL)


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["+NaN", "-NaN"])
def test_nan_top_ranks_by_its_sign(sign):
    """Scores with a NaN put in by hand (the card's +NaN, the CPU's -NaN)
    on a fitting row beside a tie at the top and a NaN m = 2 score (s*
    NaN: a tie wave): the plain version and the kernels' model agree
    with the reference's rule, computed here with numpy as `_bulk_loop`
    writes it with lax.top_k.  A +NaN is top1, no row equals it and the
    wave is empty; a -NaN ranks lowest and the tied rows place."""
    n, M = 24, 4
    ms = torch.arange(1, M + 1, dtype=torch.float32)
    fits = np.ones((n, M), bool)
    score = np.full((n, M), 0.25, np.float32)
    score[[2, 7, 11], 0] = 0.5
    # the NaN's sign bit set by hand (a product with -1.0 keeps it)
    score[5, :] = np.uint32(0x7FC00000 if sign > 0 else 0xFFC00000).view(
        np.float32)
    fits_t, score_t = torch.from_numpy(fits), torch.from_numpy(score)
    want, _ = tp.bulk_wave_allocs(ms, fits_t, score_t, 5)
    got, _, _ = tp.bulk_wave_select_model(ms, fits_t, score_t, 5)
    assert torch.equal(got, want)
    top = np.asarray(jax.lax.top_k(jnp.asarray(score[:, 0]), 2)[0])
    if sign > 0:
        assert np.isnan(top[0]) and int(want.sum()) == 0
    else:
        assert top[0] == 0.5
        assert want.numpy()[[2, 7, 11]].tolist() == [1, 1, 1]
        assert int(want.sum()) == 3


@pytest.mark.cuda
def test_bulk_kernels_match_plain_on_every_selection_path():
    """On the card: K1 and K4 bit-equal to their plain versions on the
    selection's paths (top rows, in one round and in several; radix
    select with threshold ties, in several rounds; count 0) and on -0.0 usages with deltas that
    cancel, at a row count that is not a multiple of the cluster's;
    without delays and under three seeds of the kernels' random delays
    at every exchange phase (place_bulk_set_jitter)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    from nomad_tpu_torch.ops import _build
    lib = _build.load("place_bulk")
    stream = torch.cuda.current_stream().cuda_stream
    try:
        for seed in (0, 1, 2, 3):
            assert lib.place_bulk_set_jitter(seed, stream) == 0
            _bulk_kernels_match_plain()
    finally:
        lib.place_bulk_set_jitter(0, stream)


@pytest.mark.cuda
def test_bulk_kernels_match_plain_on_nan_and_neg_inf_rows():
    """On the card: K1 and K4 bit-equal to their plain versions on fitting
    rows that score NaN (the card's +NaN ranks first in lax.top_k's
    order, so a tie wave is empty and the eval runs to max_waves; at
    m = 2 only, s* is NaN) and on a tie wave at a top score of -inf
    (fitting rows only), binpack and spread, also under three seeds of
    the kernels' random delays (place_bulk_set_jitter)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    from nomad_tpu_torch.ops import _build
    lib = _build.load("place_bulk")
    stream = torch.cuda.current_stream().cuda_stream
    c = lambda a: torch.from_numpy(np.array(a)).cuda()   # noqa: E731
    worlds = [_nan_world(k, 3001) + (np.zeros(3001, np.float32), False)
              for k in NAN_KINDS]
    worlds.append(_neg_inf_world(3001) + (True,))
    try:
        for seed in (0, 1, 2, 3):
            assert lib.place_bulk_set_jitter(seed, stream) == 0
            for cap, used, demand, coll0, aff, has_aff in worlds:
                n = cap.shape[0]
                for spread, count in ((False, 40), (True, 700)):
                    args = (c(cap), c(used), c(np.ones(n, bool)), c(aff),
                            has_aff, count, c(np.zeros(n, bool)), c(coll0),
                            c(demand), count)
                    kw = dict(spread_algorithm=spread, max_waves=NAN_WAVES)
                    k = tp.place_bulk(*args, **kw)
                    p = tp.place_bulk_plain(*args, **kw)
                    np.testing.assert_array_equal(
                        k.cpu().numpy().view(np.uint32),
                        p.cpu().numpy().view(np.uint32))
                heavy = np.stack([tp.pack_bulk_heavy(
                    np.ones(n, bool), aff, np.zeros(n, bool), coll0)] * 3)
                dyn = np.concatenate([tp.pack_bulk_light(
                    has_aff, max(cnt, 1), cnt, demand, [], n, 8)
                    for cnt in (30, 0, 500)])
                kw = dict(sparse_out=False, exact_out=True, fill_grid=16,
                          max_waves=NAN_WAVES)
                got = tp.place_bulk_batch(c(cap), c(used), c(heavy), c(dyn),
                                          8, **kw)
                want = tp.place_bulk_batch_plain(c(cap), c(used), c(heavy),
                                                 c(dyn), 8, **kw)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(
                        g.cpu().numpy().view(np.uint32),
                        w.cpu().numpy().view(np.uint32))
    finally:
        lib.place_bulk_set_jitter(0, stream)


def _bulk_kernels_match_plain():
    n = 3001
    rng, cap, used = _world(5, n, 8)
    used[::7] = -0.0
    fresh = np.zeros_like(used)    # every ready row ties at the top
    cases = [(used, False, 10, 10), (used, True, 300, 300),
             (used, False, 2500, 1), (used, False, 0, 1),
             (fresh, False, 2500, 1)]
    c = lambda a: torch.from_numpy(np.array(a)).cuda()   # noqa: E731
    feasible = rng.random(n) < 0.95
    zeros_f, zeros_b = np.zeros(n, np.float32), np.zeros(n, bool)
    coll0 = np.zeros(n, np.int32)
    demand = np.array([10, 20, 0, 0], np.float32)
    for u, spread, count, desired in cases:
        args = (c(cap), c(u), c(feasible), c(zeros_f), False, desired,
                c(zeros_b), c(coll0), c(demand), count)
        k = tp.place_bulk(*args, spread_algorithm=spread)
        p = tp.place_bulk_plain(*args, spread_algorithm=spread)
        np.testing.assert_array_equal(k.cpu().numpy().view(np.uint32),
                                      p.cpu().numpy().view(np.uint32))
    D = 8
    lights = []
    for count in (10, 0, 100, 2500):
        r = int(rng.integers(0, n))
        v = np.array([100, 200, 0, 0], np.float32)
        lights.append(tp.pack_bulk_light(False, 1, count, demand,
                                         [(r, v), (r, -v), (r + 1, v)], n, D))
    heavy = np.stack([tp.pack_bulk_heavy(feasible, zeros_f, zeros_b,
                                         coll0)] * 4)
    dyn = np.concatenate(lights)
    for spread in (False, True):
        kw = dict(sparse_out=False, spread_algorithm=spread, exact_out=True)
        got = tp.place_bulk_batch(c(cap), c(used), c(heavy), c(dyn), D, **kw)
        want = tp.place_bulk_batch_plain(c(cap), c(used), c(heavy), c(dyn),
                                         D, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy().view(np.uint32),
                                          w.cpu().numpy().view(np.uint32))
