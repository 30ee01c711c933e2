"""The stage probe's scatter (K8e) and feasibility (K8a) against the
reference's jitted units, and K8e's algorithm against its plain version.

The reference's `scatter` (nomad_tpu/parallel/stage_probe.py:109) takes
the runs in greedy order, caps them cumulatively at `count` and scatters
them back to their rows; its `feasibility` (:65) builds the [N, M, R]
usage grid and the fit of every cell.  The same numpy inputs, made from
a seed, go through them (JAX on the CPU platform of conftest.py) and the
port's plain versions (`scatter_plain`, `feasibility_plain`): on seeded
inputs and on edge inputs (count 0, count at or above the runs' total,
runs of 0, a random permutation and K8d's partition as the order, two
rows, row counts that are not a multiple of the cluster's 16 blocks, M
not a multiple of 4, NaN and infinities in the usage and the capacity).
Integers and bools must be equal; floats within RTOL of the reference,
NaN and infinities where it has them (its XLA CPU build contracts `used
+ m * demand` into an FMA, so finite floats may differ in the last bit).

`scatter_model` is K8e's algorithm in PyTorch (the positions split over
the cluster's blocks, a prefix a block, then the blocks' totals; each
row written by its position); it must equal `scatter_plain` bit for bit.
Tests marked `cuda` hold both kernels bit-equal to their plain versions
on the card, also under the delays of K8e's cluster exchange; they skip
here.
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from nomad_tpu.parallel import stage_probe as rsp
except ImportError:     # a machine with a card and no JAX runs the cuda
    jnp = rsp = None    # tests only (-m cuda)
from nomad_tpu_torch.ops import stage_probe as tsp
from nomad_tpu_torch.parallel import stage_probe as psp

torch.set_num_threads(1)

RTOL = 1e-5
# row counts: two rows, a few, not a multiple of 16 (the cluster's
# blocks) or of 32, and a multiple of both
ROWS = [2, 5, 37, 100, 256]
# (kind of order, kind of count) of the scatter's edge inputs
ORDERS = ["partition", "permutation", "identity", "reversed"]
COUNTS = ["some", "zero", "total", "above", "negative"]


@pytest.fixture(scope="module")
def ref_fns():
    return rsp._stage_fns()


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, what):
    """NaN and +-inf where the reference has them, finite values within
    RTOL."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    for kind in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(kind(got), kind(ref), err_msg=what)
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL, err_msg=what)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def scatter_inputs(n, order_kind, count_kind, seed=0, zero_runs=False,
                   odd_used=False):
    """(run, order, count, used, demand, coll) numpy: runs 0..5 (0 on
    every row with zero_runs, else on about a third of the rows); the
    order K8d's partition (a random wave first, then the rest, each in
    row order), a random permutation, the identity or reversed; count
    some of the runs, 0, their total, above it or negative; odd_used puts
    NaN, +inf, -inf and -0.0 in the usage."""
    rng = np.random.default_rng(seed)
    run = rng.integers(0, 6, n).astype(np.int32)
    run[rng.random(n) < 0.3] = 0
    if zero_runs:
        run[:] = 0
    if order_kind == "partition":
        wave = rng.random(n) < 0.25
        order = np.concatenate([np.flatnonzero(wave), np.flatnonzero(~wave)])
    elif order_kind == "permutation":
        order = rng.permutation(n)
    elif order_kind == "identity":
        order = np.arange(n)
    else:
        order = np.arange(n)[::-1]
    total = int(run.sum())
    count = {"some": max(total // 2, 1), "zero": 0, "total": total,
             "above": total + 7, "negative": -3}[count_kind]
    used = rng.uniform(0.0, 50.0, (n, 4)).astype(np.float32)
    if odd_used:
        used[0, 0] = np.nan
        used[n - 1, 1] = np.inf
        used[n // 2, 2] = -np.inf
        used[1, 3] = -0.0
    demand = rng.uniform(1.0, 10.0, 4).astype(np.float32)
    coll = rng.integers(0, 3, n).astype(np.int32)
    return (run, order.astype(np.int32), count, used, demand, coll)


def _ref_scatter(fns, args):
    run, order, count, used, demand, coll = args
    return [np.asarray(x) for x in fns[4](run, order, np.int32(count), used,
                                          demand, coll)]


def _check_scatter(fns, args, what):
    ref = _ref_scatter(fns, args)
    t = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
    plain = tsp.scatter_plain(*t)
    model = tsp.scatter_model(*t)
    for k, (p, m) in enumerate(zip(plain, model)):
        assert p.dtype == m.dtype and p.shape == m.shape, f"{what}: {k}"
        assert torch.equal(_bits(p), _bits(m)), f"{what}: model output {k}"
    _close(plain[0].numpy(), ref[0], f"{what}: used2")
    np.testing.assert_array_equal(plain[1].numpy(), ref[1],
                                  err_msg=f"{what}: coll2")
    assert plain[2].dtype == torch.int32 and plain[2].shape == ()
    assert int(plain[2]) == int(ref[2]), what
    return plain


@pytest.mark.parametrize("count_kind", COUNTS)
@pytest.mark.parametrize("order_kind", ORDERS)
@pytest.mark.parametrize("n", ROWS)
def test_scatter_matches_reference(ref_fns, n, order_kind, count_kind):
    args = scatter_inputs(n, order_kind, count_kind, seed=n)
    got = _check_scatter(ref_fns, args, f"N={n} {order_kind} {count_kind}")
    run, _, count = args[:3]
    assert int(got[2]) == min(max(count, 0), int(run.sum()))


@pytest.mark.parametrize("order_kind", ORDERS)
def test_scatter_on_runs_of_zero_and_odd_usage(ref_fns, order_kind):
    """Every run 0 (nothing placed, every row's usage + 0 * demand: -0.0
    becomes +0.0), and NaN, +-inf and -0.0 usage under a count that
    places on some rows."""
    for zero_runs in (True, False):
        args = scatter_inputs(53, order_kind, "some", seed=3,
                              zero_runs=zero_runs, odd_used=True)
        got = _check_scatter(ref_fns, args,
                             f"{order_kind}, runs of 0 {zero_runs}")
        if zero_runs:
            assert int(got[2]) == 0
            assert np.isnan(got[0].numpy()[0, 0])


@pytest.mark.parametrize("blocks", [1, 3, 16, 64])
@pytest.mark.parametrize("n", [2, 37, 1000])
def test_scatter_model_on_any_block_count(n, blocks):
    """The model's split of the positions over the blocks does not change
    a bit: at 1 block, at more blocks than rows and at the cluster's 16."""
    args = [_t(a) if isinstance(a, np.ndarray) else a
            for a in scatter_inputs(n, "permutation", "some", seed=9)]
    want = tsp.scatter_plain(*args)
    got = tsp.scatter_model(*args, blocks=blocks)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("M", [16, 64])
def test_scatter_on_the_probe_chain(ref_fns, M):
    """The probe's own chain: K8d's run and order (its partition) from the
    probe's seeded inputs, then the scatter, against the reference."""
    x = psp.probe_inputs(300, fill_grid=M, device="cpu")
    util_m, fits_m = tsp.feasibility_plain(x["capacity"], x["used"],
                                           x["demand"], x["feasible"],
                                           x["ms"])
    score_m = tsp.score_plain(tsp.fit_plain(x["capacity"], util_m),
                              x["coll"], x["ms"], x["desired_f"],
                              x["penalty"], x["affinity"],
                              x["has_affinity"])
    run, order = tsp.argmax_plain(fits_m, score_m, x["ms"])
    args = (run.numpy(), order.numpy(), x["count"], x["used"].numpy(),
            x["demand"].numpy(), x["coll"].numpy())
    for count in (x["count"], 0, int(run.sum()), 10 ** 6):
        _check_scatter(ref_fns, args[:2] + (count,) + args[3:],
                       f"M={M} count {count}")


def feasibility_inputs(n, M, seed=0, odd=False):
    """(capacity, used, demand, feasible, ms) numpy as the probe draws
    them; odd puts NaN, +inf and -inf in the usage and the capacity."""
    rng = np.random.default_rng(seed)
    cap = rng.uniform(100.0, 1000.0, (n, 4)).astype(np.float32)
    used = rng.uniform(0.0, 50.0, (n, 4)).astype(np.float32)
    # rows near full: some of their cells fit, some do not
    used[::3] = cap[::3] - rng.uniform(0.0, 40.0, (len(cap[::3]), 4))
    demand = rng.uniform(1.0, 10.0, 4).astype(np.float32)
    feasible = rng.random(n) < 0.9
    if odd:
        used[0, 0] = np.nan
        cap[1, 1] = np.nan
        used[n - 1, 0] = cap[n - 1, 0] = np.inf
        used[n // 2, 2] = np.inf
        cap[min(n // 2 + 1, n - 1), 3] = -np.inf
        used[min(2, n - 1), 1] = -np.inf
    ms = np.arange(1, M + 1, dtype=np.float32)
    return cap, used, demand, feasible, ms


@pytest.mark.parametrize("odd", [False, True], ids=["finite", "nan_inf"])
@pytest.mark.parametrize("M", [1, 3, 4, 6, 16, 17, 64])
@pytest.mark.parametrize("n", [2, 37, 256])
def test_feasibility_matches_reference(ref_fns, n, M, odd):
    args = feasibility_inputs(n, M, seed=n + M, odd=odd)
    ref_util, ref_fits = (np.asarray(a) for a in ref_fns[0](*args))
    util_m, fits_m = tsp.feasibility_plain(*[_t(a) for a in args])
    assert util_m.shape == (n, M, 4) and fits_m.dtype == torch.bool
    what = f"N={n} M={M} odd={odd}"
    _close(util_m.numpy(), ref_util, what)
    np.testing.assert_array_equal(fits_m.numpy(), ref_fits, err_msg=what)
    if n > 2:
        assert fits_m.any() and not fits_m.all()


def test_scatter_wrapper_refuses_other_devices():
    m = torch.zeros((8, 4), device="meta")
    i = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tsp.scatter(i, i, 4, m, m[0], i)


# ---------------------------------------------------------------- the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")


def _bit_equal(got, want, what):
    g, w = got.cpu().numpy(), want.cpu().numpy()
    assert g.dtype == w.dtype and g.shape == w.shape, what
    if w.dtype == np.float32:
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan, err_msg=what)
        g, w = np.where(nan, 0, g).view(np.uint32), \
            np.where(nan, 0, w).view(np.uint32)
    np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.cuda
def test_scatter_kernel_matches_plain_on_the_card():
    """K8e bit-equal to `scatter_plain` on the card: at 10,000, 20,000 and
    131,072 rows (8 positions a thread), on a random permutation, K8d's
    partition, the identity and reversed orders, every kind of count,
    runs of 0 and odd usage, two rows; again under three seeds of the
    delays at its cluster exchange (stage_probe_set_jitter)."""
    _cuda()
    from nomad_tpu_torch.ops import _build
    lib = _build.load("stage_probe")
    assert lib.stage_probe_cluster_size() == tsp.PROBE_CLUSTER
    stream = torch.cuda.current_stream().cuda_stream
    cases = [scatter_inputs(n, o, c, seed=n)
             for n in (10000, 20000, 131072) for o in ORDERS
             for c in ("some", "total", "zero")]
    cases += [scatter_inputs(n, o, "some", seed=1, zero_runs=z, odd_used=True)
              for n in (2, 37, 10000) for o in ("permutation", "partition")
              for z in (False, True)]
    before = tsp.launches["stage_scatter"]
    try:
        for seed in (0, 1, 2, 3):
            assert lib.stage_probe_set_jitter(seed, stream) == 0
            for args in cases:
                a = [_t(x).cuda() if isinstance(x, np.ndarray) else x
                     for x in args]
                got, want = tsp.scatter(*a), tsp.scatter_plain(*a)
                for k, (g, w) in enumerate(zip(got, want)):
                    _bit_equal(g, w, f"N={args[0].size} seed {seed} "
                                     f"output {k}")
    finally:
        lib.stage_probe_set_jitter(0, stream)
    assert tsp.launches["stage_scatter"] - before == 4 * len(cases)


@pytest.mark.cuda
def test_feasibility_kernel_matches_plain_on_the_card():
    """K8a bit-equal to `feasibility_plain` on the card at the probe's
    shapes (10,000, 20,000 and 131,072 rows x M = 16, 64), at M not a
    multiple of 4 (its fits bytes one at a time), two rows, and NaN and
    infinities in the usage and the capacity."""
    _cuda()
    shapes = [(n, M, False) for n in (10000, 20000, 131072)
              for M in (16, 64)]
    shapes += [(n, M, True) for n in (2, 37, 10000) for M in (1, 3, 6, 16,
                                                              17, 64)]
    for n, M, odd in shapes:
        a = [_t(x).cuda() for x in feasibility_inputs(n, M, seed=M,
                                                      odd=odd)]
        got, want = tsp.feasibility(*a), tsp.feasibility_plain(*a)
        for k, (g, w) in enumerate(zip(got, want)):
            _bit_equal(g, w, f"N={n} M={M} odd={odd} output {k}")
