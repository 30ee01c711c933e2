"""The scan kernels' cached step (K2/K3, csrc/place_scan.cu) on the CPU.

The kernel does not rescore every row every slot: each row keeps its
partial score (fit, anti-affinity, penalty and affinity, added in the
reference's order), its fit, its scorer count and its flags; every row
is rescored at an eval's first active slot and when a slot's group or
demand differs from the last active slot's, otherwise only the picked
row after its carry update.  The spread term comes from per-value boost
tables, the top-5 from the lists of a cluster's blocks, and the `+ 0` the
reference adds to every row each slot only where it changes a bit.
`place_eval_cached_model` and `place_batch_cached_model` (ops/place.py)
are that step in PyTorch; they must give the plain versions'
(`place_eval_plain`, `place_batch_packed_plain`) outputs bit for bit on
each edge case of `scan_model_cases`.  The plain versions are held
against the reference's `place_eval_packed_jit` / `place_batch_packed_jit`
(JAX on the CPU platform of conftest.py) on the same cases: integers
equal, floats within rtol 1e-5 and atol 1.2e-7, as the existing scan
tests hold them (the two builds round pow and contract differently in
the last bits).  On the card the kernels are held to the plain versions
(the `cuda` test).
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from nomad_tpu.ops import place as rp
except ImportError:     # a machine with a card and no JAX runs the cuda
    jnp = rp = None     # tests only (-m cuda)
from nomad_tpu_torch.convert import place_inputs_from_numpy
from nomad_tpu_torch.ops import place as tp

# one intra-op thread: the suite runs test files in parallel worker
# processes, and these small tensors gain nothing from more threads
torch.set_num_threads(1)

RTOL = 1e-5
ATOL = 1.2e-7   # one f32 ulp at 1.0 (scores lie in [-2, 1])
CASES = tp.scan_model_cases()
IDS = [c[0] for c in CASES]
SPREAD = pytest.mark.parametrize("spread", [False, True],
                                 ids=["binpack", "spread"])
CASE = pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)


def _bits_equal(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _batch(case):
    t = lambda a: torch.from_numpy(np.array(a))   # noqa: E731
    cap, used, heavy, dyn, dims = tp.scan_case_batch(*CASES[case][1:])
    return (t(cap), t(used), t(heavy), t(dyn), dims)


def _same_ints_close_floats(got, ref):
    got = tp.unpack_outputs(np.asarray(got))
    ref = tp.unpack_outputs(np.asarray(ref))
    for i in (0, 3, 4, 5):                  # node, n_eval, n_exh, top_nodes
        np.testing.assert_array_equal(got[i], ref[i])
    for i in (1, 2, 6):                     # score, fit_score, top_scores
        np.testing.assert_allclose(got[i], ref[i], rtol=RTOL, atol=ATOL)


@SPREAD
@CASE
def test_k2_cached_step_is_the_plain_version_bit_for_bit(case, spread):
    inp = place_inputs_from_numpy(CASES[case][1][0], "cpu")
    stats = {}
    got = tp.place_eval_cached_model(inp, spread, stats=stats)
    want = tp.place_eval_plain(inp, spread)
    for g, w in zip(got, want):
        _bits_equal(g, w)
    placed = int((got[0][:, 0] >= 0).sum())
    assert placed > 0
    assert stats["rows"] == placed          # one row rescored a pick


@SPREAD
@CASE
def test_k3_cached_step_is_the_plain_version_bit_for_bit(case, spread):
    args = _batch(case)
    stats = {}
    got = tp.place_batch_cached_model(*args, spread_algorithm=spread,
                                      stats=stats)
    want = tp.place_batch_packed_plain(*args, spread_algorithm=spread)
    for g, w in zip(got, want):
        _bits_equal(g, w)


def test_rack_spread_rescores_every_row_once_an_eval():
    """One group, one demand: after an eval's first slot only the picked
    row is rescored, in both evals of the chain."""
    case = IDS.index("rack spread (one group, one demand)")
    stats = {}
    packed, _ = tp.place_batch_cached_model(*_batch(case), stats=stats)
    assert stats["full"] == 2
    assert stats["rows"] == int((packed[..., 0] >= 0).sum()) == 2 * 24


def test_cases_cover_what_they_name():
    """The cases reach the edges they are named for, on the plain path."""
    def plain(label):
        inp = place_inputs_from_numpy(CASES[IDS.index(label)][1][0], "cpu")
        return inp, tp.unpack_outputs(tp.place_eval_plain(inp)[0].numpy())
    _, out = plain("fewer than 5 rows fit")
    assert (out[6][:, 3:] == -np.inf).all() and (out[0] == -1).any()
    inp, out = plain("place_cap reaching 0")
    assert out[3][-1] < out[3][0]           # rows left the feasible set
    inp, out = plain("ties at the top-5 boundary")
    # a row outside the first slot's top-5 whose fields equal the fifth's
    fifth = int(out[5][0, 4])
    rows = [inp.feasible[0], inp.affinity[0], inp.spread_vidx[0, 0],
            *inp.capacity.T, *inp.used.T]
    same = np.all([(x == x[fifth]).numpy() for x in rows], axis=0)
    assert set(np.flatnonzero(same)) - set(out[5][0].tolist())
    _, out = plain("N = 5 rows")
    assert sorted(out[5][0]) == [0, 1, 2, 3, 4]
    inp = place_inputs_from_numpy(
        CASES[IDS.index("-0.0 usages, S = 1")][1][0], "cpu")
    _, used = tp.place_eval_plain(inp)
    z = used.numpy().view(np.uint32)
    assert (z == 0x80000000).sum() == 2     # the pick keeps -0.0 + -0.0
    assert (z[:, 2:] == 0).sum() > 0        # every other row reads + 0
    _, evals, deltas = CASES[IDS.index("deltas: repeated rows, rows past N")]
    assert all(any(r >= 61 for r, _ in d) for d in deltas)
    assert all(len({r for r, _ in d}) < len(d) for d in deltas)

    # NaN and -inf scores on group 0's slots (the even ones): none places,
    # every group-1 slot does
    def nan_slots(label):
        inp, out = plain(label)
        assert (out[0][0::2] == -1).all() and (out[0][1::2] >= 0).all()
        return inp, out
    inp, out = nan_slots("a fitting row scoring NaN (+inf capacity and usage)")
    r = 17
    assert bool(inp.feasible[0, r]) and np.isinf(inp.capacity[r, 0].item())
    fit = tp.score_fit(inp.capacity[r], inp.used[r] + inp.demand[0], False)
    # the CPU's inf / inf is -NaN, so the row ranks last, out of the top-5
    assert fit.numpy().view(np.uint32) == 0xFFC00000
    assert r not in out[5][0]
    _, out = nan_slots("every fitting row scoring -inf beside rows that do "
                       "not fit")
    assert (out[6][0] == -np.inf).all() and out[5][0].tolist() == [0, 1, 2,
                                                                   3, 4]
    assert out[3][0] > out[4][0] > 0        # rows that do not fit
    _, out = nan_slots("a NaN row in the top-5 beside finite fitting rows")
    assert out[5][0, 0] == 40 and np.isnan(out[6][0, 0])
    assert np.isfinite(out[6][0, 1:]).all()
    inp, out = nan_slots("a row scoring -NaN")
    assert inp.affinity[0, 9].numpy().view(np.uint32) == 0xFFC00000
    assert 9 not in out[5][0] and np.isfinite(out[6][0]).all()


@SPREAD
@CASE
def test_k2_plain_matches_reference(case, spread):
    fields = CASES[case][1][0]
    ref, ref_used = rp.place_eval_packed_jit(rp.PlaceInputs(**fields),
                                             spread_algorithm=spread)
    got, used = tp.place_eval_plain(place_inputs_from_numpy(fields, "cpu"),
                                    spread)
    _same_ints_close_floats(got.numpy(), ref)
    np.testing.assert_allclose(used.numpy(), np.asarray(ref_used), rtol=RTOL)


@SPREAD
@CASE
def test_k3_plain_matches_reference(case, spread):
    cap, used, heavy, dyn, dims = tp.scan_case_batch(*CASES[case][1:])
    ref, ref_used = rp.place_batch_packed_jit(
        cap, used, tuple(jnp.asarray(h) for h in heavy), dyn, dims,
        spread_algorithm=spread)
    got, got_used = tp.place_batch_packed_plain(*_batch(case),
                                                spread_algorithm=spread)
    _same_ints_close_floats(got.numpy(), ref)
    np.testing.assert_allclose(got_used.numpy(), np.asarray(ref_used),
                               rtol=RTOL)


# the ends of lax.top_k's total order: NaN of either sign (by its bits),
# +-inf, +-0.0, and values that tie
EDGE_VALUES = np.concatenate([
    np.array([0x7FC00000, 0xFFC00000], np.uint32).view(np.float32),
    np.array([np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 0.5], np.float32)])


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("seed", range(4))
def test_lax_top_k_matches_reference(seed, k):
    """ops/place.py `_lax_top_k` against `lax.top_k` on vectors drawn
    from EDGE_VALUES: the same rows and the same bits.  The plain
    versions of K2, K7a, K7c, K7d and K8d take their top lists and
    top-2s from it."""
    from jax import lax
    x = np.random.default_rng(seed).choice(EDGE_VALUES, size=16)
    ref_v, ref_i = lax.top_k(jnp.asarray(x), k)
    got_v, got_i = tp._lax_top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    _bits_equal(got_v.numpy(), np.asarray(ref_v))


@pytest.mark.cuda
def test_scan_kernels_match_plain_on_every_case():
    """On the card: K3 bit-equal to its plain version on every case, K2
    with equal integers and floats within the tolerances; without delays
    and under three seeds of the kernels' random delays at every
    exchange phase (place_scan_set_jitter)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    from nomad_tpu_torch.ops import _build
    lib = _build.load("place_scan")
    stream = torch.cuda.current_stream().cuda_stream
    c = lambda a: a.cuda() if torch.is_tensor(a) else a   # noqa: E731
    try:
        for seed in (0, 1, 2, 3):
            assert lib.place_scan_set_jitter(seed, stream) == 0
            for case in range(len(CASES)):
                for spread in (False, True):
                    args = [c(a) for a in _batch(case)]
                    got = tp.place_batch_packed(*args,
                                                spread_algorithm=spread)
                    want = tp.place_batch_packed_plain(
                        *args, spread_algorithm=spread)
                    for g, w in zip(got, want):
                        _bits_equal(g.cpu().numpy(), w.cpu().numpy())
                    inp = place_inputs_from_numpy(CASES[case][1][0], "cuda")
                    got = tp.place_eval_packed(inp, spread)
                    want = tp.place_eval_plain(inp, spread)
                    _same_ints_close_floats(got[0].cpu().numpy(),
                                            want[0].cpu().numpy())
                    np.testing.assert_allclose(got[1].cpu().numpy(),
                                               want[1].cpu().numpy(),
                                               rtol=RTOL, atol=ATOL)
    finally:
        lib.place_scan_set_jitter(0, stream)
