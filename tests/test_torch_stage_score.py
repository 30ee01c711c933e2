"""The stage probe's score unit (K8c) against the reference's jitted
`score` (nomad_tpu/parallel/stage_probe.py:77, `_stage_fns`).

The same numpy inputs, made from a seed (tests/_stage_cases.py
`score_inputs`), go through the reference's `score` (JAX on the CPU
platform of conftest.py) and the port's `score_plain` on CPU tensors, at
M = 1, 3, 7, 16 and 64, on seeded inputs and on K8c's own edges:
has_affinity off; affinities of -0.0, NaN and +-inf; a NaN penalty; a
desired count of 0, 0.5 and NaN (the reference's jnp.maximum keeps a
NaN: every cell with a collision scores NaN); collision counts at and
past 2^24, where (float)coll + m rounds.  The unit has no multiply, so
the reference's XLA CPU build has nothing to contract into an FMA, and
every float must be bit-equal to the reference's, NaN against NaN.

Two faults of the port showed here and are repaired: XLA compiles the
reference's -(coll_m + 1) / div, with coll_m = (float)coll + m - 1, as
-((float)coll + m) / div (it folds (x - 1) + 1 to x), which differs from
the literal form once coll + m passes 2^24; and the kernels' fmaxf gave
a NaN desired count a divisor of 1.  The wave grid (ops/place.py
`bulk_wave_grid`), the score stack of K1, K4, K7 and K8f, shares the
first: it is held to the reference's jitted grid on these cases too.
Tests marked `cuda` hold the K8c kernel bit-equal to `score_plain` on
the card on every case, and K8f and K1 to their plain versions on the
wave grid's cases; they skip here.
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from nomad_tpu.ops import place as rp
    from nomad_tpu.parallel import stage_probe as rsp
except ImportError:     # a machine with a card and no JAX runs the cuda
    jnp = rp = rsp = None   # tests only (-m cuda)
from nomad_tpu_torch.ops import place as tp
from nomad_tpu_torch.ops import stage_probe as tsp
from nomad_tpu_torch.parallel import stage_probe as psp

import _stage_cases as stc

torch.set_num_threads(1)

# rows of the CPU cases: not a multiple of 32, so a warp of the kernel
# spans a row boundary at every M but 1
N = 37


@pytest.fixture(scope="module")
def ref_score():
    return rsp._stage_fns()[2]


def _t(a):
    return torch.from_numpy(np.array(a))


def _bit_equal(got, want, what):
    """Same dtype and shape; floats bit for bit where the reference is
    not NaN, NaN where it is; other types equal."""
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, what
    if w.dtype == np.float32:
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan, err_msg=what)
        g, w = np.where(nan, 0, g).view(np.uint32), \
            np.where(nan, 0, w).view(np.uint32)
    np.testing.assert_array_equal(g, w, err_msg=what)


def _plain(x, dev="cpu"):
    t = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa: E731
    return tsp.score_plain(t(x["fit_m"]), t(x["coll"]), t(x["ms"]),
                           x["desired_f"], t(x["penalty"]),
                           t(x["affinity"]), x["has_affinity"])


def _reference(ref_score, x):
    return np.asarray(ref_score(
        x["fit_m"], x["coll"], x["ms"], np.float32(x["desired_f"]),
        x["penalty"], x["affinity"], np.bool_(x["has_affinity"])))


@pytest.mark.parametrize("M", stc.SCORE_GRIDS)
@pytest.mark.parametrize("kind", stc.SCORE_KINDS)
def test_score_plain_matches_reference(ref_score, kind, M):
    x = stc.score_inputs(kind, N, M, seed=M)
    _bit_equal(_plain(x).numpy(), _reference(ref_score, x),
               f"score {kind}, M={M}")


def test_score_wrapper_takes_the_plain_version_on_the_cpu():
    x = stc.score_inputs("affinity -0.0, NaN and +-inf", N, 7)
    before = tsp.launches["stage_score"]
    got = tsp.score(_t(x["fit_m"]), _t(x["coll"]), _t(x["ms"]),
                    x["desired_f"], _t(x["penalty"]), _t(x["affinity"]),
                    x["has_affinity"])
    _bit_equal(got.numpy(), _plain(x).numpy(), "score wrapper on the CPU")
    assert tsp.launches["stage_score"] == before


def test_cases_reach_what_they_name(ref_score):
    """Each edge case reaches its edge in the reference's output."""
    M = 7
    x = stc.score_inputs("coll at and past 2^24", N, M)
    exact = x["coll"][:, None].astype(np.float64) + x["ms"][None, :] - 1.0
    rounded = x["coll"][:, None].astype(np.float32) + x["ms"][None, :] \
        - np.float32(1.0)
    assert (rounded.astype(np.float64) != exact).any()
    nan = stc.score_inputs("desired NaN", N, M)
    ref = _reference(ref_score, nan)
    has_coll = (nan["coll"][:, None] + nan["ms"][None, :] - 1) > 0
    np.testing.assert_array_equal(np.isnan(ref), has_coll)
    assert (~has_coll).any()
    odd = stc.score_inputs("affinity -0.0, NaN and +-inf", N, M)
    ref = _reference(ref_score, odd)
    off = dict(odd, affinity=np.where(odd["affinity"] == 0.0, np.float32(0.5),
                                      odd["affinity"]))
    # -0.0 is off (as 0.0), the others on: NaN and +-inf reach the score
    assert not np.array_equal(_reference(ref_score, off)[0::4], ref[0::4])
    assert np.isnan(ref[1::4]).all()
    assert np.isposinf(ref[2::4]).all() and np.isneginf(ref[3::4]).all()
    pen = _reference(ref_score, stc.score_inputs("NaN penalty", N, M))
    assert np.isnan(pen[::5]).all() and not np.isnan(pen[1::5]).any()


@pytest.mark.parametrize("kind", stc.WAVE_SCORE_KINDS)
def test_wave_grid_matches_reference_on_the_score_cases(kind):
    """K1's, K4's, K7's and K8f's score stack is the grid of
    `bulk_wave_grid` (csrc/bulk_common.cuh `grid_cell`, stage_probe.cu
    `cell_score`); held to the reference's jitted grid on a desired
    count below 1 and NaN (fits equal, NaN where it has them, the other
    floats to rtol 1e-5: the grid's fit evaluates pow with XLA's own
    routine and contracts used + m * demand into an FMA, as
    tests/test_torch_stage_probe.py states) and at collision counts past
    2^24, where the anti-affinity term (about -2^21, a quarter apart)
    swamps the fit's last bits: there every score is bit-equal."""
    import jax
    x = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
         for k, v in stc.wave_score_inputs(kind, N, 16, "cpu").items()}
    args = [x[k] for k in ("capacity", "used", "demand", "feasible",
                           "affinity")]
    grid = jax.jit(rp.bulk_wave_grid, static_argnums=(9, 10))
    ref = grid(*args, np.bool_(True), np.float32(x["desired_f"]),
               x["penalty"], x["coll"], False, 16)
    got = tp.bulk_wave_grid(*[_t(a) for a in args], True, x["desired_f"],
                            _t(x["penalty"]), _t(x["coll"]), False, 16)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    ref_s, got_s = np.asarray(ref[2]), got[2].numpy()
    if kind == "coll at and past 2^24":
        _bit_equal(got_s, ref_s, kind)
        return
    np.testing.assert_array_equal(np.isnan(got_s), np.isnan(ref_s))
    fin = np.isfinite(ref_s)
    np.testing.assert_allclose(got_s[fin], ref_s[fin], rtol=1e-5,
                               atol=1.2e-7)
    assert np.isnan(ref_s).any() == (kind == "desired NaN")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")


@pytest.mark.cuda
def test_score_kernel_matches_plain_on_the_card():
    """K8c bit-equal to `score_plain` on the card (same operations in the
    same order, true divisions, -fmad=false; NaN against NaN) on every
    case and fill grid, at 1 row, 33 rows (a warp's rows past the last
    cell), the bench's 10,000 and 131,072 rows."""
    _card()
    for n in (1, 33, 10000):
        for kind in stc.SCORE_KINDS:
            for M in stc.SCORE_GRIDS:
                x = stc.score_inputs(kind, n, M, seed=n + M)
                t = {k: (torch.from_numpy(np.array(v)).cuda()
                         if isinstance(v, np.ndarray) else v)
                     for k, v in x.items()}
                got = tsp.score(t["fit_m"], t["coll"], t["ms"],
                                t["desired_f"], t["penalty"],
                                t["affinity"], t["has_affinity"])
                _bit_equal(got.cpu().numpy(), _plain(x, "cuda").cpu().numpy(),
                           f"K8c {kind}, N={n}, M={M}")
    for M in (16, 64):
        x = stc.score_inputs("seeded", 131072, M)
        t = {k: (torch.from_numpy(np.array(v)).cuda()
                 if isinstance(v, np.ndarray) else v) for k, v in x.items()}
        got = tsp.score(t["fit_m"], t["coll"], t["ms"], t["desired_f"],
                        t["penalty"], t["affinity"], t["has_affinity"])
        _bit_equal(got.cpu().numpy(), _plain(x, "cuda").cpu().numpy(),
                   f"K8c N=131072 M={M}")


@pytest.mark.cuda
def test_wave_kernels_match_plain_on_the_score_cases():
    """K8f and K1, whose score stack is K8c's (stage_probe.cu
    `cell_score`, bulk_common.cuh `grid_cell`), bit-equal to their plain
    versions on the wave grid's score cases at 10,000 rows."""
    _card()
    from nomad_tpu_torch.ops import place as tp
    for kind in stc.WAVE_SCORE_KINDS:
        x = stc.wave_score_inputs(kind, 10000, 16, "cuda")
        args = (x["capacity"], x["used"], x["demand"], x["feasible"],
                x["affinity"], True, x["desired_f"], x["penalty"],
                x["coll"], x["count"], 16)
        for k, (g, w) in enumerate(zip(tsp.fused_wave(*args),
                                       tsp.fused_wave_plain(*args))):
            _bit_equal(g.cpu().numpy(), w.cpu().numpy(),
                       f"K8f {kind} output {k}")
        if kind == "desired NaN":
            continue        # K1 takes an integer desired count
        k1 = (x["capacity"], x["used"], x["feasible"], x["affinity"], True,
              int(x["desired_f"]), x["penalty"] > 0, x["coll"], x["demand"],
              x["count"], False, 64, 16)
        _bit_equal(tp.place_bulk(*k1).cpu().numpy(),
                   tp.place_bulk_plain(*k1).cpu().numpy(), f"K1 {kind}")
