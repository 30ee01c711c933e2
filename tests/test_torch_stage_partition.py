"""The stage probe's greedy order as a stable partition (K8d, K8f).

The reference's `argmax` orders the rows by a stable argsort of
where(wave, -cur, +inf) (nomad_tpu/parallel/stage_probe.py:105, :208).
Every wave row has cur == top1, so the keys take two values and the
order is a stable partition: the wave rows in row order, then the
others.  K8d and K8f (csrc/stage_probe.cu) compute it without a sort;
`argmax_model` and `fused_wave_model` (ops/stage_probe.py) are their
algorithm in PyTorch.  Each is held here to the plain version and to the
reference's jitted functions (JAX on the CPU platform of conftest.py) on
the same numpy inputs: the probe's seeded inputs and the edge rows of
tests/_stage_cases.py `probe_edge_inputs` (a best row scoring -inf, NaN
scores at m = 1 and past it, no row fitting, every row tied, two rows, a
count above every run), and scores with a NaN of either sign put in by hand.  Integers
must be equal; the models and the plain versions bit-equal; floats
against the reference within RTOL, NaN and infinities where it has them
(its XLA CPU build evaluates pow with its own routine and contracts
`used + m * demand` into an FMA, so finite floats may differ in the last
bits).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nomad_tpu.ops import place as rp
from nomad_tpu.parallel import stage_probe as rsp
from nomad_tpu_torch.ops import stage_probe as tsp
from nomad_tpu_torch.parallel import stage_probe as psp

import _stage_cases as stc

torch.set_num_threads(1)

RTOL = 1e-5
N = 96
SEEDS = range(5)


@pytest.fixture(scope="module")
def ref_fns():
    return rsp._stage_fns()


def _np(x):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in x.items()}


def _ref_grid(fns, x):
    """The reference's fits_m and score_m (its K8a-K8c) on inputs x."""
    f_feas, f_fit, f_score = fns[:3]
    util_m, fits_m = f_feas(x["capacity"], x["used"], x["demand"],
                            x["feasible"], x["ms"])
    fit_m = f_fit(x["capacity"], util_m)
    score_m = f_score(fit_m, x["coll"], x["ms"], np.float32(x["desired_f"]),
                      x["penalty"], x["affinity"], np.bool_(x["has_affinity"]))
    return np.array(fits_m), np.array(score_m)


def _ref_fused(x):
    """The reference's `fused_wave` (stage_probe.py:196-216), rebuilt from
    ops/place.py's bulk_wave_grid and bulk_run_lengths as probe_fused
    composes them (it is a closure there)."""
    ms, fits_m, score_m = rp.bulk_wave_grid(
        x["capacity"], x["used"], x["demand"], x["feasible"], x["affinity"],
        np.bool_(x["has_affinity"]), np.float32(x["desired_f"]),
        x["penalty"], x["coll"], False, x["fill_grid"])
    fits = fits_m[:, 0]
    cur = jnp.where(fits, score_m[:, 0], -jnp.inf)
    top2 = jax.lax.top_k(cur, 2)[0]
    second = jnp.where(cur == top2[0], top2[1], top2[0])
    run = rp.bulk_run_lengths(ms, fits_m, score_m, second)
    wave = fits & (cur == top2[0])
    order = jnp.argsort(jnp.where(wave, -cur, jnp.inf))
    base_sorted = run[order]
    prefix = jnp.cumsum(base_sorted) - base_sorted
    alloc_sorted = jnp.clip(np.int32(x["count"]) - prefix, 0, base_sorted)
    per_node = jnp.zeros(run.shape[0], jnp.int32).at[order].set(alloc_sorted)
    used2 = x["used"] + per_node[:, None].astype(jnp.float32) * x["demand"]
    return (np.asarray(used2), np.asarray(x["coll"] + per_node),
            int(jnp.sum(per_node)))


def _fused_args(x):
    return (x["capacity"], x["used"], x["demand"], x["feasible"],
            x["affinity"], x["has_affinity"], x["desired_f"], x["penalty"],
            x["coll"], x["count"], x["fill_grid"])


def _close(got, ref, what):
    """NaN and +-inf where the reference has them, finite values within
    RTOL."""
    got, ref = np.asarray(got), np.asarray(ref)
    for kind in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(kind(got), kind(ref), err_msg=what)
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL, err_msg=what)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _check_argmax(fns, fits_m, score_m, ms, what):
    """K8d's model and plain version against the reference's argmax on
    one grid: run and order equal."""
    ref_run, ref_order = (np.asarray(a) for a in fns[3](
        jnp.asarray(fits_m), jnp.asarray(score_m), jnp.asarray(ms)))
    args = (torch.from_numpy(fits_m), torch.from_numpy(score_m),
            torch.from_numpy(ms))
    for name, fn in (("model", tsp.argmax_model), ("plain", tsp.argmax_plain)):
        run, order = fn(*args)
        assert run.dtype == order.dtype == torch.int32
        np.testing.assert_array_equal(run.numpy(), ref_run,
                                      err_msg=f"{what}: {name} run")
        np.testing.assert_array_equal(order.numpy(), ref_order,
                                      err_msg=f"{what}: {name} order")
    return ref_run, ref_order


def _check_fused(x, what):
    """K8f's model and plain version: bit-equal to each other, and
    against the reference's fused wave."""
    ref_used2, ref_coll2, ref_placed = _ref_fused(_np(x))
    model = tsp.fused_wave_model(*_fused_args(x))
    plain = tsp.fused_wave_plain(*_fused_args(x))
    for k, (a, b) in enumerate(zip(model, plain)):
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}: {k}"
        assert torch.equal(_bits(a), _bits(b)), f"{what}: output {k}"
    _close(model[0].numpy(), ref_used2, f"{what}: used2")
    np.testing.assert_array_equal(model[1].numpy(), ref_coll2,
                                  err_msg=f"{what}: coll2")
    assert int(model[2]) == ref_placed, what
    return model


@pytest.mark.parametrize("M", [16, 64])
@pytest.mark.parametrize("seed", SEEDS)
def test_partition_matches_reference_on_seeded_inputs(ref_fns, seed, M):
    x = psp.probe_inputs(N, fill_grid=M, device="cpu")
    rng = np.random.default_rng(seed)
    if seed:                              # other draws than the probe's
        n = x["capacity"].shape[0]
        x["used"] = torch.from_numpy(
            rng.uniform(0.0, 400.0, (n, 4)).astype(np.float32))
        x["coll"] = torch.from_numpy(rng.integers(0, 4, n).astype(np.int32))
        x["count"] = int(rng.integers(1, 400))
    fits_m, score_m = _ref_grid(ref_fns, _np(x))
    _check_argmax(ref_fns, fits_m, score_m, x["ms"].numpy(),
                  f"seed {seed}, M={M}")
    _check_fused(x, f"seed {seed}, M={M}")


@pytest.mark.parametrize("M", [16, 64])
@pytest.mark.parametrize("kind", stc.EDGE_KINDS)
def test_partition_matches_reference_on_edge_rows(ref_fns, kind, M):
    x = stc.probe_edge_inputs(kind, N, M, device="cpu")
    fits_m, score_m = _ref_grid(ref_fns, _np(x))
    _check_argmax(ref_fns, fits_m, score_m, x["ms"].numpy(),
                  f"{kind}, M={M}")
    _check_fused(x, f"{kind}, M={M}")


def test_edge_rows_take_their_paths(ref_fns):
    """Each edge case reaches what it is named for, on the CPU: a -inf
    top1 gives the rows' own order; the CPU's NaN is -NaN and ranks
    lowest, so the NaN rows stay outside the wave and run 1; past m = 1
    the NaN rows run exactly 1; no fitting row runs or places nothing;
    tied rows are all in the wave; a count above every run places all
    runs."""
    M = 16
    got = {}
    for kind in stc.EDGE_KINDS:
        x = stc.probe_edge_inputs(kind, N, M, device="cpu")
        fits_m, score_m = _ref_grid(ref_fns, _np(x))
        run, order = tsp.argmax_model(torch.from_numpy(fits_m),
                                      torch.from_numpy(score_m), x["ms"])
        placed = int(tsp.fused_wave_model(*_fused_args(x))[2])
        got[kind] = (fits_m, score_m, run.numpy(), order.numpy(), placed)
    fits_m, score_m, run, order, _ = got["best row scores -inf"]
    assert np.isneginf(score_m[:, 0][fits_m[:, 0]]).all()
    assert fits_m[:, 0].any() and (order == np.arange(N)).all()
    for kind in ("NaN at m = 1", "NaN past m = 1"):
        fits_m, score_m, run, order, _ = got[kind]
        odd = [0, 1, N // 2]
        col = slice(0, 1) if kind == "NaN at m = 1" else slice(1, None)
        assert np.isnan(score_m[odd, col]).all() and fits_m[odd, 0].all()
        assert (np.asarray(score_m[odd, col]).view(np.uint32)
                >> 31 == 1).all()                  # -NaN on the CPU
        assert (run[odd] == 1).all() and order[0] not in odd
    fits_m, _, run, order, placed = got["no row fits"]
    assert not fits_m.any() and (run == 0).all() and placed == 0
    assert (order == np.arange(N)).all()
    fits_m, score_m, run, order, _ = got["every row tied"]
    assert fits_m[:, 0].all() and (score_m[:, 0] == score_m[0, 0]).all()
    assert (order == np.arange(N)).all()
    _, _, run, _, placed = got["count above every run"]
    assert placed == int(run.sum()) < 10 ** 6
    assert got["two rows"][2].shape == (2,)


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("col", [0, 2])
def test_partition_on_signed_nan_scores(ref_fns, col, sign):
    """NaN scores put in by hand, of either sign, at m = 1 or at m = 3 of
    fitting rows: lax.top_k ranks +NaN above every score (top1 is NaN, no
    row equals it: an empty wave, the rows' own order) and -NaN below
    every one; a NaN past m = 1 ends the row's run there.  The model and
    the plain version follow the reference on both."""
    rng = np.random.default_rng(11)
    M, n = 16, 64
    fits_m = rng.random((n, M)) < 0.9
    fits_m[:, 1:] &= fits_m[:, :1]
    score_m = rng.choice(np.float32([0.25, 0.5, 0.75]), (n, M))
    nan = np.float32(sign) * np.float32(np.nan)
    rows = [5, 17, 40]
    fits_m[rows, :4] = True
    score_m[rows, col] = nan
    ms = np.arange(1, M + 1, dtype=np.float32)
    run, order = _check_argmax(ref_fns, fits_m, score_m, ms,
                               f"NaN sign {sign} at m = {col + 1}")
    if col == 0 and sign > 0:
        assert (order == np.arange(n)).all()
    if col == 2:
        assert (run[rows] <= 2).all()
