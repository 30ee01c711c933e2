"""Parity of the port's stage probe (K8a-K8f, parallel/stage_probe.py)
with the reference's (nomad_tpu/parallel/stage_probe.py).

The same numpy inputs, drawn as the reference's probe draws them, go
through the reference's jitted `_stage_fns()` (JAX on the CPU platform
of conftest.py) and the port's plain units on CPU tensors.  Each unit is
given the reference's outputs of the stages before it, so a difference
shows in the unit that makes it.  Integer and bool outputs (fits, run
lengths, order, co-placements, placed) must be equal.  Floats agree
within rtol 1e-5 (atol one f32 ulp at 1.0): the reference's XLA CPU
build contracts `used + m * demand` into an FMA and evaluates pow with
its own routine, so floats may differ in the last bits.
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
from nomad_tpu_torch.ops import stage_probe as tsp
from nomad_tpu_torch.parallel import stage_probe as psp

import _stage_cases as stc

torch.set_num_threads(1)

RTOL = 1e-5
ATOL = 1.2e-7
N = 512


def _inputs(n, M, seed=0):
    """The reference probe's inputs (stage_probe.py:136-150), numpy."""
    rng = np.random.default_rng(seed)
    x = dict(
        capacity=rng.uniform(100.0, 1000.0, (n, 4)).astype(np.float32),
        used=rng.uniform(0.0, 50.0, (n, 4)).astype(np.float32),
        demand=rng.uniform(1.0, 10.0, 4).astype(np.float32),
        feasible=rng.random(n) < 0.9,
        ms=np.arange(1, M + 1, dtype=np.float32),
        coll=rng.integers(0, 3, n).astype(np.int32),
        penalty=(rng.random(n) < 0.05).astype(np.float32),
        affinity=rng.uniform(-1.0, 1.0, n).astype(np.float32))
    return x


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def ref_fns():
    return rsp._stage_fns()


def _ref_chain(fns, x, count=256, desired_f=8.0, has_aff=True):
    f_feas, f_fit, f_score, f_argmax, f_scatter = fns
    util_m, fits_m = f_feas(x["capacity"], x["used"], x["demand"],
                            x["feasible"], x["ms"])
    fit_m = f_fit(x["capacity"], util_m)
    score_m = f_score(fit_m, x["coll"], x["ms"], np.float32(desired_f),
                      x["penalty"], x["affinity"], np.bool_(has_aff))
    run, order = f_argmax(fits_m, score_m, x["ms"])
    used2, coll2, placed = f_scatter(run, order, np.int32(count), x["used"],
                                     x["demand"], x["coll"])
    return {k: np.asarray(v) for k, v in dict(
        util_m=util_m, fits_m=fits_m, fit_m=fit_m, score_m=score_m, run=run,
        order=order, used2=used2, coll2=coll2, placed=placed).items()}


@pytest.mark.parametrize("M", [16, 64])
def test_feasibility_and_fit_match_reference(ref_fns, M):
    x = _inputs(N, M)
    ref = _ref_chain(ref_fns, x)
    util_m, fits_m = tsp.feasibility(_t(x["capacity"]), _t(x["used"]),
                                     _t(x["demand"]), _t(x["feasible"]),
                                     _t(x["ms"]))
    assert util_m.shape == (N, M, 4) and fits_m.dtype == torch.bool
    np.testing.assert_allclose(util_m.numpy(), ref["util_m"], rtol=RTOL)
    np.testing.assert_array_equal(fits_m.numpy(), ref["fits_m"])
    assert ref["fits_m"].any() and not ref["fits_m"].all()
    fit_m = tsp.fit(_t(x["capacity"]), _t(ref["util_m"]))
    np.testing.assert_allclose(fit_m.numpy(), ref["fit_m"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("has_aff", [True, False])
@pytest.mark.parametrize("M", [16, 64])
def test_score_matches_reference(ref_fns, M, has_aff):
    x = _inputs(N, M, seed=1)
    ref = _ref_chain(ref_fns, x, desired_f=3.0, has_aff=has_aff)
    score_m = tsp.score(_t(ref["fit_m"]), _t(x["coll"]), _t(x["ms"]), 3.0,
                        _t(x["penalty"]), _t(x["affinity"]), has_aff)
    np.testing.assert_allclose(score_m.numpy(), ref["score_m"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("M", [16, 64])
def test_argmax_and_scatter_match_reference(ref_fns, M):
    x = _inputs(N, M, seed=2)
    ref = _ref_chain(ref_fns, x)
    run, order = tsp.argmax(_t(ref["fits_m"]), _t(ref["score_m"]),
                            _t(x["ms"]))
    assert run.dtype == torch.int32 and order.dtype == torch.int32
    np.testing.assert_array_equal(run.numpy(), ref["run"])
    np.testing.assert_array_equal(order.numpy(), ref["order"])
    used2, coll2, placed = tsp.scatter(_t(ref["run"]), _t(ref["order"]), 256,
                                       _t(x["used"]), _t(x["demand"]),
                                       _t(x["coll"]))
    np.testing.assert_allclose(used2.numpy(), ref["used2"], rtol=RTOL)
    np.testing.assert_array_equal(coll2.numpy(), ref["coll2"])
    assert int(placed) == int(ref["placed"]) == 256


def test_argmax_order_is_stable_on_ties(ref_fns):
    """Tied wave rows keep ascending row order, and so do all rows
    outside the wave (their key is +inf)."""
    M = 16
    fits_m = np.ones((64, M), bool)
    fits_m[::7] = False
    score_m = np.tile(np.linspace(0.5, 0.1, M, dtype=np.float32), (64, 1))
    score_m[[3, 9, 40]] += 0.25          # three tied best rows
    ms = np.arange(1, M + 1, dtype=np.float32)
    ref_run, ref_order = (np.asarray(a) for a in ref_fns[3](
        jnp.asarray(fits_m), jnp.asarray(score_m), jnp.asarray(ms)))
    run, order = tsp.argmax(_t(fits_m), _t(score_m), _t(ms))
    np.testing.assert_array_equal(order.numpy(), ref_order)
    np.testing.assert_array_equal(run.numpy(), ref_run)
    rest = [i for i in range(64) if i not in (3, 9, 40)]
    assert order.numpy().tolist() == [3, 9, 40] + rest


def _ref_fused(x, count, fill_grid, desired_f=8.0, has_aff=True):
    """The reference's `fused_wave` (stage_probe.py:196-216), rebuilt from
    ops/place.py's bulk_wave_grid and bulk_run_lengths as it composes
    them (it is a closure inside probe_fused)."""
    import jax
    ms, fits_m, score_m = rp.bulk_wave_grid(
        x["capacity"], x["used"], x["demand"], x["feasible"], x["affinity"],
        np.bool_(has_aff), np.float32(desired_f), x["penalty"], x["coll"],
        False, fill_grid)
    fits = fits_m[:, 0]
    cur = jnp.where(fits, score_m[:, 0], -jnp.inf)
    top2 = jax.lax.top_k(cur, 2)[0]
    second = jnp.where(cur == top2[0], top2[1], top2[0])
    run = rp.bulk_run_lengths(ms, fits_m, score_m, second)
    wave = fits & (cur == top2[0])
    order = jnp.argsort(jnp.where(wave, -cur, jnp.inf))
    base_sorted = run[order]
    prefix = jnp.cumsum(base_sorted) - base_sorted
    alloc_sorted = jnp.clip(count - prefix, 0, base_sorted)
    per_node = jnp.zeros(run.shape[0], jnp.int32).at[order].set(alloc_sorted)
    used2 = x["used"] + per_node[:, None].astype(jnp.float32) * x["demand"]
    return (np.asarray(used2), np.asarray(x["coll"] + per_node),
            int(jnp.sum(per_node)), np.asarray(wave))


def _fused(x, count, fill_grid, desired_f=8.0, has_aff=True):
    return tsp.fused_wave(_t(x["capacity"]), _t(x["used"]), _t(x["demand"]),
                          _t(x["feasible"]), _t(x["affinity"]), has_aff,
                          desired_f, _t(x["penalty"]), _t(x["coll"]), count,
                          fill_grid)


@pytest.mark.parametrize("M", [16, 64])
def test_fused_wave_matches_reference_composition(M):
    x = _inputs(N, M, seed=3)
    ref_used2, ref_coll2, ref_placed, _ = _ref_fused(x, 256, M)
    used2, coll2, placed = _fused(x, 256, M)
    np.testing.assert_allclose(used2.numpy(), ref_used2, rtol=RTOL)
    np.testing.assert_array_equal(coll2.numpy(), ref_coll2)
    assert int(placed) == ref_placed == 256


def test_fused_wave_equals_the_unit_chain():
    x = _inputs(N, 16, seed=4)
    t = {k: _t(v) for k, v in x.items()}
    util_m, fits_m = tsp.feasibility(t["capacity"], t["used"], t["demand"],
                                     t["feasible"], t["ms"])
    fit_m = tsp.fit(t["capacity"], util_m)
    score_m = tsp.score(fit_m, t["coll"], t["ms"], 8.0, t["penalty"],
                        t["affinity"], True)
    run, order = tsp.argmax(fits_m, score_m, t["ms"])
    chain = tsp.scatter(run, order, 256, t["used"], t["demand"], t["coll"])
    fused = _fused(x, 256, 16)
    for a, b in zip(chain, fused):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_probe_places_outside_the_wave_where_bulk_loop_would_not():
    """The probe's scatter takes `run[order]` unmasked (stage_probe.py
    :110, :209): once the wave rows' runs are used up, rows outside the
    wave take instances in row order.  Production's `_bulk_loop` masks
    `base = where(wave, run, 0)` (ops/place.py:590), so its wave places
    on the wave rows only (ROADMAP queue C).  The port reproduces the
    probe."""
    x = _inputs(64, 16, seed=5)
    ref_used2, ref_coll2, ref_placed, wave = _ref_fused(x, 200, 16)
    used2, coll2, placed = _fused(x, 200, 16)
    np.testing.assert_array_equal(coll2.numpy(), ref_coll2)
    assert int(placed) == ref_placed
    per_node = coll2.numpy() - x["coll"]
    assert wave.sum() == 1
    assert per_node[wave].sum() < 200             # the wave's run runs out
    outside = np.flatnonzero((per_node > 0) & ~wave)
    assert outside.size > 0
    # rows outside the wave fill in ascending row order: every row before
    # the last one that took instances took its whole run
    run = tsp.argmax(*_fits_score(x, 16))[0].numpy()
    before = [i for i in range(outside[-1]) if not wave[i]]
    np.testing.assert_array_equal(per_node[before], run[before])


def _fits_score(x, M):
    t = {k: _t(v) for k, v in x.items()}
    util_m, fits_m = tsp.feasibility(t["capacity"], t["used"], t["demand"],
                                     t["feasible"], t["ms"][:M])
    fit_m = tsp.fit(t["capacity"], util_m)
    score_m = tsp.score(fit_m, t["coll"], t["ms"][:M], 8.0, t["penalty"],
                        t["affinity"], True)
    return fits_m, score_m, t["ms"][:M]


def test_interval_overlap_matches_reference():
    rng = np.random.default_rng(7)
    for _ in range(20):
        def windows(k):
            t0 = np.sort(rng.uniform(0, 10, k))
            return [(float(a), float(a + d)) for a, d in
                    zip(t0, rng.uniform(0, 2, k))]
        a, b = windows(int(rng.integers(0, 30))), \
            windows(int(rng.integers(0, 30)))
        assert psp.interval_overlap_s(a, b) == pytest.approx(
            rsp.interval_overlap_s(a, b), abs=1e-12)


def test_device_stages_keys_match_reference():
    stats = {"device_s": 2.5, "put_basis_s": 0.125, "wave_lanes": 0,
             "lane_evals": 0, "lane_slots": 0, "donated_carries": 7,
             "overlap_chained": 3}
    kw = dict(n_nodes=256, iters=2, fill_grid=16, pipeline_overlap_s=0.5,
              commit_overlap_s=0.25, wave=stats)
    ref = rsp.device_stages(stats, **kw)
    got = psp.device_stages(stats, device="cpu", **kw)

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None
                for k, v in d.items()}
    assert keys(got) == keys(ref)
    assert set(got["stages_s"]) == set(psp.STAGES)
    assert sum(got["stages_s"].values()) == pytest.approx(2.5, abs=1e-5)
    assert got["dominant_stage"] in psp.STAGES
    assert got["wave"]["donated_carries"] == 7
    assert psp.device_stages({"device_s": 0.0}, 256, device="cpu") is None


def test_probe_units_are_counted_only_when_launched():
    before = dict(tsp.launches)
    psp.probe(128, iters=1, warmup=0, fill_grid=16, device="cpu")
    psp.probe_fused(128, iters=1, warmup=0, fill_grid=16, device="cpu")
    assert tsp.launches == before


def test_stage_wrappers_refuse_other_devices():
    m = torch.zeros((8, 4), device="meta")
    with pytest.raises(ValueError):
        tsp.feasibility(m, m, m[0], m[:, 0].bool(), m[0])
    with pytest.raises(ValueError):
        tsp.fused_wave(m, m, m[0], m[:, 0].bool(), m[:, 0], True, 8.0,
                       m[:, 0], m[:, 0].int(), 4, 16)


@pytest.mark.cuda
def test_stage_kernels_match_plain_on_the_card():
    """K8a-K8f against their plain versions on the card, at the bench's
    shape (N = 10,000, M = 16), past the 16,384 rows one block sorted in
    shared memory (N = 20,000), at 131,072 rows (8 a thread of K8d's and
    K8f's cluster), at M = 64, and on the edge rows of
    `probe_edge_inputs` (tests/_stage_cases.py) at N = 10,000: integers
    equal, floats bit-equal (same operations, same order, -fmad=false,
    powf; NaN against NaN), and K8f's outputs equal to the K8a->K8e
    kernel chain's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    cases = [psp.probe_inputs(n, fill_grid=M, device="cuda")
             for n, M in ((10000, 16), (20000, 16), (131072, 16),
                          (10000, 64), (131072, 64))]
    cases += [stc.probe_edge_inputs(kind, 10000, M, device="cuda")
              for M in (16, 64) for kind in stc.EDGE_KINDS]
    for x in cases:
        got = _unit_chain(x, kernels=True)
        want = _unit_chain(x, kernels=False)
        torch.cuda.synchronize()
        what = f"N={x['capacity'].shape[0]} M={x['fill_grid']}"
        for name in want:
            _bit_equal(got[name], want[name], f"{what}: {name}")
        for name in ("used2", "coll2", "placed"):
            _bit_equal(got["fused_" + name], got[name],
                       f"{what}: K8f {name} vs the K8a->K8e chain")


def _bit_equal(got, want, what):
    g, w = got.cpu().numpy(), want.cpu().numpy()
    assert g.dtype == w.dtype and g.shape == w.shape, what
    if w.dtype == np.float32:
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan, err_msg=what)
        g, w = np.where(nan, 0, g).view(np.uint32), \
            np.where(nan, 0, w).view(np.uint32)
    np.testing.assert_array_equal(g, w, err_msg=what)


def _unit_chain(x, kernels):
    f = (lambda k: getattr(tsp, k)) if kernels else \
        (lambda k: getattr(tsp, k + "_plain"))
    util_m, fits_m = f("feasibility")(x["capacity"], x["used"], x["demand"],
                                      x["feasible"], x["ms"])
    fit_m = f("fit")(x["capacity"], util_m)
    score_m = f("score")(fit_m, x["coll"], x["ms"], x["desired_f"],
                         x["penalty"], x["affinity"], x["has_affinity"])
    run, order = f("argmax")(fits_m, score_m, x["ms"])
    used2, coll2, placed = f("scatter")(run, order, x["count"], x["used"],
                                        x["demand"], x["coll"])
    fu2, fc2, fp = f("fused_wave")(
        x["capacity"], x["used"], x["demand"], x["feasible"], x["affinity"],
        x["has_affinity"], x["desired_f"], x["penalty"], x["coll"],
        x["count"], x["fill_grid"])
    return dict(util_m=util_m, fits_m=fits_m, fit_m=fit_m, score_m=score_m,
                run=run, order=order, used2=used2, coll2=coll2,
                placed=placed.reshape(1), fused_used2=fu2, fused_coll2=fc2,
                fused_placed=fp.reshape(1))
