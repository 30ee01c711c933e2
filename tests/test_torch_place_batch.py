"""Parity of the port's chained batch kernels (K3, K4) with the reference.

The same numpy inputs, made from a seed, go through the reference's
`place_batch_packed_jit` / `place_bulk_batch_jit` /
`place_bulk_batch_donate_jit` (JAX on the CPU platform of conftest.py) and
the port's `place_batch_packed` / `place_bulk_batch` on CPU tensors (their
plain PyTorch versions).  Integer outputs (node rows, counts, placed,
n_eval, n_exh, waves, sparse rows) must be equal.  Floats (scores, usage
carries) agree within rtol 1e-5: the reference's XLA CPU build contracts
`used + m * demand` into an FMA and evaluates pow with its own routine, so
floats may differ in the last bits (the worlds use integer resource sizes,
for which both roundings are exact).  The exact carry of the donated path
is held bitwise against the port's own rank-1 host update
(native.scatter_add_rank1), which is what keeps the world's device basis
and host snapshot in lockstep.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.ops import place as rp
from nomad_tpu_torch import native
from nomad_tpu_torch.ops import place as tp

# one intra-op thread: the suite runs test files in parallel worker
# processes, and these small tensors gain nothing from more threads
torch.set_num_threads(1)

RTOL = 1e-5
ATOL = 1.2e-7   # one f32 ulp at 1.0 (scores lie in [-2, 1])


# ------------------------------------------------------------------ K3

def _scan_eval(rng, n, g, s, k, v):
    """One eval's fields (integer resource sizes, every scoring feature)."""
    vidx = rng.integers(0, v + 1, (g, k, n)).astype(np.int32)
    desired = np.full((g, k, v + 1), -1.0, np.float32)
    targeted = rng.random((g, k)) < 0.5
    for gi in range(g):
        for ki in range(k):
            if targeted[gi, ki]:
                desired[gi, ki, :v] = rng.integers(0, 6, v)
    counts = np.zeros((g, k, v + 1), np.float32)
    counts[..., :v] = rng.integers(0, 3, (g, k, v))
    slot_active = np.ones(s, bool)
    slot_active[-2:] = False
    slot_tg = rng.integers(0, g, s).astype(np.int32)
    demand = np.zeros((s, 4), np.float32)
    demand[:, :2] = (rng.integers(1, 6, (g, 2)) * np.array([100, 256]))[slot_tg]
    return tp.PlaceInputs(
        capacity=None, used=None, feasible=rng.random((g, n)) < 0.9,
        affinity=rng.choice(np.array([-1.0, -0.5, 0.0, 0.0, 0.5, 1.0],
                                     np.float32), (g, n)),
        has_affinity=rng.random(g) < 0.5,
        desired_count=rng.integers(1, 20, g).astype(np.int32),
        penalty=rng.random((g, n)) < 0.05,
        tg_count=(rng.random((g, n)) < 0.1).astype(np.int32),
        spread_vidx=vidx, spread_desired=desired, spread_targeted=targeted,
        spread_wfrac=rng.choice(np.array([0.25, 0.5, 1.0], np.float32), (g, k)),
        spread_counts=counts, spread_active=rng.random((g, k)) < 0.8,
        place_cap=np.where(rng.random((g, n)) < 0.2,
                           rng.integers(0, 3, (g, n)), -1).astype(np.int32),
        demand=demand, slot_tg=slot_tg, slot_active=slot_active)


def _world(rng, n):
    cap = np.zeros((n, 4), np.float32)
    cap[:, 0] = rng.choice([2000, 4000, 8000], n)
    cap[:, 1] = rng.choice([4096, 8192, 16384], n)
    cap[:, 2] = 100000
    cap[:, 3] = 1000
    used = np.zeros((n, 4), np.float32)
    used[:, 0] = rng.integers(0, 8, n) * 100
    used[:, 1] = rng.integers(0, 8, n) * 256
    return cap, used


def _deltas(rng, n, n_deltas):
    """Integer usage deltas (stops are negative, preplacements positive),
    one row twice, as an eval's stops on one node give."""
    rows = rng.choice(n, n_deltas, replace=False)
    out = [(int(r), (rng.integers(-3, 4, 4) * np.array([100, 256, 0, 0]))
            .astype(np.float32)) for r in rows]
    if out:
        out.append((out[0][0], np.array([100, 0, 0, 0], np.float32)))
    return out


def _scan_batch(n, g, s, k, v, E, with_deltas, pads, seed):
    rng = np.random.default_rng(seed)
    cap, used = _world(rng, n)
    evals = [_scan_eval(rng, n, g, s, k, v) for _ in range(E)]
    D = 64
    heavy = np.stack([tp.pack_heavy(i) for i in evals])
    lights = [tp.pack_light(i, _deltas(rng, n, 3) if with_deltas else [], D)
              for i in evals]
    Ll = lights[0].shape[0]
    lights += [np.zeros(Ll, np.float32)] * pads
    heavy = np.concatenate([heavy, np.repeat(heavy[:1], pads, axis=0)])
    dyn = np.concatenate(lights)
    dims = (g, n, k, v + 1, s, D)
    return cap, used, heavy, dyn, dims, evals


@pytest.mark.parametrize("spread_alg", [False, True], ids=["binpack", "spread"])
@pytest.mark.parametrize("E,with_deltas,pads", [
    (1, False, 0), (1, True, 0), (8, True, 0), (5, True, 3), (8, False, 0),
])
@pytest.mark.parametrize("n,g,s,k,v", [(64, 2, 16, 2, 5), (300, 3, 24, 2, 8)])
def test_batch_packed_matches_reference(n, g, s, k, v, E, with_deltas, pads,
                                        spread_alg):
    cap, used, heavy, dyn, dims, _ = _scan_batch(
        n, g, s, k, v, E, with_deltas, pads, seed=n + E + g)
    ref_packed, ref_used = rp.place_batch_packed_jit(
        cap, used, tuple(jnp.asarray(h) for h in heavy), dyn, dims,
        spread_algorithm=spread_alg)
    before = dict(tp.launches)
    t = torch.from_numpy
    packed, used_f = tp.place_batch_packed(t(cap), t(used), t(heavy), t(dyn),
                                           dims, spread_algorithm=spread_alg)
    assert tp.launches == before            # the plain path never counts
    assert packed.shape == (heavy.shape[0], s, tp.PACKED_WIDTH)
    got = tp.unpack_outputs(packed.numpy())
    ref = tp.unpack_outputs(np.asarray(ref_packed))
    for i in (0, 3, 4, 5):                  # node, n_eval, n_exh, top_nodes
        np.testing.assert_array_equal(got[i], ref[i])
    for i in (1, 2, 6):                     # score, fit_score, top_scores
        np.testing.assert_allclose(got[i], ref[i], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(used_f.numpy(), np.asarray(ref_used),
                               rtol=RTOL)
    assert (got[0][:E, :-2] >= 0).any()
    assert (got[0][:, -2:] == -1).all()     # inactive slots place nothing


def test_pack_heavy_and_light_match_reference_layout():
    rng = np.random.default_rng(3)
    inp = _scan_eval(rng, 40, 2, 8, 2, 3)
    ref_inp = rp.PlaceInputs(**{f: getattr(inp, f)
                                for f in tp.PLACE_INPUT_DTYPES})
    np.testing.assert_array_equal(tp.pack_heavy(inp), rp.pack_heavy(ref_inp))
    assert tp.heavy_digest(inp) == rp.heavy_digest(ref_inp)
    assert tp.pack_heavy(inp).shape == (tp.heavy_len(*tp.heavy_dims(inp)),)
    deltas = _deltas(rng, 40, 4)
    np.testing.assert_array_equal(tp.pack_light(inp, deltas, 64, 16),
                                  rp.pack_light(ref_inp, deltas, 64, 16))


# ------------------------------------------------------------------ K4

def _bulk_eval(rng, n, count, extras):
    feasible = rng.random(n) < 0.9
    affinity = np.zeros(n, np.float32)
    penalty = np.zeros(n, bool)
    coll0 = np.zeros(n, np.int32)
    if extras:
        affinity = rng.choice(np.array([-1.0, -0.5, 0.0, 0.0, 0.5, 1.0],
                                       np.float32), n)
        penalty = rng.random(n) < 0.05
        coll0 = ((rng.random(n) < 0.1) * rng.integers(1, 3, n)).astype(np.int32)
    demand = np.array([rng.integers(1, 6) * 100, rng.integers(1, 6) * 256,
                       0, 0], np.float32)
    return dict(feasible=feasible, affinity=affinity, penalty=penalty,
                coll0=coll0, demand=demand, count=count,
                has_affinity=extras, desired=max(count, 1))


def _bulk_batch(n, counts, with_deltas, extras, pads, seed):
    rng = np.random.default_rng(seed)
    cap, used = _world(rng, n)
    evals = [_bulk_eval(rng, n, c, extras) for c in counts]
    D = 64 if with_deltas else 0
    heavy = np.stack([tp.pack_bulk_heavy(e["feasible"], e["affinity"],
                                         e["penalty"], e["coll0"])
                      for e in evals])
    lights = [tp.pack_bulk_light(e["has_affinity"], e["desired"], e["count"],
                                 e["demand"],
                                 _deltas(rng, n, 3) if with_deltas else [],
                                 n, D) for e in evals]
    Ll = lights[0].shape[0]
    # pads as the reference engine pads a chain: count 0, zero light block
    lights += [np.zeros(Ll, np.float32)] * pads
    heavy = np.concatenate([heavy, np.repeat(heavy[:1], pads, axis=0)])
    return cap, used, heavy, np.concatenate(lights), D


BULK_CASES = {
    "sparse_e1": ([10], False, False, 0),
    "sparse_deltas_e8": ([10, 4, 30, 2, 10, 10, 7, 120], True, True, 0),
    "sparse_pads": ([10, 20, 3], True, False, 5),
    "dense_e4": ([300, 10, 200, 50], False, True, 0),
    "dense_deltas_pads": ([200, 150, 10], True, True, 1),
    "dense_overfull": ([3000, 500], True, False, 0),
}


@pytest.mark.parametrize("exact", [False, True], ids=["plain", "donate"])
@pytest.mark.parametrize("spread_alg", [False, True], ids=["binpack", "spread"])
@pytest.mark.parametrize("case", sorted(BULK_CASES))
@pytest.mark.parametrize("n", [64, 400])
def test_bulk_batch_matches_reference(n, case, spread_alg, exact):
    counts, with_deltas, extras, pads = BULK_CASES[case]
    cap, used, heavy, dyn, D = _bulk_batch(n, counts, with_deltas, extras,
                                           pads, seed=n + len(counts))
    sparse = all(c <= tp.SPARSE_CAP for c in counts)
    fill_grid = tp.fill_grid_for(max(counts))
    kw = dict(sparse_out=sparse, spread_algorithm=spread_alg,
              fill_grid=fill_grid)
    if exact:
        ref_packed, ref_used, ref_exact = rp.place_bulk_batch_donate_jit(
            cap, jnp.asarray(used), heavy, dyn, D, exact_out=True, **kw)
    else:
        ref_packed, ref_used = rp.place_bulk_batch_jit(cap, used, heavy,
                                                       dyn, D, **kw)
    before = dict(tp.launches)
    t = torch.from_numpy
    used_t = t(used.copy())
    out = tp.place_bulk_batch(t(cap), used_t, t(heavy), t(dyn), D,
                              exact_out=exact, **kw)
    assert tp.launches == before
    packed, used_f = out[0], out[1]
    width = 3 * tp.SPARSE_CAP + 4 if sparse else 2 * n + 4
    assert packed.shape == (heavy.shape[0], width)
    got = tp.unpack_bulk_batch(packed.numpy(), n, sparse=sparse)
    ref = tp.unpack_bulk_batch(np.asarray(ref_packed), n, sparse=sparse)
    for i in (0, 2, 3, 4, 5):       # assign, placed, n_eval, n_exh, waves
        np.testing.assert_array_equal(got[i], ref[i])
    np.testing.assert_allclose(got[1], ref[1], rtol=RTOL, atol=ATOL)
    if sparse:                      # the packed sparse rows themselves
        np.testing.assert_array_equal(packed.numpy()[:, :tp.SPARSE_CAP],
                                      np.asarray(ref_packed)[:, :tp.SPARSE_CAP])
    np.testing.assert_allclose(used_f.numpy(), np.asarray(ref_used),
                               rtol=RTOL)
    assert (got[2][:len(counts)] > 0).all()
    assert (got[2][len(counts):] == 0).all()      # count-0 pads place nothing
    if exact:
        exact_t = out[2]
        assert exact_t is used_t                   # written in place
        np.testing.assert_allclose(exact_t.numpy(), np.asarray(ref_exact),
                                   rtol=RTOL)
        # bitwise against the host rank-1 update the world applies
        host = used.copy()
        light = dyn.reshape(heavy.shape[0], -1)
        for e in range(heavy.shape[0]):
            rows = np.flatnonzero(got[0][e])
            native.scatter_add_rank1(host, rows, got[0][e][rows],
                                     light[e, 3:7])
        np.testing.assert_array_equal(exact_t.numpy(), host)


def test_pack_bulk_transport_matches_reference_layout():
    rng = np.random.default_rng(5)
    e = _bulk_eval(rng, 50, 12, True)
    args = (e["feasible"], e["affinity"], e["penalty"], e["coll0"])
    np.testing.assert_array_equal(tp.pack_bulk_heavy(*args),
                                  rp.pack_bulk_heavy(*args))
    assert tp.bulk_heavy_digest(*args) == rp.bulk_heavy_digest(*args)
    deltas = _deltas(rng, 50, 3)
    np.testing.assert_array_equal(
        tp.pack_bulk_light(True, 12, 12, e["demand"], deltas, 50, 64),
        rp.pack_bulk_light(True, 12, 12, e["demand"], deltas, 50, 64))


def test_bulk_batch_wrapper_refuses_other_devices():
    cap = torch.zeros((8, 4), device="meta")
    with pytest.raises(ValueError):
        tp.place_bulk_batch(cap, cap, cap, cap, 0)
    with pytest.raises(ValueError):
        tp.place_batch_packed(cap, cap, cap, cap, (1, 8, 1, 2, 16, 64))
