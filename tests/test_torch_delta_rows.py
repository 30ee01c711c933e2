"""Negative delta rows: the port's K3 and K4 against the reference.

The reference applies an eval's sparse usage deltas with
`used.at[delta_rows].add(vals, mode="drop")` (nomad_tpu/ops/place.py
`place_batch_packed_jit` and `_place_bulk_batch`).  JAX normalises a
negative index first, so a row in [-N, 0) lands on row + N, while rows
below -N and at N or past drop.  The port's plain versions (K3's
`place_batch_packed`, its model `place_batch_cached_model`, and K4's
`place_bulk_batch`, on CPU tensors) must do the same; the kernels are
held to the plain versions on these rows by chip_smoke.py.

The sharded reference masks every row outside the shard before its
scatter (`_apply_deltas_local`, nomad_tpu/parallel/sharded.py), so it
drops a negative row; the port's sharded chains do too.  The two
references split there, and `test_sharded_chains_drop_negative_rows`
pins the split.

Every eval's deltas hold rows -1, -N, -N - 1 and N, and a row met twice
(once as r - N, once as r).  The worlds use integer resource sizes, so
usage is compared bit for bit; integer outputs must be equal and scores
agree within rtol 1e-5 (the reference's XLA CPU build evaluates pow with
its own routine).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nomad_tpu.ops import place as rp
from nomad_tpu.parallel import sharded as rs
from nomad_tpu_torch.ops import place as tp
from nomad_tpu_torch.parallel import sharded as ps
from test_torch_place_batch import _bulk_eval, _scan_eval, _world
from test_torch_sharded import BULK_ORDER, _lane_inputs, _scan_chain

torch.set_num_threads(1)

RTOL = 1e-5
ATOL = 1.2e-7
D = 16


def _negative_deltas(rng, n, scale=1):
    """Deltas on rows -1, -N, -N - 1, N, N - 1 (the row -1 lands on) and
    a row r met as r - N and as r, integer sizes."""
    r = int(rng.integers(1, n - 1))
    v = lambda: (scale * rng.integers(1, 4, 4)      # noqa: E731
                 * np.array([100, 256, 0, 0])).astype(np.float32)
    return [(-1, v()), (-n, v()), (-n - 1, v()), (n, v()), (n - 1, -v()),
            (r - n, v()), (r, v())]


def test_scatter_wraps_rows_as_jax_indexes():
    """The plain scatter against `.at[rows].add(mode="drop")`."""
    got = tp._scatter_add_rows(torch.zeros(4), torch.tensor([-1, -5, 4, 1]),
                               torch.tensor([1.0, 2.0, 3.0, 4.0]))
    assert got.tolist() == [0.0, 4.0, 0.0, 1.0]
    rng = np.random.default_rng(5)
    x = rng.integers(-9, 9, (7, 3)).astype(np.float32)
    rows = rng.integers(-16, 16, 40)
    vals = rng.integers(-9, 9, (40, 3)).astype(np.float32)
    want = jnp.asarray(x).at[rows].add(vals, mode="drop")
    got = tp._scatter_add_rows(torch.from_numpy(x), torch.from_numpy(rows),
                               torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _scan_chain_with(n, E, seed):
    rng = np.random.default_rng(seed)
    cap, used = _world(rng, n)
    g, s, k, v = 2, 12, 2, 5
    evals = [_scan_eval(rng, n, g, s, k, v) for _ in range(E)]
    heavy = np.stack([tp.pack_heavy(i) for i in evals])
    dyn = np.concatenate([tp.pack_light(i, _negative_deltas(rng, n), D)
                          for i in evals])
    return cap, used, heavy, dyn, (g, n, k, v + 1, s, D)


@pytest.mark.parametrize("spread", [False, True], ids=["binpack", "spread"])
def test_k3_wraps_negative_delta_rows_as_reference(spread):
    cap, used, heavy, dyn, dims = _scan_chain_with(48, 3, seed=21)
    ref, ref_used = rp.place_batch_packed_jit(
        cap, used, tuple(jnp.asarray(h) for h in heavy), dyn, dims,
        spread_algorithm=spread)
    ref = tp.unpack_outputs(np.asarray(ref))
    t = torch.from_numpy
    args = (t(cap), t(used), t(heavy), t(dyn), dims)
    for fn in (tp.place_batch_packed, tp.place_batch_cached_model):
        packed, used_f = fn(*args, spread_algorithm=spread)
        got = tp.unpack_outputs(packed.numpy())
        for i in (0, 3, 4, 5):          # node, n_eval, n_exh, top_nodes
            np.testing.assert_array_equal(got[i], ref[i])
        for i in (1, 2, 6):             # score, fit_score, top_scores
            np.testing.assert_allclose(got[i], ref[i], rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(used_f.numpy(), np.asarray(ref_used))


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_k4_wraps_negative_delta_rows_as_reference(sparse):
    """Deltas large enough to fill their rows, so where a delta lands
    decides where instances go."""
    n, counts = 48, [40, 25, 60]
    rng = np.random.default_rng(22)
    cap, used = _world(rng, n)
    evals = [_bulk_eval(rng, n, c, False) for c in counts]
    heavy = np.stack([tp.pack_bulk_heavy(e["feasible"], e["affinity"],
                                         e["penalty"], e["coll0"])
                      for e in evals])
    dyn = np.concatenate([tp.pack_bulk_light(
        e["has_affinity"], e["desired"], e["count"], e["demand"],
        _negative_deltas(rng, n, scale=4), n, D) for e in evals])
    kw = dict(sparse_out=sparse, fill_grid=tp.fill_grid_for(max(counts)))
    ref_packed, ref_used = rp.place_bulk_batch_jit(cap, used, heavy, dyn, D,
                                                   **kw)
    t = torch.from_numpy
    packed, used_f = tp.place_bulk_batch(t(cap), t(used.copy()), t(heavy),
                                         t(dyn), D, **kw)
    got = tp.unpack_bulk_batch(packed.numpy(), n, sparse=sparse)
    ref = tp.unpack_bulk_batch(np.asarray(ref_packed), n, sparse=sparse)
    for i in (0, 2, 3, 4, 5):       # assign, placed, n_eval, n_exh, waves
        np.testing.assert_array_equal(got[i], ref[i])
    np.testing.assert_allclose(got[1], ref[1], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(used_f.numpy(), np.asarray(ref_used))
    assert (got[2] == counts).all()


def _ref_mesh():
    return rs.make_mesh(n_wave_shards=2, n_node_shards=4)


def _port_mesh():
    return ps.make_mesh(2, 4, devices=["cpu"] * 8)


def test_sharded_chains_drop_negative_rows():
    """The sharded scan and bulk chains against the sharded reference on
    negative delta rows, which both drop; the unsharded K3 wraps them,
    so its final usage differs on the rows they wrap to."""
    cap, used, fields, drows, dvals = _scan_chain(64, 3, False, seed=11)
    n = cap.shape[0]
    rng = np.random.default_rng(23)
    for e in range(drows.shape[0]):
        for d, (r, v) in enumerate(_negative_deltas(rng, n)):
            drows[e, d], dvals[e, d] = r, v
    ref_packed, ref_used = rs.place_batch_sharded(
        _ref_mesh(), cap, used, fields, drows, dvals, False)
    packed, used_sh = ps.place_batch_sharded_plain(
        _port_mesh(), cap, used, fields, drows, dvals, False)
    got = tp.unpack_outputs(packed.numpy())
    ref = tp.unpack_outputs(np.asarray(ref_packed))
    for i in (0, 3, 4, 5):
        np.testing.assert_array_equal(got[i], ref[i])
    for i in (1, 2, 6):
        np.testing.assert_allclose(got[i], ref[i], rtol=RTOL, atol=ATOL)
    sharded_used = torch.cat(used_sh).numpy()
    np.testing.assert_array_equal(sharded_used, np.asarray(ref_used))
    # the unsharded reference on the same chain takes -1 as row N - 1
    E, S = drows.shape[0], fields["demand"].shape[1]
    inps = [tp.PlaceInputs(capacity=cap, used=used,
                           **{k: fields[k][e] for k in ps.SCAN_FIELDS})
            for e in range(E)]
    heavy = np.stack([tp.pack_heavy(i) for i in inps])
    dyn = np.concatenate([tp.pack_light(
        inps[e], list(zip(drows[e].tolist(), dvals[e])), drows.shape[1], S)
        for e in range(E)])
    dims = tp.heavy_dims(inps[0]) + (S, drows.shape[1])
    _, single_used = rp.place_batch_packed_jit(
        cap, used, tuple(jnp.asarray(h) for h in heavy), dyn, dims)
    split = np.flatnonzero((np.asarray(single_used) != sharded_used)
                           .any(axis=1))
    assert n - 1 in split.tolist()

    W = 2
    cap, used, f = _lane_inputs(64, W, [[10, 30], [40, 4]], True, True,
                                seed=7)
    for w in range(W):
        for e in range(2):
            for d, (r, v) in enumerate(_negative_deltas(rng, 64, scale=4)):
                f["delta_rows"][w, e, d], f["delta_vals"][w, e, d] = r, v
    ref = rs.place_bulk_batch_sharded(
        _ref_mesh(), cap, used, *[f[k] for k in BULK_ORDER], fill_grid=64)
    got = ps.place_bulk_batch_sharded_plain(
        _port_mesh(), cap, used, *[f[k] for k in BULK_ORDER], fill_grid=64)
    for name, g, r in zip(("assign", "scores", "placed", "n_eval", "n_exh",
                           "waves"), got[:6], ref[:6]):
        g, r = np.asarray(g), np.asarray(r)
        if name == "scores":
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)
    np.testing.assert_array_equal(torch.cat(got[6]).numpy(),
                                  np.asarray(ref[6]))
