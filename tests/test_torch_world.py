"""Parity of the port's device-resident world (K5 scatters, DeviceWorld)
with the reference.

K5: the same numpy inputs, made from a seed, go through the reference's
jitted scatters (`parallel.world._single_device_fns`, JAX on the CPU) and
the port's `set_rows` / `add_rank1` on CPU tensors (their plain PyTorch
versions); results must be bitwise equal, and add_rank1 also bitwise
equal to the host rank-1 update (`native.scatter_add_rank1`, the port's
and the reference's) that keeps the world's host snapshot in lockstep.

DeviceWorld: the same sequence of updates goes through the reference's
`DeviceWorld(mesh=None)` and the port's `DeviceWorld(device="cpu")`; the
dirty-row diff, its buckets and the full-upload rule must give the same
stats and the same resident matrices.
"""
import jax
import numpy as np
import pytest
import torch

from nomad_tpu import native as ref_native
from nomad_tpu.parallel import world as rw
from nomad_tpu_torch import native
from nomad_tpu_torch.parallel import world as tw

torch.set_num_threads(1)

R = 4


def _basis(rng, n):
    b = np.zeros((n, R), np.float32)
    b[:, 0] = rng.integers(0, 40, n) * 100
    b[:, 1] = rng.integers(0, 40, n) * 256
    b[:, 2] = rng.random(n).astype(np.float32) * 1000   # non-integer too
    return b


def _padded_rows(rng, n, live, bucket):
    rows = np.full(bucket, n, np.int32)          # pad rows drop
    rows[:live] = rng.choice(n, live, replace=False)
    return rows


@pytest.mark.parametrize("bucket", tw.ROW_BUCKETS)
@pytest.mark.parametrize("n", [100, 5000])
def test_set_rows_bitwise_reference(n, bucket):
    rng = np.random.default_rng(n + bucket)
    d = _basis(rng, n)
    live = min(n, bucket) // 2 + 1
    rows = _padded_rows(rng, n, live, bucket)
    vals = rng.random((bucket, R)).astype(np.float32) * 5000
    set_fn, _ = rw._single_device_fns()
    ref = np.asarray(jax.device_get(set_fn(d, rows, vals)))
    before = dict(tw.launches)
    got = tw.set_rows(torch.from_numpy(d.copy()), torch.from_numpy(rows),
                      torch.from_numpy(vals))
    assert tw.launches == before
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n,live", [(100, 1), (100, 60), (5000, 700)])
def test_add_rank1_bitwise_reference_and_host(n, live):
    rng = np.random.default_rng(n + live)
    d = _basis(rng, n)
    rows = rng.choice(n, live, replace=False).astype(np.int32)
    counts = rng.integers(1, 40, live).astype(np.int32)
    dem = np.array([150.0, 0.1, 33.3, 7.0], np.float32)
    _, add_fn = rw._single_device_fns()
    ref = np.asarray(jax.device_get(add_fn(d, rows, counts, dem)))
    got = tw.add_rank1(torch.from_numpy(d.copy()), torch.from_numpy(rows),
                       torch.from_numpy(counts), torch.from_numpy(dem))
    np.testing.assert_array_equal(got.numpy(), ref)
    for nat in (native, ref_native):
        host = d.copy()
        nat.scatter_add_rank1(host, rows, counts, dem)
        np.testing.assert_array_equal(got.numpy(), host)
    # pad rows (index N) drop
    padded = np.concatenate([rows, np.full(3, n, np.int32)])
    got2 = tw.add_rank1(torch.from_numpy(d.copy()), torch.from_numpy(padded),
                        torch.from_numpy(np.concatenate(
                            [counts, np.ones(3, np.int32)])),
                        torch.from_numpy(dem))
    np.testing.assert_array_equal(got2.numpy(), ref)


def test_scatter_plain_path_asserts_unique_rows():
    d = torch.zeros((8, R))
    rows = torch.tensor([1, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="unique"):
        tw.set_rows(d, rows, torch.ones((2, R)))
    with pytest.raises(ValueError, match="unique"):
        tw.add_rank1(d, rows, torch.ones(2, dtype=torch.int32),
                     torch.ones(R))


def _world_pair():
    return rw.DeviceWorld(mesh=None), tw.DeviceWorld(device="cpu")


def _same(ref_w, port_w):
    assert port_w.stats == {k: ref_w.stats[k] for k in port_w.stats}
    rc, rb = ref_w.device_arrays()
    pc, pb = port_w.device_arrays()
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    if rb is None:
        assert pb is None
    else:
        np.testing.assert_array_equal(pb.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(port_w.host_basis(), ref_w.host_basis())


def test_device_world_diff_buckets_and_full_uploads_match_reference():
    rng = np.random.default_rng(11)
    n = 256
    cap = np.full((n, R), 10000.0, np.float32)
    basis = _basis(rng, n)
    ref_w, port_w = _world_pair()
    steps = []
    b = basis.copy()
    steps.append((cap, b.copy()))                     # epoch upload
    steps.append((cap, b.copy()))                     # clean hit
    b[rng.choice(n, 5, replace=False), 0] += 100      # 5 rows -> bucket 64
    steps.append((cap, b.copy()))
    b[rng.choice(n, 60, replace=False), 1] += 256     # <= N/4 -> scatter
    steps.append((cap, b.copy()))
    b[rng.choice(n, 100, replace=False), 2] += 1      # > N/4 -> full upload
    steps.append((cap, b.copy()))
    cap2 = cap.copy()
    cap2[3] = 500.0                                   # capacity churn
    steps.append((cap2, b.copy()))
    big = np.zeros((2 * n, R), np.float32)            # new epoch (grown)
    steps.append((np.full((2 * n, R), 1.0, np.float32), big))
    for c, bb in steps:
        ref_w.update(c, bb)
        port_w.update(c, bb)
        _same(ref_w, port_w)
    assert port_w.stats["full_uploads"] == 3
    assert port_w.stats["steady_reuploads"] == 1
    assert port_w.stats["clean_hits"] >= 1


def test_device_world_force_scatter_chunks_match_reference():
    rng = np.random.default_rng(12)
    n = 8192
    cap = np.full((n, R), 10000.0, np.float32)
    basis = _basis(rng, n)
    ref_w, port_w = _world_pair()
    for w in (ref_w, port_w):
        w.update(cap, basis)
    b = basis.copy()
    b[rng.choice(n, 5000, replace=False), 0] += 100   # > largest bucket
    for w in (ref_w, port_w):
        w.update(cap, b, force_scatter=True)
    _same(ref_w, port_w)
    assert port_w.stats["full_uploads"] == 1
    assert port_w.stats["rows_scattered"] == 5000


def test_device_world_upload_never_aliases_host_snapshot():
    """tests/test_engine.py's regression on the port: on the CPU a
    zero-copy upload of the host snapshot would let apply_rank1's host
    scatter mutate the 'device' basis too, and the device scatter would
    then add the delta a second time."""
    N = 16
    world = tw.DeviceWorld(device="cpu")
    world.update(np.full((N, R), 100.0, np.float32),
                 np.zeros((N, R), np.float32))
    rows = np.array([0, 3], np.int32)
    demand = np.array([5.0, 2.0, 0.0, 0.0], np.float32)
    world.apply_rank1(rows, np.ones(2, np.int32), demand)
    _, basis_dev = world.device_arrays()
    expect = np.zeros((N, R), np.float32)
    expect[rows] = demand
    np.testing.assert_array_equal(basis_dev.numpy(), expect)
    np.testing.assert_array_equal(world.host_basis(), expect)


def test_device_world_rank1_matches_reference():
    rng = np.random.default_rng(13)
    n = 128
    cap = np.full((n, R), 10000.0, np.float32)
    basis = _basis(rng, n)
    ref_w, port_w = _world_pair()
    for w in (ref_w, port_w):
        w.update(cap, basis)
    rows = np.array([1, 7, 90, n + 2], np.int32)      # last one clipped
    counts = np.array([3, 1, 10, 4], np.int32)
    dem = np.array([100.0, 256.0, 1.5, 0.0], np.float32)
    for w in (ref_w, port_w):
        w.apply_rank1(rows, counts, dem)
    _same(ref_w, port_w)
    # the next update of the now-matching basis is a clean hit
    host = port_w.host_basis()
    for w in (ref_w, port_w):
        w.update(cap, host)
    _same(ref_w, port_w)
    assert port_w.stats["clean_hits"] == 2


def test_device_world_loan_adopt_invalidate():
    n = 32
    cap = np.full((n, R), 100.0, np.float32)
    w = tw.DeviceWorld(device="cpu")
    _, basis_dev = w.update(cap, np.zeros((n, R), np.float32))
    loaned = w.loan_basis()
    assert loaned is basis_dev and w.device_arrays()[1] is None
    assert w.loan_basis() is None                     # nothing resident
    # the donated kernel adds the placements in place; the host twin
    # catches up and the pair is back in lockstep
    rows = np.array([2, 5], np.int32)
    counts = np.array([1, 2], np.int32)
    dem = np.array([10.0, 20.0, 0.0, 0.0], np.float32)
    loaned[torch.from_numpy(rows).long()] += \
        torch.from_numpy(counts)[:, None].float() * torch.from_numpy(dem)
    w.adopt_basis(loaned)
    w.apply_rank1_host(rows, counts, dem)
    np.testing.assert_array_equal(w.device_arrays()[1].numpy(),
                                  w.host_basis())
    assert (w.stats["basis_loans"], w.stats["basis_adopts"]) == (1, 1)
    # apply_rank1 while loaned updates the host only; invalidation makes
    # the next update re-upload the snapshot in full
    w.loan_basis()
    w.apply_rank1(rows, counts, dem)
    w.adopt_basis(None)
    w.invalidate_basis()
    _, b = w.update(cap, w.host_basis())
    np.testing.assert_array_equal(b.numpy(), w.host_basis())
    assert w.stats["full_uploads"] == 2 and w.stats["steady_reuploads"] == 1


def test_device_world_refuses_a_mesh():
    # a serving mesh is a parallel.sharded.Mesh (the sharded world is
    # tests/test_torch_sharded.py's); anything else is refused
    with pytest.raises(TypeError, match="Mesh"):
        tw.DeviceWorld(mesh=object(), device="cpu")


def test_warm_scatter_launches_nothing_on_cpu():
    before = dict(tw.launches)
    tw.warm_scatter((64, R), "cpu")
    assert tw.launches == before
