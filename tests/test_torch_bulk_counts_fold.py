"""The sharded bulk path's counts (K7f) inside the basis merge's launch.

K7f (the psum over node shards of each eval's n_eval/n_exh partials,
placed and waves from shard 0) has no launch of its own: node shard 0's
K7g `basis_merge` launch takes every lane's partials, i32[W, n_shard, E,
4] on the output card, and its thread j writes counts[j] of i32[W, E,
4] beside its row.  On CPU tensors the fused wrapper is `basis_merge_plain`
followed by `bulk_counts_plain`; these tests hold it to the two run one
after the other (and to the counts written out with numpy), and the
staged bulk form's counts, through the fused call, to the reference's
`place_bulk_batch_sharded` over `tests/_sharded_cases.py`'s selection
cases (NaN and -inf scores and count-0 lane pads among them) at (4, 2),
(2, 4) and (8, 1), on conftest.py's eight virtual CPU devices.

A mesh of "cpu" puts every shard on one device, as a mesh of one card
repeated puts every shard on that card: a shard whose partials are not
on the output card (their peer copy into the [W, n_shard, E, 4] buffer)
exists only on a mesh over two or more cards.  A mesh of CPU device
indices (cpu:0 to cpu:3) runs those copies on the CPU, as three layouts
of a (2, 2) mesh over cards would; the peer copies themselves run only
on such cards: the `cuda` test here runs the same layouts where the
machine has the cards, and chip_smoke.py runs them too (it logs that it
skipped on a machine of one card); without them the test skips.
"""
import numpy as np
import pytest
import torch

try:
    from nomad_tpu.parallel import sharded as rs
except ImportError:     # a machine with a card and no JAX runs the cuda
    rs = None           # tests only (-m cuda)
import _sharded_cases as sc
from nomad_tpu_torch.ops import sharded as k7
from nomad_tpu_torch.parallel import sharded as ps

torch.set_num_threads(1)

N = 128                 # 16 rows a shard at (8, 1)
SHAPES = [(4, 2), (2, 4), (8, 1)]
ORDER = ("feasible", "affinity", "has_affinity", "desired", "penalty",
         "coll0", "demand", "count", "delta_rows", "delta_vals")
LABELS = [c[0] for c in sc.bulk_select_cases(N, 4, 2)]


def _case(label, shape):
    for case in sc.bulk_select_cases(N, shape[0], shape[1]):
        if case[0] == label:
            return case
    raise KeyError(label)


def _merge_inputs(W, NS, E, seed):
    """u0 f32[n, 4] (with -0.0), exacts f32[W, n, 4], partials i32[W, NS,
    E, 4] (counts up to 2**20, zeros for count-0 pads)."""
    rng = np.random.default_rng(seed)
    n = 24
    u0 = (rng.integers(0, 64, (n, 4)) * 12.5).astype(np.float32)
    u0[::3, 2] = -0.0
    exacts = u0 + (rng.random((W, n, 4)) * 70).astype(np.float32)
    partials = rng.integers(0, 2 ** 20, (W, NS, E, 4)).astype(np.int32)
    partials[:, :, ::4] = 0
    return (torch.from_numpy(u0), torch.from_numpy(exacts),
            torch.from_numpy(partials))


def _numpy_counts(p):
    """K7f's counts from partials i32[W, NS, E, 4], written out."""
    W, NS, E, _ = p.shape
    out = np.zeros((W, E, 4), np.int32)
    for w in range(W):
        for e in range(E):
            out[w, e] = (p[w, 0, e, 0], sum(p[w, s, e, 1] for s in range(NS)),
                         sum(p[w, s, e, 2] for s in range(NS)), p[w, 0, e, 3])
    return out


@pytest.mark.parametrize("E", [1, 5, 40])
@pytest.mark.parametrize("NS", [1, 2, 4, 8])
@pytest.mark.parametrize("W", [1, 2, 4])
def test_fused_plain_path_is_the_merge_then_the_counts(W, NS, E):
    u0, exacts, partials = _merge_inputs(W, NS, E, seed=W * 100 + NS * 10 + E)
    out = torch.empty_like(u0)
    counts = torch.full((W, E, 4), -7, dtype=torch.int32)
    k7.basis_merge(u0, exacts, out, partials, counts)
    want_out = torch.empty_like(u0)
    k7.basis_merge_plain(u0, exacts, want_out)
    want = torch.full((W, E, 4), -7, dtype=torch.int32)
    for w in range(W):
        k7.bulk_counts_plain(partials[w], want[w])
    assert torch.equal(out.view(torch.int32), want_out.view(torch.int32))
    assert torch.equal(counts, want)
    np.testing.assert_array_equal(counts.numpy(),
                                  _numpy_counts(partials.numpy()))
    # donated: the merge written into u0 itself, the counts the same
    donated = u0.clone()
    counts2 = torch.zeros_like(counts)
    k7.basis_merge(donated, exacts, donated, partials, counts2)
    assert torch.equal(donated.view(torch.int32), want_out.view(torch.int32))
    assert torch.equal(counts2, want)


def test_merge_without_partials_writes_no_counts():
    u0, exacts, partials = _merge_inputs(2, 4, 3, seed=1)
    out = torch.empty_like(u0)
    k7.basis_merge(u0, exacts, out)
    want = torch.empty_like(u0)
    k7.basis_merge_plain(u0, exacts, want)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("label", LABELS)
def test_staged_counts_match_reference(monkeypatch, label, shape):
    """The staged bulk form's counts (placed, n_eval, n_exh, waves), each
    lane's from node shard 0's fused K7g call, equal the reference's; one
    K7g call a node shard, only shard 0's with the partials."""
    _, cap, used, f, spread = _case(label, shape)
    calls = []
    merge = k7.basis_merge

    def spy(u0, exacts, out, partials=None, counts=None):
        calls.append(partials is not None)
        if partials is not None:
            assert partials.shape == (shape[1], shape[0], f["count"].shape[1],
                                      k7.COUNTS_W)
        return merge(u0, exacts, out, partials, counts)
    monkeypatch.setattr(k7, "basis_merge", spy)
    mesh = ps.make_mesh(shape[1], shape[0], devices=["cpu"] * 8)
    got = ps.place_bulk_batch_sharded_staged(mesh, cap, used,
                                             *[f[k] for k in ORDER],
                                             spread_algorithm=spread)
    assert calls == [True] + [False] * (shape[0] - 1)
    ref_mesh = rs.make_mesh(n_wave_shards=shape[1], n_node_shards=shape[0])
    ref = rs.place_bulk_batch_sharded(ref_mesh, cap, used,
                                      *[f[k] for k in ORDER],
                                      spread_algorithm=spread)
    for k, name in zip(range(2, 6), ("placed", "n_eval", "n_exh", "waves")):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=f"{label} {shape}: {name}")
    assert (np.asarray(f["count"]) == 0).any()      # lane pads among them
    assert (got[3].numpy() > 0).any()


# (2, 2) meshes over several cards: [node shard][lane] card indices
LAYOUTS = {
    "a_lane_a_card": [[0, 1], [0, 1]],      # lane 1's counts gathered on
                                            # its shard 0, then one copy
    "a_node_shard_a_card": [[0, 0], [1, 1]],
    "a_shard_a_card": [[0, 1], [2, 3]],
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("label", LABELS)
def test_staged_counts_on_a_mesh_of_cpu_indices(label, layout):
    """The staged bulk form on a (2, 2) mesh of CPU devices cpu:0 to cpu:3
    laid out as LAYOUTS has the cards: to the staged form they are
    distinct devices (the tensors all lie in host memory), so shards
    away from the output device copy their partials in, and a lane
    whose shard 0 is away gathers them there and copies them over once.
    Every output equals the plain form's on the same mesh, and the
    counts the reference's."""
    mesh = ps.make_mesh(2, 2, devices=[torch.device("cpu", c)
                                       for r in LAYOUTS[layout] for c in r])
    _, cap, used, f, spread = _case(label, (2, 2))
    args = [f[k] for k in ORDER]
    got = ps.place_bulk_batch_sharded_staged(mesh, cap, used, *args,
                                             spread_algorithm=spread)
    want = ps.place_bulk_batch_sharded_plain(mesh, cap, used, *args,
                                             spread_algorithm=spread)
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    for k in range(6):
        assert torch.equal(bits(got[k]), bits(want[k])), k
    assert torch.equal(bits(torch.cat(got[6])), bits(torch.cat(want[6])))
    ref = rs.place_bulk_batch_sharded(
        rs.make_mesh(n_wave_shards=2, n_node_shards=2), cap, used, *args,
        spread_algorithm=spread)
    for k in range(2, 6):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_counts_fold_on_a_mesh_over_cards(layout):
    """Every selection case on a (2, 2) mesh whose shards sit on several
    cards: the shards' partials reach the output card by peer copies
    before the fused launch; every output equals the function's plain
    form on the same mesh."""
    cards = LAYOUTS[layout]
    need = 1 + max(max(r) for r in cards)
    if torch.cuda.device_count() < need:
        pytest.skip(f"needs {need} or more NVIDIA cards")
    mesh = ps.make_mesh(2, 2, devices=[f"cuda:{c}" for r in cards
                                       for c in r])
    bits = lambda t: t.cpu().view(torch.int32)  # noqa: E731
    for label in LABELS:
        _, cap, used, f, spread = _case(label, (2, 2))
        before = dict(k7.launches)
        got = ps.place_bulk_batch_sharded(mesh, cap, used,
                                          *[f[k] for k in ORDER],
                                          spread_algorithm=spread)
        want = ps.place_bulk_batch_sharded_plain(mesh, cap, used,
                                                 *[f[k] for k in ORDER],
                                                 spread_algorithm=spread)
        torch.cuda.synchronize()
        assert k7.launches["basis_merge"] - before["basis_merge"] == 2
        for k in range(6):
            assert torch.equal(bits(got[k]), bits(want[k])), (label, k)
        assert torch.equal(bits(torch.cat([u.cpu() for u in got[6]])),
                           bits(torch.cat([u.cpu() for u in want[6]]))), \
            label
