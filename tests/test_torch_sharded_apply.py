"""K7b's global step and K7g's basis merge, held to their plain versions
and the reference.

`_sharded_cases.scan_apply_cases` builds K7b's gathered records by hand
in K7a's layout (numpy, one seed), on 1, 2, 4 and 8 shards: equal bests
on several shards (also with the rows out of shard order); +0.0 and
-0.0 bests and top entries; shards of fewer than 5 rows; fewer than 5
fitting rows (-inf tails); every row infeasible; K = 1 and K = 64;
inactive spreads and the V1 - 1 sentinel; a pick on each shard and on
the rows either side of a shard boundary; a NaN best; NaN top entries.
Every call of every case runs on every shard twice from the same state:
by `scan_apply_model` (the kernel's warp: a lane a shard, the merge as
five rounds of a maximum of 64-bit keys) and by `scan_apply_plain`; the
carries, the pick word and the packed row must be equal bit for bit.
The records K7a writes go the same way: `_sharded_cases.scan_cache_cases`
through the port's `place_batch_sharded_staged` on CPU meshes of 1, 2, 4
and 8 node shards, every K7b call checked.

The global best follows the reference's pmax (XLA's all-reduce on
conftest.py's devices, pinned by `test_reference_pmax_rule`): each
shard's best kept where it beats the running maximum, so a NaN best
never wins and of +0.0 and -0.0 the first shard's stays.  The port's
plain versions took torch.max, which propagates a NaN, so a shard with
a fitting row that scores NaN stopped every pick where the reference
picked on the other shards (`test_nan_best_places_as_reference`).

K7g: `basis_merge_plain`, through the port's staged bulk form on CPU
meshes of W = 1, 2 and 4 wave lanes, against the reference's
`u0 + psum(exact - u0)` in `place_bulk_batch_sharded` on conftest.py's
eight virtual CPU devices, with non-integer sizes and -0.0 usage: the
placements equal, the merged basis bit for bit.

Cases marked `cuda` run both kernels against their plain versions on
the card, bit for bit; they skip here.
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

NODE_SHARDS = [1, 2, 4, 8]
APPLY = [(NS, c["label"]) for NS in NODE_SHARDS
         for c in sc.scan_apply_cases(NS)]
SCAN_N = 128                        # 16 rows a shard on 8 shards
SCAN_SHAPES = [(1, 8), (2, 4), (4, 2), (8, 1)]
SCAN_LABELS = [c[0] for c in sc.scan_cache_cases(SCAN_N, 8)]
BULK_N = 64
BULK_ORDER = ("feasible", "affinity", "has_affinity", "desired", "penalty",
              "coll0", "demand", "count", "delta_rows", "delta_vals")


def _apply_case(NS, label):
    for case in sc.scan_apply_cases(NS):
        if case["label"] == label:
            return case
    raise KeyError(label)


def _port_mesh(shape, dev="cpu"):
    return ps.make_mesh(shape[1], shape[0], devices=[dev] * 8)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _state(sh, recs, out):
    return [sh.used, sh.tg_count, sh.place_cap, sh.counts, sh.pick, recs] + \
        ([out] if out is not None else [])


def _same_call(fn, ref, sh, s, recs, out, what):
    """fn and ref from the same state on one shard: every state tensor
    bit for bit (ref's state kept)."""
    state = _state(sh, recs, out)
    before = [t.clone() for t in state]
    fn(sh, s, recs, out)
    got = [t.clone() for t in state]
    for t, b in zip(state, before):
        t.copy_(b)
    ref(sh, s, recs, out)
    for k, (t, g) in enumerate(zip(state, got)):
        assert torch.equal(_bits(t), _bits(g)), f"{what}: state tensor {k}"


def _run_apply_case(case, fn, ref, dev="cpu"):
    """Every call of a K7b case on every shard, fn against ref; returns
    (the packed rows, the shards' pick words a call)."""
    shards, recs, out = sc.scan_apply_shards(case, dev)
    picks = []
    for t, r in enumerate(recs):
        s = t % sc.APPLY_SLOTS
        for i, sh in enumerate(shards):
            _same_call(fn, ref, sh, s, r, out if i == 0 else None,
                       f"{case['label']}: call {t}, shard {i}")
        picks.append([int(sh.pick[0]) for sh in shards])
    return out.cpu(), picks


@pytest.mark.parametrize("NS,label", APPLY)
def test_apply_model_matches_plain_on_hand_set_records(NS, label):
    _run_apply_case(_apply_case(NS, label), k7.scan_apply_model,
                    k7.scan_apply_plain)


@pytest.mark.parametrize("NS", NODE_SHARDS)
def test_apply_cases_reach_their_paths(NS):
    """The hand-set cases hold what they are named for (read from the
    plain version's outputs)."""
    n = 8
    got = {c["label"]: _run_apply_case(c, k7.scan_apply_plain,
                                       k7.scan_apply_plain)
           for c in sc.scan_apply_cases(NS)}
    out, _ = got["equal bests, rows out of shard order"]
    np.testing.assert_array_equal(out[:, 0].numpy(), 3 + np.arange(4))
    out, picks = got["a pick on each shard and either side of a shard "
                     "boundary"]
    wins = [j * n + 5 for j in range(NS)] + [0, NS * n - 1] + (
        [n - 1, n] if NS > 1 else [])
    for t, w in enumerate(wins):
        assert picks[t][w // n] == w % n
        assert sum(p >= 0 for p in picks[t]) == 1
    bests = got["+0.0 and -0.0 bests and top entries"][0][:, 1].numpy()
    assert (bests == 0).all()
    # a NaN best never wins: another shard's row, none on one shard
    out, picks = got["a NaN best"]
    for t, call in enumerate(picks):
        assert call[t % NS] == -1
        assert (out[t, 0] == -1) == (NS == 1)
    out, picks = got["+0.0 and -0.0 bests beside lower ones"]
    if NS > 2:      # its last call: +0.0 on shard 1, -0.0 on 2: the first
        last = (len(picks) - 1) % sc.APPLY_SLOTS
        assert out[last, 1] == 0 and not torch.signbit(out[last, 1])
    out, _ = got["every row infeasible"]
    assert (out[:, 0] == -1).all()
    assert torch.isneginf(out[:, 10:]).all()
    tops = got["NaN top entries"][0][:, 10:]
    nan = torch.isnan(tops)
    assert nan.any()
    # NaN ranks below every score, -inf included
    for row, isn in zip(tops, nan):
        assert not (isn[:-1] & ~isn[1:]).any()
    signs = set()
    for label in ("+0.0 and -0.0 bests and top entries",
                  "+0.0 and -0.0 bests beside lower ones"):
        if label in got:
            zs = got[label][0][:, 10:]
            signs |= set(torch.signbit(zs[zs == 0]).tolist())
    assert signs == {False, True}


def test_reference_pmax_rule():
    """The reference's pmax over the node axis (a shard_map on
    conftest.py's virtual CPU devices), which `k7.shard_max` (in
    `scan_apply_plain` and the plain forms' `_pmax`) follows: the maximum
    of the values that are not NaN (all NaN: -inf), and of equal ones the
    first shard's (so of +0.0 and -0.0 the first one's sign)."""
    import jax
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    rng = np.random.default_rng(0)
    for n in (2, 4, 8):
        mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
        f = jax.jit(shard_map(lambda v: jax.lax.pmax(v, "x"), mesh=mesh,
                              in_specs=P("x"), out_specs=P("x"),
                              check_vma=False))
        for _ in range(50):
            v = rng.choice(np.float32([0.0, -0.0, -1.0, np.nan, -np.inf]),
                           n)
            got = np.asarray(f(v))[0]
            want = k7.shard_max([torch.tensor(x) for x in v])
            assert got.view(np.int32) == want.numpy().view(np.int32), v


class ApplyCheck:
    """Stands in for ops/sharded.py's `scan_apply`: each call runs the
    model and the plain version from the same state (_same_call)."""

    def __init__(self):
        self.calls = 0

    def __call__(self, sh, s, recs, out):
        _same_call(k7.scan_apply_model, k7.scan_apply_plain, sh, s, recs,
                   out, f"slot {s} shard {sh.off}")
        self.calls += 1


@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("label", SCAN_LABELS)
def test_apply_model_matches_plain_on_scan_records(monkeypatch, label,
                                                   shape):
    """K7a's records (its plain version) on the scan cache cases."""
    # (the cases' shard boundary rows: of 2 shards where there is one)
    case = next(c for c in sc.scan_cache_cases(SCAN_N, max(shape[0], 2))
                if c[0] == label)
    _, cap, used, f, drows, dvals, spread = case
    chk = ApplyCheck()
    monkeypatch.setattr(k7, "scan_apply", chk)
    ps.place_batch_sharded_staged(_port_mesh(shape), cap, used, f, drows,
                                  dvals, spread)
    assert chk.calls == sc.SCAN_EVALS * sc.SCAN_SLOTS * shape[0]


def test_nan_best_places_as_reference(monkeypatch):
    """A row whose score is NaN and that fits (+inf capacity and usage:
    1 - inf / inf) is its shard's best in K7a's record.  The reference's
    pmax passes over it and places on the other shards; so do the port's
    plain form and its staged scan, with K7b's model checked against its
    plain version on every call (both took torch.max before, which stops
    every pick at a NaN).  Without that row all three place the same."""
    N, NS = 64, 4
    rng = np.random.default_rng(3)
    cap, used = sc._scan_world(rng, N)
    ev = [sc._scan_eval(rng, N) for _ in range(sc.SCAN_EVALS)]
    for e in ev:
        e["feasible"][:] = True
        e["place_cap"][:] = -1
    f, drows, dvals = sc._scan_chain(N, ev)
    mesh = rs.make_mesh(n_wave_shards=2, n_node_shards=NS)
    monkeypatch.setattr(k7, "scan_apply", ApplyCheck())
    nan_row = 2 * N // NS + 3
    for with_nan in (True, False):
        c, u = cap.copy(), used.copy()
        if with_nan:
            c[nan_row, 0] = u[nan_row, 0] = np.inf
        packed, _ = rs.place_batch_sharded(mesh, c, u, f, drows, dvals)
        ref = np.asarray(packed)[..., 0]
        assert (ref >= 0).all() and not (ref == nan_row).any()
        for form in ("plain", "staged"):
            fn = getattr(ps, f"place_batch_sharded_{form}")
            got, _ = fn(_port_mesh((NS, 2)), c, u, f, drows, dvals)
            np.testing.assert_array_equal(got.numpy()[..., 0], ref,
                                          err_msg=f"{form}, NaN {with_nan}")


# ------------------------------------------------------------------ K7g

def _bulk_case(shape):
    """C2M-like lanes on `shape` with non-integer sizes and -0.0 usage."""
    NS, W = shape
    rng = np.random.default_rng(13 + W)
    N = BULK_N
    cap = np.tile(np.float32([4000.0, 8192.0, 100000.0, 1000.0]), (N, 1))
    used = (rng.random((N, 4)) * np.float32([900, 2000, 0, 0])).astype(
        np.float32)
    used[rng.random((N, 4)) < 0.3] = -0.0
    lanes = []
    for w in range(W):
        evals = []
        for e in range(sc.SELECT_EVALS):
            ev = dict(count=int(rng.integers(0, 12)),
                      feasible=rng.random(N) < 0.9)
            evals.append(ev)
        lanes.append(evals)
    f = sc._select_lanes(N, lanes)
    f["demand"][:] = np.float32([33.3, 70.7, 0.1, 0.0])
    f["demand"][..., 2] = np.where(rng.random(f["demand"].shape[:2]) < 0.5,
                                   np.float32(-0.0), np.float32(0.1))
    return cap, used, f


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_basis_merge_plain_matches_reference(monkeypatch, shape):
    cap, used, f = _bulk_case(shape)
    merges = []
    monkeypatch.setattr(k7, "basis_merge", lambda *a: (
        merges.append(1), k7.basis_merge_plain(*a)))
    got = ps.place_bulk_batch_sharded_staged(
        _port_mesh(shape), cap, used, *[f[k] for k in BULK_ORDER])
    assert len(merges) == shape[0]
    mesh = rs.make_mesh(n_wave_shards=shape[1], n_node_shards=shape[0])
    ref = rs.place_bulk_batch_sharded(mesh, cap, used,
                                      *[f[k] for k in BULK_ORDER])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert int(np.asarray(ref[2]).sum()) > 0
    assert np.signbit(used[used == 0]).any()
    u_got = torch.cat(got[6]).numpy()
    u_ref = np.asarray(ref[6])
    np.testing.assert_array_equal(u_got.view(np.int32), u_ref.view(np.int32))
    assert (u_got != np.round(u_got)).any()


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("NS,label", APPLY)
def test_apply_kernel_matches_plain_on_card(cuda_dev, NS, label):
    before = k7.launches["scan_apply"]
    _run_apply_case(_apply_case(NS, label), k7.scan_apply,
                    k7.scan_apply_plain, cuda_dev)
    assert k7.launches["scan_apply"] > before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 32768])
@pytest.mark.parametrize("W", [1, 2, 3, 4, 8, 9])
def test_basis_merge_kernel_matches_plain_on_card(cuda_dev, n, W):
    """K7g against basis_merge_plain on the card: non-integer deltas, -0.0
    usage, out a fresh tensor and out u0 itself (the donated basis)."""
    rng = np.random.default_rng(n + W)
    u0 = (rng.random((n, 4)) * 1000).astype(np.float32)
    u0[rng.random((n, 4)) < 0.2] = -0.0
    ex = u0[None] + (rng.random((W, n, 4)) < 0.3) * rng.random(
        (W, n, 4)).astype(np.float32) * 70.7
    ex = ex.astype(np.float32)
    exacts = torch.from_numpy(ex).to(cuda_dev)
    want = torch.empty((n, 4), device=cuda_dev)
    k7.basis_merge_plain(torch.from_numpy(u0).to(cuda_dev), exacts, want)
    before = k7.launches["basis_merge"]
    for donate in (False, True):
        u = torch.from_numpy(u0).to(cuda_dev)
        out = u if donate else torch.empty_like(u)
        k7.basis_merge(u, exacts, out)
        assert torch.equal(_bits(out), _bits(want)), f"donate {donate}"
    assert k7.launches["basis_merge"] == before + 2


@pytest.mark.cuda
def test_basis_merge_refuses_unaligned_operands(cuda_dev):
    buf = torch.zeros(4 * 64 + 1, device=cuda_dev)
    u0 = buf[1:].view(64, 4)
    exacts = torch.zeros((2, 64, 4), device=cuda_dev)
    with pytest.raises(ValueError, match="16-byte"):
        k7.basis_merge(u0, exacts, torch.empty((64, 4), device=cuda_dev))
