"""The sharded bulk wave's order (K7e) and statistics (K7c) on the cases
that steer K7e's selection, held against the reference.

`_sharded_cases.bulk_select_cases` builds the inputs with numpy (one seed):
a tie wave with more tied rows than `remaining`, strict waves at one
score and split by the threshold across a shard boundary, a `remaining`
of at least the wave, scores of exactly 0.0, lane pads of count 0 with
deltas, delta rows that repeat a row, a usage row at +inf under deltas,
and fitting rows that score NaN (at m = 1, at m = 2 only, and on one
shard between finite scores on the others): the wave's statistics
follow the reference's rules there (s* the pmax of each shard's max,
which a NaN makes NaN and the pmax passes over; the strict set used
where some row beats s*; the top-2 in lax.top_k's order).  Each goes through the reference's `place_bulk_batch_sharded`
on conftest.py's eight virtual CPU devices and through the port's two
CPU forms on a mesh of eight "cpu" entries of the same shape, (4, 2) and
(2, 4): `place_bulk_batch_sharded_plain` (the reference's function as
loops over the shards) and `place_bulk_batch_sharded_staged` (the
shard-local kernels' plain versions, in the kernels' sequence).
Integers must be equal; floats as in tests/test_torch_sharded.py: NaN
and infinities where the reference has them, finite values within rtol
1e-5 of it (its XLA CPU build evaluates pow with its own routine, which
differs in the last bit on some of these scores), and the two port forms
bit for bit with each other.  `bulk_order_plain`'s order is held to the
reference's `jnp.argsort` where +0.0 and -0.0 scores tie.

Cases marked `cuda` run the same inputs through the kernels on a mesh of
one card repeated (also under the random delays of K7c's cluster
exchange), against the function's plain form on the card, bit for bit;
they skip here.
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from nomad_tpu.parallel import sharded as rs
except ImportError:     # a machine with a card and no JAX runs the cuda
    jnp = rs = None     # tests only (-m cuda)
import _sharded_cases as sc
from nomad_tpu_torch.ops import sharded as k7
from nomad_tpu_torch.parallel import sharded as ps

torch.set_num_threads(1)

N = 64
RTOL = 1e-5
SHAPES = [(4, 2), (2, 4)]
FORMS = ["plain", "staged"]
ORDER = ("feasible", "affinity", "has_affinity", "desired", "penalty",
         "coll0", "demand", "count", "delta_rows", "delta_vals")
NAMES = ("assign", "scores", "placed", "n_eval", "n_exh", "waves")
LABELS = [c[0] for c in sc.bulk_select_cases(N, 4, 2)]
_REF = {}


def _case(label, shape):
    for case in sc.bulk_select_cases(N, shape[0], shape[1]):
        if case[0] == label:
            return case
    raise KeyError(label)


def _port_mesh(shape, dev="cpu"):
    return ps.make_mesh(shape[1], shape[0], devices=[dev] * 8)


def _run(fn, mesh, case):
    _, cap, used, f, spread = case
    out = fn(mesh, cap, used, *[f[k] for k in ORDER],
             spread_algorithm=spread)
    return [x.cpu().numpy() for x in out[:6]] + \
        [torch.cat([u.cpu() for u in out[6]]).numpy()]


def _reference(label, shape):
    key = (label, shape)
    if key not in _REF:
        _, cap, used, f, spread = _case(label, shape)
        mesh = rs.make_mesh(n_wave_shards=shape[1], n_node_shards=shape[0])
        out = rs.place_bulk_batch_sharded(mesh, cap, used,
                                          *[f[k] for k in ORDER],
                                          spread_algorithm=spread)
        _REF[key] = [np.asarray(x) for x in out[:7]]
    return _REF[key]


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _close(got, ref, what):
    """Integers equal; floats NaN, +-inf and finite where the reference's
    are, finite values within RTOL."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    if ref.dtype.kind in "iub":
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    for kind in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(kind(got), kind(ref), err_msg=what)
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL, err_msg=what)


def _equal(got, want, what):
    """Integers equal; floats bit for bit, NaN against NaN."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if want.dtype.kind == "f":
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
        got, want = np.where(nan, 0, got), np.where(nan, 0, want)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("label", LABELS)
def test_selection_cases_match_reference(label, shape, form):
    case = _case(label, shape)
    got = _run(getattr(ps, f"place_bulk_batch_sharded_{form}"),
               _port_mesh(shape), case)
    ref = _reference(label, shape)
    for name, g, r in zip(NAMES + ("used_tot",), got, ref):
        _close(g, r, f"{label} {shape} {form}: {name}")
    if form == "staged":
        plain = _run(ps.place_bulk_batch_sharded_plain, _port_mesh(shape),
                     case)
        for name, g, w in zip(NAMES + ("used_tot",), got, plain):
            _equal(g, w, f"{label} {shape} staged vs plain: {name}")
    f = case[3]
    # every count placed, except where a usage row at +inf or a delta of
    # 1e7 leaves too few rows: then the reference's count too
    assert (got[2] <= f["count"]).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_selection_case_waves_take_their_paths(shape):
    """The cases reach what they are named for: the threshold case's first
    wave takes B rows on both sides of the shard boundary, and the pads
    place nothing."""
    label = LABELS[2]
    _, cap, used, f, _ = case = _case(label, shape)
    got = _run(ps.place_bulk_batch_sharded_staged, _port_mesh(shape), case)
    n = N // shape[0]
    assign = got[0][0, 0]
    b_rows = [n - 2, n - 1, n, n + 1, n + 2]
    taken_b = [r for r in b_rows if assign[r] > 0]
    assert taken_b == b_rows[:int(f["count"][0, 0]) - 3]
    assert min(taken_b) < n <= max(taken_b)
    pads = _case(LABELS[5], shape)
    got = _run(ps.place_bulk_batch_sharded_staged, _port_mesh(shape), pads)
    pad = pads[3]["count"] == 0
    assert (got[2][pad] == 0).all() and (got[0][pad] == 0).all()


@pytest.mark.parametrize("form", FORMS)
def test_nan_row_in_a_tie_wave_ranks_as_lax_top_k(form):
    """A binpack wave of tied empty rows beside a fitting row that scores
    NaN (+inf capacity and usage): no m = 1 score beats s*, so the wave is
    the tie set at the global top score.  The reference's lax.top_k
    ranks the CPU's -NaN below every score, so the top score is the tied
    rows' and the wave places; a top-2 that put any NaN first (as
    torch.sort does) would leave the tie set empty and the eval spinning
    to max_waves.  The port's forms take lax.top_k's total order
    (ops/place.py _lax_top_k) and place as the reference does."""
    shape = (4, 2)
    _, cap, used, _, _ = _case(LABELS[0], shape)
    cap, used = cap.copy(), used.copy()
    cap[N // 2 + 3, 0] = used[N // 2 + 3, 0] = np.inf
    # one co-placement and a large desired count: the anti-affinity term
    # counts from m = 1 and is small, so every row's m = 2 score is above
    # its m = 1 score (binpack) and no row beats s*
    ev = lambda c: dict(count=c, coll0=np.ones(N, np.int32),  # noqa: E731
                        desired=1000)
    f = sc._select_lanes(N, [[ev(5 + w), ev(3), ev(0)]
                             for w in range(shape[1])])
    kw = dict(spread_algorithm=False, max_waves=4)
    mesh = rs.make_mesh(n_wave_shards=shape[1], n_node_shards=shape[0])
    ref = [np.asarray(x) for x in rs.place_bulk_batch_sharded(
        mesh, cap, used, *[f[k] for k in ORDER], **kw)[:6]]
    got = getattr(ps, f"place_bulk_batch_sharded_{form}")(
        _port_mesh(shape), cap, used, *[f[k] for k in ORDER], **kw)
    for name, g, r in zip(NAMES, got[:6], ref):
        _close(g.cpu().numpy(), r, f"{form}: {name}")
    assert (ref[2] == f["count"]).all() and (ref[5] < 4).all()


def test_order_ties_signed_zeros_as_the_reference():
    """bulk_order_plain's order on a wave whose scores include +0.0 and
    -0.0 (which tie) equals the reference's `jnp.argsort(where(wave,
    -cur, inf))` with its cumulative cap."""
    rng = np.random.default_rng(5)
    n_rows = 48
    cur = rng.choice(np.array([0.5, 0.0, -0.0, -0.25, 0.0, -0.0],
                              np.float32), n_rows)
    base = rng.integers(0, 3, n_rows).astype(np.int32)
    remaining = 17
    order = np.asarray(jnp.argsort(jnp.where(base > 0, -cur, jnp.inf)))
    b = base[order].astype(np.int64)
    alloc = np.minimum(np.clip(remaining - (np.cumsum(b) - b), 0, None), b)
    want = np.zeros(n_rows, np.int64)
    want[order] = alloc
    assert want.sum() == remaining
    n = n_rows // 4
    got = np.zeros(n_rows, np.int64)
    for i in range(4):
        sh = _order_shard(n, n_rows, i * n, remaining)
        k7.bulk_order_plain(sh, 0, torch.tensor([[0.5, 0.5, 0.0, 1.0, 0.5]]),
                            torch.from_numpy(cur), torch.from_numpy(base),
                            False, 1000)
        got[i * n:(i + 1) * n] = sh.assign[0].numpy()
    np.testing.assert_array_equal(got, want)


def _order_shard(n, n_rows, off, count, dev="cpu"):
    z = lambda *s, t=torch.float32: torch.zeros(s, dtype=t, device=dev)  # noqa
    return k7.BulkShard(
        off=off, n_rows=n_rows, capacity=z(n, 4) + 1e6, used=z(n, 4),
        exact=z(n, 4), delta=z(n, 4), coll=z(n, t=torch.int32),
        feasible=torch.ones((1, n), dtype=torch.bool, device=dev),
        affinity=z(1, n), penalty=z(1, n, t=torch.bool),
        coll0=z(1, n, t=torch.int32),
        has_affinity=z(1, t=torch.bool),
        desired=torch.ones(1, dtype=torch.int32, device=dev),
        demand=torch.tensor([[1.0, 1.0, 0.0, 0.0]], device=dev),
        count=torch.tensor([count], dtype=torch.int32, device=dev),
        delta_rows=None, delta_vals=None, assign=z(1, n, t=torch.int32),
        scores=z(1, n), partial=z(1, 4, t=torch.int32),
        state=z(4, t=torch.int32),
        fits=torch.ones(n, dtype=torch.bool, device=dev)).check()


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_mesh_of():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return lambda shape: _port_mesh(shape, "cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("label", LABELS)
def test_selection_cases_kernels_match_plain_on_repeated_card(cuda_mesh_of,
                                                              label, shape):
    """K7c-K7g on the card against the function's plain form on the card
    (powf and torch.pow on the CPU may differ in the last bit), bit for
    bit, and again under three seeds of the delays of K7c's cluster
    exchange."""
    from nomad_tpu_torch.ops import _build
    case = _case(label, shape)
    want = _run(ps.place_bulk_batch_sharded_plain, cuda_mesh_of(shape), case)
    lib = _build.load("sharded")
    stream = torch.cuda.current_stream().cuda_stream
    before = dict(k7.launches)
    try:
        for seed in (0, 1, 2, 3):
            assert lib.sharded_set_jitter(seed, stream) == 0
            got = _run(ps.place_bulk_batch_sharded, cuda_mesh_of(shape), case)
            for name, g, w in zip(NAMES + ("used_tot",), got, want):
                _equal(g, w, f"{label} {shape} delays {seed}: {name}")
    finally:
        lib.sharded_set_jitter(0, stream)
    for name in ("bulk_stats", "bulk_order"):
        assert k7.launches[name] > before[name], name


@pytest.mark.cuda
def test_order_kernel_ties_signed_zeros(cuda_mesh_of):
    """K7e against bulk_order_plain on one launch a shard whose gathered
    scores tie +0.0 and -0.0, bit for bit on every state tensor."""
    rng = np.random.default_rng(5)
    n_rows, n = 4096, 1024
    cur = rng.choice(np.array([0.5, 0.0, -0.0, -0.25, 0.0, -0.0],
                              np.float32), n_rows)
    base = rng.integers(0, 3, n_rows).astype(np.int32)
    stats = torch.tensor([[0.5, 0.5, 0.0, 1.0, 0.5]])
    for remaining in (1, 17, 700, 5000):
        for i in range(4):
            outs = []
            for fn in (k7.bulk_order, k7.bulk_order_plain):
                dev = "cuda:0"
                sh = _order_shard(n, n_rows, i * n, remaining, dev)
                fn(sh, 0, stats.to(dev), torch.from_numpy(cur).to(dev),
                   torch.from_numpy(base).to(dev), False, 1000)
                outs.append([t.cpu() for t in (sh.used, sh.coll, sh.assign,
                                               sh.state, sh.scores,
                                               sh.partial, sh.exact)])
            # the tail takes the wave-start scores and fits K7c wrote for
            # this shard's rows; these are made up (every row fits at its
            # gathered score), so the tail's scores are not compared here
            # (the selection cases compare them)
            del outs[0][4], outs[1][4]
            for k, (g, w) in enumerate(zip(*outs)):
                _equal(g.numpy(), w.numpy(), f"remaining {remaining} shard "
                                             f"{i} tensor {k}")


@pytest.mark.cuda
def test_selection_kernels_on_every_card():
    """K7c-K7g launched on each card of the machine in turn (a mesh of
    that card repeated), bit for bit against the function's plain form
    there.  A kernel attribute set through the runtime holds for one
    device only, so K7c's 16-block cluster must be allowed on each card,
    not only on the first that launches it."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA cards")
    shape = SHAPES[0]
    case = _case(LABELS[0], shape)
    for i in range(torch.cuda.device_count()):
        with torch.cuda.device(i):
            mesh = _port_mesh(shape, f"cuda:{i}")
            want = _run(ps.place_bulk_batch_sharded_plain, mesh, case)
            got = _run(ps.place_bulk_batch_sharded, mesh, case)
        for name, g, w in zip(NAMES + ("used_tot",), got, want):
            _equal(g, w, f"cuda:{i}: {name}")
