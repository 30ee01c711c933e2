"""K7a's cached scan step and K7d's run rule, held to the plain versions.

`_sharded_cases.scan_cache_cases` builds chained scan evals with numpy
(one seed): the group changing between slots; the demand changing within
a group (also only in the sign of a zero); inactive slots between active
ones and at an eval's first slot; a pick on each shard and on the rows
either side of a shard boundary; every row infeasible; rows that tie
across shards; -0.0 usage; NaN and +-inf usage under deltas; a spread
over more than 64 values; spreads whose boost tables pass the shared
memory K7a keeps them in.  On CPU meshes of eight "cpu" entries, (4, 2)
and (2, 4), each runs through the shard-local sequence
(`place_batch_sharded_staged`, `place_eval_batch_sharded_staged`) with
every K7a call made twice from the same state: by
`scan_local_cached_model` (the kernel's cache, pick word, boost tables
and key order) and by `scan_local_plain`; records and carries must be
equal bit for bit, slot by slot, and the function's output bit-equal to
its plain form.  The plain forms are held to the reference's
`place_batch_sharded` / `place_eval_batch_sharded` on conftest.py's eight
virtual CPU devices as tests/test_torch_sharded.py holds them: integers
equal; floats NaN and +-inf where the reference's are, finite values
within rtol 1e-5 (the reference's XLA CPU build evaluates pow with its
own routine, which differs in the last bit on some scores).

`_sharded_cases.bulk_run_cases` builds K7d's wave cases (a run cap of 1,
fill grids of 16 and 64, m = 1 forced, rows that fit one instance and
not two, no row fitting, the tie and the strict set, a done lane, NaN
and +-inf usage); `bulk_run_model` (every cell of a row at once, the
first failure) must equal `bulk_run_plain` bit for bit on 2 and 4
shards.

Cases marked `cuda` run the kernels on a mesh of one card repeated
against the plain versions there, bit for bit (K7a also under the
random delays of its cluster exchange); they skip here.
"""
import numpy as np
import pytest
import torch

try:
    from nomad_tpu.ops import place as rp
    from nomad_tpu.parallel import sharded as rs
except ImportError:     # a machine with a card and no JAX runs the cuda
    rp = rs = None      # tests only (-m cuda)
import _sharded_cases as sc
from nomad_tpu_torch.ops import place as tp
from nomad_tpu_torch.ops import sharded as k7
from nomad_tpu_torch.parallel import sharded as ps

torch.set_num_threads(1)

N = 64
RTOL = 1e-5
SHAPES = [(4, 2), (2, 4)]
LABELS = [c[0] for c in sc.scan_cache_cases(N, 4)]
RUN_LABELS = [c[0] for c in sc.bulk_run_cases(N)]
FUNCTIONS = ["batch", "eval_batch"]


def _case(label, node_shards):
    for case in sc.scan_cache_cases(N, node_shards):
        if case[0] == label:
            return case
    raise KeyError(label)


def _run_case(label):
    for case in sc.bulk_run_cases(N):
        if case[0] == label:
            return case
    raise KeyError(label)


def _port_mesh(shape, dev="cpu"):
    return ps.make_mesh(shape[1], shape[0], devices=[dev] * 8)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _eval_inputs(case, W, module):
    """The case's evals as a batch of W independent evals (eval b % E),
    each on the case's world, stacked by `module` (the reference's
    parallel/sharded.py or the port's)."""
    _, cap, used, f, _, _, _ = case
    E = f["demand"].shape[0]
    inputs = rp.PlaceInputs if module is rs else tp.PlaceInputs
    return module.stack_inputs([inputs(
        capacity=cap, used=used, **{k: v[b % E] for k, v in f.items()})
        for b in range(W)])


def _call(function, mesh, case, form):
    """(packed or unpacked outputs as numpy arrays) of the case through
    the port's `function` in `form` ("plain" or "staged")."""
    _, cap, used, f, drows, dvals, spread = case
    if function == "batch":
        fn = getattr(ps, f"place_batch_sharded_{form}")
        packed, used_sh = fn(mesh, cap, used, f, drows, dvals, spread)
        return list(tp.unpack_outputs(packed.numpy())) + \
            [torch.cat(used_sh).numpy()]
    fn = getattr(ps, f"place_eval_batch_sharded_{form}")
    out = fn(mesh, _eval_inputs(case, mesh.shape[ps.WAVE_AXIS_NAME], ps),
             spread)
    return [x.numpy() for x in out]


def _reference(function, shape, case):
    _, cap, used, f, drows, dvals, spread = case
    mesh = rs.make_mesh(n_wave_shards=shape[1], n_node_shards=shape[0])
    if function == "batch":
        packed, used_sh = rs.place_batch_sharded(mesh, cap, used, f, drows,
                                                 dvals, spread)
        return list(tp.unpack_outputs(np.asarray(packed))) + \
            [np.asarray(used_sh)]
    out = rs.place_eval_batch_sharded(mesh, _eval_inputs(case, shape[1], rs),
                                      spread)
    return [np.asarray(x) for x in out]


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


def _equal(got, want, what, signed_zeros=True):
    """Bit for bit (NaN against NaN of any payload); without
    `signed_zeros`, -0.0 against +0.0 too."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if want.dtype.kind == "f":
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
        got, want = np.where(nan, 0, got), np.where(nan, 0, want)
        if not signed_zeros:
            got, want = got + np.float32(0), want + np.float32(0)
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=what)


class ModelCheck:
    """Stands in for ops/sharded.py's `scan_local`: each call runs the
    cached model, then, from the state before it, the plain version, and
    requires the record and every carry bit-equal (the cache goes on from
    the model's).  Counts the paths the model took: "all" (every row
    rescored), "pick" (the pick word's row), "inactive pick" (a pending
    pick rescored on an inactive slot); and the picks K7b named on each
    shard (`picks`, local rows)."""

    def __init__(self):
        self.paths = {"all": 0, "pick": 0, "inactive pick": 0}
        self.picks = {}

    def __call__(self, sh, s, init, used_in, drows, dvals, recs, shard,
                 spread):
        n = sh.capacity.shape[0]
        if not init:
            pick = int(sh.pick[0])
            if pick >= 0:
                self.picks.setdefault(shard, set()).add(pick)
            key = sh.cache[3 * n:3 * n + 5]
            same = int(key[0]) == int(sh.slot_tg[s]) and torch.equal(
                key[1:5], sh.demand[s].view(torch.int32))
            if not bool(sh.slot_active[s]):
                if int(key[0]) >= 0 and pick >= 0:
                    self.paths["inactive pick"] += 1
            elif not same:
                self.paths["all"] += 1
            elif pick >= 0:
                self.paths["pick"] += 1
        elif bool(sh.slot_active[s]):
            self.paths["all"] += 1
        state = [sh.used, sh.tg_count, sh.place_cap, sh.counts, recs]
        before = [t.clone() for t in state]
        k7.scan_local_cached_model(sh, s, init, used_in, drows, dvals, recs,
                                   shard, spread)
        got = [t.clone() for t in state]
        for t, b in zip(state, before):
            t.copy_(b)
        k7.scan_local_plain(sh, s, init, used_in, drows, dvals, recs, shard,
                            spread)
        for k, (t, g) in enumerate(zip(state, got)):
            assert torch.equal(_bits(t), _bits(g)), \
                f"slot {s} shard {shard}: state tensor {k} differs"


def _through_model(monkeypatch, function, shape, case):
    chk = ModelCheck()
    monkeypatch.setattr(k7, "scan_local", chk)
    got = _call(function, _port_mesh(shape), case, "staged")
    monkeypatch.undo()
    return got, chk


@pytest.mark.parametrize("function", FUNCTIONS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("label", LABELS)
def test_cached_model_matches_plain_slot_by_slot(monkeypatch, label, shape,
                                                 function):
    case = _case(label, shape[0])
    got, chk = _through_model(monkeypatch, function, shape, case)
    want = _call(function, _port_mesh(shape), case, "plain")
    # the plain form adds the carry update to every row (0 to all but the
    # pick, as the reference does), which turns -0.0 usage into +0.0; K7b
    # adds it to the picked row only
    for k, (g, w) in enumerate(zip(got, want)):
        _equal(g, w, f"{label} {shape} {function}: output {k}",
               signed_zeros=False)
    assert chk.paths["all"] > 0


@pytest.mark.parametrize("function", FUNCTIONS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("label", LABELS)
def test_scan_cases_plain_match_reference(label, shape, function):
    case = _case(label, shape[0])
    got = _call(function, _port_mesh(shape), case, "plain")
    ref = _reference(function, shape, case)
    for k, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, f"{label} {shape} {function}: output {k}")


@pytest.mark.parametrize("shape", SHAPES)
def test_scan_cases_reach_their_paths(monkeypatch, shape):
    """The cases take the paths they are named for: the pick alone is
    rescored between slots of one key; a key change rescores every row;
    an inactive slot rescores a pending pick; a pick lands on every
    shard and on the rows either side of the boundary of shards 0 and 1;
    no pick where no row is feasible; ties resolve to the lowest row."""
    NS = shape[0]
    n = N // NS

    def run(i):
        return _through_model(monkeypatch, "batch", shape,
                              _case(LABELS[i], NS))

    _, chk = run(0)
    assert chk.paths["pick"] > 0 and chk.paths["all"] > 2 * sc.SCAN_EVALS
    _, chk = run(1)
    assert chk.paths["all"] > sc.SCAN_EVALS
    _, chk = run(2)
    assert chk.paths["inactive pick"] > 0
    got, chk = run(3)
    assert set(chk.picks) == set(range(NS))
    assert n - 1 in chk.picks[0] and 0 in chk.picks[1]
    nodes = got[0][0]
    wins = sorted({n - 1, n} | {i * n + 5 for i in range(NS)})
    np.testing.assert_array_equal(nodes[:len(wins)], wins)
    got, _ = run(4)
    _, _, _, f, _, _, _ = _case(LABELS[4], NS)
    assert (got[0][f["slot_tg"] == 1] == -1).all()
    got, _ = run(5)
    assert got[0][0, 0] == 0
    np.testing.assert_array_equal(got[5][0, 0], np.arange(5))


# ------------------------------------------------------------------ K7d

def _run_rule(case, NS, fn, dev="cpu"):
    """base_g after `fn` (bulk_run_plain, bulk_run_model or bulk_run) on
    every shard of the case's wave (pre-filled with -7, which a done
    lane leaves)."""
    _, _, _, _, fill_grid, spread, _, _ = case
    shards, stats, cur_g = sc.bulk_run_shards(case, NS, dev)
    base_g = torch.full((N,), -7, dtype=torch.int32, device=dev)
    for sh in shards:
        fn(sh, 0, stats, cur_g, base_g, spread, fill_grid)
    return base_g.cpu().numpy()


@pytest.mark.parametrize("NS", [2, 4])
@pytest.mark.parametrize("label", RUN_LABELS)
def test_run_rule_model_matches_plain(label, NS):
    case = _run_case(label)
    got = _run_rule(case, NS, k7.bulk_run_model)
    want = _run_rule(case, NS, k7.bulk_run_plain)
    np.testing.assert_array_equal(got, want, err_msg=f"{label}, {NS} shards")


def test_run_cases_reach_their_paths():
    """The run cases hold what they are named for: runs of 1 under a cap
    of 1; runs past 32 under a grid of 64; forced m = 1 runs of 1 in a
    strict set; runs of 1 on the rows that fit one instance; nothing
    without a fitting row; every row in the tie set, with runs past the
    first pass's 4 cells, and the strict set's wave a strict one; the
    done lane untouched; NaN and +-inf rows out of the wave."""
    runs = {label: _run_rule(_run_case(label), 4, k7.bulk_run_plain)
            for label in RUN_LABELS}
    strict = {}
    for label in ("the tie set", "the strict set", "fill grid 64"):
        _, stats, _ = sc.bulk_run_shards(_run_case(label), 4)
        strict[label] = k7._wave_globals(stats)[2]
    assert strict == {"the tie set": False, "the strict set": True,
                      "fill grid 64": False}
    assert runs["run cap 1"].max() == 1
    assert runs["fill grid 64"].max() > 32
    forced = runs["m = 1 forced where the score does not beat second"]
    assert (forced == 1).all()
    assert runs["rows that fit one instance and not two"].max() >= 1
    assert (runs["no row fitting"] == 0).all()
    assert (runs["the tie set"] > 4).all()
    assert (runs["a done lane"] == -7).all()
    odd = runs["NaN and +-inf usage"]
    assert odd[9] == 0 and odd[1] == 0


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_mesh_of():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return lambda shape: _port_mesh(shape, "cuda:0")


def _card_outputs(function, mesh, case, fn):
    _, cap, used, f, drows, dvals, spread = case
    if function == "batch":
        packed, used_sh = fn(mesh, cap, used, f, drows, dvals, spread)
        return [packed.cpu().numpy(), torch.cat(used_sh).cpu().numpy()]
    stacked = _eval_inputs(case, mesh.shape[ps.WAVE_AXIS_NAME], ps)
    return [x.cpu().numpy() for x in fn(mesh, stacked, spread)]


@pytest.mark.cuda
@pytest.mark.parametrize("function", FUNCTIONS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("label", LABELS)
def test_scan_cases_kernels_match_plain_on_repeated_card(
        monkeypatch, cuda_mesh_of, label, shape, function):
    """K7a/K7b on the card against their plain versions on the card in
    the same sequence, bit for bit, and again under three seeds of the
    delays of K7a's cluster exchange."""
    from nomad_tpu_torch.ops import _build
    case = _case(label, shape[0])
    mesh = cuda_mesh_of(shape)
    kern = getattr(ps, "place_batch_sharded" if function == "batch"
                   else "place_eval_batch_sharded")
    monkeypatch.setattr(k7, "scan_local", k7.scan_local_plain)
    monkeypatch.setattr(k7, "scan_apply", k7.scan_apply_plain)
    want = _card_outputs(function, mesh, case, kern)
    monkeypatch.undo()
    lib = _build.load("sharded")
    stream = torch.cuda.current_stream().cuda_stream
    before = k7.launches["scan_local"]
    try:
        for seed in (0, 1, 2, 3):
            assert lib.sharded_set_jitter(seed, stream) == 0
            got = _card_outputs(function, mesh, case, kern)
            for k, (g, w) in enumerate(zip(got, want)):
                _equal(g, w, f"{label} {shape} {function} delays {seed}: "
                             f"output {k}")
    finally:
        lib.sharded_set_jitter(0, stream)
    assert k7.launches["scan_local"] > before


@pytest.mark.cuda
@pytest.mark.parametrize("NS", [2, 4])
@pytest.mark.parametrize("label", RUN_LABELS)
def test_run_cases_kernel_matches_plain_on_card(cuda_mesh_of, label, NS):
    """K7d on the card against bulk_run_plain on the card, bit for bit."""
    cuda_mesh_of((4, 2))
    case = _run_case(label)
    before = k7.launches["bulk_run"]
    got = _run_rule(case, NS, k7.bulk_run, "cuda:0")
    want = _run_rule(case, NS, k7.bulk_run_plain, "cuda:0")
    np.testing.assert_array_equal(got, want, err_msg=f"{label}, {NS} shards")
    assert k7.launches["bulk_run"] > before
