"""The port's native host library (nomad_tpu_torch/native.py over
csrc/nomad_native.cpp, built with g++) against the reference's own
library and against the port's plain numpy specs.

Every entry point is held bit for bit to the reference's
`nomad_tpu.native` running its C library (NATIVE_AVAILABLE asserted, its
breaker closed) and to the port's `<name>_plain` spec on seeded cases:
duplicate rows, negative and zero counts, NaN and +-inf values, ports
out of range or repeated within a request, freed ports, empty inputs and
expand_pairs triples of count 0.  The one exception is score_fit against
its plain spec: glibc's powf and numpy's float32 power may round
10 ** x to different neighbours, so the scores agree within
SCORE_ATOL (a score is (20 - total) / 18 with total < 20: one ulp of
total near 20 is 1.9e-6, 1.06e-7 of score; the bound allows four).

Also pinned: 5,000 seeded rank-1 adds equal numpy's np.add.at (built
with -march=native GCC contracts the multiply-add into an FMA, which
rounds once); format_uuids on patched random bytes gives the reference's
strings; and no fallback: with no g++ and an empty build directory the
first call raises, a float64 `used` raises, and native.py catches no
exception around a library call.
"""
import ast
import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest

from nomad_tpu_torch import native
from nomad_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = 4
N_ROWS = 64
PORT_WORDS = 2048
SCORE_ATOL = 4.3e-7


@pytest.fixture(scope="module")
def ref():
    from nomad_tpu import native as ref_native
    ref_native._load()
    assert ref_native.NATIVE_AVAILABLE, "the reference's C library did not build"
    yield ref_native
    assert not ref_native.breaker.open, "the reference fell back to numpy"


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _world(seed, n=N_ROWS):
    rng = np.random.default_rng(seed)
    cap = rng.integers(1000, 8000, (n, DIMS)).astype(np.float32)
    used = (cap * rng.uniform(0, 1, (n, DIMS))).astype(np.float32)
    return rng, cap, used


ODD = np.array([np.nan, np.inf, -np.inf, -0.0], np.float32)


def _odd(rng, a, frac=0.25):
    """`a` with a share of its cells NaN, +inf, -inf or -0.0."""
    a = a.copy()
    mask = rng.uniform(0, 1, a.shape) < frac
    a[mask] = rng.choice(ODD, int(mask.sum()))
    return a


# ------------------------------------------------------------ fit, score

def _dense_case(kind, seed):
    rng, cap, used = _world(seed)
    demand = rng.integers(0, 4000, DIMS).astype(np.float32)
    if kind == "exact boundary":
        demand = (cap[0] - used[0]).astype(np.float32)
    elif kind == "fractional":
        demand = rng.uniform(0, 3000, DIMS).astype(np.float32)
    elif kind == "nan and inf capacity":
        cap = _odd(rng, cap)
    elif kind == "nan and inf usage":
        used = _odd(rng, used)
    elif kind == "nan and inf demand":
        demand = ODD.copy()
    elif kind == "zero and negative capacity":
        cap[rng.uniform(0, 1, cap.shape) < 0.2] = 0.0
        cap[rng.uniform(0, 1, cap.shape) < 0.1] = -5.0
    elif kind == "empty":
        cap, used = cap[:0], used[:0]
    return cap, used, demand


DENSE_KINDS = ("random", "exact boundary", "fractional",
               "nan and inf capacity", "nan and inf usage",
               "nan and inf demand", "zero and negative capacity", "empty")


@pytest.mark.parametrize("kind", DENSE_KINDS)
def test_allocs_fit(ref, kind):
    cap, used, demand = _dense_case(kind, 1)
    got = native.allocs_fit(cap, used, demand)
    _same(got, ref.allocs_fit(cap, used, demand))
    _same(got, native.allocs_fit_plain(cap, used, demand))


@pytest.mark.parametrize("spread", (False, True))
@pytest.mark.parametrize("kind", DENSE_KINDS)
def test_score_fit(ref, kind, spread):
    cap, used, demand = _dense_case(kind, 2)
    got = native.score_fit(cap, used, demand, spread)
    _same(got, ref.score_fit(cap, used, demand, spread))
    plain = native.score_fit_plain(cap, used, demand, spread)
    assert plain.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(plain))
    np.testing.assert_allclose(got, plain, rtol=0, atol=SCORE_ATOL)


# ------------------------------------------------------------ ports

def _port_words(seed):
    rng = np.random.default_rng(seed)
    pw = np.zeros((8, PORT_WORDS), np.uint32)
    for row in range(8):
        for p in rng.integers(0, 65536, 40):
            pw[row, p >> 5] |= np.uint32(1 << (p & 31))
    return pw


def _taken(pw, row):
    bits = np.unpackbits(pw[row].view(np.uint8), bitorder="little")
    return np.flatnonzero(bits)


def _ports_case(kind, pw, row):
    taken = [int(p) for p in _taken(pw, row)]
    free = [p for p in range(20000, 20100) if p not in taken][:5]
    return {
        "free ports": (free, []),
        "taken port": (free[:2] + taken[:1], []),
        "taken port freed": (free[:2] + taken[:2], taken[:2]),
        "freed port not asked": (free[:3], taken[:3]),
        "repeated within the request": (free[:2] + free[:1], []),
        "negative port": (free[:2] + [-1], []),
        "port past the words": (free[:2] + [65536], []),
        "port far past the words": (free[:1] + [1 << 30], []),
        "empty request": ([], taken[:2]),
    }[kind]


PORT_KINDS = ("free ports", "taken port", "taken port freed",
              "freed port not asked", "repeated within the request",
              "negative port", "port past the words",
              "port far past the words", "empty request")


@pytest.mark.parametrize("kind", PORT_KINDS)
def test_ports_check(ref, kind):
    pw = _port_words(3)
    ports, freed = _ports_case(kind, pw, 5)
    got = native.ports_check(pw, 5, ports, freed)
    assert got == ref.ports_check(pw, 5, ports, freed)
    assert got == native.ports_check_plain(pw, 5, ports, freed)
    assert isinstance(got, bool)


@pytest.mark.parametrize("value", (True, False))
@pytest.mark.parametrize("kind", PORT_KINDS)
def test_ports_set(ref, kind, value):
    pw = _port_words(4)
    ports, _ = _ports_case(kind, pw, 2)
    ports = ports + _taken(pw, 2)[:3].tolist()
    got, want, plain = pw.copy(), pw.copy(), pw.copy()
    native.ports_set(got, 2, ports, value)
    ref.ports_set(want, 2, ports, value)
    native.ports_set_plain(plain, 2, ports, value)
    _same(got, want)
    _same(got, plain)


# ------------------------------------------------------------ scatters

def _scatter_case(kind, seed):
    rng, _, used = _world(seed)
    k = 40
    rows = rng.integers(0, N_ROWS, k).astype(np.int32)
    counts = rng.integers(-3, 6, k).astype(np.int32)
    demand = rng.uniform(0, 700, DIMS).astype(np.float32)
    deltas = rng.uniform(-500, 500, (k, DIMS)).astype(np.float32)
    if kind == "duplicate rows":
        rows = np.repeat(rows[:8], 5)
    elif kind == "nan and inf values":
        demand = ODD.copy()
        deltas = _odd(rng, deltas)
        used = _odd(rng, used, 0.1)
    elif kind == "signed zeros":
        used[:] = -0.0
        demand[:2] = 0.0
        deltas[:, :2] = 0.0
        counts[::3] = 0
    elif kind == "counts past 2^24":
        counts = rng.integers(1 << 24, (1 << 24) + 64, k).astype(np.int32)
        counts[::2] *= -1
    elif kind == "empty":
        rows, counts, deltas = rows[:0], counts[:0], deltas[:0]
    return used, rows, counts, demand, deltas


SCATTER_KINDS = ("random", "duplicate rows", "nan and inf values",
                 "signed zeros", "counts past 2^24", "empty")


@pytest.mark.parametrize("kind", SCATTER_KINDS)
def test_scatter_add(ref, kind):
    used, rows, _, _, deltas = _scatter_case(kind, 5)
    got, want, plain = used.copy(), used.copy(), used.copy()
    native.scatter_add(got, rows, deltas)
    ref.scatter_add(want, rows, deltas)
    native.scatter_add_plain(plain, rows, deltas)
    _same(got, want)
    _same(got, plain)


@pytest.mark.parametrize("kind", SCATTER_KINDS + ("zero counts only",))
def test_scatter_add_rank1(ref, kind):
    used, rows, counts, demand, _ = _scatter_case(
        "nan and inf values" if kind == "zero counts only" else kind, 6)
    if kind == "zero counts only":
        counts[:] = 0
    got, want, plain = used.copy(), used.copy(), used.copy()
    native.scatter_add_rank1(got, rows, counts, demand)
    ref.scatter_add_rank1(want, rows, counts, demand)
    native.scatter_add_rank1_plain(plain, rows, counts, demand)
    _same(got, want)
    _same(got, plain)


def test_rank1_adds_round_as_numpy(ref):
    """5,000 seeded rank-1 adds, each rounding its multiply before its
    add: a contracted FMA would part from np.add.at here."""
    rng = np.random.default_rng(7)
    got = np.zeros((N_ROWS, DIMS), np.float32)
    want, lib = got.copy(), got.copy()
    for _ in range(5000):
        rows = rng.integers(0, N_ROWS, 8).astype(np.int32)
        counts = rng.integers(1, 1000, 8).astype(np.int32)
        demand = rng.uniform(0, 10, DIMS).astype(np.float32)
        native.scatter_add_rank1(got, rows, counts, demand)
        ref.scatter_add_rank1(lib, rows, counts, demand)
        np.add.at(want, rows, counts[:, None].astype(np.float32) * demand)
    _same(got, want)
    _same(got, lib)


# ------------------------------------------------------------ the plan

def _plan_case(kind, seed):
    rng, cap, used = _world(seed)
    pw = np.zeros((N_ROWS, PORT_WORDS), np.uint32)
    pw[:8] = _port_words(seed)
    g = 24
    rows = rng.integers(0, N_ROWS, g).astype(np.int32)
    rows[::7] = -1
    demand = rng.uniform(0, 2500, (g, DIMS)).astype(np.float32)
    freed = rng.uniform(0, 600, (g, DIMS)).astype(np.float32)
    freed[::2] = 0.0
    ports = [[] for _ in range(g)]
    freed_ports = [[] for _ in range(g)]
    if kind == "nan and inf capacity":
        cap = _odd(rng, cap, 0.3)
    elif kind == "nan and inf usage":
        used = _odd(rng, used, 0.3)
    elif kind == "nan and inf demand":
        demand = _odd(rng, demand, 0.3)
    elif kind == "nan and inf freed":
        freed = _odd(rng, freed, 0.3)
    elif kind == "ports":
        rows[:8] = np.arange(8)
        demand[:8] = 0.0
        for i in range(8):
            taken = _taken(pw, i).tolist()
            ports[i] = {0: [21000, 21001], 1: taken[:1],
                        2: [21000, 21000], 3: [-4], 4: [70000],
                        5: taken[:2], 6: [], 7: [21002]}[i]
            freed_ports[i] = {5: taken[:2], 7: taken[:1]}.get(i, [])
    elif kind == "empty plan":
        rows, demand, freed = rows[:0], demand[:0], freed[:0]
        ports, freed_ports = [], []
    return cap, used, pw, rows, demand, freed, ports, freed_ports


PLAN_KINDS = ("random", "nan and inf capacity", "nan and inf usage",
              "nan and inf demand", "nan and inf freed", "ports",
              "empty plan")


@pytest.mark.parametrize("kind", PLAN_KINDS)
def test_validate_plan(ref, kind):
    args = _plan_case(kind, 8)
    got = native.validate_plan(*args)
    assert got.dtype == bool
    _same(got, ref.validate_plan(*args))
    _same(got, native.validate_plan_plain(*args))
    if kind != "empty plan":
        assert 0 < got.sum() < len(got)


@pytest.mark.parametrize("where", ("capacity", "usage"))
def test_nan_rows_pass_the_fit_test_as_the_reference_library(ref, where):
    """One group on a row with a NaN capacity or usage: nomad_native.cpp
    tests `use + dem - fre > cap + 1e-6f`, which a NaN makes false, so
    the group passes (the reference's numpy fallback, `<=`, rejects it)."""
    cap = np.full((2, DIMS), 1000.0, np.float32)
    used = np.zeros((2, DIMS), np.float32)
    (cap if where == "capacity" else used)[1, 0] = np.nan
    pw = np.zeros((2, PORT_WORDS), np.uint32)
    args = (cap, used, pw, [0, 1], np.full((2, DIMS), 10.0, np.float32),
            np.zeros((2, DIMS), np.float32), [[], []], [[], []])
    assert native.validate_plan(*args).tolist() == [True, True]
    assert native.validate_plan_plain(*args).tolist() == [True, True]
    assert ref.validate_plan(*args).tolist() == [True, True]
    demand = np.full(DIMS, 10.0, np.float32)
    assert native.allocs_fit(cap, used, demand).tolist() == [True, True]
    assert native.allocs_fit_plain(cap, used, demand).tolist() == [True, True]
    assert ref.allocs_fit(cap, used, demand).tolist() == [True, True]


# ------------------------------------------------------------ materialize

def _pairs_case(kind, seed):
    rng = np.random.default_rng(seed)
    k = 30
    rows = rng.integers(0, 10000, k).astype(np.int32)
    counts = rng.integers(0, 12, k).astype(np.int32)
    scores = rng.uniform(-1, 1, k).astype(np.float32)
    if kind == "count-0 triples":
        counts[::2] = 0
    elif kind == "negative counts":
        counts[::3] = -counts[::3] - 1
    elif kind == "all counts 0":
        counts[:] = 0
    elif kind == "nan and inf scores":
        scores = _odd(rng, scores, 0.5)
    elif kind == "no scores":
        scores = None
    elif kind == "empty":
        rows, counts, scores = rows[:0], counts[:0], scores[:0]
    return rows, counts, scores


PAIR_KINDS = ("random", "count-0 triples", "negative counts",
              "all counts 0", "nan and inf scores", "no scores", "empty")


@pytest.mark.parametrize("kind", PAIR_KINDS)
def test_expand_pairs(ref, kind):
    rows, counts, scores = _pairs_case(kind, 9)
    got = native.expand_pairs(rows, counts, scores)
    for g, w, p in zip(got, ref.expand_pairs(rows, counts, scores),
                       native.expand_pairs_plain(rows, counts, scores)):
        _same(g, w)
        _same(g, p)
    assert len(got[0]) == int(np.clip(counts, 0, None).sum())


@pytest.mark.parametrize("n", (0, 1, 3, 257))
def test_format_uuids(ref, monkeypatch, n):
    rnd = np.random.default_rng(n).integers(0, 256, 16 * n,
                                            dtype=np.uint8).tobytes()
    monkeypatch.setattr(os, "urandom", lambda k: rnd[:k])
    got = native.format_uuids(n)
    assert got == ref.format_uuids(n)
    assert got == native.format_uuids_plain(n)
    assert all(len(u) == 36 and u.count("-") == 4 for u in got)


# ------------------------------------------------------------ no fallback

_NO_COMPILER = r"""
import os, sys
import numpy as np
from nomad_tpu_torch import native
from nomad_tpu_torch.ops import _build
_build.BUILD_DIR = sys.argv[1]
try:
    native.scatter_add_rank1(np.zeros((4, 4), np.float32), [0], [1],
                             np.ones(4, np.float32))
except RuntimeError as e:
    print("RAISED: " + str(e).splitlines()[0])
else:
    print("NO RAISE")
print("BUILT: " + ",".join(os.listdir(sys.argv[1])))
"""


def test_first_call_raises_without_a_compiler(tmp_path):
    env = dict(os.environ, PATH="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _NO_COMPILER, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "RAISED: " in out.stdout and "g++" in out.stdout, out.stdout
    assert "BUILT: \n" in out.stdout + "\n", out.stdout


def test_failed_build_names_the_compilers_stderr(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "nomad_native.cpp").write_text("int broken(\n")
    monkeypatch.setattr(_build, "SRC_DIR", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for "
                                           "nomad_native.cpp.*\n.*error"):
        _build._build_host()


def test_abi_mismatch_raises(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    text = open(os.path.join(_build.SRC_DIR, "nomad_native.cpp")).read()
    (src / "nomad_native.cpp").write_text(text.replace(
        "nomad_native_abi_version(void) { return 2; }",
        "nomad_native_abi_version(void) { return 3; }"))
    monkeypatch.setattr(_build, "SRC_DIR", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="ABI mismatch"):
        _build.load_host()


@pytest.mark.parametrize("used", ("float64", "fortran order", "read-only",
                                  "1-d"))
def test_wrong_used_raises(used):
    u = {"float64": np.zeros((4, DIMS)),
         "fortran order": np.zeros((4, DIMS), np.float32, order="F"),
         "read-only": np.zeros((4, DIMS), np.float32),
         "1-d": np.zeros(4 * DIMS, np.float32)}[used]
    if used == "read-only":
        u.flags.writeable = False
    with pytest.raises(TypeError, match="used"):
        native.scatter_add_rank1(u, [0], [1], np.ones(DIMS, np.float32))
    with pytest.raises(TypeError, match="used"):
        native.scatter_add(u, [0], np.ones((1, DIMS), np.float32))


@pytest.mark.parametrize("row", (-1, 4))
def test_rows_outside_raise(row):
    u = np.zeros((4, DIMS), np.float32)
    with pytest.raises(IndexError):
        native.scatter_add_rank1(u, [0, row], [1, 1],
                                 np.ones(DIMS, np.float32))
    with pytest.raises(IndexError):
        native.ports_set(np.zeros((4, 8), np.uint32), row, [3], True)
    assert not u.any()


def _public(tree):
    return [f for f in tree.body if isinstance(f, ast.FunctionDef)
            and not f.name.startswith("_") and not f.name.endswith("_plain")]


def _calls_library(node):
    return any(isinstance(c, ast.Call) and isinstance(c.func, ast.Name)
               and c.func.id == "_native" for c in ast.walk(node))


def test_every_public_function_calls_the_library_and_nothing_catches():
    path = os.path.join(REPO, "nomad_tpu_torch", "native.py")
    tree = ast.parse(open(path).read(), filename=path)
    public = _public(tree)
    assert sorted(f.name for f in public) == sorted(
        ["allocs_fit", "score_fit", "ports_check", "ports_set",
         "scatter_add", "scatter_add_rank1", "validate_plan",
         "expand_pairs", "format_uuids"])
    for f in public:
        assert _calls_library(f), f.name
        assert hasattr(native, f.name + "_plain"), f.name
    assert not [n for n in ast.walk(tree)
                if isinstance(n, (ast.Try, ast.ExceptHandler))]


def test_library_calls_keep_the_interpreter_lock():
    """The library is a ctypes.PyDLL: a call of a few microseconds keeps
    the interpreter lock (a CDLL releases it around each call, and the
    caller waits for it again behind the server's other threads)."""
    assert isinstance(native._native(), ctypes.PyDLL)
