"""Parity of the port's fit primitives (nomad_tpu_torch.ops.fit) with the
reference's (nomad_tpu.ops.fit) on the same numpy inputs.  Booleans must be
equal; floats agree within rtol 1e-6."""
import numpy as np
import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.encode import ClusterMatrix
from nomad_tpu.ops import fit as rf
from nomad_tpu_torch.ops import fit as tf

# one intra-op thread: the suite runs test files in parallel worker
# processes, and these small tensors gain nothing from more threads
torch.set_num_threads(1)

RTOL = 1e-6


def _matrix(n=5):
    cm = ClusterMatrix()
    for _ in range(n):
        cm.upsert_node(mock.node())
    return cm


def _util(cm, seed):
    rng = np.random.default_rng(seed)
    util = np.zeros_like(cm.used)
    for r in cm.row_of.values():
        util[r, 0] = rng.integers(0, 4000)
        util[r, 1] = rng.integers(0, 8192)
    return util


def _zero_cap_case():
    """Rows with zero capacity: unused (0 on 0 -> free fraction 1) and
    used (used > 0 on 0 -> -inf), beside ordinary rows."""
    cap = np.array([[0, 0, 0, 0], [0, 0, 0, 0], [2048, 4096, 0, 0],
                    [4000, 0, 0, 0]], np.float32)
    util = np.array([[0, 0, 0, 0], [10, 20, 0, 0], [1024, 2048, 0, 0],
                     [100, 0, 0, 0]], np.float32)
    return cap, util


# the cases of tests/test_ops.py:19-44 and test_parity_golden.py:78
GOLDEN = [(2048, 4096), (0, 0), (1024, 2048)]


def _cases():
    cm = _matrix()
    out = {"seeded": (cm.capacity, _util(cm, 0)),
           "padded_rows": (_matrix(2).capacity, np.zeros_like(_matrix(2).used)),
           "zero_capacity": _zero_cap_case()}
    for cpu, mem in GOLDEN:
        out[f"golden_{cpu}_{mem}"] = (
            np.array([[2048.0, 4096.0, 0.0, 0.0]], np.float32),
            np.array([[cpu, mem, 0.0, 0.0]], np.float32))
    return out


CASES = _cases()
T = torch.from_numpy


@pytest.mark.parametrize("case", list(CASES))
def test_free_fractions(case):
    cap, util = CASES[case]
    got = tf.free_fractions(T(cap), T(util)).numpy()
    want = np.asarray(rf.free_fractions(cap, util))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("spread", [False, True], ids=["binpack", "spread"])
@pytest.mark.parametrize("case", list(CASES))
def test_score_fit(case, spread):
    cap, util = CASES[case]
    got = tf.score_fit(T(cap), T(util), spread).numpy()
    want = np.asarray(rf.score_fit(cap, util, spread))
    assert got.dtype == np.float32 and not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_score_fit_golden_values():
    for (cpu, mem), (bp, sp) in zip(GOLDEN, [(18.0, 0.0), (0.0, 18.0),
                                             (13.675, 4.325)]):
        cap, util = CASES[f"golden_{cpu}_{mem}"]
        assert float(tf.score_fit(T(cap), T(util), False)[0]) == \
            pytest.approx(bp, abs=1e-3)
        assert float(tf.score_fit(T(cap), T(util), True)[0]) == \
            pytest.approx(sp, abs=1e-3)


def test_score_fit_grid_broadcast():
    """[N, 1, R] capacity against [N, M, R] usage, as the bulk grid calls it."""
    cm = _matrix(4)
    util = _util(cm, 1)
    grid = util[:, None, :] + np.arange(1, 9, dtype=np.float32)[None, :, None] \
        * np.array([30, 60, 0, 0], np.float32)
    got = tf.score_fit(T(cm.capacity)[:, None, :], T(grid), False).numpy()
    want = np.asarray(rf.score_fit(cm.capacity[:, None, :], grid, False))
    assert got.shape == (cm.n_rows, 8)
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fits_after_and_validate_capacity(seed):
    cm = _matrix(6)
    used = _util(cm, seed)
    rng = np.random.default_rng(seed)
    for d in (np.array([4000.0, 8192.0, 0.0, 0.0], np.float32),
              np.array([1.0, 1.0, 0.0, 0.0], np.float32),
              rng.integers(0, 3000, 4).astype(np.float32)):
        np.testing.assert_array_equal(
            tf.fits_after(T(cm.capacity), T(used), T(d)).numpy(),
            np.asarray(rf.fits_after(cm.capacity, used, d)))
    over = used.copy()
    over[0, 0] = cm.capacity[0, 0] + 1
    for u in (used, over):
        np.testing.assert_array_equal(
            tf.validate_capacity(T(cm.capacity), T(u)).numpy(),
            np.asarray(rf.validate_capacity(cm.capacity, u)))


def test_fit_norm_is_the_reference_compiled_division():
    """The reference writes `score_fit(...) / 18.0`; XLA compiles that into
    a multiply by the f32 reciprocal, which is why the port (plain versions
    and CUDA kernels) multiplies by FIT_NORM.  Placements hinge on these
    bits at near-ties, so the port must follow the reference if this ever
    changes."""
    import jax
    from nomad_tpu_torch.ops.place import FIT_NORM
    x = np.random.default_rng(0).uniform(0, 18, 100_000).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: a / 18.0)(x))
    np.testing.assert_array_equal(ref, (T(x) * FIT_NORM).numpy())
