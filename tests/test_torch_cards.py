"""Every kernel wrapper launches with its operands' card current.

A kernel launched into another card's stream while card 0 is current
faulted on a four-card H100 machine (an illegal address), and a cluster
launch sets its size attribute for the current card only.  So every
wrapper calls its kernel's C entry point through `_on_card`
(ops/place.py), with the card of its operands current for the call and
the caller's card current again after it: K1-K4 (ops/place.py), K6
(ops/preempt.py), K8a-K8f (ops/stage_probe.py), and the mesh's K7
wrappers (ops/sharded.py) and K5/K5' scatter (parallel/world.py).

On the CPU: no module calls a C entry point (`*_launch`) but through
`_on_card` (a scan of the sources).  The tests marked `cuda` need two or
more cards and skip with fewer: each single-device wrapper runs on
`cuda:1` with card 0 current, its outputs equal to its plain version's
on the same inputs (K2's floats within the tolerances of
tests/test_torch_scan_select.py, every other output bit for bit), and
card 0 current after the call.
"""
import ast
import os

import numpy as np
import pytest
import torch

from nomad_tpu_torch.convert import place_inputs_from_numpy
from nomad_tpu_torch.ops import place as tp
from nomad_tpu_torch.ops import preempt as tk
from nomad_tpu_torch.ops import stage_probe as tsp
from nomad_tpu_torch.parallel import stage_probe as psp

torch.set_num_threads(1)

_PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "nomad_tpu_torch")
# the modules that hold the wrappers of the C entry points
WRAPPER_MODULES = ("ops/place.py", "ops/preempt.py", "ops/stage_probe.py",
                   "ops/sharded.py", "parallel/world.py")
# K2's floats (tests/test_torch_scan_select.py)
RTOL, ATOL = 1e-5, 1.2e-7


@pytest.mark.parametrize("module", WRAPPER_MODULES)
def test_entry_points_are_called_through_on_card(module):
    """No call of a `*_launch` attribute in the module: each entry point
    is handed to `_on_card`, which calls it with the card current."""
    with open(os.path.join(_PKG, module)) as fh:
        tree = ast.parse(fh.read())
    direct = [node.lineno for node in ast.walk(tree)
              if isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr.endswith("_launch")]
    assert not direct, f"{module}: entry points called directly at {direct}"
    on_card = [node for node in ast.walk(tree)
               if isinstance(node, ast.Call)
               and isinstance(node.func, ast.Name)
               and node.func.id == "_on_card"]
    assert on_card, f"{module}: no call through _on_card"


def _bits(got, want, what):
    g, w = got.cpu().numpy(), want.cpu().numpy()
    assert g.dtype == w.dtype and g.shape == w.shape, what
    if w.dtype == np.float32:
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan, err_msg=what)
        g, w = np.where(nan, 0, g).view(np.uint32), \
            np.where(nan, 0, w).view(np.uint32)
    np.testing.assert_array_equal(g, w, err_msg=what)


def _k2_close(got, want):
    got = tp.unpack_outputs(got[0].cpu().numpy()), got[1]
    want = tp.unpack_outputs(want[0].cpu().numpy()), want[1]
    for i in (0, 3, 4, 5):                  # node, n_eval, n_exh, top_nodes
        np.testing.assert_array_equal(got[0][i], want[0][i])
    for i in (1, 2, 6):                     # score, fit_score, top_scores
        np.testing.assert_allclose(got[0][i], want[0][i], rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


def _bulk(dev, n=4096, M=16, count=300):
    """K1's and K4's inputs on `dev` from the probe's seeded draw."""
    x = psp.probe_inputs(n, fill_grid=M, device=dev)
    return x, (x["capacity"], x["used"], x["feasible"], x["affinity"], True,
               10, x["penalty"] > 0, x["coll"], x["demand"], count, False,
               64, M)


def _k4(dev, x, E=3, D=4, count=300, M=16):
    n = x["capacity"].shape[0]
    heavy = np.stack([tp.pack_bulk_heavy(
        *(x[k].cpu().numpy() for k in ("feasible", "affinity")),
        x["penalty"].cpu().numpy() > 0, x["coll"].cpu().numpy())] * E)
    dem = x["demand"].cpu().numpy()
    dyn = np.concatenate([tp.pack_bulk_light(
        True, 10, count, dem, [(e, dem)], n, D) for e in range(E)])
    t = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
    return (x["capacity"], x["used"], t(heavy), t(dyn), D, False, False, 64,
            M)


def _k6(dev, N=512, A=16, R=4, seed=6):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
    return (t((rng.integers(1, 8, (N, A, R)) * 50.0).astype(np.float32)),
            t(rng.integers(0, 60, (N, A)).astype(np.int32)),
            t(rng.random((N, A)) < 0.8),
            t((rng.integers(-6, 2, (N, R)) * 50.0).astype(np.float32)),
            t(np.array([300.0, 200.0, 0.0, 0.0], np.float32)))


# the single-device wrappers, as the cuda test names them
WRAPPERS = ("K1", "K2", "K3", "K4", "K6", "K8a", "K8b", "K8c", "K8d", "K8e",
            "K8f")


def _calls(dev):
    """WRAPPERS' name -> (wrapper call, plain call, compare) on `dev`."""
    cases = tp.scan_model_cases()
    evals, deltas = cases[0][1], cases[0][2]
    inp = place_inputs_from_numpy(evals[0], dev)
    batch = [torch.from_numpy(np.array(a)).to(dev) if isinstance(
        a, np.ndarray) else a for a in tp.scan_case_batch(evals, deltas)]
    x, k1 = _bulk(dev)
    k4 = _k4(dev, x)
    k6 = _k6(dev)
    p = psp.probe_inputs(4096, fill_grid=16, device=dev)
    util_m, fits_m = tsp.feasibility_plain(p["capacity"], p["used"],
                                           p["demand"], p["feasible"],
                                           p["ms"])
    fit_m = tsp.fit_plain(p["capacity"], util_m)
    score_args = (fit_m, p["coll"], p["ms"], p["desired_f"], p["penalty"],
                  p["affinity"], p["has_affinity"])
    score_m = tsp.score_plain(*score_args)
    run, order = tsp.argmax_plain(fits_m, score_m, p["ms"])
    fused = (p["capacity"], p["used"], p["demand"], p["feasible"],
             p["affinity"], p["has_affinity"], p["desired_f"], p["penalty"],
             p["coll"], p["count"], 16)
    units = {
        "K8a": ("feasibility", (p["capacity"], p["used"], p["demand"],
                                p["feasible"], p["ms"])),
        "K8b": ("fit", (p["capacity"], util_m)),
        "K8c": ("score", score_args),
        "K8d": ("argmax", (fits_m, score_m, p["ms"])),
        "K8e": ("scatter", (run, order, p["count"], p["used"], p["demand"],
                            p["coll"])),
        "K8f": ("fused_wave", fused),
    }
    calls = {
        "K1": (lambda: tp.place_bulk(*k1), lambda: tp.place_bulk_plain(*k1),
               None),
        "K2": (lambda: tp.place_eval_packed(inp),
               lambda: tp.place_eval_plain(inp), _k2_close),
        "K3": (lambda: tp.place_batch_packed(*batch),
               lambda: tp.place_batch_packed_plain(*batch), None),
        "K4": (lambda: tp.place_bulk_batch(*k4),
               lambda: tp.place_bulk_batch_plain(*k4), None),
        "K6": (lambda: tk.preempt_for_task_group(*k6),
               lambda: tk.preempt_for_task_group_plain(*k6), None),
    }
    for name, (fn, args) in units.items():
        calls[name] = (lambda fn=fn, args=args: getattr(tsp, fn)(*args),
                       lambda fn=fn, args=args: getattr(tsp, fn + "_plain")(
                           *args), None)
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("name", WRAPPERS)
def test_single_device_wrapper_on_a_card_that_is_not_current(name):
    """The wrapper with its operands on cuda:1 and card 0 current: its
    outputs equal its plain version's, and card 0 is current again after
    the call."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA cards")
    torch.cuda.set_device(0)
    kern, plain, compare = _calls("cuda:1")[name]
    got = kern()
    assert torch.cuda.current_device() == 0, name
    torch.cuda.synchronize(1)
    want = plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert all(t.device == torch.device("cuda:1") for t in got), name
    if compare is not None:
        compare(got, want)
        return
    for k, (g, w) in enumerate(zip(got, want)):
        _bits(g, w, f"{name} output {k}")
