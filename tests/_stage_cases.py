"""The stage probe's edge cases, built with numpy from the probe's seeded
inputs, for tests/test_torch_stage_partition.py,
tests/test_torch_stage_probe.py and chip_smoke.py's stage-probe check:
the rows that reach each edge of K8d's and K8f's greedy order; and the
score unit's (K8c's) own cases (`score_inputs`), for
tests/test_torch_stage_score.py and chip_smoke.py's K8c check."""
import numpy as np
import torch

from nomad_tpu_torch.device import resolve_device
from nomad_tpu_torch.parallel.stage_probe import probe_inputs

# the edge rows of K8d's and K8f's partition (probe_edge_inputs)
EDGE_KINDS = ("best row scores -inf", "NaN at m = 1", "NaN past m = 1",
              "no row fits", "every row tied", "two rows",
              "count above every run")


def probe_edge_inputs(kind: str, n_nodes: int, fill_grid: int,
                      device=None) -> dict:
    """The probe's inputs (probe_inputs) changed to reach one edge of the
    greedy order, `kind` one of EDGE_KINDS:

    * best row scores -inf: an affinity of -inf on every row, so every
      fitting row scores -inf and top1 is -inf (every order key ties);
    * NaN at m = 1: rows 0, 1 and n // 2 at +inf capacity and usage (1 -
      inf / inf), fitting at a NaN score for every m: -NaN on the CPU
      (lax.top_k ranks it lowest), +NaN on the card (highest: top1 is
      NaN and the wave is empty);
    * NaN past m = 1: cpu demands of 1e38 on capacities of the largest
      f32, rows 0, 1 and n // 2 at +inf capacity and 2e38 usage: their
      m = 1 cell is finite, m = 2 reaches +inf usage and a NaN score;
    * no row fits; every row tied (equal rows, no penalty or affinity);
    * two rows (n_nodes is ignored); count above every run (10**6)."""
    if kind not in EDGE_KINDS:
        raise ValueError(f"probe_edge_inputs: unknown kind {kind!r}")
    n = 2 if kind == "two rows" else int(n_nodes)
    x = {k: (v.cpu().numpy().copy() if isinstance(v, torch.Tensor) else v)
         for k, v in probe_inputs(n, fill_grid=fill_grid,
                                  device="cpu").items()}
    odd = [0, 1, n // 2]
    if kind == "best row scores -inf":
        x["affinity"][:] = -np.inf
    elif kind == "NaN at m = 1":
        x["capacity"][odd, 0] = x["used"][odd, 0] = np.inf
    elif kind == "NaN past m = 1":
        rng = np.random.default_rng(1)
        x["demand"][0] = 1e38
        x["capacity"][:, 0] = np.finfo(np.float32).max
        x["used"][:, 0] = rng.choice(np.float32([0.0, 0.5e38, 1e38]), n)
        x["capacity"][odd, 0] = np.inf
        x["used"][odd, 0] = 2e38
    elif kind == "no row fits":
        x["feasible"][:] = False
    elif kind == "every row tied":
        x["capacity"][:] = x["capacity"][0]
        x["used"][:] = x["used"][0]
        x["feasible"][:] = True
        x["coll"][:] = 0
        x["penalty"][:] = 0.0
        x["affinity"][:] = 0.0
    elif kind == "count above every run":
        x["count"] = 10 ** 6
    dev = resolve_device(device)
    return {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
                else v) for k, v in x.items()}


# K8c's cases (score_inputs), each at every fill grid of SCORE_GRIDS: M =
# 1, odd M, and the probe's two grids
SCORE_KINDS = ("seeded", "has_affinity off", "affinity -0.0, NaN and +-inf",
               "NaN penalty", "desired 0", "desired 0.5", "desired NaN",
               "coll at and past 2^24")
SCORE_GRIDS = (1, 3, 7, 16, 64)
# collision counts where (float)coll + m rounds (f32 holds integers
# exactly only up to 2^24)
BIG_COLL = np.array([2 ** 24 - 2, 2 ** 24 - 1, 2 ** 24, 2 ** 24 + 1,
                     2 ** 24 + 2, 2 ** 24 + 3, 2 ** 25 + 1, 2 ** 25 + 3,
                     2 ** 30 + 5], np.int32)


def score_inputs(kind: str, n: int, M: int, seed: int = 0) -> dict:
    """numpy inputs of the score unit (fit_m f32[n, M], coll i32[n], ms
    f32[M], desired_f, penalty f32[n], affinity f32[n], has_affinity),
    `kind` one of SCORE_KINDS: seeded fits in [0, 1), collisions 0..3,
    ms 1..M, a penalty of 1 on about 5% of the rows, affinities in
    [-1, 1), desired_f 8, has_affinity on; then

    * has_affinity off;
    * affinity -0.0, NaN and +-inf: rows 0, 4, 8, ... an affinity of
      -0.0 (off: it equals 0), rows 1, 5, ... NaN, 2, 6, ... +inf, 3, 7,
      ... -inf;
    * NaN penalty: every fifth row;
    * desired 0, 0.5 (both divide by 1) and NaN (the reference's
      jnp.maximum keeps it: every cell with a collision scores NaN);
    * coll at and past 2^24: collisions drawn from BIG_COLL, where
      (float)coll + m rounds."""
    if kind not in SCORE_KINDS:
        raise ValueError(f"score_inputs: unknown kind {kind!r}")
    rng = np.random.default_rng(seed)
    x = dict(fit_m=rng.random((n, M), dtype=np.float32),
             coll=rng.integers(0, 4, n).astype(np.int32),
             ms=np.arange(1, M + 1, dtype=np.float32), desired_f=8.0,
             penalty=(rng.random(n) < 0.05).astype(np.float32),
             affinity=rng.uniform(-1.0, 1.0, n).astype(np.float32),
             has_affinity=True)
    if kind == "has_affinity off":
        x["has_affinity"] = False
    elif kind == "affinity -0.0, NaN and +-inf":
        for k, v in enumerate((-0.0, np.nan, np.inf, -np.inf)):
            x["affinity"][k::4] = v
    elif kind == "NaN penalty":
        x["penalty"][::5] = np.nan
    elif kind.startswith("desired "):
        x["desired_f"] = float(kind.split()[1].replace("NaN", "nan"))
    elif kind == "coll at and past 2^24":
        x["coll"] = rng.choice(BIG_COLL, n)
    return x


# the score cases of the wave grid (ops/place.py bulk_wave_grid), the
# score stack of K1, K4, K7 and K8f (wave_score_inputs)
WAVE_SCORE_KINDS = ("desired 0", "desired 0.5", "desired NaN",
                    "coll at and past 2^24")


def wave_score_inputs(kind: str, n_nodes: int, fill_grid: int,
                      device=None) -> dict:
    """The probe's inputs (probe_inputs) with a desired count of 0, 0.5
    or NaN, or collision counts drawn from BIG_COLL; `kind` one of
    WAVE_SCORE_KINDS."""
    if kind not in WAVE_SCORE_KINDS:
        raise ValueError(f"wave_score_inputs: unknown kind {kind!r}")
    x = {k: (v.cpu().numpy().copy() if isinstance(v, torch.Tensor) else v)
         for k, v in probe_inputs(n_nodes, fill_grid=fill_grid,
                                  device="cpu").items()}
    if kind.startswith("desired "):
        x["desired_f"] = float(kind.split()[1].replace("NaN", "nan"))
    else:
        x["coll"] = np.random.default_rng(5).choice(BIG_COLL, n_nodes)
    dev = resolve_device(device)
    return {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
                else v) for k, v in x.items()}
