"""The stage probe's edge cases, built with numpy from the probe's seeded
inputs, for tests/test_torch_stage_partition.py,
tests/test_torch_stage_probe.py and chip_smoke.py's stage-probe check:
the rows that reach each edge of K8d's and K8f's greedy order."""
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
