"""Carry state from numpy (and from the reference's structures) into the
port.

* `place_inputs_from_numpy` turns the fields of a placement input — the
  reference's `PlaceInputs` fields, or the port's own `DenseStack`
  assembly, both numpy — into the port's tensor `PlaceInputs` on a
  device.
* `cluster_matrix_from_numpy` rebuilds a port `ClusterMatrix` from the
  arrays of another one (capacity, used, readiness, attribute values,
  class codes, row map), so both packages can score the identical world.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from nomad_tpu_torch.device import resolve_device
from nomad_tpu_torch.encode.matrixizer import ClusterMatrix
from nomad_tpu_torch.ops.place import PLACE_INPUT_DTYPES, PlaceInputs

# numpy dtype of each torch dtype a PlaceInputs field has
NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
             torch.bool: np.bool_}


def place_inputs_from_numpy(fields: Dict[str, np.ndarray], device=None) -> PlaceInputs:
    """Port `PlaceInputs` on `device` (default "cuda") from a dict of
    numpy arrays keyed by the PlaceInputs field names."""
    dev = resolve_device(device)
    out = {}
    for name, dtype in PLACE_INPUT_DTYPES.items():
        arr = np.ascontiguousarray(np.asarray(fields[name]),
                                   dtype=NP_DTYPES[dtype])
        out[name] = torch.from_numpy(arr).to(dev)
    return PlaceInputs(**out)


def cluster_matrix_from_numpy(arrays: Dict[str, object]) -> ClusterMatrix:
    """A port ClusterMatrix holding copies of `arrays`: capacity, used,
    ready, port_words, dyn_port_lo/hi, class_codes, class_names,
    node_ids (row -> id or None), attrs ({column: [value per row]}) and
    optionally device_caps/device_used ({group: i32[N]}), as the
    reference's ClusterMatrix holds them.  Rows keep their positions;
    rows without a node id stay free for later nodes."""
    capacity = np.asarray(arrays["capacity"], np.float32)
    n = capacity.shape[0]
    cm = ClusterMatrix(n)
    if cm.n_rows != n:
        raise ValueError(f"row count {n} is not a power-of-two bucket")
    cm.capacity[:] = capacity
    cm.used[:] = np.asarray(arrays["used"], np.float32)
    cm.ready[:] = np.asarray(arrays["ready"], bool)
    cm.port_words[:] = np.asarray(arrays["port_words"], np.uint32)
    cm.dyn_port_lo[:] = np.asarray(arrays["dyn_port_lo"], np.int32)
    cm.dyn_port_hi[:] = np.asarray(arrays["dyn_port_hi"], np.int32)
    cm.class_codes[:] = np.asarray(arrays["class_codes"], np.int32)
    cm.class_names = list(arrays["class_names"])
    cm._class_rank = {c: i for i, c in enumerate(cm.class_names)}
    node_ids = list(arrays["node_ids"])
    cm.node_ids = node_ids
    cm.row_of = {nid: r for r, nid in enumerate(node_ids) if nid is not None}
    cm._free_rows = [r for r in range(n - 1, -1, -1) if node_ids[r] is None]
    for name, values in arrays["attrs"].items():
        col = cm.attrs.column(name)
        for r, v in enumerate(values):
            if v is not None:
                col.set(r, v)
    cm.device_caps = {k: np.array(v, np.int32)
                      for k, v in arrays.get("device_caps", {}).items()}
    cm.device_used = {k: np.array(v, np.int32)
                      for k, v in arrays.get("device_used", {}).items()}
    cm.generation += 1
    return cm
