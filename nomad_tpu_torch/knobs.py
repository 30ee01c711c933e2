"""The ``NOMAD_TPU_*`` tuning knobs the placement engine and the server
spine read.

A copy of the reference's registry entries for them (same names,
defaults and parsing), read through the typed accessors `get_int` and
`get_float` and `get_bool`.  Accessors read ``os.environ`` at call time, so tests can
set a knob around a block.  An empty string counts as unset.
"""
from __future__ import annotations

import os
from typing import Dict, Optional


class Knob:
    """One registered knob: wire default (string form, "" = unset),
    type name ("int" | "float" | "bool"), one-line doc."""

    __slots__ = ("default", "type", "doc")

    def __init__(self, default: str, type: str, doc: str) -> None:
        self.default = default
        self.type = type
        self.doc = doc


KNOBS: Dict[str, Knob] = {
    "NOMAD_TPU_ENGINE": Knob(
        "1", "bool",
        "`0` bypasses the batching engine (direct kernel calls)"),
    "NOMAD_TPU_SHARD": Knob(
        "1", "bool",
        "`0` disables the multi-device serving mesh entirely"),
    "NOMAD_TPU_SHARD_MIN": Knob(
        "128", "int",
        "minimum padded node rows before dispatches route over the "
        "`('node_shard','wave')` mesh (`shard_min_nodes`)"),
    "NOMAD_TPU_WAVE_SHARDS": Knob(
        "", "int",
        "wave extent of the 2-D serving mesh (`wave_mesh_shape`); "
        "empty = auto, a non-divisor of the device count falls back "
        "to 1"),
    "NOMAD_TPU_FUSE": Knob(
        "1", "bool",
        "`0` splits bulk waves into per-format device dispatches "
        "instead of one fused part per wave"),
    "NOMAD_TPU_DONATE": Knob(
        "1", "bool",
        "`0` disables donated usage-basis carries (rank-1 scatters "
        "into the resident basis instead)"),
    "NOMAD_TPU_OVERLAP": Knob(
        "1", "bool",
        "`0` disables upload/compute overlap (each bulk dispatch "
        "drains before the next uploads; requires donation)"),
    "NOMAD_TPU_BULK_BYTES": Knob(
        "268435456", "int",
        "byte budget for one bulk dispatch's stacked per-eval "
        "tensors; caps the eval-axis chain length at large N"),
    # -- server spine ------------------------------------------------
    "NOMAD_TPU_PIPELINE_DEPTH": Knob(
        "2", "int",
        "in-flight commit waves a worker may run ahead of "
        "(double-buffer depth); `0` restores blocking submit"),
    "NOMAD_TPU_HEARTBEAT_BATCH_MS": Knob(
        "50", "float",
        "leader heartbeat-batcher flush interval (one "
        "`NodeHeartbeatBatch` raft entry per flush)"),
    "NOMAD_TPU_HB_PENDING_MAX": Knob(
        "8192", "int",
        "heartbeat-batcher pending cap; at the cap the writer forces "
        "a flush"),
    "NOMAD_TPU_FLEET_AGENTS": Knob(
        "10000", "int",
        "in-process client agents the `fleet_soak` bench cells "
        "register and heartbeat"),
    # -- event streaming ---------------------------------------------
    "NOMAD_TPU_SUB_QUEUE": Knob(
        "1024", "int",
        "per-subscriber event queue depth before the subscriber is "
        "marked lagging"),
    "NOMAD_TPU_EVENT_BUFFER": Knob(
        "256", "int",
        "retained event-broker ring size (catch-up window)"),
}

_FALSE_STRINGS = ("", "0", "false", "no", "off")


def _raw(name: str) -> tuple:
    try:
        knob = KNOBS[name]
    except KeyError:
        raise KeyError(f"unregistered knob {name!r}: declare it in "
                       f"nomad_tpu_torch/knobs.py KNOBS") from None
    val = os.environ.get(name)
    if val is None or val == "":
        return None, knob
    return val, knob


def get_int(name: str, default: Optional[int] = None) -> Optional[int]:
    """The knob as an int; `None` when unset with an empty registry
    default and no `default=`."""
    raw, knob = _raw(name)
    if raw is not None:
        return int(raw)
    if default is not None:
        return default
    return int(knob.default) if knob.default else None


def get_float(name: str, default: Optional[float] = None
              ) -> Optional[float]:
    """The knob as a float; `None` when unset with an empty registry
    default and no `default=`."""
    raw, knob = _raw(name)
    if raw is not None:
        return float(raw)
    if default is not None:
        return default
    return float(knob.default) if knob.default else None


def get_bool(name: str, default: Optional[bool] = None) -> bool:
    """The knob as a bool: "", "0", "false", "no", "off" (any case)
    are false, anything else true; unset falls back to `default=` then
    the registry default."""
    raw, knob = _raw(name)
    if raw is None:
        if default is not None:
            return default
        raw = knob.default
    return raw.strip().lower() not in _FALSE_STRINGS
