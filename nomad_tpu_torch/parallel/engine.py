"""The placement engine seam.

The reference routes every placement through a process-wide batching
`PlacementEngine` unless NOMAD_TPU_ENGINE=0, in which case its
`get_engine()` returns None and the schedulers call the single-eval
kernels directly.  This slice of the port is that engine-off
configuration: `get_engine()` always returns None, so the copied
schedulers, feasibility checks and plan applier keep their reference
call sites unchanged.  The engine (device-resident world, batched and
donated bulk/scan dispatches reusing the single-eval kernels' device
code) is the next slice.
"""
from __future__ import annotations


def get_engine():
    """None: the port has no batching engine yet (see module docstring)."""
    return None
