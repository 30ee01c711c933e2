"""Scheduler factory registry (reference: scheduler/scheduler.go:24-46).

Same plugin boundary: the server's workers look schedulers up by eval type.
The dense schedulers register under the reference's names (service,
batch, system, sysbatch).  This registry belongs to the port alone; every
scheduler it builds runs its kernels on the device it is given.
"""
from __future__ import annotations

from typing import Callable, Dict

SCHEDULER_VERSION = 1

_registry: Dict[str, Callable] = {}


def register(name: str, factory: Callable) -> None:
    _registry[name] = factory


def new_scheduler(name: str, state, planner, device=None):
    """Reference NewScheduler (scheduler.go:33-40); `device` (default
    "cuda") is where the scheduler's kernels run."""
    if not _registry:
        _register_builtins()
    try:
        factory = _registry[name]
    except KeyError:
        raise ValueError(f"unknown scheduler '{name}'") from None
    return factory(state, planner, device=device)


def builtin_schedulers() -> Dict[str, Callable]:
    return dict(_registry)


def _register_builtins() -> None:
    from nomad_tpu_torch.scheduler.generic import BatchScheduler, ServiceScheduler
    from nomad_tpu_torch.scheduler.system import SysBatchScheduler, SystemScheduler
    register("service", ServiceScheduler)
    register("batch", BatchScheduler)
    register("system", SystemScheduler)
    register("sysbatch", SysBatchScheduler)
