"""Server core of the port (reference: nomad/ — the control plane around
the scheduler): eval broker with ack/nack leases, blocked-eval tracking
with unblock-on-capacity, plan queue + serialized optimistic-concurrency
plan applier (partial commit), scheduler workers, the control loops
(heartbeats, drainer, deployment, volume and periodic watchers, core
GC, the event broker), and the dev-mode `Server` that wires them.  All host-side; device work happens in
nomad_tpu_torch.ops through the schedulers."""

from nomad_tpu_torch.core.blocked import BlockedEvals
from nomad_tpu_torch.core.broker import EvalBroker
from nomad_tpu_torch.core.plan_apply import PlanApplier
from nomad_tpu_torch.core.plan_queue import PlanQueue

__all__ = ["EvalBroker", "BlockedEvals", "PlanApplier", "PlanQueue"]
