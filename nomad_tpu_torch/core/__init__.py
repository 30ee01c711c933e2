"""Server core of the port.  This slice holds the serialized plan applier
(`PlanApplier.apply`); broker, plan queue and workers come with the
server spine."""

from nomad_tpu_torch.core.plan_apply import PlanApplier

__all__ = ["PlanApplier"]
