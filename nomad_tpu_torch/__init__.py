"""nomad_tpu_torch — the PyTorch/CUDA port of nomad_tpu.

The same cluster scheduler, with its device work written for an NVIDIA
Hopper card (H100, sm_90a) instead of jitted JAX: the scheduler's
eval-to-commit path (reconcile -> DenseStack -> dense placement kernels
-> plan -> PlanApplier -> StateStore) over hand-written CUDA kernels in
`csrc/`, each with a plain PyTorch version beside it in `ops/`.

Entry points run on "cuda" unless the caller passes `device="cpu"`; the
package imports torch, numpy and the standard library only.
"""

__version__ = "0.1.0"

SCHEDULER_VERSION = 1  # parity: reference scheduler/scheduler.go:19
