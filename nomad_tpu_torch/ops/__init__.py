"""Device kernels of the scheduler hot path.

- fit.py    vectorized AllocsFit + BestFit-v3 scoring over the node axis
            (device functions of the two kernels below)
- place.py  the placement kernels: the bulk wavefront (K1, csrc/place_bulk.cu),
            the sequential slot scan (K2, csrc/place_scan.cu) and their
            chained batches over the packed transport (K4, K3, same
            sources), each with its plain PyTorch version
- preempt.py the preemption victim selection (K6, csrc/preempt.cu) with its
            plain PyTorch version, and the host ranking helpers
- stage_probe.py the stage probe's units (K8a-K8f, csrc/stage_probe.cu):
            the wave pipeline's stages as kernels of their own, and fused
"""

from nomad_tpu_torch.ops.fit import (
    fits_after,
    free_fractions,
    score_fit,
    validate_capacity,
)
from nomad_tpu_torch.ops.place import (
    PlaceInputs,
    PlaceResult,
    place_bulk,
    place_eval,
)

__all__ = [k for k in dir() if not k.startswith("_")]
