"""Dense encoding of cluster state into fixed-shape arrays.

This is the bridge between the host control plane (nomad_tpu_torch.state /
nomad_tpu_torch.core) and the device kernels (nomad_tpu_torch.ops): a snapshot of
nodes/allocations becomes padded node x resource matrices, hashed/ordinal
attribute code matrices, and per-eval task-group demand tensors.
"""

from nomad_tpu_torch.encode.attrs import AttrTable, hash_code, MISSING_CODE
from nomad_tpu_torch.encode.matrixizer import (
    ClusterMatrix,
    EvalTensors,
    NUM_RESOURCE_DIMS,
    RES_CPU,
    RES_MEM,
    RES_DISK,
    pad_to_bucket,
)

__all__ = [k for k in dir() if not k.startswith("_")]
