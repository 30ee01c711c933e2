"""The device every entry point of the port runs on.

Entry points take an explicit `device` and default to "cuda".  Nothing
here picks the CPU by itself: the CPU runs only when the caller passes
`device="cpu"` (the tests do), and asking for CUDA on a machine without
a card raises instead of quietly running elsewhere.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """torch.device for `device` (default "cuda"); raises when CUDA is
    asked for and no card is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nomad_tpu_torch: device 'cuda' requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"nomad_tpu_torch: unsupported device {dev}")
    return dev
