"""Where the port's tensors live by default: the CUDA card.

Every entry point that makes tensors takes ``device=None`` and resolves it
here. None means the GPU; a machine without one raises instead of quietly
running on the CPU, which is asked for with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA card, or a RuntimeError naming ``device="cpu"`` when torch
    sees none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tracer_tpu_torch runs on an NVIDIA GPU by default and torch "
            "sees none; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def resolve(device) -> torch.device:
    """``device`` as a torch.device; None means :func:`default_device`."""
    return default_device() if device is None else torch.device(device)
