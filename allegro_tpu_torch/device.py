"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card. Raises
    RuntimeError when a CUDA device is asked for (or defaulted to) and
    PyTorch finds none: the entry points never fall back to the CPU
    quietly, a caller who wants it passes ``device="cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: allegro_tpu_torch runs on the GPU by default "
            "(torch.cuda.is_available() is False); pass device='cpu' to run on the CPU"
        )
    return device
