"""The device, or the devices, an entry point runs on."""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

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
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def visible_cards() -> List[torch.device]:
    """Every CUDA card this process sees, ``cuda:0`` first (JAX's
    ``jax.devices()``); raises as :func:`resolve_device` does without one."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def resolve_mesh(mesh: Optional[Sequence] = None, device=None) -> List[torch.device]:
    """A mesh as a list of devices, in the role of a JAX device mesh run by
    one process: ``mesh`` (an entry may repeat: ``["cpu"] * D`` plays JAX's
    virtual host devices, ``[cuda:0] * D`` runs D domains or rows on one
    card), or ``[device]`` when ``mesh`` is None. Each entry is resolved by
    :func:`resolve_device`, so a CUDA entry carries its index."""
    if mesh is None:
        return [resolve_device(device)]
    if device is not None:
        raise ValueError("pass a mesh or a device, not both")
    if len(mesh) == 0:
        raise ValueError("a mesh needs at least one device")
    return [resolve_device(d) for d in mesh]


def replicate(model, devices: Sequence[torch.device]) -> Dict[torch.device, object]:
    """One model per distinct device of ``devices``: the model itself where
    its parameters are, a copy (``copy.deepcopy``, then ``.to``) on every
    other device. Entries of a mesh on the same device share one model."""
    home = next(model.module.parameters()).device
    out = {}
    for device in devices:
        if device not in out:
            out[device] = model if device == home else copy.deepcopy(model).to(device)
    return out
