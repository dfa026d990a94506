"""Per-type energy scale/shift and atom → frame sum (twin of
``allegro_tpu/nn/atomwise.py``). Both mask by ``NODE_MASK`` so padded atoms
add nothing to total energies."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..data import keys
from ..ops.fused_tp import segment_sum


class PerTypeScaleShift(nn.Module):
    """Fixed scales/shifts are non-persistent buffers; trainable ones are the
    parameters ``scales``/``shifts`` (the JAX package's names)."""

    def __init__(
        self,
        num_types: int,
        scales: Optional[Union[float, Sequence[float]]] = None,
        shifts: Optional[Union[float, Sequence[float]]] = None,
        scales_trainable: bool = False,
        shifts_trainable: bool = False,
        dtype=torch.float32,
    ):
        super().__init__()
        for name, value, trainable in (("scales", scales, scales_trainable),
                                       ("shifts", shifts, shifts_trainable)):
            if value is None:
                setattr(self, name, None)
                continue
            t = torch.as_tensor(np.asarray(value, dtype=np.float64) * np.ones(num_types), dtype=dtype)
            if trainable:
                self.register_parameter(name, nn.Parameter(t))
            else:
                self.register_buffer(name, t, persistent=False)

    def forward(self, data: Dict) -> Dict:
        x = data[keys.PER_ATOM_ENERGY]
        types = data[keys.ATOM_TYPES].long()
        if self.scales is not None:
            x = x * self.scales.to(x.dtype).index_select(0, types)[:, None]
        if self.shifts is not None:
            x = x + self.shifts.to(x.dtype).index_select(0, types)[:, None]
        if keys.NODE_MASK in data:
            x = x * data[keys.NODE_MASK].to(x.dtype)[:, None]
        out = dict(data)
        out[keys.PER_ATOM_ENERGY] = x
        return out


class AtomwiseReduce:
    """Per-frame sum of the per-atom energies into TOTAL_ENERGY, masked by
    NODE_MASK."""

    def __call__(self, data: Dict) -> Dict:
        x = data[keys.PER_ATOM_ENERGY]
        if keys.NODE_MASK in data:
            x = x * data[keys.NODE_MASK].to(x.dtype)[:, None]
        out = dict(data)
        if keys.BATCH in data:
            n_frames = (
                data[keys.CELL].shape[0] if keys.CELL in data else int(data[keys.NUM_NODES].shape[0])
            )
            out[keys.TOTAL_ENERGY] = segment_sum(x, data[keys.BATCH], n_frames)
        else:
            out[keys.TOTAL_ENERGY] = x.sum(dim=0, keepdim=True)
        return out
