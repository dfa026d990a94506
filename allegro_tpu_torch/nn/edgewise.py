"""Edge → atom scatter sum (twin of ``allegro_tpu/nn/edgewise.py``, "sum").

With the CSR statics (``CENTER_ROW_PTR``) the sum is the ``center_sum``
kernel, whose transpose (the per-atom cotangent gathered to the edges) is
``center_gather``; otherwise a plain segment sum. Padded edges carry
exactly-zero fields and the sentinel center, which both drop.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..data import keys
from ..ops.fused_primitives import center_scatter
from ..ops.fused_tp import segment_sum


class EdgewiseReduce:
    def __init__(self, field: str = keys.EDGE_ENERGY, out_field: str = keys.PER_ATOM_ENERGY,
                 factor: Optional[float] = None):
        self.field = field
        self.out_field = out_field
        self.factor = factor

    def __call__(self, data: Dict) -> Dict:
        x = data[self.field]
        if self.factor is not None:
            x = x * self.factor
        out = dict(data)
        centers = data[keys.EDGE_INDEX][0]
        if keys.CENTER_ROW_PTR in data:
            out[self.out_field] = center_scatter(
                x.contiguous(), centers.to(torch.int32).contiguous(), data[keys.CENTER_ROW_PTR]
            )
        else:
            out[self.out_field] = segment_sum(x, centers, data[keys.POSITIONS].shape[0])
        return out
