"""Edge → atom scatter sum (twin of ``allegro_tpu/nn/edgewise.py``, "sum").

Padded edges carry exactly-zero fields and the sentinel center, which the
segment sum drops.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..data import keys
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
        out[self.out_field] = segment_sum(
            x, data[keys.EDGE_INDEX][0], data[keys.POSITIONS].shape[0]
        )
        return out
