"""Edge geometry: vectors, lengths, normalized lengths, edge types.

Twin of ``allegro_tpu/nn/edge_geometry.py``. Edge vectors are
``pos[j] - pos[i] + shift @ cell``. With the CSR statics of
``Model.precompute_statics`` (``CENTER_ROW_PTR``, ``NBR_PERM``,
``NBR_ROW_PTR``) both position gathers go through the ``center_gather``
kernel, whose transpose, the force scatter, is the ``center_sum`` kernel over
the center and the neighbor CSR; sentinel edges read zero rows there.
Without them the indices are clamped to the atom range, as JAX's
``mode="clip"``. Either way padded (sentinel) edges get ``vec == 0``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..data import keys
from ..ops.fused_primitives import center_gather


def with_edge_vectors(data: Dict) -> Dict:
    """Attach EDGE_VECTORS/EDGE_LENGTH (kept if already present)."""
    if keys.EDGE_VECTORS in data and keys.EDGE_LENGTH in data:
        return data
    pos = data[keys.POSITIONS]
    n = pos.shape[0]
    if keys.CENTER_ROW_PTR in data:
        # exact position gathers (copies) through the kernels
        ei = data[keys.EDGE_INDEX].to(torch.int32)
        p = pos.contiguous()
        vec = center_gather(
            p, ei[1].contiguous(), data[keys.NBR_ROW_PTR], data[keys.NBR_PERM]
        ) - center_gather(p, ei[0].contiguous(), data[keys.CENTER_ROW_PTR])
    else:
        centers = data[keys.EDGE_INDEX][0].long().clamp(0, n - 1)
        neighbors = data[keys.EDGE_INDEX][1].long().clamp(0, n - 1)
        vec = pos.index_select(0, neighbors) - pos.index_select(0, centers)
    if keys.CELL in data and keys.EDGE_CELL_SHIFT in data:
        cell = data[keys.CELL]
        if cell.ndim == 2:
            cell = cell[None]
        shift = data[keys.EDGE_CELL_SHIFT].to(vec.dtype)
        if cell.shape[0] == 1 or keys.BATCH not in data:
            vec = vec + shift @ cell[0].to(vec.dtype)
        else:
            centers = data[keys.EDGE_INDEX][0].long().clamp(0, n - 1)
            edge_frame = data[keys.BATCH].long().index_select(0, centers)
            edge_cell = cell.to(vec.dtype).index_select(0, edge_frame)  # [E, 3, 3]
            vec = vec + torch.einsum("es,esr->er", shift, edge_cell)
    out = dict(data)
    out[keys.EDGE_VECTORS] = vec
    # NaN-safe norm: d|v|/dv at v = 0 is NaN and would poison the force
    # gradient of padded edges; the double where keeps it finite (r = 0 there)
    n2 = (vec * vec).sum(dim=-1, keepdim=True)
    safe = torch.where(n2 > 0, n2, torch.ones_like(n2))
    out[keys.EDGE_LENGTH] = torch.where(n2 > 0, torch.sqrt(safe), torch.zeros_like(n2))
    return out


class EdgeLengthNormalizer:
    """``NORM_LENGTH = r / r_max`` and the flattened
    ``EDGE_TYPE = center_type * n_types + neighbor_type`` (stateless)."""

    def __init__(self, r_max: float, num_types: int):
        self.r_max = float(r_max)
        self.num_types = int(num_types)

    def __call__(self, data: Dict) -> Dict:
        data = with_edge_vectors(data)
        out = dict(data)
        if keys.EDGE_TYPE not in data:
            types = data[keys.ATOM_TYPES].long()
            n = types.shape[0]
            ei = data[keys.EDGE_INDEX].long().clamp(0, n - 1)
            out[keys.EDGE_TYPE] = (
                types.index_select(0, ei[0]) * self.num_types + types.index_select(0, ei[1])
            ).to(torch.int32)
        out[keys.NORM_LENGTH] = data[keys.EDGE_LENGTH] / self.r_max
        return out
