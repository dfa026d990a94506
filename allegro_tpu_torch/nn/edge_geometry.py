"""Edge geometry: vectors, lengths, normalized lengths, edge types.

Twin of ``allegro_tpu/nn/edge_geometry.py``. Edge vectors are
``pos[j] - pos[i] + shift @ cell``. With the CSR statics of
``Model.precompute_statics`` (``CENTER_ROW_PTR``, ``NBR_PERM``,
``NBR_ROW_PTR``) both position gathers go through the ``center_gather``
kernel, whose transpose, the force scatter, is the ``center_sum`` kernel over
the center and the neighbor CSR; sentinel edges read zero rows there.
Without them (the ``einsum`` reference) the indices are clamped to the
atom range, as JAX's ``mode="clip"``. Either way padded (sentinel) edges get
``vec == 0``. A batch of several periodic frames reads each edge's cell
through a product with the one-hot of the edges' frames, so the virial's
sum over edges needs no ``index_add`` either.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data import keys
from ..ops.fused_primitives import center_gather
from .atomwise import frame_one_hot


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
            # each edge's cell as a product with the one-hot of the edges'
            # frames: its transpose, the virial's sum over a frame's edges,
            # adds in a fixed order (a gather's would be an index_add)
            centers = data[keys.EDGE_INDEX][0].long().clamp(0, n - 1)
            edge_frame = data[keys.BATCH].long().index_select(0, centers)
            onehot = frame_one_hot(edge_frame, cell.shape[0], vec.dtype)  # [F, E]
            edge_cell = (onehot.T @ cell.to(vec.dtype).reshape(-1, 9)).reshape(-1, 3, 3)
            vec = vec + torch.einsum("es,esr->er", shift, edge_cell)
    out = dict(data)
    out[keys.EDGE_VECTORS] = vec
    # NaN-safe norm: d|v|/dv at v = 0 is NaN and would poison the force
    # gradient of padded edges; the double where keeps it finite (r = 0 there)
    # a bfloat16 vec (bfloat16 positions) squared and summed in float32 and
    # rounded once, as XLA reduces JAX's bfloat16 sum(vec * vec)
    wide = vec.float() if vec.dtype == torch.bfloat16 else vec
    n2 = (wide * wide).sum(dim=-1, keepdim=True).to(vec.dtype)
    safe = torch.where(n2 > 0, n2, torch.ones_like(n2))
    out[keys.EDGE_LENGTH] = torch.where(n2 > 0, torch.sqrt(safe), torch.zeros_like(n2))
    return out


class EdgeLengthNormalizer(torch.nn.Module):
    """``NORM_LENGTH = r / r_max``, or ``r / cutoff[EDGE_TYPE]`` with
    per-edge-type cutoffs, and the flattened ``EDGE_TYPE = center_type *
    n_types + neighbor_type``.

    ``per_edge_type_cutoff`` is a [n_types, n_types] matrix (center type by
    neighbor type, each <= r_max), kept flattened as a non-persistent buffer
    (checkpoints do not change). An edge beyond its pair's cutoff gets
    ``NORM_LENGTH > 1``, where the cutoff envelope and so the edge's whole
    contribution are exactly zero."""

    def __init__(self, r_max: float, num_types: int,
                 per_edge_type_cutoff: Optional[np.ndarray] = None):
        super().__init__()
        self.r_max = float(r_max)
        self.num_types = int(num_types)
        self.flat_cutoffs: Optional[torch.Tensor]
        if per_edge_type_cutoff is None:
            self.register_buffer("flat_cutoffs", None, persistent=False)
        else:
            cut = np.asarray(per_edge_type_cutoff, dtype=np.float64)
            if cut.shape != (num_types, num_types):
                raise ValueError(f"per_edge_type_cutoff must be [{num_types}, {num_types}], "
                                 f"got {cut.shape}")
            if not (cut <= r_max + 1e-12).all():
                raise ValueError("per-edge-type cutoffs must be <= r_max")
            self.register_buffer("flat_cutoffs", torch.from_numpy(cut.reshape(-1).copy()),
                                 persistent=False)

    def forward(self, data: Dict) -> Dict:
        data = with_edge_vectors(data)
        out = dict(data)
        if keys.EDGE_TYPE not in data:
            types = data[keys.ATOM_TYPES].long()
            n = types.shape[0]
            ei = data[keys.EDGE_INDEX].long().clamp(0, n - 1)
            out[keys.EDGE_TYPE] = (
                types.index_select(0, ei[0]) * self.num_types + types.index_select(0, ei[1])
            ).to(torch.int32)
        r = data[keys.EDGE_LENGTH]
        if self.flat_cutoffs is None:
            out[keys.NORM_LENGTH] = r / self.r_max
        else:
            rc = self.flat_cutoffs.to(r.dtype).index_select(0, out[keys.EDGE_TYPE].long())
            out[keys.NORM_LENGTH] = r / rc[:, None]
        return out
