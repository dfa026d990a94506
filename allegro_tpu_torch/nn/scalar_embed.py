"""Two-body radial × chemistry scalar embeddings (twin of
``allegro_tpu/nn/scalar_embed.py``).

- ``TwoBodyBesselScalarEmbed``: Bessel radial basis × polynomial cutoff,
  times a product of center and neighbor type embeddings.
- ``TwoBodySplineScalarEmbed``: a learned spline of the normalized length
  per edge type (center type × neighbor type).

Both write ``EDGE_EMBEDDING`` and ``EDGE_CUTOFF``, multiplied by
``EDGE_MASK``, which keeps every padded edge identically zero through the
whole network.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..data import keys
from ..ops.fused_primitives import table_rows
from .cutoffs import PolynomialCutoff, bessel_basis
from .mlp import ScalarMLP
from .spline import PerClassSpline


def class_csr(data: Dict, lookup: str):
    """A lookup's class CSR statics ``(idx, row_ptr, perm)`` from ``data``,
    or None where the batch has none (the ``einsum`` reference)."""
    names = keys.class_csr_keys(lookup)
    return tuple(data[k] for k in names) if names[0] in data else None


def _edge_mask(data: Dict, like: torch.Tensor) -> torch.Tensor:
    if keys.EDGE_MASK in data:
        return data[keys.EDGE_MASK].to(like.dtype)[:, None]
    return torch.ones((like.shape[0], 1), dtype=like.dtype, device=like.device)


class OneHotEmbed(nn.Module):
    """Type-embedding table ``[num_embeddings, features]`` (param
    ``embedding``), looked up by exact row selection. JAX multiplies a
    one-hot matrix to keep the TPU's matrix unit busy; a row gather gives the
    same values. With the lookup's class CSR (``csr``) the rows are read with
    ``center_gather``, whose transpose sums the table's gradient in a fixed
    order (:func:`~allegro_tpu_torch.ops.fused_primitives.table_rows`)."""

    def __init__(self, num_embeddings: int, features: int, dtype=torch.float32):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features, dtype=dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax variance_scaling(1.0, "fan_in", "normal", out_axis=0) on a
        # [T, D] table: fan_in = D
        v = torch.randn(tuple(self.embedding.shape), generator=generator, dtype=torch.float64)
        with torch.no_grad():
            self.embedding.copy_(v / self.embedding.shape[1] ** 0.5)

    def forward(self, indices: torch.Tensor, csr=None) -> torch.Tensor:
        return table_rows(self.embedding, indices, csr)


class ProductTypeEmbedding(nn.Module):
    """Center/neighbor type embeddings of ``dim/2`` each, concatenated, times
    a linear projection of the radial basis."""

    def __init__(self, num_types: int, num_basis: int, dim: int, dtype=torch.float32):
        super().__init__()
        if dim % 2:
            raise ValueError("embedding dim must be even")
        self.radial_proj = ScalarMLP(num_basis, dim, hidden_dims=(), dtype=dtype)
        self.center_type_embed = OneHotEmbed(num_types, dim // 2, dtype)
        self.neighbor_type_embed = OneHotEmbed(num_types, dim // 2, dtype)

    def forward(self, radial_basis, center_types, neighbor_types, center_csr=None,
                neighbor_csr=None):
        chem = torch.cat(
            [self.center_type_embed(center_types, center_csr),
             self.neighbor_type_embed(neighbor_types, neighbor_csr)],
            dim=-1,
        )
        return self.radial_proj(radial_basis) * chem


class TwoBodyBesselScalarEmbed(nn.Module):
    """Bessel(norm_length) × polynomial cutoff → ProductTypeEmbedding."""

    class_lookups = (keys.CENTER_TYPE_LOOKUP, keys.NEIGHBOR_TYPE_LOOKUP)

    def __init__(self, num_types: int, output_dim: int = 64, num_bessels: int = 8,
                 polynomial_cutoff_p: int = 6, dtype=torch.float32):
        super().__init__()
        self.num_types = int(num_types)
        self.num_bessels = int(num_bessels)
        self.cutoff = PolynomialCutoff(polynomial_cutoff_p)
        self.dtype = dtype
        self.product_type_embed = ProductTypeEmbedding(num_types, num_bessels, output_dim, dtype)

    def forward(self, data: Dict) -> Dict:
        u = data[keys.NORM_LENGTH][:, 0]
        cutoff = self.cutoff(u)[:, None].to(self.dtype)
        radial = bessel_basis(u, self.num_bessels).to(self.dtype) * cutoff
        et = data[keys.EDGE_TYPE].long()
        emb = self.product_type_embed(radial, et // self.num_types, et % self.num_types,
                                      class_csr(data, keys.CENTER_TYPE_LOOKUP),
                                      class_csr(data, keys.NEIGHBOR_TYPE_LOOKUP))
        out = dict(data)
        mask = _edge_mask(data, emb)
        out[keys.EDGE_CUTOFF] = cutoff * mask
        out[keys.EDGE_EMBEDDING] = emb * mask
        return out


class TwoBodySplineScalarEmbed(nn.Module):
    """Per-edge-type spline of the normalized length → ``EDGE_EMBEDDING``.
    The spline basis vanishes smoothly at the cutoff by itself, so the
    embedding takes no cutoff envelope; ``EDGE_CUTOFF`` is still attached
    for downstream consumers (ZBL). The spline runs in the geometry's dtype
    and is cast to the model dtype at the end, as in JAX."""

    class_lookups = (keys.EDGE_CLASS_LOOKUP,)

    def __init__(self, num_types: int, output_dim: int = 64, num_splines: int = 16,
                 spline_span: int = 12, polynomial_cutoff_p: int = 6, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.cutoff = PolynomialCutoff(polynomial_cutoff_p)
        self.spline = PerClassSpline(num_types * num_types, output_dim, num_splines,
                                     spline_span, dtype)

    def forward(self, data: Dict) -> Dict:
        u = data[keys.NORM_LENGTH][:, 0]
        emb = self.spline(u, data[keys.EDGE_TYPE],
                          class_csr(data, keys.EDGE_CLASS_LOOKUP)).to(self.dtype)
        out = dict(data)
        mask = _edge_mask(data, emb)
        out[keys.EDGE_CUTOFF] = self.cutoff(u)[:, None].to(emb.dtype) * mask
        out[keys.EDGE_EMBEDDING] = emb * mask
        return out
