"""Two-body radial × chemistry scalar embedding (twin of the Bessel half of
``allegro_tpu/nn/scalar_embed.py``).

``TwoBodyBesselScalarEmbed`` writes ``EDGE_EMBEDDING`` and ``EDGE_CUTOFF``,
multiplied by ``EDGE_MASK``, which keeps every padded edge identically zero
through the whole network.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..data import keys
from .cutoffs import PolynomialCutoff, bessel_basis
from .mlp import ScalarMLP


def _edge_mask(data: Dict, like: torch.Tensor) -> torch.Tensor:
    if keys.EDGE_MASK in data:
        return data[keys.EDGE_MASK].to(like.dtype)[:, None]
    return torch.ones((like.shape[0], 1), dtype=like.dtype, device=like.device)


class OneHotEmbed(nn.Module):
    """Type-embedding table ``[num_embeddings, features]`` (param
    ``embedding``), looked up by exact row selection. JAX multiplies a
    one-hot matrix to keep the TPU's matrix unit busy; a row gather gives the
    same values."""

    def __init__(self, num_embeddings: int, features: int, dtype=torch.float32):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features, dtype=dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax variance_scaling(1.0, "fan_in", "normal", out_axis=0) on a
        # [T, D] table: fan_in = D
        v = torch.randn(tuple(self.embedding.shape), generator=generator, dtype=torch.float64)
        with torch.no_grad():
            self.embedding.copy_(v / self.embedding.shape[1] ** 0.5)

    def forward(self, indices: torch.Tensor) -> torch.Tensor:
        return self.embedding.index_select(0, indices.long())


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

    def forward(self, radial_basis, center_types, neighbor_types):
        chem = torch.cat(
            [self.center_type_embed(center_types), self.neighbor_type_embed(neighbor_types)],
            dim=-1,
        )
        return self.radial_proj(radial_basis) * chem


class TwoBodyBesselScalarEmbed(nn.Module):
    """Bessel(norm_length) × polynomial cutoff → ProductTypeEmbedding."""

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
        emb = self.product_type_embed(radial, et // self.num_types, et % self.num_types)
        out = dict(data)
        mask = _edge_mask(data, emb)
        out[keys.EDGE_CUTOFF] = cutoff * mask
        out[keys.EDGE_EMBEDDING] = emb * mask
        return out
