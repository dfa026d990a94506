"""Two-body spherical-harmonic tensor embedding (twin of
``allegro_tpu/nn/tensor_embed.py``).

Edge unit vectors → real spherical harmonics (``EDGE_ATTRS``), weighted into
``mul`` channels by a linear projection of the scalar embedding
(``EDGE_FEATURE_WEIGHTS``, always emitted), giving the initial tensor track
``EDGE_FEATURES`` in the flat dim-major layout ``[E, dim*mul]``.

``build_features=False`` leaves ``EDGE_FEATURES`` out, for a consumer that
reads the factors only (the mega-fused layer 0 builds the features inside
its kernel). Under ``jit``, JAX drops the unused array by itself; eager
PyTorch would compute it. ``tensor_dtype``: the features' storage, as in
JAX (the bf16 track stores them in bfloat16; where it is on, the port's
mega layer 0 builds its own from the factors and these are not built).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..data import keys
from ..lib.irreps import Irreps
from ..lib.spherical_harmonics import spherical_harmonics
from .channels import MakeWeightedChannels
from .edge_geometry import with_edge_vectors
from .mlp import ScalarMLP


class TwoBodySphericalHarmonicTensorEmbed(nn.Module):
    def __init__(self, irreps_sh: str, mul: int, embed_dim: int, dtype=torch.float32,
                 build_features: bool = True, tensor_dtype=None):
        super().__init__()
        self.irreps_sh = Irreps(irreps_sh)
        self.dtype = dtype
        self.tensor_dtype = tensor_dtype or dtype
        self.build_features = build_features
        self.weighter = MakeWeightedChannels(self.irreps_sh, mul)
        self.env_embed_linear = ScalarMLP(
            embed_dim, self.weighter.weight_numel, hidden_dims=(), dtype=dtype
        )

    def forward(self, data: Dict) -> Dict:
        data = with_edge_vectors(data)
        ls = [mi.ir.l for mi in self.irreps_sh]
        sh = spherical_harmonics(ls, data[keys.EDGE_VECTORS], normalize=True).to(self.dtype)
        weights = self.env_embed_linear(data[keys.EDGE_EMBEDDING])
        out = dict(data)
        out[keys.EDGE_ATTRS] = sh
        out[keys.EDGE_FEATURE_WEIGHTS] = weights
        if self.build_features:
            # padded edges: weights are exactly 0 (zero embedding, bias-free
            # linear), so the features vanish there
            out[keys.EDGE_FEATURES] = self.weighter.flat_dim_major(sh, weights).to(
                self.tensor_dtype)
        return out
