"""Per-class smooth spline over the normalized edge length (twin of
``allegro_tpu/nn/spline.py``).

``num_splines`` = K bumps; ``spline_span`` = s is the integer number of
bumps that overlap at a grid point. Bump k lives on ``[lower_k, lower_k +
diff]`` with ``lower_k = (k - s)/K`` and ``diff = (s + 1)/K``, where it is
``0.25 (1 - cos(2π (x - lower_k)/diff))²``; the last bump ends at x = 1, so
every bump, and the embedding, vanishes smoothly at the cutoff. The weights
are initialized ``U(-√(3/s), √(3/s))`` (about s bumps overlap anywhere).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.fused_primitives import table_rows


def spline_basis(x: torch.Tensor, num_splines: int, spline_span: int) -> torch.Tensor:
    """The bump basis on [0, 1]: ``x [...]`` → ``[..., num_splines]``."""
    if not 0 <= spline_span <= num_splines or num_splines < 1:
        raise ValueError(f"spline_span {spline_span} must lie in [0, num_splines={num_splines}]")
    K, s = num_splines, int(spline_span)
    lower = (torch.arange(K, dtype=x.dtype, device=x.device) - s) / K
    diff = (s + 1) / K
    t = (2.0 * math.pi / diff) * (torch.minimum(torch.maximum(x[..., None], lower),
                                                lower + diff) - lower)
    return 0.25 * (1.0 - torch.cos(t)) ** 2


class PerClassSpline(nn.Module):
    """``(x [E], class_idx [E]) → [E, channels]``: a learned spline per class,
    parameter ``spline_weights [num_classes, channels, num_splines]``, read
    per edge by its class and contracted with the basis, as JAX's
    ``jnp.take`` and ``einsum``: ``[E, channels, K]`` whatever the class
    count. With the lookup's class CSR (``csr``) the weights are read with
    ``center_gather``, so their gradient sums in a fixed order
    (:func:`~allegro_tpu_torch.ops.fused_primitives.table_rows`)."""

    def __init__(self, num_classes: int, channels: int, num_splines: int = 16,
                 spline_span: int = 12, dtype=torch.float32):
        super().__init__()
        self.num_classes = int(num_classes)
        self.num_splines = int(num_splines)
        self.spline_span = int(spline_span)
        self.spline_weights = nn.Parameter(
            torch.empty(self.num_classes, int(channels), self.num_splines, dtype=dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = math.sqrt(3.0 / max(self.spline_span, 1))
        v = torch.rand(tuple(self.spline_weights.shape), generator=generator,
                       dtype=torch.float64)
        with torch.no_grad():
            self.spline_weights.copy_((2.0 * v - 1.0) * bound)

    def forward(self, x: torch.Tensor, class_idx: torch.Tensor, csr=None) -> torch.Tensor:
        basis = spline_basis(x, self.num_splines, self.spline_span)  # [E, K]
        cls = class_idx.long().clamp(0, self.num_classes - 1)
        w = table_rows(self.spline_weights.to(basis.dtype), cls, csr)  # [E, channels, K]
        return torch.einsum("ek,eck->ec", basis, w)
