"""Bias-free scalar MLPs (twin of ``allegro_tpu/nn/mlp.py``).

Weights are kept in the JAX orientation ``[fan_in, fan_out]`` and applied as
``x @ w``, drawn ``N(0, 1/fan_in)``. SiLU (or the configured nonlinearity)
sits between layers; ``hidden_dims=()`` is one linear layer. Bias-free is
what keeps padded (zero-embedding) edges exactly zero through every MLP.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch
from torch import nn


def silu(x):
    return torch.nn.functional.silu(x)


def forward_weight_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    """In place: ``N(0, 1/fan_in)`` with ``fan_in = w.shape[0]``, drawn on the
    CPU in float64 so the values do not depend on the device."""
    v = torch.randn(tuple(w.shape), generator=generator, dtype=torch.float64)
    with torch.no_grad():
        w.copy_(v / w.shape[0] ** 0.5)


class ScalarMLP(nn.Module):
    """``[in] -> hidden_dims -> [out]``, parameters ``w0, w1, ...``.

    ``out_col_scale = (start_col, factor)`` scales output columns
    ``[start_col:]`` by ``factor``, folded into the last weight matrix at
    apply time (the fused backend absorbs the env scatter factor there).
    """

    def __init__(
        self,
        in_dim: int,
        output_dim: int,
        hidden_dims: Sequence[int] = (),
        nonlinearity: Optional[Callable] = silu,
        dtype: torch.dtype = torch.float32,
        out_col_scale: Optional[Tuple[int, float]] = None,
    ):
        super().__init__()
        self.dims = (int(in_dim), *map(int, hidden_dims), int(output_dim))
        self.nonlinearity = nonlinearity
        self.out_col_scale = out_col_scale
        for k in range(len(self.dims) - 1):
            self.register_parameter(
                f"w{k}", nn.Parameter(torch.empty(self.dims[k], self.dims[k + 1], dtype=dtype))
            )

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    def reset_parameters(self, generator: torch.Generator) -> None:
        for k in range(self.n_layers):
            forward_weight_init_(getattr(self, f"w{k}"), generator)

    def weights(self):
        """The weight matrices with ``out_col_scale`` folded into the last."""
        ws = [getattr(self, f"w{k}") for k in range(self.n_layers)]
        if self.out_col_scale is not None:
            start, factor = self.out_col_scale
            last = ws[-1]
            ws[-1] = torch.cat([last[:, :start], last[:, start:] * factor], dim=1)
        return ws

    def forward(self, x: Union[torch.Tensor, Sequence[torch.Tensor]]) -> torch.Tensor:
        """``x``: a tensor, or a tuple of tensors read as their concatenation
        along the last axis without building it (the first matmul runs as a
        sum over row blocks of ``w0``)."""
        pieces = tuple(x) if isinstance(x, (tuple, list)) else (x,)
        ws = self.weights()
        h = None
        off = 0
        for p in pieces:
            t = p @ ws[0][off : off + p.shape[-1]].to(p.dtype)
            h = t if h is None else h + t
            off += p.shape[-1]
        if off != self.dims[0]:
            raise ValueError(f"ScalarMLP expects {self.dims[0]} input features, got {off}")
        for w in ws[1:]:
            if self.nonlinearity is not None:
                h = self.nonlinearity(h)
            h = h @ w.to(h.dtype)
        return h
