"""Radial basis and cutoff envelope (twin of ``allegro_tpu/nn/cutoffs.py``)."""

from __future__ import annotations

import math

import torch


class PolynomialCutoff:
    """Smooth envelope ``f(u)`` on ``u = r/r_max``: ``f(0)=1``, ``f(1)=0``,
    ``p``-th order flat at both ends, exactly zero for ``u >= 1``."""

    def __init__(self, p: int = 6):
        self.p = int(p)

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        p = float(self.p)
        u = u.clamp(0.0, 1.0)
        return (
            1.0
            - ((p + 1.0) * (p + 2.0) / 2.0) * u**p
            + p * (p + 2.0) * u ** (p + 1.0)
            - (p * (p + 1.0) / 2.0) * u ** (p + 2.0)
        )


def bessel_basis(u: torch.Tensor, num_bessels: int, eps: float = 1e-10) -> torch.Tensor:
    """``b_n(u) = sqrt(2) sin(n π u) / u`` for ``n = 1..num_bessels``; the
    ``u → 0`` limit ``sqrt(2) n π`` on padded (zero-length) edges."""
    n = torch.arange(1, num_bessels + 1, dtype=u.dtype, device=u.device) * math.pi
    small = (u.abs() < eps)[..., None]
    safe_u = torch.where(u.abs() < eps, torch.full_like(u, eps), u)[..., None]
    out = torch.where(small, n.expand(*u.shape, num_bessels), torch.sin(u[..., None] * n) / safe_u)
    return math.sqrt(2.0) * out
