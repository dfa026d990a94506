"""Real spherical harmonics as homogeneous polynomials in (x, y, z).

PyTorch twin of ``allegro_tpu/lib/spherical_harmonics.py``: the monomial
coefficient tables are fitted once on the host in float64 with NumPy (same
seeds and fit, so they agree with the JAX package to machine precision), and
the evaluation is ``monomials @ coeffs`` in torch.

Conventions: basis order ``m = -l..l`` within degree ``l``; "component"
normalization (``|Y^l(x)|^2 = 2l+1`` for unit ``x``); ``Y^1(x) = sqrt(3) *
(y, z, x)``; real-SH phase with the Condon–Shortley phase cancelled.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch


def monomial_exponents(l: int) -> List[Tuple[int, int, int]]:
    """Deterministic ordering of the degree-``l`` monomials x^a y^b z^c."""
    return [(a, b, l - a - b) for a in range(l, -1, -1) for b in range(l - a, -1, -1)]


def _real_sh_numeric(l: int, xyz: np.ndarray) -> np.ndarray:
    """Reference real SH values on unit vectors, shape [N, 2l+1], float64
    (direct associated-Legendre construction, host only)."""
    from scipy.special import lpmv

    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    ct = np.clip(z, -1.0, 1.0)
    phi = np.arctan2(y, x)
    out = np.zeros((xyz.shape[0], 2 * l + 1))
    for m in range(0, l + 1):
        # lpmv includes the Condon–Shortley (-1)^m; cancel it
        plm = lpmv(m, l, ct) * ((-1.0) ** m)
        nrm = np.sqrt(
            (2 * l + 1) * float(math.factorial(l - m)) / float(math.factorial(l + m))
        )
        if m == 0:
            out[:, l] = nrm * plm
        else:
            out[:, l + m] = np.sqrt(2.0) * nrm * plm * np.cos(m * phi)
            out[:, l - m] = np.sqrt(2.0) * nrm * plm * np.sin(m * phi)
    return out


@functools.lru_cache(maxsize=None)
def sh_coefficients(l: int) -> np.ndarray:
    """Monomial coefficients of degree-``l`` real SH: [n_monomials(l), 2l+1]."""
    if l == 0:
        return np.ones((1, 1))
    exps = monomial_exponents(l)
    rng = np.random.RandomState(12345 + l)
    n = 8 * len(exps) + 32
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    A = np.stack([v[:, 0] ** a * v[:, 1] ** b * v[:, 2] ** c for a, b, c in exps], axis=1)
    B = _real_sh_numeric(l, v)
    coeffs, _, _, _ = np.linalg.lstsq(A, B, rcond=None)
    resid = np.abs(A @ coeffs - B).max()
    if resid >= 1e-10:
        raise RuntimeError(f"SH polynomial fit failed for l={l}: resid={resid}")
    coeffs[np.abs(coeffs) < 1e-12] = 0.0
    return coeffs


@functools.lru_cache(maxsize=None)
def _device_coefficients(l: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``sh_coefficients(l)`` on ``device``, uploaded once: an upload per
    call would make the host wait for the device."""
    return torch.as_tensor(sh_coefficients(l), dtype=dtype, device=device)


def spherical_harmonics(
    ls: Union[int, Sequence[int]],
    vectors: torch.Tensor,
    normalize: bool = True,
    eps: float = 1e-12,
) -> torch.Tensor:
    """Real spherical harmonics of ``vectors`` [..., 3] for the given degrees.

    ``ls`` is an int ``lmax`` (degrees ``0..lmax``) or a list of degrees.
    With ``normalize``, zero vectors (padding) map to zero for ``l > 0`` and
    to the constant for ``l = 0``. Returns [..., sum(2l+1)].
    """
    if isinstance(ls, int):
        ls = list(range(ls + 1))
    ls = list(ls)
    lmax = max(ls) if ls else 0
    v = vectors
    if normalize:
        # bfloat16 vectors squared and summed in float32, rounded once (XLA's
        # reduction of JAX's bfloat16 sum(v * v))
        wide = v.float() if v.dtype == torch.bfloat16 else v
        n2 = (wide * wide).sum(dim=-1, keepdim=True).to(v.dtype)
        inv = torch.where(n2 > eps, 1.0 / torch.sqrt(n2.clamp_min(eps)), torch.zeros_like(n2))
        v = v * inv
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    xs, ys, zs = [torch.ones_like(x)], [torch.ones_like(y)], [torch.ones_like(z)]
    for _ in range(lmax):
        xs.append(xs[-1] * x)
        ys.append(ys[-1] * y)
        zs.append(zs[-1] * z)
    blocks = []
    for l in ls:
        monos = torch.stack(
            [xs[a] * ys[b] * zs[c] for (a, b, c) in monomial_exponents(l)], dim=-1
        )
        blocks.append(monos @ _device_coefficients(l, v.dtype, v.device))
    return torch.cat(blocks, dim=-1)
