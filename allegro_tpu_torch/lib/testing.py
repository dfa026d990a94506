"""O(3) equivariance test utilities (NumPy twin of
``allegro_tpu/lib/testing.py``): apply an O(3) element to features through
block-diagonal Wigner D matrices, so a test can compare ``f(g·x)`` with
``g·f(x)``.
"""

from __future__ import annotations

import numpy as np

from .irreps import Irreps
from .wigner import wigner_D


def rep_matrix(irreps, R: np.ndarray, parity_sign: int = 1) -> np.ndarray:
    """Block-diagonal representation matrix of the O(3) element
    ``(parity, R)`` on the basis of ``irreps`` (each copy of an irrep its own
    block); ``parity_sign=-1`` multiplies each block by its irrep's parity."""
    irreps = Irreps(irreps)
    out = np.zeros((irreps.dim, irreps.dim))
    i = 0
    for mi in irreps:
        D = wigner_D(mi.ir.l, R)
        if parity_sign == -1:
            D = D * mi.ir.p
        for _ in range(mi.mul):
            d = D.shape[0]
            out[i : i + d, i : i + d] = D
            i += d
    return out


def transform_strided(x, irreps, R: np.ndarray, parity_sign: int = 1) -> np.ndarray:
    """Apply an O(3) element to a strided ``[..., mul, dim]`` feature array."""
    D = rep_matrix(irreps, R, parity_sign)
    return np.einsum("...d,kd->...k", np.asarray(x), D)


def transform_flat_dim_major(x, irreps, mul: int, R: np.ndarray,
                             parity_sign: int = 1) -> np.ndarray:
    """The same on the port's flat dim-major track ``[..., dim*mul]``
    (column ``i*mul + u``)."""
    x = np.asarray(x)
    D = rep_matrix(irreps, R, parity_sign)
    xs = x.reshape(*x.shape[:-1], D.shape[0], mul)
    return np.einsum("...du,kd->...ku", xs, D).reshape(x.shape)
