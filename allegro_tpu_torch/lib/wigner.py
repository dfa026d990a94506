"""Wigner D matrices and real-basis Wigner 3j coupling tensors.

NumPy twin of ``allegro_tpu/lib/wigner.py`` (same construction, same seeds,
so the tables agree to machine precision). Replaces ``e3nn.o3.wigner_3j`` as
consumed by the reference Contracter (``allegro/nn/_strided/_contract.py``).
All tables are computed once on the host in float64.

Self-consistent construction (no external convention to match):

1. ``wigner_D(l, R)`` is *defined* by our real spherical harmonics:
   ``Y^l(R x) = D^l(R) Y^l(x)``. Since ``Y^l`` are exact homogeneous
   polynomials, a least-squares solve over sample points recovers ``D^l`` to
   machine precision.
2. ``wigner_3j(l1, l2, l3)`` is the (unique up to sign/scale) tensor ``C``
   with ``C = (D^{l1} ⊗ D^{l2} ⊗ D^{l3}) C`` for all rotations — computed as
   the null space of stacked ``(D1⊗D2⊗D3 - I)`` constraints for a few fixed
   pseudo-random rotations, normalized to unit Frobenius norm with a
   deterministic sign.

Equivariance of anything built from these tensors then holds by construction
and is verified in ``tests/lib/test_wigner.py``.
"""

from __future__ import annotations

import functools

import numpy as np

from .spherical_harmonics import _real_sh_numeric


def rand_rotation(rng: np.random.RandomState) -> np.ndarray:
    """Uniform random proper rotation matrix (3x3, det=+1), float64."""
    A = rng.randn(3, 3)
    Q, R = np.linalg.qr(A)
    Q = Q * np.sign(np.diag(R))
    if np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    return Q


def rand_o3_matrix(rng: np.random.RandomState) -> np.ndarray:
    """Random O(3) matrix: rotation times (maybe) inversion."""
    R = rand_rotation(rng)
    if rng.rand() < 0.5:
        R = -R
    return R


def wigner_D(l: int, R: np.ndarray) -> np.ndarray:
    """Real-basis Wigner D matrix: ``Y^l(R x) = wigner_D(l, R) @ Y^l(x)``.

    ``R`` must be a proper rotation. For an O(3) element ``g = (-1)^s R`` with
    parity ``p``, the representation matrix on irrep ``(l, p)`` is
    ``p^s * wigner_D(l, R)``.
    """
    if l == 0:
        return np.ones((1, 1))
    rng = np.random.RandomState(777 + l)
    n = 6 * (2 * l + 1) + 20
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    A = _real_sh_numeric(l, v)  # [n, 2l+1]
    B = _real_sh_numeric(l, v @ R.T)  # [n, 2l+1]
    # Solve A @ D.T = B  →  D = lstsq(A, B).T
    D, _, _, _ = np.linalg.lstsq(A, B, rcond=None)
    D = D.T
    resid = np.abs(A @ D.T - B).max()
    assert resid < 1e-9, f"wigner_D solve failed for l={l}: resid={resid}"
    return D


@functools.lru_cache(maxsize=None)
def wigner_3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis 3j coupling tensor, shape [2l1+1, 2l2+1, 2l3+1], float64.

    Unit Frobenius norm, deterministic sign (first entry > 1e-8 in flat order
    is positive). Zero tensor when the triangle inequality fails. Symmetric
    under simultaneous permutation of (l, axis) — not explicitly enforced, but
    holds up to sign by uniqueness.
    """
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    rng = np.random.RandomState(1000 * l1 + 100 * l2 + 10 * l3 + 3)
    mats = []
    for _ in range(3):
        R = rand_rotation(rng)
        D = np.kron(np.kron(wigner_D(l1, R), wigner_D(l2, R)), wigner_D(l3, R))
        mats.append(D - np.eye(d1 * d2 * d3))
    M = np.concatenate(mats, axis=0)
    _, s, vh = np.linalg.svd(M, full_matrices=True)
    # Null space must be exactly 1-dimensional for triangle-allowed l's.
    tol = 1e-7
    null_dim = int(np.sum(s < tol)) + (vh.shape[0] - len(s))
    assert null_dim == 1, (
        f"wigner_3j({l1},{l2},{l3}): expected 1-dim invariant subspace, "
        f"got {null_dim} (smallest singular values {s[-3:]})"
    )
    c = vh[-1]
    c = c / np.linalg.norm(c)
    # Deterministic sign.
    nz = np.nonzero(np.abs(c) > 1e-8)[0]
    if c[nz[0]] < 0:
        c = -c
    c[np.abs(c) < 1e-12] = 0.0
    return c.reshape(d1, d2, d3)
