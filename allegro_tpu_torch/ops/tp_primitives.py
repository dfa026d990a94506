"""The ``pallas`` backend's ``torch.autograd.Function``s (twin of
``allegro_tpu/ops/tp_primitives.py``).

``SparseTp(a, b, w)`` and ``SparseTpGradW(a, b, g)`` form a family closed
under differentiation, JAX's transpose table (``tp_primitives.py:104-122,
175-187``): the TP is trilinear, so every cotangent is again a member on a
permuted entry table (``ops/pallas_contract.py:ROLES``):

- ``SparseTp``: the cotangent of ``a`` is ``SparseTp(g, b, w)`` on the
  a-swapped table (k, j, i), that of ``b`` is ``SparseTp(a, g, w)`` on the
  b-swapped table (i, k, j), that of ``w`` is ``SparseTpGradW(a, b, g)``;
- ``SparseTpGradW``: with its cotangent ``t`` [P, U] in the weight slot, the
  cotangents are ``SparseTp(b, g, t)`` on (j, k, i), ``SparseTp(a, g, t)`` on
  (i, k, j) and ``SparseTp(a, b, t)`` on the table itself.

Each ``backward`` is built from ``.apply`` of the two only, so it is itself
differentiable (the double backward of force training runs on the kernels),
and computes only the cotangents in ``ctx.needs_input_grad``. Both reach
their kernels through ``custom_ops``: the wrappers of
``ops/pallas_contract.py`` eagerly, the ``atpt::sparse_tp`` op inside
``custom_ops.tracing()`` (a force call, whose parameters are frozen, never
reaches ``SparseTpGradW``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import custom_ops as kernels
from .gen_cg_blocks import CgPaths
from .fused_primitives import _need
from .pallas_contract import ROLES

# role maps of the transpose table: the new (i, j, k) in terms of the old
SWAP_A, SWAP_B, GRADW_A = (2, 1, 0), (0, 2, 1), (1, 2, 0)


def compose(r: int, op: Tuple[int, int, int]) -> int:
    """The role order of table ``r`` after the role map ``op``."""
    return ROLES.index(tuple(ROLES[r][s] for s in op))


class TpStatics(NamedTuple):
    """The layer's entry table in all six role orders (``entry_idx`` [6, n, 4]
    int32, ``entry_coef`` [6, n], built once per ``Contracter``), its dims
    ``(d1, d2, d3)`` in order 0, its number of paths and, for the kernels,
    each role order's path table in walk order (``paths[r]``,
    ``gen_cg_blocks.path_table(by_output=True)`` of the float64 entries;
    the plain versions read the entries and need none)."""

    entry_idx: torch.Tensor
    entry_coef: torch.Tensor
    dims: Tuple[int, int, int]
    n_paths: int
    paths: Tuple[CgPaths, ...] = ()

    def table(self, r: int):
        return self.entry_idx[r], self.entry_coef[r]

    def walk(self, r: int) -> Optional[CgPaths]:
        return self.paths[r] if self.paths else None

    def out_dim(self, r: int) -> int:
        return self.dims[ROLES[r][2]]


class SparseTp(torch.autograd.Function):
    """``out [E, d3*U] = Σ c w[p,u] a[e,iU+u] b[e,jU+u]`` on table order ``r``."""

    @staticmethod
    def forward(ctx, a, b, w, st: TpStatics, r: int):
        ctx.save_for_backward(a, b, w)
        ctx.st, ctx.r = st, r
        return kernels.sparse_tp(a, b, w, *st.table(r), st.out_dim(r), st.walk(r))

    @staticmethod
    def backward(ctx, g):
        a, b, w = ctx.saved_tensors
        g, st, r = g.contiguous(), ctx.st, ctx.r
        return (_need(ctx, 0, lambda: SparseTp.apply(g, b, w, st, compose(r, SWAP_A))),
                _need(ctx, 1, lambda: SparseTp.apply(a, g, w, st, compose(r, SWAP_B))),
                _need(ctx, 2, lambda: SparseTpGradW.apply(a, b, g, st, r)), None, None)


class SparseTpGradW(torch.autograd.Function):
    """``gw [P, U] = Σ_e Σ_{(i,j,k)∈p} c a[e,iU+u] b[e,jU+u] g[e,kU+u]`` on
    table order ``r``."""

    @staticmethod
    def forward(ctx, a, b, g, st: TpStatics, r: int):
        ctx.save_for_backward(a, b, g)
        ctx.st, ctx.r = st, r
        U = a.shape[1] // st.dims[ROLES[r][0]]
        return kernels.sparse_tp_gradw(a, b, g, *st.table(r), st.n_paths, U, st.walk(r))

    @staticmethod
    def backward(ctx, t):
        a, b, g = ctx.saved_tensors
        t, st, r = t.contiguous(), ctx.st, ctx.r
        return (_need(ctx, 0, lambda: SparseTp.apply(b, g, t, st, compose(r, GRADW_A))),
                _need(ctx, 1, lambda: SparseTp.apply(a, g, t, st, compose(r, SWAP_B))),
                _need(ctx, 2, lambda: SparseTp.apply(a, b, t, st, r)), None, None)


def sparse_tp_layer(x, env, w, st: TpStatics) -> torch.Tensor:
    """One layer's contraction on the ``pallas`` backend: x [E, d1*U]
    features, env [E, d2*U] the environment-summed weighted basis, w [P, U]
    path weights → [E, d3*U]. Differentiable to any order in all three."""
    return SparseTp.apply(x, env, w, st, 0)
