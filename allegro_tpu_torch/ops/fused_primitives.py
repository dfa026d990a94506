"""The kernels' ``torch.autograd.Function``s (twin of
``allegro_tpu/ops/fused_primitives.py``).

- ``fused_layer_infer``: one Allegro layer's tensor-track update on the
  inference backend. Forward: ``env_scatter`` → ``gather_tp``. Backward
  (first order only, the force call's): ``bwd_fused`` → ``unweight_both``.
- ``center_gather`` / ``center_scatter``: per-atom → per-edge gather and its
  transpose, the CSR segment sum. Each one's backward is the other, so the
  pair is closed under transposition and differentiable to any order.
- ``readout_sum_infer``: the fused readout (per-edge MLP and per-atom energy
  sum); backward ``readout_bwd``, first order only.

On the inference Functions the weight gradients are NaN by design, so
training parameters on the inference backend fails loudly instead of
silently.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from . import fused_tp


class _FusedLayerInfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sh, wexp, w, centers, row_ptr, entry_idx, entry_coef, dim_to_irr, d3):
        env = fused_tp.env_scatter(sh, wexp, centers, row_ptr, dim_to_irr, w.shape[1])
        out = fused_tp.gather_tp(x, env, w, centers, entry_idx, entry_coef, d3)
        ctx.save_for_backward(x, sh, wexp, w, env, centers, row_ptr, entry_idx, entry_coef,
                              dim_to_irr)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, sh, wexp, w, env, centers, row_ptr, entry_idx, entry_coef, dim_to_irr = (
            ctx.saved_tensors
        )
        dx, denv = fused_tp.bwd_fused(
            x, g.contiguous(), env, w, centers, row_ptr, entry_idx, entry_coef
        )
        dsh, dwexp = fused_tp.unweight_both(denv, sh, wexp, centers, dim_to_irr)
        dw = torch.full_like(w, float("nan")) if ctx.needs_input_grad[3] else None
        return dx, dsh, dwexp, dw, None, None, None, None, None, None


def fused_layer_infer(x, sh, wexp, w, centers, row_ptr, entry_idx, entry_coef, dim_to_irr,
                      d3: int) -> torch.Tensor:
    """x [E, d1*U] tensor features; sh [E, d2] basis; wexp [E, n_irr*U] env
    weights (irrep-major, scatter factor already applied); w [P, U] path
    weights; centers [E] and row_ptr [n_atoms+1] the CSR statics; the sparse
    CG entries as idx [n, 4] (i, j, k, p) and coef [n]. Returns [E, d3*U]."""
    return _FusedLayerInfer.apply(
        x, sh, wexp, w, centers, row_ptr, entry_idx, entry_coef, dim_to_irr, d3
    )


class _CenterGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, idx, row_ptr, perm):
        ctx.save_for_backward(idx, row_ptr, perm)
        return fused_tp.center_gather(a, idx)

    @staticmethod
    def backward(ctx, g):
        idx, row_ptr, perm = ctx.saved_tensors
        return center_scatter(g.contiguous(), idx, row_ptr, perm), None, None, None


class _CenterScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, idx, row_ptr, perm):
        ctx.save_for_backward(idx, row_ptr, perm)
        return fused_tp.center_sum(v, row_ptr, perm)

    @staticmethod
    def backward(ctx, g):
        idx, row_ptr, perm = ctx.saved_tensors
        return center_gather(g.contiguous(), idx, row_ptr, perm), None, None, None


def center_gather(a, idx, row_ptr, perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a [n_atoms, C] → [E, C], ``out[e] = a[idx[e]]`` (zero rows for
    sentinel ids ``>= n_atoms``). ``row_ptr`` (and ``perm``, for an ``idx``
    that is not sorted) is the CSR of ``idx`` that the transpose sums over:
    ``keys.CENTER_ROW_PTR`` for the centers, ``keys.NBR_ROW_PTR`` with
    ``keys.NBR_PERM`` for the neighbors."""
    return _CenterGather.apply(a, idx, row_ptr, perm)


def center_scatter(v, idx, row_ptr, perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """v [E, C] → [n_atoms, C], the sum of each atom's edges: the transpose
    of :func:`center_gather` with the same CSR statics."""
    return _CenterScatter.apply(v, idx, row_ptr, perm)


class _ReadoutSumInfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w0, w1, centers, row_ptr, *pieces):
        ctx.save_for_backward(w0, w1, centers, *pieces)
        return fused_tp.readout_sum(pieces, w0, w1, row_ptr)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        w0, w1, centers, *pieces = ctx.saved_tensors
        dpieces = fused_tp.readout_bwd(pieces, w0, w1, g.contiguous(), centers)
        nan = float("nan")
        dw0 = torch.full_like(w0, nan) if ctx.needs_input_grad[0] else None
        dw1 = torch.full_like(w1, nan) if w1 is not None and ctx.needs_input_grad[1] else None
        return (dw0, dw1, None, None, *dpieces)


def readout_sum_infer(pieces: Sequence[torch.Tensor], w0, w1: Optional[torch.Tensor], centers,
                      row_ptr) -> torch.Tensor:
    """Per-atom readout energy [n_atoms, 1] from the scalar-track pieces
    [E, S_i] through the readout MLP (w0 [ΣS_i, H], w1 [H, 1]; ``w1=None``
    for a linear readout, w0 [ΣS_i, 1]), summed over each atom's edges."""
    return _ReadoutSumInfer.apply(w0, w1, centers, row_ptr, *pieces)
