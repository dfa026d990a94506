"""``fused_layer_infer``: one Allegro layer's tensor-track update on the
inference backend, as a ``torch.autograd.Function``.

Twin of ``allegro_tpu/ops/fused_primitives.py:fused_layer_infer``. Forward:
``env_scatter`` → ``gather_tp``. Backward (first order only, the force
call's): ``bwd_fused`` → ``unweight_both``. The path-weight gradient is NaN
by design, so training parameters on the inference backend fails loudly
instead of silently.
"""

from __future__ import annotations

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
