"""The kernels' ``torch.autograd.Function``s (twin of
``allegro_tpu/ops/fused_primitives.py``).

- The trainable backend (``tp_kernel_backend="fused"``): ``fused_layer`` =
  ``GatherTp(x, EnvScatter(sh, wexp), w)`` over the closed family
  ``EnvScatter``, ``GatherTp``, ``TpScatter``, ``GatherDw``, ``UnweightSh``,
  ``UnweightW``. Every function in it is multilinear, and each transpose is
  again a member with permuted roles (the table of
  ``allegro_tpu/ops/fused_primitives.py:18-33``; ᵀ is the role-swapped entry
  table, :class:`FusedStatics.swap`). Each ``backward`` is built from
  ``.apply`` of members only, so it is itself differentiable: the double
  backward of force training runs on the kernels too.
- ``fused_layer_infer``: one Allegro layer's tensor-track update on the
  inference backend. Forward: ``env_scatter`` → ``gather_tp``. Backward
  (first order only, the force call's): ``bwd_fused`` → ``unweight_both``.
- ``center_gather`` / ``center_scatter``: per-atom → per-edge gather and its
  transpose, the CSR segment sum. Each one's backward is the other, so the
  pair is closed under transposition and differentiable to any order.
- ``readout_sum_infer``: the fused readout (per-edge MLP and per-atom energy
  sum); backward ``readout_bwd``, first order only.
- The mega-fused layers (``nn/allegro.py``'s default inference path), each
  one kernel forward and one backward, first order only:
  ``mega_latent_env`` (latent MLP + env-weight slice + env scatter;
  backward ``latent_env_bwd``), ``gather_tp_infer`` (env gather + CG TP,
  optionally with the split scalar output; backward ``bwd_fused``) and
  ``gather_tp_embed_infer`` (the same at layer 0 with the tensor embed built
  in the kernel; backward ``bwd_embed``).

On the inference Functions the weight gradients are NaN by design, so
training parameters on the inference backend fails loudly instead of
silently.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import fused_tp


def _nan_like(t: Optional[torch.Tensor], needed: bool) -> Optional[torch.Tensor]:
    """The NaN weight cotangent of the inference Functions (None where not
    needed)."""
    return torch.full_like(t, float("nan")) if t is not None and needed else None


class FusedStatics(NamedTuple):
    """The non-differentiable arguments of the trainable family: the CSR
    statics (``centers`` [E] and ``row_ptr`` [n_atoms+1], int32), the SH
    basis map (``dim_to_irr`` [d2] int32, ``n_irr``), the channels ``U``, and
    the layer's sparse CG table (``entry_idx`` [n, 4] = (i, j, k, p),
    ``entry_swapped`` its role swap, ``entry_coef`` [n], ``n_paths``) with its
    dims ``(d1, d2, d3)``."""

    centers: torch.Tensor
    row_ptr: torch.Tensor
    dim_to_irr: torch.Tensor
    n_irr: int
    U: int
    entry_idx: torch.Tensor
    entry_swapped: torch.Tensor
    entry_coef: torch.Tensor
    n_paths: int
    dims: Tuple[int, int, int]

    def swap(self) -> "FusedStatics":
        """The ᵀ of the transpose table: entries (i,j,k) -> (k,j,i), dims reversed."""
        d1, d2, d3 = self.dims
        return self._replace(entry_idx=self.entry_swapped, entry_swapped=self.entry_idx,
                             dims=(d3, d2, d1))


def _need(ctx, i: int, fn):
    """``fn()`` where input ``i`` needs a gradient, else None."""
    return fn() if ctx.needs_input_grad[i] else None


class EnvScatter(torch.autograd.Function):
    """``env [n_atoms, d2*U] = Σ_{c(e)=a} sh[e,j] wexp[e, irr(j)U+u]``."""

    @staticmethod
    def forward(ctx, sh, wexp, st: FusedStatics):
        ctx.save_for_backward(sh, wexp)
        ctx.st = st
        return fused_tp.env_scatter(sh, wexp, st.centers, st.row_ptr, st.dim_to_irr, st.U)

    @staticmethod
    def backward(ctx, t):
        sh, wexp = ctx.saved_tensors
        t, st = t.contiguous(), ctx.st
        return (_need(ctx, 0, lambda: UnweightSh.apply(t, wexp, st)),
                _need(ctx, 1, lambda: UnweightW.apply(t, sh, st)), None)


class GatherTp(torch.autograd.Function):
    """``out [E, d3*U] = Σ c w[p,u] x[e,iU+u] env[c(e),jU+u]``."""

    @staticmethod
    def forward(ctx, x, env, w, st: FusedStatics):
        ctx.save_for_backward(x, env, w)
        ctx.st = st
        return fused_tp.gather_tp(x, env, w, st.centers, st.entry_idx, st.entry_coef, st.dims[2])

    @staticmethod
    def backward(ctx, g):
        x, env, w = ctx.saved_tensors
        g, st = g.contiguous(), ctx.st
        return (_need(ctx, 0, lambda: GatherTp.apply(g, env, w, st.swap())),
                _need(ctx, 1, lambda: TpScatter.apply(x, g, w, st)),
                _need(ctx, 2, lambda: GatherDw.apply(x, env, g, st)), None)


class TpScatter(torch.autograd.Function):
    """``denv [n_atoms, d2*U] = Σ_{c(e)=a} Σ c w[p,u] x[e,iU+u] g[e,kU+u]``."""

    @staticmethod
    def forward(ctx, x, g, w, st: FusedStatics):
        ctx.save_for_backward(x, g, w)
        ctx.st = st
        return fused_tp.tp_scatter(x, g, w, st.centers, st.row_ptr, st.entry_idx, st.entry_coef,
                                   st.dims[1])

    @staticmethod
    def backward(ctx, t):
        x, g, w = ctx.saved_tensors
        t, st = t.contiguous(), ctx.st
        return (_need(ctx, 0, lambda: GatherTp.apply(g, t, w, st.swap())),
                _need(ctx, 1, lambda: GatherTp.apply(x, t, w, st)),
                _need(ctx, 2, lambda: GatherDw.apply(x, t, g, st)), None)


class GatherDw(torch.autograd.Function):
    """``dw [P, U] = Σ_e Σ_{(i,j,k)∈p} c x[e,iU+u] env[c(e),jU+u] g[e,kU+u]``."""

    @staticmethod
    def forward(ctx, x, env, g, st: FusedStatics):
        ctx.save_for_backward(x, env, g)
        ctx.st = st
        return fused_tp.gather_dw(x, env, g, st.centers, st.entry_idx, st.entry_coef, st.n_paths,
                                  st.U)

    @staticmethod
    def backward(ctx, v):
        x, env, g = ctx.saved_tensors
        v, st = v.contiguous(), ctx.st
        return (_need(ctx, 0, lambda: GatherTp.apply(g, env, v, st.swap())),
                _need(ctx, 1, lambda: TpScatter.apply(x, g, v, st)),
                _need(ctx, 2, lambda: GatherTp.apply(x, env, v, st)), None)


class UnweightSh(torch.autograd.Function):
    """``dsh [E, d2] = Σ_u t[c(e), jU+u] wexp[e, irr(j)U+u]``."""

    @staticmethod
    def forward(ctx, t, wexp, st: FusedStatics):
        ctx.save_for_backward(t, wexp)
        ctx.st = st
        return fused_tp.unweight_sh(t, wexp, st.centers, st.dim_to_irr)

    @staticmethod
    def backward(ctx, s):
        t, wexp = ctx.saved_tensors
        s, st = s.contiguous(), ctx.st
        return (_need(ctx, 0, lambda: EnvScatter.apply(s, wexp, st)),
                _need(ctx, 1, lambda: UnweightW.apply(t, s, st)), None)


class UnweightW(torch.autograd.Function):
    """``dwexp [E, n_irr*U] = Σ_{irr(j)=r} t[c(e), jU+u] sh[e, j]``."""

    @staticmethod
    def forward(ctx, t, sh, st: FusedStatics):
        ctx.save_for_backward(t, sh)
        ctx.st = st
        return fused_tp.unweight_w(t, sh, st.centers, st.dim_to_irr, st.n_irr)

    @staticmethod
    def backward(ctx, v):
        t, sh = ctx.saved_tensors
        v, st = v.contiguous(), ctx.st
        return (_need(ctx, 0, lambda: EnvScatter.apply(sh, v, st)),
                _need(ctx, 1, lambda: UnweightSh.apply(t, v, st)), None)


def fused_layer(x, sh, wexp, w, st: FusedStatics) -> torch.Tensor:
    """One Allegro layer's tensor-track update on the trainable backend:
    x [E, d1*U] features, sh [E, d2] basis, wexp [E, n_irr*U] env weights
    (irrep-major, scatter factor already applied), w [P, U] path weights
    → [E, d3*U]. Differentiable to any order in all four."""
    return GatherTp.apply(x, EnvScatter.apply(sh, wexp, st), w, st)


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
        dw = _nan_like(w, ctx.needs_input_grad[3])
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
        nig = ctx.needs_input_grad
        return (_nan_like(w0, nig[0]), _nan_like(w1, nig[1]), None, None, *dpieces)


def readout_sum_infer(pieces: Sequence[torch.Tensor], w0, w1: Optional[torch.Tensor], centers,
                      row_ptr) -> torch.Tensor:
    """Per-atom readout energy [n_atoms, 1] from the scalar-track pieces
    [E, S_i] through the readout MLP (w0 [ΣS_i, H], w1 [H, 1]; ``w1=None``
    for a linear readout, w0 [ΣS_i, 1]), summed over each atom's edges."""
    return _ReadoutSumInfer.apply(w0, w1, centers, row_ptr, *pieces)


class _MegaLatentEnv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w0, w1, sh, centers, row_ptr, dim_to_irr, U, S, *pieces):
        lat_s, env = fused_tp.latent_env_scatter(pieces, sh, w0, w1, row_ptr, dim_to_irr, U, S)
        ctx.save_for_backward(w0, w1, sh, centers, dim_to_irr, *pieces)
        ctx.U, ctx.S = U, S
        return lat_s, env

    @staticmethod
    @once_differentiable
    def backward(ctx, g_lat, g_env):
        w0, w1, sh, centers, dim_to_irr, *pieces = ctx.saved_tensors
        dsh, dpieces = fused_tp.latent_env_bwd(
            pieces, sh, w0, w1, g_env.contiguous(), g_lat.contiguous(), centers, dim_to_irr,
            ctx.U, ctx.S,
        )
        nig = ctx.needs_input_grad
        return (_nan_like(w0, nig[0]), _nan_like(w1, nig[1]), dsh, None, None, None, None, None,
                *dpieces)


def mega_latent_env(pieces: Sequence[torch.Tensor], sh, w0, w1: Optional[torch.Tensor], centers,
                    row_ptr, dim_to_irr, U: int, S: int):
    """A latent MLP (``w1=None``: a linear map) on the pieces [E, S_i] → its
    scalar columns ``lat_s`` [E, S] and the environment ``env``
    [n_atoms, d2*U] that its env-weight columns weight sh [E, d2] into,
    summed over each atom's edges: ``(lat_s, env)``."""
    return _MegaLatentEnv.apply(w0, w1, sh, centers, row_ptr, dim_to_irr, U, S, *pieces)


class _GatherTpInfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, env, w, centers, row_ptr, entry_idx, entry_coef, d3, split):
        ctx.save_for_backward(x, env, w, centers, row_ptr, entry_idx, entry_coef)
        return fused_tp.gather_tp(x, env, w, centers, entry_idx, entry_coef, d3, split)

    @staticmethod
    @once_differentiable
    def backward(ctx, g, gts=None):
        x, env, w, centers, row_ptr, entry_idx, entry_coef = ctx.saved_tensors
        dx, denv = fused_tp.bwd_fused(x, g.contiguous(), env, w, centers, row_ptr, entry_idx,
                                      entry_coef, None if gts is None else gts.contiguous())
        return dx, denv, _nan_like(w, ctx.needs_input_grad[2]), None, None, None, None, None, None


def gather_tp_infer(x, env, w, centers, row_ptr, entry_idx, entry_coef, d3: int,
                    split: bool = False):
    """x [E, d1*U], env [n_atoms, d2*U], w [P, U] → out [E, d3*U], or
    ``(out, ts)`` with ``split`` (ts [E, U], the leading 0e block, whose
    cotangent the backward folds in)."""
    return _GatherTpInfer.apply(x, env, w, centers, row_ptr, entry_idx, entry_coef, d3, split)


class _GatherTpEmbedInfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs, d3,
                split):
        ctx.save_for_backward(sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs)
        return fused_tp.gather_tp_embed(sh, w2b, env, w, centers, entry_idx, entry_coef,
                                        row_specs, d3, split)

    @staticmethod
    @once_differentiable
    def backward(ctx, g, gts=None):
        sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs = ctx.saved_tensors
        dsh, dw2b, denv = fused_tp.bwd_embed(
            sh, w2b, g.contiguous(), env, w, centers, row_ptr, entry_idx, entry_coef, row_specs,
            None if gts is None else gts.contiguous(),
        )
        return (dsh, dw2b, denv, _nan_like(w, ctx.needs_input_grad[3]), None, None, None, None,
                None, None, None)


def gather_tp_embed_infer(sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs,
                          d3: int, split: bool = False):
    """``gather_tp_infer`` at layer 0 on the tensor embed's factors: sh
    [E, d_sh] and w2b [E, n_irr*U] (its channel weights), the features
    ``x0[e, iU+u] = sh[e, js_i] w2b[e, irs_i U+u]`` built in the kernel from
    ``row_specs`` [d1, 2] = (js_i, irs_i)."""
    return _GatherTpEmbedInfer.apply(sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef,
                                     row_specs, d3, split)
