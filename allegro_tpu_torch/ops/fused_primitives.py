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
  ``table_rows`` reads a parameter table by class with the same pair.
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
silently. Every Function here reaches its kernels through ``custom_ops``:
the wrappers of ``fused_tp`` eagerly, the ``atpt::`` ops inside
``custom_ops.tracing()`` (the export of ``compile/export.py``).

The bf16 tensor track (``tensor_dtype="bfloat16"``, on every route of both
fused backends): on the mega path ``mega_latent_env`` takes ``wexp_dtype``
(the env weights rounded to it inside the kernel, forward and backward),
``gather_tp_embed_infer`` takes ``out_dtype`` (layer 0's features stored in
it), and ``gather_tp_infer`` takes bfloat16 features and returns bfloat16
features. Off it, ``fused_layer`` and ``fused_layer_infer`` take bfloat16
features x, env weights wexp and path weights w (JAX's
``path_weights.astype(x.dtype)``: autograd sums their gradient's
contributions in bfloat16, as JAX does; the kernels read w widened to
float32, :func:`_wide`) and return bfloat16 features; sh stays in the model
dtype. Each kernel returns JAX's dtype (``fused_tp.compute_dtype``), and
each cotangent takes its primal's dtype (JAX's ``_cast_ct``, :func:`_ct`):
autograd hands a bfloat16 output's backward a bfloat16 cotangent, dx comes
back in x's dtype, dwexp in wexp's (``unweight_w``'s ``out_dtype``,
``unweight_both``'s bf16 store), and on the CPU a float64 model's float32
kernel results are cast to the model dtype. On the card every such cast is
the identity: the kernels store each output in its primal's dtype.

A bfloat16 model (``model_dtype="bfloat16"``) on the trainable backend:
sh, the features, the env weights and the path weights are bfloat16 (the
kernels read the path weights widened, :func:`_wide`), env and the
per-atom cotangents float32; each gradient comes back in its primal's
dtype, the parameters' bfloat16 (``_ct``, as JAX's ``_cast_ct``), and
autograd sums a parameter's contributions in it, as JAX does. The double
backward launches only bf16 forms (``UnweightW`` reads bf16 sh).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import custom_ops as kernels
from .fused_tp import compute_dtype
from .gen_cg_blocks import CgPaths


def _nan_like(t: Optional[torch.Tensor], needed: bool) -> Optional[torch.Tensor]:
    """The NaN weight cotangent of the inference Functions (None where not
    needed)."""
    return torch.full_like(t, float("nan")) if t is not None and needed else None


class FusedStatics(NamedTuple):
    """The non-differentiable arguments of the trainable family: the CSR
    statics (``centers`` [E] and ``row_ptr`` [n_atoms+1], int32), the SH
    basis map (``dim_to_irr`` [d2] int32, ``n_irr``), the channels ``U``, the
    layer's sparse CG table (``entry_idx`` [n, 4] = (i, j, k, p),
    ``entry_swapped`` its role swap, ``entry_coef`` [n], ``n_paths``) with its
    dims ``(d1, d2, d3)``, and, for the path-walking kernels on the card,
    each order's path tables in walk order: ``paths`` for ``entry_idx`` and
    ``paths_swapped`` for ``entry_swapped`` (``gather_tp``, ``gather_dw``;
    ``Contracter.gather_paths``), and ``scatter_paths`` /
    ``scatter_paths_swapped``, the same two orders with their roles permuted
    (0, 2, 1) so that out is j (``tp_scatter``;
    ``Contracter.scatter_paths``). The plain versions read the entries and
    need none."""

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
    paths: Optional[CgPaths] = None
    paths_swapped: Optional[CgPaths] = None
    scatter_paths: Optional[CgPaths] = None
    scatter_paths_swapped: Optional[CgPaths] = None

    def swap(self) -> "FusedStatics":
        """The ᵀ of the transpose table: entries (i,j,k) -> (k,j,i) with their
        path tables, dims reversed."""
        d1, d2, d3 = self.dims
        return self._replace(entry_idx=self.entry_swapped, entry_swapped=self.entry_idx,
                             paths=self.paths_swapped, paths_swapped=self.paths,
                             scatter_paths=self.scatter_paths_swapped,
                             scatter_paths_swapped=self.scatter_paths, dims=(d3, d2, d1))


def _need(ctx, i: int, fn):
    """``fn()`` where input ``i`` needs a gradient, else None."""
    return fn() if ctx.needs_input_grad[i] else None


def _wide(w: torch.Tensor) -> torch.Tensor:
    """The path weights as the kernels read them: on the bf16 track, JAX's
    bfloat16 weights (or a cotangent in their role) widened to float32, the
    [P, U] values exactly (the kernels read float32 path weights)."""
    return w.float() if w.dtype == torch.bfloat16 else w


def _ct(v: torch.Tensor, primal: torch.Tensor) -> torch.Tensor:
    """The cotangent ``v`` in its primal's dtype (JAX's ``_cast_ct``)."""
    return v if v.dtype == primal.dtype else v.to(primal.dtype)


class EnvScatter(torch.autograd.Function):
    """``env [n_atoms, d2*U] = Σ_{c(e)=a} sh[e,j] wexp[e, irr(j)U+u]``."""

    @staticmethod
    def forward(ctx, sh, wexp, st: FusedStatics):
        ctx.save_for_backward(sh, wexp)
        ctx.st = st
        return kernels.env_scatter(sh, wexp, st.centers, st.row_ptr, st.dim_to_irr, st.U)

    @staticmethod
    def backward(ctx, t):
        sh, wexp = ctx.saved_tensors
        t, st = t.contiguous(), ctx.st
        return (_need(ctx, 0, lambda: _ct(UnweightSh.apply(t, wexp, st), sh)),
                _need(ctx, 1, lambda: UnweightW.apply(t, sh, st, wexp.dtype)), None)


class GatherTp(torch.autograd.Function):
    """``out [E, d3*U] = Σ c w[p,u] x[e,iU+u] env[c(e),jU+u]``."""

    @staticmethod
    def forward(ctx, x, env, w, st: FusedStatics):
        ctx.save_for_backward(x, env, w)
        ctx.st = st
        return kernels.gather_tp(x, env, _wide(w), st.centers, st.entry_idx, st.entry_coef,
                                 st.dims[2], paths=st.paths)

    @staticmethod
    def backward(ctx, g):
        x, env, w = ctx.saved_tensors
        g, st = g.contiguous(), ctx.st
        return (_need(ctx, 0, lambda: _ct(GatherTp.apply(g, env, w, st.swap()), x)),
                _need(ctx, 1, lambda: _ct(TpScatter.apply(x, g, w, st), env)),
                _need(ctx, 2, lambda: _ct(GatherDw.apply(x, env, g, st), w)), None)


class TpScatter(torch.autograd.Function):
    """``denv [n_atoms, d2*U] = Σ_{c(e)=a} Σ c w[p,u] x[e,iU+u] g[e,kU+u]``."""

    @staticmethod
    def forward(ctx, x, g, w, st: FusedStatics):
        ctx.save_for_backward(x, g, w)
        ctx.st = st
        return kernels.tp_scatter(x, g, _wide(w), st.centers, st.row_ptr, st.entry_idx,
                                  st.entry_coef, st.dims[1], st.scatter_paths)

    @staticmethod
    def backward(ctx, t):
        x, g, w = ctx.saved_tensors
        t, st = t.contiguous(), ctx.st
        return (_need(ctx, 0, lambda: _ct(GatherTp.apply(g, t, w, st.swap()), x)),
                _need(ctx, 1, lambda: _ct(GatherTp.apply(x, t, w, st), g)),
                _need(ctx, 2, lambda: _ct(GatherDw.apply(x, t, g, st), w)), None)


class GatherDw(torch.autograd.Function):
    """``dw [P, U] = Σ_e Σ_{(i,j,k)∈p} c x[e,iU+u] env[c(e),jU+u] g[e,kU+u]``."""

    @staticmethod
    def forward(ctx, x, env, g, st: FusedStatics):
        ctx.save_for_backward(x, env, g)
        ctx.st = st
        return kernels.gather_dw(x, env, g, st.centers, st.entry_idx, st.entry_coef, st.n_paths,
                                 st.U, st.paths)

    @staticmethod
    def backward(ctx, v):
        x, env, g = ctx.saved_tensors
        v, st = v.contiguous(), ctx.st
        return (_need(ctx, 0, lambda: _ct(GatherTp.apply(g, env, v, st.swap()), x)),
                _need(ctx, 1, lambda: _ct(TpScatter.apply(x, g, v, st), env)),
                _need(ctx, 2, lambda: _ct(GatherTp.apply(x, env, v, st), g)), None)


class UnweightSh(torch.autograd.Function):
    """``dsh [E, d2] = Σ_u t[c(e), jU+u] wexp[e, irr(j)U+u]``."""

    @staticmethod
    def forward(ctx, t, wexp, st: FusedStatics):
        ctx.save_for_backward(t, wexp)
        ctx.st = st
        return kernels.unweight_sh(t, wexp, st.centers, st.dim_to_irr)

    @staticmethod
    def backward(ctx, s):
        t, wexp = ctx.saved_tensors
        s, st = s.contiguous(), ctx.st
        return (_need(ctx, 0, lambda: _ct(EnvScatter.apply(s, wexp, st), t)),
                _need(ctx, 1, lambda: UnweightW.apply(t, s, st, wexp.dtype)), None)


class UnweightW(torch.autograd.Function):
    """``dwexp [E, n_irr*U] = Σ_{irr(j)=r} t[c(e), jU+u] sh[e, j]``, stored
    in ``out_dtype`` (the env weights': the wexp-cotangent it is)."""

    @staticmethod
    def forward(ctx, t, sh, st: FusedStatics, out_dtype: Optional[torch.dtype] = None):
        ctx.save_for_backward(t, sh)
        ctx.st = st
        return kernels.unweight_w(t, sh, st.centers, st.dim_to_irr, st.n_irr, out_dtype)

    @staticmethod
    def backward(ctx, v):
        t, sh = ctx.saved_tensors
        v, st = v.contiguous(), ctx.st
        return (_need(ctx, 0, lambda: _ct(EnvScatter.apply(sh, v, st), t)),
                _need(ctx, 1, lambda: _ct(UnweightSh.apply(t, v, st), sh)), None, None)


def fused_layer(x, sh, wexp, w, st: FusedStatics) -> torch.Tensor:
    """One Allegro layer's tensor-track update on the trainable backend:
    x [E, d1*U] features, sh [E, d2] basis, wexp [E, n_irr*U] env weights
    (irrep-major, scatter factor already applied), w [P, U] path weights
    → [E, d3*U] in x's dtype. Differentiable to any order in all four. x,
    wexp and w may be the bf16 track (all three): sh stays in the model
    dtype."""
    return GatherTp.apply(x, EnvScatter.apply(sh, wexp, st), w, st)


class _FusedLayerInfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sh, wexp, w, centers, row_ptr, entry_idx, entry_coef, dim_to_irr, d3,
                paths, swapped_paths, scatter_paths, split, wexp_dtype):
        ctx.w_dtype, ctx.dwexp_dtype = w.dtype, wexp.dtype
        w = _wide(w)
        if wexp_dtype is not None:
            wexp = wexp.to(wexp_dtype)
        env = kernels.env_scatter(sh, wexp, centers, row_ptr, dim_to_irr, w.shape[1])
        # ts (a routed mega model's) in the model dtype, sh's: JAX's scalar_dtype
        out = kernels.gather_tp(x, env, w, centers, entry_idx, entry_coef, d3, split, paths,
                                sh.dtype)
        ctx.save_for_backward(x, sh, wexp, w, env, centers, row_ptr, entry_idx, entry_coef,
                              dim_to_irr)
        ctx.bwd_paths = (swapped_paths, scatter_paths)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g, gts=None):
        x, sh, wexp, w, env, centers, row_ptr, entry_idx, entry_coef, dim_to_irr = (
            ctx.saved_tensors
        )
        dx, denv = kernels.bwd_fused(
            x, g.contiguous(), env, w, centers, row_ptr, entry_idx, entry_coef,
            None if gts is None else gts.contiguous(), paths=ctx.bwd_paths[0],
            scatter_paths=ctx.bwd_paths[1],
        )
        # dwexp in wexp's primal dtype: the stored wexp's, except on a routed
        # mega model (wexp_dtype), whose env weights' cotangent is unrounded
        out_dtype = None if ctx.dwexp_dtype == wexp.dtype else ctx.dwexp_dtype
        dsh, dwexp = kernels.unweight_both(denv, sh, wexp, centers, dim_to_irr, out_dtype)
        dw = _nan_like(w, ctx.needs_input_grad[3])
        return (_ct(dx, x), _ct(dsh, sh), dwexp, None if dw is None else dw.to(ctx.w_dtype),
                None, None, None, None, None, None, None, None, None, None, None)


def fused_layer_infer(x, sh, wexp, w, centers, row_ptr, entry_idx, entry_coef, dim_to_irr,
                      d3: int, paths: Optional[CgPaths] = None,
                      swapped_paths: Optional[CgPaths] = None,
                      scatter_paths: Optional[CgPaths] = None, split: bool = False,
                      wexp_dtype: Optional[torch.dtype] = None):
    """x [E, d1*U] tensor features; sh [E, d2] basis; wexp [E, n_irr*U] env
    weights (irrep-major, scatter factor already applied); w [P, U] path
    weights; centers [E] and row_ptr [n_atoms+1] the CSR statics; the sparse
    CG entries as idx [n, 4] (i, j, k, p) and coef [n], and on the card
    their path tables (``Contracter.infer_paths``): ``paths``, which
    ``gather_tp`` walks, and the role swap's (``swapped_paths``) and the
    (0, 2, 1) order's (``scatter_paths``), which ``bwd_fused`` walks.
    Returns [E, d3*U] in x's dtype, or with ``split`` ``(out, ts)``: ts
    [E, U] the leading 0e block in env's dtype, unrounded (``gather_tp``'s
    split output; its cotangent goes to ``bwd_fused``'s gts). x, wexp and
    w may be the bf16 track: the backward returns dx and dwexp in bfloat16
    (``bwd_fused``'s dx, ``unweight_both``'s dwexp), dsh in sh's dtype.
    ``wexp_dtype`` (JAX's mega path, for a mega model routed here): wexp in
    the model dtype is stored in it for the kernels, and its cotangent comes
    back unrounded in the model dtype (``unweight_both``'s ``out_dtype``)."""
    return _FusedLayerInfer.apply(
        x, sh, wexp, w, centers, row_ptr, entry_idx, entry_coef, dim_to_irr, d3, paths,
        swapped_paths, scatter_paths, split, wexp_dtype,
    )


class _CenterGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, idx, row_ptr, perm, chunked):
        ctx.save_for_backward(idx, row_ptr, perm)
        ctx.chunked = chunked
        return kernels.center_gather(a, idx)

    @staticmethod
    def backward(ctx, g):
        idx, row_ptr, perm = ctx.saved_tensors
        return (center_scatter(g.contiguous(), idx, row_ptr, perm, ctx.chunked), None, None,
                None, None)


class _CenterScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, idx, row_ptr, perm, chunked):
        ctx.save_for_backward(idx, row_ptr, perm)
        ctx.chunked = chunked
        return kernels.center_sum(v, row_ptr, perm, chunked)

    @staticmethod
    def backward(ctx, g):
        idx, row_ptr, perm = ctx.saved_tensors
        return (center_gather(g.contiguous(), idx, row_ptr, perm, ctx.chunked), None, None,
                None, None)


def center_gather(a, idx, row_ptr, perm: Optional[torch.Tensor] = None,
                  chunked: bool = False) -> torch.Tensor:
    """a [n_atoms, C] → [E, C], ``out[e] = a[idx[e]]`` (zero rows for
    sentinel ids ``>= n_atoms``). ``row_ptr`` (and ``perm``, for an ``idx``
    that is not sorted) is the CSR of ``idx`` that the transpose sums over:
    ``keys.CENTER_ROW_PTR`` for the centers, ``keys.NBR_ROW_PTR`` with
    ``keys.NBR_PERM`` for the neighbors; ``chunked`` for a few long segments
    (``fused_tp.center_sum``)."""
    return _CenterGather.apply(a, idx, row_ptr, perm, chunked)


def center_scatter(v, idx, row_ptr, perm: Optional[torch.Tensor] = None,
                   chunked: bool = False) -> torch.Tensor:
    """v [E, C] → [n_atoms, C], the sum of each atom's edges: the transpose
    of :func:`center_gather` with the same CSR statics."""
    return _CenterScatter.apply(v, idx, row_ptr, perm, chunked)


def table_rows(table, idx, csr: Optional[Tuple[torch.Tensor, ...]] = None) -> torch.Tensor:
    """``table[idx]`` along dim 0 for a parameter table read per edge or per
    atom by class. ``csr`` is the lookup's class CSR ``(idx, row_ptr, perm)``
    (``keys.class_csr_keys``, from ``Model.precompute_statics``): with it, a
    table that takes a gradient is read with :func:`center_gather`, so its
    gradient is ``center_sum`` over the class CSR, summed in a fixed order
    where ``index_select``'s transpose adds with atomics on the card. Rows
    whose class-CSR idx is the table's row count (padded edges and atoms)
    read zeros. A frozen table (the force call) or no ``csr`` (the ``einsum``
    reference) reads with ``index_select``: the same values, copied."""
    if csr is None or not table.requires_grad:
        return table.index_select(0, idx.long())
    # a few rows, each read by thousands of edges or atoms: the chunked sum
    rows = center_gather(table.reshape(table.shape[0], -1), *csr, chunked=True)
    return rows.reshape((rows.shape[0],) + tuple(table.shape[1:]))


class _ReadoutSumInfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w0, w1, centers, row_ptr, *pieces):
        ctx.save_for_backward(w0, w1, centers, *pieces)
        return kernels.readout_sum(pieces, _wide(w0), None if w1 is None else _wide(w1), row_ptr)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        w0, w1, centers, *pieces = ctx.saved_tensors
        dpieces = kernels.readout_bwd(pieces, _wide(w0), None if w1 is None else _wide(w1),
                                      g.to(compute_dtype(g)).contiguous(), centers)
        nig = ctx.needs_input_grad
        return (_nan_like(w0, nig[0]), _nan_like(w1, nig[1]), None, None, *dpieces)


def readout_sum_infer(pieces: Sequence[torch.Tensor], w0, w1: Optional[torch.Tensor], centers,
                      row_ptr) -> torch.Tensor:
    """Per-atom readout energy [n_atoms, 1] from the scalar-track pieces
    [E, S_i] through the readout MLP (w0 [ΣS_i, H], w1 [H, 1]; ``w1=None``
    for a linear readout, w0 [ΣS_i, 1]), summed over each atom's edges, in
    the compute dtype (float32 for a bfloat16 model: JAX's kernel's; its
    caller rounds it to the model dtype). A bfloat16 model's weights are
    widened for the kernels (:func:`_wide`)."""
    return _ReadoutSumInfer.apply(w0, w1, centers, row_ptr, *pieces)


class _MegaLatentEnv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w0, w1, sh, centers, row_ptr, dim_to_irr, irr_ranges, U, S, wexp_dtype,
                *pieces):
        lat_s, env = kernels.latent_env_scatter(pieces, sh, _wide(w0),
                                                None if w1 is None else _wide(w1), centers,
                                                row_ptr, dim_to_irr, U, S, irr_ranges, wexp_dtype)
        ctx.save_for_backward(w0, w1, sh, centers, dim_to_irr, irr_ranges, *pieces)
        ctx.U, ctx.S, ctx.wexp_dtype = U, S, wexp_dtype
        return lat_s, env

    @staticmethod
    @once_differentiable
    def backward(ctx, g_lat, g_env):
        w0, w1, sh, centers, dim_to_irr, irr_ranges, *pieces = ctx.saved_tensors
        dsh, dpieces = kernels.latent_env_bwd(
            pieces, sh, _wide(w0), None if w1 is None else _wide(w1), g_env.contiguous(),
            g_lat.contiguous(), centers, dim_to_irr, ctx.U, ctx.S, irr_ranges, ctx.wexp_dtype,
        )
        nig = ctx.needs_input_grad
        return (_nan_like(w0, nig[0]), _nan_like(w1, nig[1]), dsh, None, None, None, None, None,
                None, None, *dpieces)


def mega_latent_env(pieces: Sequence[torch.Tensor], sh, w0, w1: Optional[torch.Tensor], centers,
                    row_ptr, dim_to_irr, U: int, S: int, irr_ranges=None,
                    wexp_dtype: Optional[torch.dtype] = None):
    """A latent MLP (``w1=None``: a linear map) on the pieces [E, S_i] → its
    scalar columns ``lat_s`` [E, S] and the environment ``env``
    [n_atoms, d2*U] that its env-weight columns weight sh [E, d2] into,
    summed over each atom's edges: ``(lat_s, env)``. ``irr_ranges``: the
    basis's per-irrep (start, len) table, which both kernels read
    (``Contracter.irr_ranges``; built from ``dim_to_irr`` where not given).
    ``wexp_dtype``: the env weights are rounded to it and back before they
    weight sh (the bf16 track's bfloat16; None: not rounded). A bfloat16
    model's pieces and sh may be bfloat16: lat_s and env are then float32
    (JAX's compute dtype), and the weights are widened for the kernels."""
    return _MegaLatentEnv.apply(w0, w1, sh, centers, row_ptr, dim_to_irr, irr_ranges, U, S,
                                wexp_dtype, *pieces)


class _GatherTpInfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, env, w, centers, row_ptr, entry_idx, entry_coef, d3, split, paths,
                swapped_paths, scatter_paths, ts_dtype):
        w = _wide(w)
        ctx.save_for_backward(x, env, w, centers, row_ptr, entry_idx, entry_coef)
        ctx.bwd_paths = (swapped_paths, scatter_paths)
        return kernels.gather_tp(x, env, w, centers, entry_idx, entry_coef, d3, split, paths,
                                 ts_dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g, gts=None):
        x, env, w, centers, row_ptr, entry_idx, entry_coef = ctx.saved_tensors
        dx, denv = kernels.bwd_fused(x, g.contiguous(), env, w, centers, row_ptr, entry_idx,
                                     entry_coef, None if gts is None else gts.contiguous(),
                                     paths=ctx.bwd_paths[0], scatter_paths=ctx.bwd_paths[1])
        return (dx, denv, _nan_like(w, ctx.needs_input_grad[2]), None, None, None, None, None,
                None, None, None, None, None)


def gather_tp_infer(x, env, w, centers, row_ptr, entry_idx, entry_coef, d3: int,
                    split: bool = False, paths: Optional[CgPaths] = None,
                    swapped_paths: Optional[CgPaths] = None,
                    scatter_paths: Optional[CgPaths] = None,
                    ts_dtype: Optional[torch.dtype] = None):
    """x [E, d1*U], env [n_atoms, d2*U], w [P, U] → out [E, d3*U], or
    ``(out, ts)`` with ``split`` (ts [E, U], the leading 0e block, whose
    cotangent the backward folds in). ``paths``: the entries' path table in
    walk order, which ``gather_tp`` walks on the card; ``swapped_paths`` and
    ``scatter_paths``: the role swap's and the (0, 2, 1) order's, which the
    backward's ``bwd_fused`` walks (``Contracter.infer_paths``). x may be
    the bf16 track: out is then bfloat16 too. ts is stored in ``ts_dtype``
    (JAX's ``scalar_dtype``, the model dtype; default env's). A bfloat16
    model's w is widened for the kernels (:func:`_wide`)."""
    return _GatherTpInfer.apply(x, env, w, centers, row_ptr, entry_idx, entry_coef, d3, split,
                                paths, swapped_paths, scatter_paths, ts_dtype)


class _GatherTpEmbedInfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs, d3,
                split, paths, out_dtype):
        w = _wide(w)
        ctx.save_for_backward(sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs)
        ctx.paths = paths
        return kernels.gather_tp_embed(sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef,
                                       row_specs, d3, split, paths, out_dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g, gts=None):
        sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs = ctx.saved_tensors
        dsh, dw2b, denv = kernels.bwd_embed(
            sh, w2b, g.contiguous(), env, w, centers, row_ptr, entry_idx, entry_coef, row_specs,
            None if gts is None else gts.contiguous(), ctx.paths,
        )
        return (dsh, dw2b, denv, _nan_like(w, ctx.needs_input_grad[3]), None, None, None, None,
                None, None, None, None, None)


def gather_tp_embed_infer(sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs,
                          d3: int, split: bool = False, paths=None,
                          out_dtype: Optional[torch.dtype] = None):
    """``gather_tp_infer`` at layer 0 on the tensor embed's factors: sh
    [E, d_sh] and w2b [E, n_irr*U] (its channel weights), the features
    ``x0[e, iU+u] = sh[e, js_i] w2b[e, irs_i U+u]`` built in the kernel from
    ``row_specs`` [d1, 2] = (js_i, irs_i). ``paths``: the entry table's path
    descriptors, which both kernels walk (``Contracter.cg_paths``; built from
    the entries where not given). ``out_dtype``: the features' storage (the
    bf16 track's bfloat16; default sh's dtype); ts stays in sh's dtype."""
    return _GatherTpEmbedInfer.apply(sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef,
                                     row_specs, d3, split, paths, out_dtype)
