"""The force call's kernels as ``torch.library`` custom ops, for export.

A kernel is launched through ctypes with raw pointers
(``fused_tp._launch``), which a trace cannot see. So each kernel that a
force call launches, on any backend, is also an op of the ``atpt``
namespace, with a fake that gives its outputs' shapes and dtypes:

| op | kernel | wrapper | bf16 flags |
| --- | --- | --- | --- |
| ``env_scatter`` | 1 | ``fused_tp.env_scatter`` | ``bf16``: wexp |
| ``gather_tp`` | 2, 13 | ``fused_tp.gather_tp`` | ``bf16``: x, out |
| ``bwd_fused`` | 3 | ``fused_tp.bwd_fused`` (without dw) | ``bf16``: x, g, dx |
| ``unweight_both`` | 4 | ``fused_tp.unweight_both`` | ``bf16``: wexp; ``bf16_out``: dwexp |
| ``center_gather`` | 5 | ``fused_tp.center_gather`` | |
| ``center_sum`` | 6 | ``fused_tp.center_sum`` | |
| ``latent_env_scatter`` | 7 | ``fused_tp.latent_env_scatter`` | ``bf16_wexp``: the env weights rounded |
| ``latent_env_bwd`` | 8 | ``fused_tp.latent_env_bwd`` | ``bf16_wexp``: the same |
| ``gather_tp_embed`` | 9 | ``fused_tp.gather_tp_embed`` | ``bf16``: out |
| ``bwd_embed`` | 10 | ``fused_tp.bwd_embed`` | ``bf16``: g |
| ``readout_sum`` | 11 | ``fused_tp.readout_sum`` | |
| ``readout_bwd`` | 12 | ``fused_tp.readout_bwd`` | |
| ``tp_scatter`` | 14 | ``fused_tp.tp_scatter`` | ``bf16``: x, g |
| ``unweight_sh`` | 16 | ``fused_tp.unweight_sh`` | ``bf16``: wexp |
| ``unweight_w`` | 17 | ``fused_tp.unweight_w`` | ``bf16``: dwexp |
| ``sparse_tp`` | 20 | ``pallas_contract.sparse_tp`` | |

Kernel 13 is ``gather_tp`` on the role-swapped table, and the trainable
backend's env sum is kernel 1's ``env_scatter``. A bf16 flag is the flag the
kernel's launch takes: it names the form, and an op given arrays of the
other storage raises. Each fake returns the dtypes of the eager call
(``fused_tp.compute_dtype``).

The weight-gradient kernels 15 (``gather_dw``) and 21 (``sparse_tp_gradw``)
have no op: a force call runs with the parameters frozen
(``Model.apply_with_derivatives``), so no Function of the trainable
families is asked for a path-weight cotangent (``_need``) and neither
kernel runs in it, as JAX's transposes skip them; a trace that reaches one
raises.

An op's implementation is its wrapper: on a CUDA tensor it launches the
kernel (and counts it in ``fused_tp.LAUNCHES``) or raises, on a CPU tensor
it runs the plain version. The ``autograd.Function``s of
``ops/fused_primitives.py`` and ``ops/tp_primitives.py`` reach the kernels
through the functions of this module, which take the wrappers' arguments:
eagerly they call the wrapper itself, as before; inside :func:`tracing`
they call the op, so the trace records one node per launch. A path table
(``CgPaths``) is passed as its four tensors, an entry table of the
``pallas`` backend as the role order's rows of ``TpStatics``' tables. The
schemas are ``SCHEMAS``; ``csrc/torch_ops.cpp`` defines the same ones letter
for letter for a process without Python (the C++ MD driver), where
AOTInductor calls the ops through the dispatcher.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch

from . import fused_tp, pallas_contract
from .fused_tp import compute_dtype
from .gen_cg_blocks import CgPaths, path_table

NAMESPACE = "atpt"

_PATHS = "Tensor desc, Tensor scale, Tensor path_idx, Tensor path_coef"
SCHEMAS = {
    "env_scatter": "(Tensor sh, Tensor wexp, Tensor centers, Tensor row_ptr, "
                   "Tensor dim_to_irr, int U, bool bf16) -> Tensor",
    "gather_tp": "(Tensor x, Tensor env, Tensor w, Tensor centers, Tensor entry_idx, "
                 f"Tensor entry_coef, int d3, bool split, {_PATHS}, bool bf16) "
                 "-> (Tensor, Tensor)",
    "bwd_fused": "(Tensor x, Tensor g, Tensor? gts, Tensor env, Tensor w, Tensor centers, "
                 f"Tensor row_ptr, Tensor entry_idx, Tensor entry_coef, {_PATHS}, "
                 "Tensor scatter_desc, Tensor scatter_scale, Tensor scatter_path_idx, "
                 "Tensor scatter_path_coef, bool bf16) -> (Tensor, Tensor)",
    "unweight_both": "(Tensor t, Tensor sh, Tensor wexp, Tensor centers, Tensor dim_to_irr, "
                     "bool bf16, bool bf16_out) -> (Tensor, Tensor)",
    "center_gather": "(Tensor a, Tensor idx) -> Tensor",
    "center_sum": "(Tensor v, Tensor row_ptr, Tensor? perm, bool chunked) -> Tensor",
    "latent_env_scatter": "(Tensor[] pieces, Tensor sh, Tensor w0, Tensor? w1, Tensor centers, "
                          "Tensor row_ptr, Tensor dim_to_irr, Tensor irr_ranges, int U, int S, "
                          "bool bf16_wexp) -> (Tensor, Tensor)",
    "latent_env_bwd": "(Tensor[] pieces, Tensor sh, Tensor w0, Tensor? w1, Tensor t, "
                      "Tensor g_lat, Tensor centers, Tensor dim_to_irr, Tensor irr_ranges, "
                      "int U, int S, bool bf16_wexp) -> Tensor[]",
    "gather_tp_embed": "(Tensor sh, Tensor w2b, Tensor env, Tensor w, Tensor centers, "
                       "Tensor row_ptr, Tensor entry_idx, Tensor entry_coef, Tensor row_specs, "
                       f"int d3, bool split, {_PATHS}, bool bf16) -> (Tensor, Tensor)",
    "bwd_embed": "(Tensor sh, Tensor w2b, Tensor g, Tensor? gts, Tensor env, Tensor w, "
                 "Tensor centers, Tensor row_ptr, Tensor entry_idx, Tensor entry_coef, "
                 f"Tensor row_specs, {_PATHS}, bool bf16) -> (Tensor, Tensor, Tensor)",
    "readout_sum": "(Tensor[] pieces, Tensor w0, Tensor? w1, Tensor row_ptr) -> Tensor",
    "readout_bwd": "(Tensor[] pieces, Tensor w0, Tensor? w1, Tensor y, Tensor centers) "
                   "-> Tensor[]",
    "tp_scatter": "(Tensor x, Tensor g, Tensor w, Tensor centers, Tensor row_ptr, "
                  f"Tensor entry_idx, Tensor entry_coef, int d2, {_PATHS}, bool bf16) -> Tensor",
    "unweight_sh": "(Tensor t, Tensor wexp, Tensor centers, Tensor dim_to_irr, bool bf16) "
                   "-> Tensor",
    "unweight_w": "(Tensor t, Tensor sh, Tensor centers, Tensor dim_to_irr, int n_irr, "
                  "bool bf16) -> Tensor",
    "sparse_tp": "(Tensor a, Tensor b, Tensor w, Tensor entry_idx, Tensor entry_coef, int d3, "
                 f"{_PATHS}) -> Tensor",
}

_TRACING = False
BF16 = torch.bfloat16


@contextlib.contextmanager
def tracing():
    """Within: the kernels' Functions call the ``atpt`` ops, so that a
    trace (``make_fx``) records each kernel launch as a node."""
    global _TRACING
    before, _TRACING = _TRACING, True
    try:
        yield
    finally:
        _TRACING = before


def _c(*tensors):
    """The tensors made contiguous (a traced caller may hand over any
    layout; the kernels read dense rows)."""
    return tuple(None if t is None else t.contiguous() for t in tensors)


def _pieces(pieces: Sequence[torch.Tensor]) -> tuple:
    """Pieces with unit column stride (the readout's and latent kernels'
    row tables take any row stride)."""
    return tuple(p if p.shape[1] <= 1 or p.stride(1) == 1 else p.contiguous() for p in pieces)


def _own(tensors) -> list:
    """The outputs of a multi-output op as the fakes promise them: dense,
    each with storage of its own. A plain version may return column views
    of one result (``torch.split``), which a compiled caller would read with
    the fake's strides."""
    seen, out = set(), []
    for t in tensors:
        t = t.contiguous()
        ptr = t.untyped_storage().data_ptr()
        out.append(t.clone() if ptr in seen and t.numel() else t)
        seen.add(ptr)
    return out


def _form(op: str, bf16: bool, **track) -> None:
    """Raises unless the arrays of the op's bf16 form (``track``) are
    bfloat16 exactly where its flag says so."""
    wrong = {k: str(t.dtype) for k, t in track.items() if (t.dtype == BF16) != bool(bf16)}
    if wrong:
        raise TypeError(f"atpt::{op} with bf16={bool(bf16)}: {wrong}")


def _define(name: str):
    """The decorator that makes a function the op ``atpt::name``."""
    return torch.library.custom_op(f"{NAMESPACE}::{name}", mutates_args=(), schema=SCHEMAS[name])


def _empty(like: torch.Tensor, *shape, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    return like.new_empty(shape, dtype=dtype or like.dtype)


def _like(t: torch.Tensor) -> torch.Tensor:
    """A dense tensor of ``t``'s shape and type (the kernels' outputs)."""
    return t.new_empty(t.shape)


def _paths(desc, scale, path_idx, path_coef) -> CgPaths:
    return CgPaths(*_c(desc, scale, path_idx, path_coef))


def _dwexp_dtype(sh, wexp, bf16_out: bool) -> torch.dtype:
    """The dwexp storage of ``unweight_both``: bfloat16, else the model
    dtype (wexp's, or sh's where wexp is the bf16 track)."""
    return BF16 if bf16_out else compute_dtype(sh, wexp)


# ---------------------------------------------------------------------------
# the ops: their implementations (the wrappers) and fakes
# ---------------------------------------------------------------------------


@_define("env_scatter")
def _env_scatter(sh, wexp, centers, row_ptr, dim_to_irr, U, bf16):
    _form("env_scatter", bf16, wexp=wexp)
    return fused_tp.env_scatter(*_c(sh, wexp, centers, row_ptr, dim_to_irr), U)


@_env_scatter.register_fake
def _(sh, wexp, centers, row_ptr, dim_to_irr, U, bf16):
    return _empty(sh, row_ptr.shape[0] - 1, sh.shape[1] * U, dtype=compute_dtype(sh, wexp))


@_define("gather_tp")
def _gather_tp(x, env, w, centers, entry_idx, entry_coef, d3, split, desc, scale, path_idx,
               path_coef, bf16):
    _form("gather_tp", bf16, x=x)
    x, env, w, centers = _c(x, env, w, centers)
    res = fused_tp.gather_tp(x, env, w, centers, entry_idx, entry_coef, d3, split,
                             _paths(desc, scale, path_idx, path_coef))
    return tuple(_own(res if split else (res, _empty(env, x.shape[0], 0,
                                                     dtype=compute_dtype(x, env)))))


@_gather_tp.register_fake
def _(x, env, w, centers, entry_idx, entry_coef, d3, split, desc, scale, path_idx, path_coef,
      bf16):
    E, U = x.shape[0], w.shape[1]
    return _empty(x, E, d3 * U), _empty(env, E, U if split else 0, dtype=compute_dtype(x, env))


@_define("bwd_fused")
def _bwd_fused(x, g, gts, env, w, centers, row_ptr, entry_idx, entry_coef, desc, scale,
               path_idx, path_coef, scatter_desc, scatter_scale, scatter_path_idx,
               scatter_path_coef, bf16):
    _form("bwd_fused", bf16, x=x, g=g)
    x, g, gts, env, w, centers, row_ptr, entry_idx, entry_coef = _c(
        x, g, gts, env, w, centers, row_ptr, entry_idx, entry_coef)
    return tuple(_own(fused_tp.bwd_fused(
        x, g, env, w, centers, row_ptr, entry_idx, entry_coef, gts,
        paths=_paths(desc, scale, path_idx, path_coef),
        scatter_paths=_paths(scatter_desc, scatter_scale, scatter_path_idx, scatter_path_coef))))


@_bwd_fused.register_fake
def _(x, g, gts, env, *rest):
    return _like(x), _empty(env, *env.shape, dtype=compute_dtype(x, g))


@_define("unweight_both")
def _unweight_both(t, sh, wexp, centers, dim_to_irr, bf16, bf16_out):
    _form("unweight_both", bf16, wexp=wexp)
    return tuple(_own(fused_tp.unweight_both(*_c(t, sh, wexp, centers, dim_to_irr),
                                             _dwexp_dtype(sh, wexp, bf16_out))))


@_unweight_both.register_fake
def _(t, sh, wexp, centers, dim_to_irr, bf16, bf16_out):
    return (_empty(sh, *sh.shape, dtype=compute_dtype(t)),
            _empty(wexp, *wexp.shape, dtype=_dwexp_dtype(sh, wexp, bf16_out)))


@_define("center_gather")
def _center_gather(a, idx):
    return fused_tp.center_gather(*_c(a, idx))


@_center_gather.register_fake
def _(a, idx):
    return _empty(a, idx.shape[0], a.shape[1])


@_define("center_sum")
def _center_sum(v, row_ptr, perm, chunked):
    return fused_tp.center_sum(*_c(v, row_ptr, perm), chunked=chunked)


@_center_sum.register_fake
def _(v, row_ptr, perm, chunked):
    return _empty(v, row_ptr.shape[0] - 1, v.shape[1])


def _round(bf16_wexp: bool) -> Optional[torch.dtype]:
    return BF16 if bf16_wexp else None


@_define("latent_env_scatter")
def _latent_env_scatter(pieces, sh, w0, w1, centers, row_ptr, dim_to_irr, irr_ranges, U, S,
                        bf16_wexp):
    return tuple(_own(fused_tp.latent_env_scatter(
        _pieces(pieces), *_c(sh, w0, w1, centers, row_ptr, dim_to_irr), U, S, *_c(irr_ranges),
        _round(bf16_wexp))))


@_latent_env_scatter.register_fake
def _(pieces, sh, w0, w1, centers, row_ptr, dim_to_irr, irr_ranges, U, S, bf16_wexp):
    return _empty(sh, sh.shape[0], S), _empty(sh, row_ptr.shape[0] - 1, sh.shape[1] * U)


@_define("latent_env_bwd")
def _latent_env_bwd(pieces, sh, w0, w1, t, g_lat, centers, dim_to_irr, irr_ranges, U, S,
                    bf16_wexp):
    dsh, dpieces = fused_tp.latent_env_bwd(_pieces(pieces), *_c(sh, w0, w1, t, g_lat, centers,
                                                                dim_to_irr), U, S,
                                           *_c(irr_ranges), _round(bf16_wexp))
    return _own([dsh, *dpieces])


@_latent_env_bwd.register_fake
def _(pieces, sh, *rest):
    return [_like(sh), *(_like(p) for p in pieces)]


@_define("gather_tp_embed")
def _gather_tp_embed(sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs, d3,
                     split, desc, scale, path_idx, path_coef, bf16):
    sh, w2b, env, w, centers, row_ptr, row_specs = _c(sh, w2b, env, w, centers, row_ptr,
                                                      row_specs)
    res = fused_tp.gather_tp_embed(sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef,
                                   row_specs, d3, split, _paths(desc, scale, path_idx, path_coef),
                                   BF16 if bf16 else None)
    return tuple(_own(res if split else (res, _empty(sh, sh.shape[0], 0))))


@_gather_tp_embed.register_fake
def _(sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs, d3, split, desc,
      scale, path_idx, path_coef, bf16):
    E, U = sh.shape[0], w.shape[1]
    return (_empty(sh, E, d3 * U, dtype=BF16 if bf16 else None),
            _empty(sh, E, U if split else 0))


@_define("bwd_embed")
def _bwd_embed(sh, w2b, g, gts, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs,
               desc, scale, path_idx, path_coef, bf16):
    _form("bwd_embed", bf16, g=g)
    sh, w2b, g, gts, env, w, centers, row_ptr, row_specs = _c(sh, w2b, g, gts, env, w, centers,
                                                              row_ptr, row_specs)
    return tuple(_own(fused_tp.bwd_embed(sh, w2b, g, env, w, centers, row_ptr, entry_idx,
                                         entry_coef, row_specs, gts,
                                         _paths(desc, scale, path_idx, path_coef))))


@_bwd_embed.register_fake
def _(sh, w2b, g, gts, env, *rest):
    return _like(sh), _like(w2b), _like(env)


@_define("readout_sum")
def _readout_sum(pieces, w0, w1, row_ptr):
    return fused_tp.readout_sum(_pieces(pieces), *_c(w0, w1, row_ptr))


@_readout_sum.register_fake
def _(pieces, w0, w1, row_ptr):
    return _empty(w0, row_ptr.shape[0] - 1, 1)


@_define("readout_bwd")
def _readout_bwd(pieces, w0, w1, y, centers):
    return _own(fused_tp.readout_bwd(_pieces(pieces), *_c(w0, w1, y, centers)))


@_readout_bwd.register_fake
def _(pieces, w0, w1, y, centers):
    return [_like(p) for p in pieces]


@_define("tp_scatter")
def _tp_scatter(x, g, w, centers, row_ptr, entry_idx, entry_coef, d2, desc, scale, path_idx,
                path_coef, bf16):
    _form("tp_scatter", bf16, x=x, g=g)
    return fused_tp.tp_scatter(*_c(x, g, w, centers, row_ptr), entry_idx, entry_coef, d2,
                               _paths(desc, scale, path_idx, path_coef))


@_tp_scatter.register_fake
def _(x, g, w, centers, row_ptr, entry_idx, entry_coef, d2, *rest):
    return _empty(x, row_ptr.shape[0] - 1, d2 * w.shape[1], dtype=compute_dtype(x, g))


@_define("unweight_sh")
def _unweight_sh(t, wexp, centers, dim_to_irr, bf16):
    _form("unweight_sh", bf16, wexp=wexp)
    return fused_tp.unweight_sh(*_c(t, wexp, centers, dim_to_irr))


@_unweight_sh.register_fake
def _(t, wexp, centers, dim_to_irr, bf16):
    return _empty(t, wexp.shape[0], dim_to_irr.shape[0], dtype=compute_dtype(t))


@_define("unweight_w")
def _unweight_w(t, sh, centers, dim_to_irr, n_irr, bf16):
    return fused_tp.unweight_w(*_c(t, sh, centers, dim_to_irr), n_irr,
                               BF16 if bf16 else compute_dtype(t, sh))


@_unweight_w.register_fake
def _(t, sh, centers, dim_to_irr, n_irr, bf16):
    U = t.shape[1] // sh.shape[1]
    return _empty(t, sh.shape[0], n_irr * U, dtype=BF16 if bf16 else compute_dtype(t, sh))


@_define("sparse_tp")
def _sparse_tp(a, b, w, entry_idx, entry_coef, d3, desc, scale, path_idx, path_coef):
    return pallas_contract.sparse_tp(*_c(a, b, w, entry_idx, entry_coef), d3,
                                     _paths(desc, scale, path_idx, path_coef))


@_sparse_tp.register_fake
def _(a, b, w, entry_idx, entry_coef, d3, *paths):
    return _empty(a, a.shape[0], d3 * w.shape[1])


# ---------------------------------------------------------------------------
# what the Functions call: the wrapper eagerly, the op inside ``tracing()``
# ---------------------------------------------------------------------------


def _ops():
    return getattr(torch.ops, NAMESPACE)


def _is_bf16(t: torch.Tensor) -> bool:
    return t.dtype == BF16


def _stored_bf16(what: str, dtype: Optional[torch.dtype], model_dtype: torch.dtype) -> bool:
    """The ``bf16`` flag of an output stored in ``dtype`` (None: the model
    dtype); raises for a storage no form has."""
    if dtype in (None, model_dtype):
        return False
    if dtype != BF16:
        raise TypeError(f"{what}: the kernels store in bfloat16 or {model_dtype}, got {dtype}")
    return True


def _no_op(name: str):
    raise NotImplementedError(
        f"{name} has no atpt op: a force call runs with the parameters frozen, so no "
        "weight-gradient kernel runs in it (ops/custom_ops.py)")


def env_scatter(sh, wexp, centers, row_ptr, dim_to_irr, U: int):
    if not _TRACING:
        return fused_tp.env_scatter(sh, wexp, centers, row_ptr, dim_to_irr, U)
    return _ops().env_scatter(sh, wexp, centers, row_ptr, dim_to_irr, U, _is_bf16(wexp))


def gather_tp(x, env, w, centers, entry_idx, entry_coef, d3: int, split: bool = False,
              paths: Optional[CgPaths] = None, ts_dtype: Optional[torch.dtype] = None):
    if not _TRACING:
        return fused_tp.gather_tp(x, env, w, centers, entry_idx, entry_coef, d3, split, paths,
                                  ts_dtype)
    out, ts = _ops().gather_tp(x, env, w, centers, entry_idx, entry_coef, d3, split, *paths,
                               _is_bf16(x))
    return (out, ts) if split else out


def bwd_fused(x, g, env, w, centers, row_ptr, entry_idx, entry_coef, gts=None,
              paths: Optional[CgPaths] = None, scatter_paths: Optional[CgPaths] = None):
    if not _TRACING:
        return fused_tp.bwd_fused(x, g, env, w, centers, row_ptr, entry_idx, entry_coef, gts,
                                  paths=paths, scatter_paths=scatter_paths)
    return tuple(_ops().bwd_fused(x, g, gts, env, w, centers, row_ptr, entry_idx, entry_coef,
                                  *paths, *scatter_paths, _is_bf16(x)))


def unweight_both(t, sh, wexp, centers, dim_to_irr, out_dtype=None):
    if not _TRACING:
        return fused_tp.unweight_both(t, sh, wexp, centers, dim_to_irr, out_dtype)
    bf16_out = _stored_bf16("unweight_both", out_dtype or wexp.dtype, compute_dtype(sh, wexp))
    return tuple(_ops().unweight_both(t, sh, wexp, centers, dim_to_irr, _is_bf16(wexp),
                                      bf16_out))


def center_gather(a, idx):
    if not _TRACING:
        return fused_tp.center_gather(a, idx)
    return _ops().center_gather(a, idx)


def center_sum(v, row_ptr, perm=None, chunked: bool = False):
    if not _TRACING:
        return fused_tp.center_sum(v, row_ptr, perm, chunked)
    return _ops().center_sum(v, row_ptr, perm, chunked)


def _ranges(irr_ranges, dim_to_irr):
    return fused_tp.irrep_ranges(dim_to_irr).to(dim_to_irr.device) if irr_ranges is None \
        else irr_ranges


def latent_env_scatter(pieces, sh, w0, w1, centers, row_ptr, dim_to_irr, U: int, S: int,
                       irr_ranges=None, wexp_dtype=None):
    if not _TRACING:
        return fused_tp.latent_env_scatter(pieces, sh, w0, w1, centers, row_ptr, dim_to_irr, U,
                                           S, irr_ranges, wexp_dtype)
    return tuple(_ops().latent_env_scatter(
        list(pieces), sh, w0, w1, centers, row_ptr, dim_to_irr, _ranges(irr_ranges, dim_to_irr),
        U, S, bool(fused_tp._round_flag("latent_env_scatter", wexp_dtype, sh))))


def latent_env_bwd(pieces, sh, w0, w1, t, g_lat, centers, dim_to_irr, U: int, S: int,
                   irr_ranges=None, wexp_dtype=None):
    if not _TRACING:
        return fused_tp.latent_env_bwd(pieces, sh, w0, w1, t, g_lat, centers, dim_to_irr, U, S,
                                       irr_ranges, wexp_dtype)
    dsh, *dpieces = _ops().latent_env_bwd(
        list(pieces), sh, w0, w1, t, g_lat, centers, dim_to_irr,
        _ranges(irr_ranges, dim_to_irr), U, S,
        bool(fused_tp._round_flag("latent_env_bwd", wexp_dtype, sh)))
    return dsh, tuple(dpieces)


def _embed_paths(paths, entry_idx, entry_coef, device) -> CgPaths:
    return path_table(entry_idx, entry_coef).to(device) if paths is None else paths


def gather_tp_embed(sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs,
                    d3: int, split: bool = False, paths=None, out_dtype=None):
    if not _TRACING:
        return fused_tp.gather_tp_embed(sh, w2b, env, w, centers, row_ptr, entry_idx,
                                        entry_coef, row_specs, d3, split, paths, out_dtype)
    out, ts = _ops().gather_tp_embed(sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef,
                                     row_specs, d3, split,
                                     *_embed_paths(paths, entry_idx, entry_coef, sh.device),
                                     _stored_bf16("gather_tp_embed", out_dtype, sh.dtype))
    return (out, ts) if split else out


def bwd_embed(sh, w2b, g, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs, gts=None,
              paths=None):
    if not _TRACING:
        return fused_tp.bwd_embed(sh, w2b, g, env, w, centers, row_ptr, entry_idx, entry_coef,
                                  row_specs, gts, paths)
    return tuple(_ops().bwd_embed(sh, w2b, g, gts, env, w, centers, row_ptr, entry_idx,
                                  entry_coef, row_specs,
                                  *_embed_paths(paths, entry_idx, entry_coef, sh.device),
                                  _is_bf16(g)))


def readout_sum(pieces, w0, w1, row_ptr):
    if not _TRACING:
        return fused_tp.readout_sum(pieces, w0, w1, row_ptr)
    return _ops().readout_sum(list(pieces), w0, w1, row_ptr)


def readout_bwd(pieces, w0, w1, y, centers) -> List[torch.Tensor]:
    if not _TRACING:
        return fused_tp.readout_bwd(pieces, w0, w1, y, centers)
    return tuple(_ops().readout_bwd(list(pieces), w0, w1, y, centers))


def tp_scatter(x, g, w, centers, row_ptr, entry_idx, entry_coef, d2: int,
               paths: Optional[CgPaths] = None):
    if not _TRACING:
        return fused_tp.tp_scatter(x, g, w, centers, row_ptr, entry_idx, entry_coef, d2, paths)
    return _ops().tp_scatter(x, g, w, centers, row_ptr, entry_idx, entry_coef, d2, *paths,
                             _is_bf16(x))


def gather_dw(x, env, g, centers, entry_idx, entry_coef, n_paths: int, U: int,
              paths: Optional[CgPaths] = None):
    if not _TRACING:
        return fused_tp.gather_dw(x, env, g, centers, entry_idx, entry_coef, n_paths, U, paths)
    _no_op("gather_dw")


def unweight_sh(t, wexp, centers, dim_to_irr):
    if not _TRACING:
        return fused_tp.unweight_sh(t, wexp, centers, dim_to_irr)
    return _ops().unweight_sh(t, wexp, centers, dim_to_irr, _is_bf16(wexp))


def unweight_w(t, sh, centers, dim_to_irr, n_irr: int, out_dtype=None):
    if not _TRACING:
        return fused_tp.unweight_w(t, sh, centers, dim_to_irr, n_irr, out_dtype)
    return _ops().unweight_w(t, sh, centers, dim_to_irr, n_irr,
                             _stored_bf16("unweight_w", out_dtype, compute_dtype(t, sh)))


def sparse_tp(a, b, w, entry_idx, entry_coef, d3: int, paths: Optional[CgPaths] = None):
    if not _TRACING:
        return pallas_contract.sparse_tp(a, b, w, entry_idx, entry_coef, d3, paths)
    return _ops().sparse_tp(a, b, w, entry_idx, entry_coef, d3, *paths)


def sparse_tp_gradw(a, b, g, entry_idx, entry_coef, n_paths: int, U: int,
                    paths: Optional[CgPaths] = None):
    if not _TRACING:
        return pallas_contract.sparse_tp_gradw(a, b, g, entry_idx, entry_coef, n_paths, U, paths)
    _no_op("sparse_tp_gradw")
