"""The force call's kernels as ``torch.library`` custom ops, for export.

A kernel is launched through ctypes with raw pointers
(``fused_tp._launch``), which a trace cannot see. So each kernel that a
``fused_infer`` route launches (TPU kernels 1–12) is also an op of the
``atpt`` namespace, with a fake that gives its outputs' shapes and dtypes:

| op | kernel | wrapper |
| --- | --- | --- |
| ``env_scatter`` | 1 | ``fused_tp.env_scatter`` |
| ``gather_tp`` | 2 | ``fused_tp.gather_tp`` |
| ``bwd_fused`` | 3 | ``fused_tp.bwd_fused`` (without dw) |
| ``unweight_both`` | 4 | ``fused_tp.unweight_both`` |
| ``center_gather`` | 5 | ``fused_tp.center_gather`` |
| ``center_sum`` | 6 | ``fused_tp.center_sum`` |
| ``latent_env_scatter`` | 7 | ``fused_tp.latent_env_scatter`` |
| ``latent_env_bwd`` | 8 | ``fused_tp.latent_env_bwd`` |
| ``gather_tp_embed`` | 9 | ``fused_tp.gather_tp_embed`` |
| ``bwd_embed`` | 10 | ``fused_tp.bwd_embed`` |
| ``readout_sum`` | 11 | ``fused_tp.readout_sum`` |
| ``readout_bwd`` | 12 | ``fused_tp.readout_bwd`` |

An op's implementation is its wrapper: on a CUDA tensor it launches the
kernel (and counts it in ``fused_tp.LAUNCHES``) or raises, on a CPU tensor
it runs the plain version. The inference ``autograd.Function``s of
``ops/fused_primitives.py`` reach the kernels through the functions of this
module, which take the wrappers' arguments: eagerly they call the wrapper
itself, as before; inside :func:`tracing` they call the op, so the trace
records one node per launch. A path table (``CgPaths``) is passed as its
four tensors. The schemas are ``SCHEMAS``; ``csrc/torch_ops.cpp`` defines
the same ones letter for letter for a process without Python (the C++ MD
driver), where AOTInductor calls the ops through the dispatcher. The ops
take the model dtype only: the bf16 track is not exported.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch

from . import fused_tp
from .gen_cg_blocks import CgPaths, path_table

NAMESPACE = "atpt"

_PATHS = "Tensor desc, Tensor scale, Tensor path_idx, Tensor path_coef"
SCHEMAS = {
    "env_scatter": "(Tensor sh, Tensor wexp, Tensor centers, Tensor row_ptr, "
                   "Tensor dim_to_irr, int U) -> Tensor",
    "gather_tp": "(Tensor x, Tensor env, Tensor w, Tensor centers, Tensor entry_idx, "
                 f"Tensor entry_coef, int d3, bool split, {_PATHS}) -> (Tensor, Tensor)",
    "bwd_fused": "(Tensor x, Tensor g, Tensor? gts, Tensor env, Tensor w, Tensor centers, "
                 f"Tensor row_ptr, Tensor entry_idx, Tensor entry_coef, {_PATHS}, "
                 "Tensor scatter_desc, Tensor scatter_scale, Tensor scatter_path_idx, "
                 "Tensor scatter_path_coef) -> (Tensor, Tensor)",
    "unweight_both": "(Tensor t, Tensor sh, Tensor wexp, Tensor centers, Tensor dim_to_irr) "
                     "-> (Tensor, Tensor)",
    "center_gather": "(Tensor a, Tensor idx) -> Tensor",
    "center_sum": "(Tensor v, Tensor row_ptr, Tensor? perm, bool chunked) -> Tensor",
    "latent_env_scatter": "(Tensor[] pieces, Tensor sh, Tensor w0, Tensor? w1, Tensor centers, "
                          "Tensor row_ptr, Tensor dim_to_irr, Tensor irr_ranges, int U, int S) "
                          "-> (Tensor, Tensor)",
    "latent_env_bwd": "(Tensor[] pieces, Tensor sh, Tensor w0, Tensor? w1, Tensor t, "
                      "Tensor g_lat, Tensor centers, Tensor dim_to_irr, Tensor irr_ranges, "
                      "int U, int S) -> Tensor[]",
    "gather_tp_embed": "(Tensor sh, Tensor w2b, Tensor env, Tensor w, Tensor centers, "
                       "Tensor row_ptr, Tensor entry_idx, Tensor entry_coef, Tensor row_specs, "
                       f"int d3, bool split, {_PATHS}) -> (Tensor, Tensor)",
    "bwd_embed": "(Tensor sh, Tensor w2b, Tensor g, Tensor? gts, Tensor env, Tensor w, "
                 "Tensor centers, Tensor row_ptr, Tensor entry_idx, Tensor entry_coef, "
                 f"Tensor row_specs, {_PATHS}) -> (Tensor, Tensor, Tensor)",
    "readout_sum": "(Tensor[] pieces, Tensor w0, Tensor? w1, Tensor row_ptr) -> Tensor",
    "readout_bwd": "(Tensor[] pieces, Tensor w0, Tensor? w1, Tensor y, Tensor centers) "
                   "-> Tensor[]",
}

_TRACING = False


@contextlib.contextmanager
def tracing():
    """Within: the inference Functions call the ``atpt`` ops, so that a
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


def _define(name: str):
    """The decorator that makes a function the op ``atpt::name``."""
    return torch.library.custom_op(f"{NAMESPACE}::{name}", mutates_args=(), schema=SCHEMAS[name])


def _empty(like: torch.Tensor, *shape) -> torch.Tensor:
    return like.new_empty(shape)


def _like(t: torch.Tensor) -> torch.Tensor:
    """A dense tensor of ``t``'s shape and type (the kernels' outputs)."""
    return t.new_empty(t.shape)


# ---------------------------------------------------------------------------
# the ops: their implementations (the wrappers) and fakes
# ---------------------------------------------------------------------------


@_define("env_scatter")
def _env_scatter(sh, wexp, centers, row_ptr, dim_to_irr, U):
    return fused_tp.env_scatter(*_c(sh, wexp, centers, row_ptr, dim_to_irr), U)


@_env_scatter.register_fake
def _(sh, wexp, centers, row_ptr, dim_to_irr, U):
    return _empty(sh, row_ptr.shape[0] - 1, sh.shape[1] * U)


@_define("gather_tp")
def _gather_tp(x, env, w, centers, entry_idx, entry_coef, d3, split, desc, scale, path_idx,
               path_coef):
    x, env, w, centers = _c(x, env, w, centers)
    res = fused_tp.gather_tp(x, env, w, centers, entry_idx, entry_coef, d3, split,
                             CgPaths(*_c(desc, scale, path_idx, path_coef)))
    return tuple(_own(res if split else (res, _empty(env, x.shape[0], 0))))


@_gather_tp.register_fake
def _(x, env, w, centers, entry_idx, entry_coef, d3, split, *paths):
    E, U = x.shape[0], w.shape[1]
    return _empty(x, E, d3 * U), _empty(env, E, U if split else 0)


@_define("bwd_fused")
def _bwd_fused(x, g, gts, env, w, centers, row_ptr, entry_idx, entry_coef, desc, scale,
               path_idx, path_coef, scatter_desc, scatter_scale, scatter_path_idx,
               scatter_path_coef):
    x, g, gts, env, w, centers, row_ptr, entry_idx, entry_coef = _c(
        x, g, gts, env, w, centers, row_ptr, entry_idx, entry_coef)
    return tuple(_own(fused_tp.bwd_fused(
        x, g, env, w, centers, row_ptr, entry_idx, entry_coef, gts,
        paths=CgPaths(*_c(desc, scale, path_idx, path_coef)),
        scatter_paths=CgPaths(*_c(scatter_desc, scatter_scale, scatter_path_idx,
                                  scatter_path_coef)))))


@_bwd_fused.register_fake
def _(x, g, gts, env, *rest):
    return _like(x), _like(env)


@_define("unweight_both")
def _unweight_both(t, sh, wexp, centers, dim_to_irr):
    return tuple(_own(fused_tp.unweight_both(*_c(t, sh, wexp, centers, dim_to_irr))))


@_unweight_both.register_fake
def _(t, sh, wexp, centers, dim_to_irr):
    return _like(sh), _like(wexp)


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


@_define("latent_env_scatter")
def _latent_env_scatter(pieces, sh, w0, w1, centers, row_ptr, dim_to_irr, irr_ranges, U, S):
    return tuple(_own(fused_tp.latent_env_scatter(
        _pieces(pieces), *_c(sh, w0, w1, centers, row_ptr, dim_to_irr), U, S, *_c(irr_ranges))))


@_latent_env_scatter.register_fake
def _(pieces, sh, w0, w1, centers, row_ptr, dim_to_irr, irr_ranges, U, S):
    return _empty(sh, sh.shape[0], S), _empty(sh, row_ptr.shape[0] - 1, sh.shape[1] * U)


@_define("latent_env_bwd")
def _latent_env_bwd(pieces, sh, w0, w1, t, g_lat, centers, dim_to_irr, irr_ranges, U, S):
    dsh, dpieces = fused_tp.latent_env_bwd(_pieces(pieces), *_c(sh, w0, w1, t, g_lat, centers,
                                                                dim_to_irr), U, S,
                                           *_c(irr_ranges))
    return _own([dsh, *dpieces])


@_latent_env_bwd.register_fake
def _(pieces, sh, *rest):
    return [_like(sh), *(_like(p) for p in pieces)]


@_define("gather_tp_embed")
def _gather_tp_embed(sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs, d3,
                     split, desc, scale, path_idx, path_coef):
    sh, w2b, env, w, centers, row_ptr, row_specs = _c(sh, w2b, env, w, centers, row_ptr,
                                                      row_specs)
    res = fused_tp.gather_tp_embed(sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef,
                                   row_specs, d3, split,
                                   CgPaths(*_c(desc, scale, path_idx, path_coef)))
    return tuple(_own(res if split else (res, _empty(sh, sh.shape[0], 0))))


@_gather_tp_embed.register_fake
def _(sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs, d3, split, *paths):
    E, U = sh.shape[0], w.shape[1]
    return _empty(sh, E, d3 * U), _empty(sh, E, U if split else 0)


@_define("bwd_embed")
def _bwd_embed(sh, w2b, g, gts, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs,
               desc, scale, path_idx, path_coef):
    sh, w2b, g, gts, env, w, centers, row_ptr, row_specs = _c(sh, w2b, g, gts, env, w, centers,
                                                              row_ptr, row_specs)
    return tuple(_own(fused_tp.bwd_embed(sh, w2b, g, env, w, centers, row_ptr, entry_idx,
                                         entry_coef, row_specs, gts,
                                         CgPaths(*_c(desc, scale, path_idx, path_coef)))))


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


# ---------------------------------------------------------------------------
# what the Functions call: the wrapper eagerly, the op inside ``tracing()``
# ---------------------------------------------------------------------------


def _ops():
    return getattr(torch.ops, NAMESPACE)


def _untraced(what: str, **dtypes) -> None:
    if any(v is not None for v in dtypes.values()):
        raise NotImplementedError(
            f"{what}: the bf16 track is not exported (ROADMAP.md queue 1, item 10)")


def env_scatter(sh, wexp, centers, row_ptr, dim_to_irr, U: int):
    if not _TRACING:
        return fused_tp.env_scatter(sh, wexp, centers, row_ptr, dim_to_irr, U)
    return _ops().env_scatter(sh, wexp, centers, row_ptr, dim_to_irr, U)


def gather_tp(x, env, w, centers, entry_idx, entry_coef, d3: int, split: bool = False,
              paths: Optional[CgPaths] = None):
    if not _TRACING:
        return fused_tp.gather_tp(x, env, w, centers, entry_idx, entry_coef, d3, split, paths)
    out, ts = _ops().gather_tp(x, env, w, centers, entry_idx, entry_coef, d3, split, *paths)
    return (out, ts) if split else out


def bwd_fused(x, g, env, w, centers, row_ptr, entry_idx, entry_coef, gts=None,
              paths: Optional[CgPaths] = None, scatter_paths: Optional[CgPaths] = None):
    if not _TRACING:
        return fused_tp.bwd_fused(x, g, env, w, centers, row_ptr, entry_idx, entry_coef, gts,
                                  paths=paths, scatter_paths=scatter_paths)
    return tuple(_ops().bwd_fused(x, g, gts, env, w, centers, row_ptr, entry_idx, entry_coef,
                                  *paths, *scatter_paths))


def unweight_both(t, sh, wexp, centers, dim_to_irr, out_dtype=None):
    if not _TRACING:
        return fused_tp.unweight_both(t, sh, wexp, centers, dim_to_irr, out_dtype)
    _untraced("unweight_both", out_dtype=out_dtype)
    return tuple(_ops().unweight_both(t, sh, wexp, centers, dim_to_irr))


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
    _untraced("latent_env_scatter", wexp_dtype=wexp_dtype)
    return tuple(_ops().latent_env_scatter(list(pieces), sh, w0, w1, centers, row_ptr,
                                           dim_to_irr, _ranges(irr_ranges, dim_to_irr), U, S))


def latent_env_bwd(pieces, sh, w0, w1, t, g_lat, centers, dim_to_irr, U: int, S: int,
                   irr_ranges=None, wexp_dtype=None):
    if not _TRACING:
        return fused_tp.latent_env_bwd(pieces, sh, w0, w1, t, g_lat, centers, dim_to_irr, U, S,
                                       irr_ranges, wexp_dtype)
    _untraced("latent_env_bwd", wexp_dtype=wexp_dtype)
    dsh, *dpieces = _ops().latent_env_bwd(list(pieces), sh, w0, w1, t, g_lat, centers,
                                          dim_to_irr, _ranges(irr_ranges, dim_to_irr), U, S)
    return dsh, tuple(dpieces)


def _embed_paths(paths, entry_idx, entry_coef, device) -> CgPaths:
    return path_table(entry_idx, entry_coef).to(device) if paths is None else paths


def gather_tp_embed(sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs,
                    d3: int, split: bool = False, paths=None, out_dtype=None):
    if not _TRACING:
        return fused_tp.gather_tp_embed(sh, w2b, env, w, centers, row_ptr, entry_idx,
                                        entry_coef, row_specs, d3, split, paths, out_dtype)
    _untraced("gather_tp_embed", out_dtype=out_dtype)
    out, ts = _ops().gather_tp_embed(sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef,
                                     row_specs, d3, split,
                                     *_embed_paths(paths, entry_idx, entry_coef, sh.device))
    return (out, ts) if split else out


def bwd_embed(sh, w2b, g, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs, gts=None,
              paths=None):
    if not _TRACING:
        return fused_tp.bwd_embed(sh, w2b, g, env, w, centers, row_ptr, entry_idx, entry_coef,
                                  row_specs, gts, paths)
    return tuple(_ops().bwd_embed(sh, w2b, g, gts, env, w, centers, row_ptr, entry_idx,
                                  entry_coef, row_specs,
                                  *_embed_paths(paths, entry_idx, entry_coef, sh.device)))


def readout_sum(pieces, w0, w1, row_ptr):
    if not _TRACING:
        return fused_tp.readout_sum(pieces, w0, w1, row_ptr)
    return _ops().readout_sum(list(pieces), w0, w1, row_ptr)


def readout_bwd(pieces, w0, w1, y, centers) -> List[torch.Tensor]:
    if not _TRACING:
        return fused_tp.readout_bwd(pieces, w0, w1, y, centers)
    return tuple(_ops().readout_bwd(list(pieces), w0, w1, y, centers))
