"""Channelwise Clebsch–Gordan tensor product fused with the neighbor
environment sum (twin of ``allegro_tpu/nn/contract.py``).

The tensor track is flat dim-major ``[E, d*U]``. The backends share one
parameter set (``path_weights``, ``(mul, P)`` with path-channel coupling,
else ``(P,)``):

- ``"einsum"``: plain torch — ``env_sum`` (scatter edges → atoms, gather
  back) then ``contract`` (a static loop over the first input's basis dims).
- ``"pallas"``: ``env_sum`` on the center CSR (required): ``center_scatter``
  then ``center_gather``, the ``center_sum`` and ``center_gather`` kernels,
  each the other's transpose, so the layer sums in a fixed order to any
  derivative order; then ``sparse_tp_layer``, the per-edge sparse CG kernel
  (``csrc/sparse_tp.cu``) behind the closed family ``SparseTp`` /
  ``SparseTpGradW`` (differentiable to any order).
- ``"fused_infer"``: ``fused_layer_infer``, the four CUDA kernels (their
  plain versions on the CPU); the mega-fused layers of ``nn/allegro.py``
  drive the kernels themselves with ``fused_infer_parts``.
- ``"fused"``: ``fused_layer``, the trainable family of autograd Functions
  (differentiable to any order, real weight gradients).

On both fused backends ``gather_tp`` and ``gather_dw`` walk the layer's
path tables (``gather_paths``: its entry order and the role swap), and
``tp_scatter`` (``fused``) and ``bwd_fused`` (``fused_infer``, denv) walk
those two orders with their roles permuted (0, 2, 1) (``scatter_paths``),
all built once here.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..lib.irreps import Irreps
from ..lib.wigner import wigner_3j
from ..ops.fused_primitives import (
    FusedStatics,
    center_gather,
    center_scatter,
    fused_layer,
    fused_layer_infer,
)
from ..ops.fused_tp import (SCATTER_ROLES, gather_rows, irrep_ranges, segment_sum,
                             swap_entries)
from ..ops.gen_cg_blocks import CgPaths, path_table
from ..ops.pallas_contract import ROLES, Entry, role_tables
from ..ops.tp_primitives import TpStatics, sparse_tp_layer


def enumerate_instructions(
    irreps_in1: Irreps, irreps_in2: Irreps, irreps_out: Irreps
) -> List[Tuple[int, int, int]]:
    """All (i1, i2, i_out) index triples allowed by the selection rules."""
    ins = []
    for a, mi1 in enumerate(irreps_in1):
        for b, mi2 in enumerate(irreps_in2):
            for c, mio in enumerate(irreps_out):
                if mio.ir in mi1.ir * mi2.ir:
                    ins.append((a, b, c))
    return ins


def pack_w3j(
    irreps_in1: Irreps,
    irreps_in2: Irreps,
    irreps_out: Irreps,
    instructions: List[Tuple[int, int, int]],
) -> np.ndarray:
    """Dense packed 3j buffer [P, dim1, dim2, dim_out], float64; each path's
    block scaled by sqrt(2 l_out + 1) ("component" normalization)."""
    s1, s2, s3 = irreps_in1.slices(), irreps_in2.slices(), irreps_out.slices()
    out = np.zeros((len(instructions), irreps_in1.dim, irreps_in2.dim, irreps_out.dim))
    for p, (a, b, c) in enumerate(instructions):
        l1, l2, l3 = irreps_in1[a].ir.l, irreps_in2[b].ir.l, irreps_out[c].ir.l
        out[p, s1[a], s2[b], s3[c]] = wigner_3j(l1, l2, l3) * math.sqrt(2 * l3 + 1)
    return out


def sparse_entries(w3j_packed: np.ndarray, tol: float = 1e-12) -> Tuple[Entry, ...]:
    """Nonzero entries (i, j, k, p, c) of the packed [P, d1, d2, d3] buffer,
    sorted by (i, j, k) (twin of ``allegro_tpu/ops/pallas_contract.py``)."""
    entries: List[Entry] = []
    for p in range(w3j_packed.shape[0]):
        for i, j, k in np.argwhere(np.abs(w3j_packed[p]) > tol):
            entries.append((int(i), int(j), int(k), int(p), float(w3j_packed[p, i, j, k])))
    entries.sort(key=lambda e: (e[0], e[1], e[2]))
    return tuple(entries)


def walk_tables(entry_idx, entry_swapped, entry_coef, columns,
                dtype=torch.float32) -> Tuple[CgPaths, CgPaths]:
    """The path tables (``path_table(by_output=True)``, on the CPU) of a
    layer's entry order and of its role swap, each with its (i, j, k, p)
    columns taken in ``columns``' order: ``[0, 1, 2, 3]`` for ``gather_tp``
    and ``gather_dw``, ``SCATTER_ROLES`` for ``tp_scatter``. ``entry_coef``
    must be the float64 coefficients."""
    return tuple(path_table(idx[:, columns], entry_coef, dtype, by_output=True)
                 for idx in (entry_idx, entry_swapped))


class Contracter(nn.Module):
    """``forward(x1 [E, d1*U], x2 [E, d2*U], centers [E], n_atoms, row_ptr)``
    → ``[E, d_out*U]`` on the ``einsum`` and ``pallas`` backends (``row_ptr``:
    the center CSR, which ``pallas`` requires and ``einsum`` ignores);
    ``fused_call`` on the fused kernel backends (``kernel_backend``
    "fused_infer" or "fused"). ``chunk_edges`` (> 0): the ``einsum``
    contraction runs over slices of that many edges (JAX's
    ``tp_chunk_edges``: bounded temporaries, the same result)."""

    def __init__(
        self,
        irreps_in1: str,
        irreps_in2: str,
        irreps_out: str,
        mul: int,
        path_channel_coupling: bool = True,
        scatter_factor: Optional[float] = None,
        dtype=torch.float32,
        kernel_backend: str = "einsum",
        chunk_edges: int = 0,
    ):
        super().__init__()
        self.kernel_backend = kernel_backend
        self.chunk_edges = int(chunk_edges or 0)
        irreps_in1, irreps_in2, irreps_out = Irreps(irreps_in1), Irreps(irreps_in2), Irreps(irreps_out)
        self.mul = int(mul)
        self.path_channel_coupling = bool(path_channel_coupling)
        self.scatter_factor = scatter_factor
        instructions = enumerate_instructions(irreps_in1, irreps_in2, irreps_out)
        if not instructions:
            raise ValueError("no valid paths")
        w3j = pack_w3j(irreps_in1, irreps_in2, irreps_out, instructions)
        P, self.d1, self.d2, self.d3 = w3j.shape
        shape = (self.mul, P) if self.path_channel_coupling else (P,)
        self.path_weights = nn.Parameter(torch.empty(shape, dtype=dtype))
        entries = sparse_entries(w3j)
        # the kernels' CG tables in their compute dtype: a bfloat16 model's
        # kernels compute in float32 with the coefficients JAX's kernels
        # read (Python floats), so its tables stay float32; the einsum
        # reference rounds w3j to the model dtype, as JAX's does
        kdt = torch.promote_types(torch.float32, dtype)
        self.register_buffer("w3j", torch.from_numpy(w3j), persistent=False)
        self.register_buffer(
            "entry_idx",
            torch.tensor([e[:4] for e in entries], dtype=torch.int32).reshape(-1, 4),
            persistent=False,
        )
        # the role swap of the x-transposes, built once
        self.register_buffer("entry_swapped", swap_entries(self.entry_idx), persistent=False)
        self.register_buffer(
            "entry_coef", torch.tensor([e[4] for e in entries], dtype=torch.float64),
            persistent=False,
        )
        # the table walked by path (the embed-fused backward), built once
        for name, t in zip(("cg_desc", "cg_scale", "cg_entry_idx", "cg_entry_coef"),
                           path_table(self.entry_idx, self.entry_coef, kdt)):
            self.register_buffer(name, t, persistent=False)
        if kernel_backend in ("fused", "fused_infer"):
            # the tables gather_tp and gather_dw walk: the layer's order and
            # its role swap (the x-transposes), each in the kernels' walk
            # order, built once from the float64 coefficients
            self._register_paths("walk", [0, 1, 2, 3], kdt)
            # the tables tp_scatter and bwd_fused's denv walk: both orders
            # with their roles permuted (0, 2, 1), so that the walk's out is
            # j (the env)
            self._register_paths("scatter", SCATTER_ROLES, kdt)
        self.n_irr = len(irreps_in2)
        dim_to_irr = [k for k, sl in enumerate(irreps_in2.slices()) for _ in range(sl.stop - sl.start)]
        self.register_buffer("dim_to_irr", torch.tensor(dim_to_irr, dtype=torch.int32),
                             persistent=False)
        self.register_buffer("irr_ranges", irrep_ranges(self.dim_to_irr), persistent=False)
        if kernel_backend == "pallas":
            # the table in every role order of the transposes, and each
            # order's path table in the kernels' walk order, built once from
            # the float64 coefficients (a float32 table is no CG block to 1e-12)
            tp_idx, tp_coef = role_tables(entries, torch.float64)
            self.register_buffer("tp_idx", tp_idx, persistent=False)
            self.register_buffer("tp_coef", tp_coef.to(kdt), persistent=False)
            for r in range(len(ROLES)):
                for name, t in zip(CgPaths._fields,
                                   path_table(tp_idx[r], tp_coef[r], kdt, by_output=True)):
                    self.register_buffer(f"tp_paths{r}_{name}", t, persistent=False)

    @property
    def num_paths(self) -> int:
        return self.w3j.shape[0]

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = math.sqrt(3.0)
        v = torch.rand(tuple(self.path_weights.shape), generator=generator, dtype=torch.float64)
        with torch.no_grad():
            self.path_weights.copy_((2.0 * v - 1.0) * bound)

    def _w_up(self, dtype) -> torch.Tensor:
        """Path weights as [U, P]."""
        w = self.path_weights.to(dtype)
        return w if self.path_channel_coupling else w[None, :].expand(self.mul, -1)

    def env_sum(self, x2: torch.Tensor, centers: torch.Tensor, n_atoms: int,
                row_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Neighbor-environment sum: scatter edges → atoms, gather back. The
        backend decides: ``einsum``, the reference, takes a plain segment sum
        and ignores ``row_ptr``; ``pallas`` takes the center kernels over the
        center CSR ``row_ptr`` (int32 ``centers``), which sum in edge order,
        and raises without it."""
        if self.scatter_factor is not None:
            x2 = x2 * self.scatter_factor
        if self.kernel_backend == "einsum":
            return gather_rows(segment_sum(x2, centers, n_atoms), centers)
        if row_ptr is None:
            raise ValueError(
                f"kernel_backend={self.kernel_backend!r} needs the center CSR row_ptr: "
                "call Model.precompute_statics(data) once per neighbor list"
            )
        return center_gather(center_scatter(x2.contiguous(), centers, row_ptr), centers, row_ptr)

    def contract(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """CG contraction ``out[e,k,u] = Σ_ij x1[e,i,u] x2[e,j,u] WW[u,i,j,k]``
        as a loop over the first input's basis dims; with ``chunk_edges``,
        over slices of that many edges."""
        ww = torch.einsum("up,pijk->uijk", self._w_up(x1.dtype), self.w3j.to(x1.dtype))
        C = self.chunk_edges
        if C and x1.shape[0] > C:
            return torch.cat([self._contract(x1[s : s + C], x2[s : s + C], ww)
                              for s in range(0, x1.shape[0], C)])
        return self._contract(x1, x2, ww)

    def _contract(self, x1, x2, ww) -> torch.Tensor:
        E, U = x1.shape[0], self.mul
        x1v, x2v = x1.view(E, self.d1, U), x2.view(E, self.d2, U)
        out = None
        for i in range(self.d1):
            t = x1v[:, i : i + 1, :] * torch.einsum("eju,ujk->eku", x2v, ww[:, i])
            out = t if out is None else out + t
        return out.reshape(E, self.d3 * U)

    def forward(self, x1, x2, centers, n_atoms: int, row_ptr=None) -> torch.Tensor:
        env = self.env_sum(x2, centers, n_atoms, row_ptr)
        if self.kernel_backend == "pallas":
            st = self.tp_statics()
            w = self._w_up(x1.dtype).T.contiguous()  # [P, U]
            return sparse_tp_layer(x1.contiguous(), env.contiguous(), w, st)
        return self.contract(x1, env)

    def tp_statics(self) -> TpStatics:
        """The ``pallas`` backend's statics: the six role orders' entry and
        path tables, gathered from the buffers once and again only after a
        move or cast has replaced them."""
        st = self.__dict__.get("_tp_statics")
        if st is None or st.entry_idx is not self.tp_idx or st.entry_coef is not self.tp_coef:
            paths = tuple(CgPaths(*(getattr(self, f"tp_paths{r}_{name}")
                                    for name in CgPaths._fields)) for r in range(len(ROLES)))
            st = TpStatics(self.tp_idx, self.tp_coef, (self.d1, self.d2, self.d3),
                           self.num_paths, paths)
            self.__dict__["_tp_statics"] = st
        return st

    def fused_infer_parts(self, dtype):
        """(wk [P, U] in ``dtype``, entry_idx, entry_coef in the kernels'
        compute dtype) for the fused kernels; the scatter factor must
        already be folded into the env weights."""
        if self.scatter_factor is not None:
            raise ValueError("the fused kernels expect the scatter factor folded into the weights")
        return (self._w_up(dtype).T.contiguous(), self.entry_idx,
                self.entry_coef.to(torch.promote_types(torch.float32, dtype)))

    def cg_paths(self) -> CgPaths:
        """The layer's path descriptors (``gen_cg_blocks.path_table``)."""
        return CgPaths(self.cg_desc, self.cg_scale, self.cg_entry_idx, self.cg_entry_coef)

    def _register_paths(self, prefix: str, columns, dtype) -> None:
        """Buffers ``{prefix}_*`` and ``{prefix}_swapped_*``: the layer's
        ``walk_tables(..., columns)``; non-persistent, so checkpoints do not
        change."""
        tables = walk_tables(self.entry_idx, self.entry_swapped, self.entry_coef, columns, dtype)
        for tag, paths in zip(("", "_swapped"), tables):
            for name, t in zip(CgPaths._fields, paths):
                self.register_buffer(f"{prefix}{tag}_{name}", t, persistent=False)

    def _buffer_paths(self, prefix: str) -> Tuple[CgPaths, CgPaths]:
        """The two path tables of ``_register_paths(prefix, ...)``, gathered
        from the buffers once and again only after a move or cast has
        replaced them."""
        cached = self.__dict__.get(f"_{prefix}_paths")
        if cached is None or cached[0].desc is not getattr(self, f"{prefix}_desc") \
                or cached[0].scale is not getattr(self, f"{prefix}_scale"):
            cached = tuple(CgPaths(*(getattr(self, f"{prefix}{tag}_{name}")
                                     for name in CgPaths._fields)) for tag in ("", "_swapped"))
            self.__dict__[f"_{prefix}_paths"] = cached
        return cached

    def gather_paths(self) -> Tuple[CgPaths, CgPaths]:
        """The path tables of ``gather_tp`` and ``gather_dw`` on ``fused`` and
        ``fused_infer``: the layer's entry order's and its role swap's, in
        walk order (``path_table(by_output=True)``)."""
        return self._buffer_paths("walk")

    def scatter_paths(self) -> Tuple[CgPaths, CgPaths]:
        """The path tables of ``tp_scatter`` on ``fused`` and of
        ``bwd_fused``'s denv walk on ``fused_infer``: the layer's entry
        order's and its role swap's, each with its roles permuted (0, 2, 1),
        in walk order."""
        return self._buffer_paths("scatter")

    def infer_paths(self) -> Tuple[CgPaths, CgPaths, CgPaths]:
        """The path tables of a ``fused_infer`` layer's kernels:
        ``gather_tp``'s (the layer's order), then ``bwd_fused``'s, the role
        swap's (dx) and the layer's order with roles (0, 2, 1) (denv)."""
        paths, swapped = self.gather_paths()
        return paths, swapped, self.scatter_paths()[0]

    def fused_call(self, x, sh, wexp, centers, row_ptr, split: bool = False,
                   wexp_dtype: Optional[torch.dtype] = None):
        """Whole layer update (env weight + scatter + gather + CG) through the
        fused kernels: ``fused_layer`` on ``fused`` (differentiable weights),
        ``fused_layer_infer`` on ``fused_infer`` (NaN weight gradients). On
        the bf16 track (x and wexp bfloat16) the path weights are cast to
        x's dtype, as JAX's are, so that their gradient's contributions are
        each rounded to it and summed in it; the kernels read them widened
        to float32 (``fused_primitives._wide``). ``split`` and ``wexp_dtype``
        (``fused_infer`` only, JAX's mega path for a mega model routed here):
        also return the leading 0e block, unrounded, as its own [E, U] array
        in the model dtype, ``(out, ts)``; the env weights, in the model
        dtype, stored in ``wexp_dtype`` for the kernels, their cotangent
        unrounded."""
        wk, entry_idx, entry_coef = self.fused_infer_parts(self.path_weights.dtype)
        wk = wk.to(x.dtype)
        if self.kernel_backend == "fused":
            if split or wexp_dtype is not None:
                raise ValueError("fused_call: split and wexp_dtype are for fused_infer")
            st = FusedStatics(centers, row_ptr, self.dim_to_irr, self.n_irr, self.mul, entry_idx,
                              self.entry_swapped, entry_coef, self.num_paths,
                              (self.d1, self.d2, self.d3), *self.gather_paths(),
                              *self.scatter_paths())
            return fused_layer(x, sh, wexp, wk, st)
        paths, swapped, scatter = self.infer_paths()
        return fused_layer_infer(
            x, sh, wexp, wk, centers, row_ptr, entry_idx, entry_coef, self.dim_to_irr, self.d3,
            paths, swapped_paths=swapped, scatter_paths=scatter, split=split,
            wexp_dtype=wexp_dtype,
        )
