"""Channelwise Clebsch–Gordan tensor product fused with the neighbor
environment sum (twin of ``allegro_tpu/nn/contract.py``).

The tensor track is flat dim-major ``[E, d*U]``. Two backends share one
parameter set (``path_weights``, ``(mul, P)`` with path-channel coupling,
else ``(P,)``):

- ``"einsum"``: plain torch — ``env_sum`` (scatter edges → atoms, gather
  back) then ``contract`` (a static loop over the first input's basis dims).
- ``"fused_infer"``: ``fused_layer_infer``, the four CUDA kernels (their
  plain versions on the CPU); the mega-fused layers of ``nn/allegro.py``
  drive the kernels themselves with ``fused_infer_parts``.
- ``"fused"``: ``fused_layer``, the trainable family of autograd Functions
  (differentiable to any order, real weight gradients).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..lib.irreps import Irreps
from ..lib.wigner import wigner_3j
from ..ops.fused_primitives import FusedStatics, fused_layer, fused_layer_infer
from ..ops.fused_tp import gather_rows, segment_sum, swap_entries

Entry = Tuple[int, int, int, int, float]  # (i, j, k, p, c)


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


class Contracter(nn.Module):
    """``forward(x1 [E, d1*U], x2 [E, d2*U], centers [E], n_atoms)`` →
    ``[E, d_out*U]`` on the einsum backend; ``fused_call`` on the kernel
    backends (``kernel_backend`` "fused_infer" or "fused")."""

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
    ):
        super().__init__()
        self.kernel_backend = kernel_backend
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
        self.n_irr = len(irreps_in2)
        dim_to_irr = [k for k, sl in enumerate(irreps_in2.slices()) for _ in range(sl.stop - sl.start)]
        self.register_buffer("dim_to_irr", torch.tensor(dim_to_irr, dtype=torch.int32),
                             persistent=False)

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

    def env_sum(self, x2: torch.Tensor, centers: torch.Tensor, n_atoms: int) -> torch.Tensor:
        """Neighbor-environment sum: scatter edges → atoms, gather back."""
        if self.scatter_factor is not None:
            x2 = x2 * self.scatter_factor
        return gather_rows(segment_sum(x2, centers, n_atoms), centers)

    def contract(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """CG contraction ``out[e,k,u] = Σ_ij x1[e,i,u] x2[e,j,u] WW[u,i,j,k]``
        as a loop over the first input's basis dims."""
        E, U = x1.shape[0], self.mul
        ww = torch.einsum("up,pijk->uijk", self._w_up(x1.dtype), self.w3j.to(x1.dtype))
        x1v, x2v = x1.view(E, self.d1, U), x2.view(E, self.d2, U)
        out = None
        for i in range(self.d1):
            t = x1v[:, i : i + 1, :] * torch.einsum("eju,ujk->eku", x2v, ww[:, i])
            out = t if out is None else out + t
        return out.reshape(E, self.d3 * U)

    def forward(self, x1, x2, centers, n_atoms: int) -> torch.Tensor:
        return self.contract(x1, self.env_sum(x2, centers, n_atoms))

    def fused_infer_parts(self, dtype):
        """(wk [P, U], entry_idx, entry_coef) for the fused kernels; the
        scatter factor must already be folded into the env weights."""
        if self.scatter_factor is not None:
            raise ValueError("the fused kernels expect the scatter factor folded into the weights")
        return self._w_up(dtype).T.contiguous(), self.entry_idx, self.entry_coef.to(dtype)

    def fused_call(self, x, sh, wexp, centers, row_ptr) -> torch.Tensor:
        """Whole layer update (env weight + scatter + gather + CG) through the
        fused kernels: ``fused_layer`` on ``fused`` (differentiable weights),
        ``fused_layer_infer`` on ``fused_infer`` (NaN weight gradients)."""
        wk, entry_idx, entry_coef = self.fused_infer_parts(x.dtype)
        if self.kernel_backend == "fused":
            st = FusedStatics(centers, row_ptr, self.dim_to_irr, self.n_irr, self.mul, entry_idx,
                              self.entry_swapped, entry_coef, self.num_paths,
                              (self.d1, self.d2, self.d3))
            return fused_layer(x, sh, wexp, wk, st)
        return fused_layer_infer(
            x, sh, wexp, wk, centers, row_ptr, entry_idx, entry_coef, self.dim_to_irr, self.d3,
        )
