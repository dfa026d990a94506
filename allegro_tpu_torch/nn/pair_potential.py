"""ZBL universal repulsive pair potential (twin of
``allegro_tpu/nn/pair_potential.py``).

A short-range screened-Coulomb repulsion added to the per-atom energies,
parameter-free given the atomic numbers (metal units: eV, Å):

  V(r) = (14.399645 eV·Å) * Z1*Z2 / r * φ(r/a),
  a = 0.46850 / (Z1^0.23 + Z2^0.23),
  φ(x) = 0.18175 e^{-3.19980x} + 0.50986 e^{-0.94229x}
       + 0.28022 e^{-0.40290x} + 0.02817 e^{-0.20162x}

times the polynomial cutoff envelope of ``r / r_max``. Each directed edge
contributes half (pairs appear twice), and edges with ``EDGE_MASK`` False
contribute nothing. With the CSR statics (which ``Model.apply`` requires on
the kernel backends and drops on ``einsum``) the edge → atom sum is the
``center_sum`` kernel (edge order, no atomics), else a plain segment sum.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..data import keys
from ..ops.fused_primitives import center_scatter
from ..ops.fused_tp import segment_sum
from .cutoffs import PolynomialCutoff
from .edge_geometry import with_edge_vectors

_COULOMB_EV_ANG = 14.399645478425668  # e^2 / (4 pi eps0) in eV·Å


@functools.lru_cache(maxsize=None)
def _device_z(type_to_Z: Tuple[float, ...], dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """The atomic numbers by type on ``device``, uploaded once: an upload per
    call would make the host wait for the device (and, inside a traced call,
    be a host constant)."""
    return torch.as_tensor(type_to_Z, dtype=dtype, device=device)


class ZBLPairPotential:
    """Stateless: adds the ZBL pair energy to PER_ATOM_ENERGY."""

    def __init__(self, type_to_Z: Sequence[int], r_max: float, polynomial_cutoff_p: int = 6):
        self.type_to_Z = np.asarray(type_to_Z, dtype=np.float64)
        self.r_max = float(r_max)
        self.cutoff = PolynomialCutoff(polynomial_cutoff_p)

    def __call__(self, data: Dict) -> Dict:
        data = with_edge_vectors(data)
        r = data[keys.EDGE_LENGTH][:, 0]
        dtype = data[keys.PER_ATOM_ENERGY].dtype
        n_atoms = data[keys.POSITIONS].shape[0]
        ei = data[keys.EDGE_INDEX].long().clamp(0, n_atoms - 1)
        types = data[keys.ATOM_TYPES].long()
        Z = _device_z(tuple(self.type_to_Z.tolist()), r.dtype, r.device)
        Zi = Z.index_select(0, types.index_select(0, ei[0]))
        Zj = Z.index_select(0, types.index_select(0, ei[1]))
        a = 0.46850 / (Zi**0.23 + Zj**0.23)
        r_safe = r.clamp_min(1e-6)
        x = r_safe / a
        phi = (
            0.18175 * torch.exp(-3.19980 * x)
            + 0.50986 * torch.exp(-0.94229 * x)
            + 0.28022 * torch.exp(-0.40290 * x)
            + 0.02817 * torch.exp(-0.20162 * x)
        )
        v = _COULOMB_EV_ANG * Zi * Zj / r_safe * phi
        env = self.cutoff(r / self.r_max)
        e_edge = 0.5 * v * env
        if keys.EDGE_MASK in data:
            e_edge = e_edge * data[keys.EDGE_MASK].to(r.dtype)
        e_edge = e_edge.to(dtype)[:, None]
        if keys.CENTER_ROW_PTR in data:
            centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
            e_atom = center_scatter(e_edge.contiguous(), centers, data[keys.CENTER_ROW_PTR])
        else:
            e_atom = segment_sum(e_edge, data[keys.EDGE_INDEX][0], n_atoms)
        out = dict(data)
        out[keys.PER_ATOM_ENERGY] = data[keys.PER_ATOM_ENERGY] + e_atom
        return out
