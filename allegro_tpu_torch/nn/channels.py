"""Broadcast a multiplicity-1 tensor basis into ``mul`` weighted channels
(twin of ``allegro_tpu/nn/channels.py``: one weight per channel and irrep,
flat dim-major layout only).

Weights are irrep-major: column ``irr*mul + u`` weights channel ``u`` of
irrep ``irr``. The output is the flat dim-major ``[E, dim*mul]`` tensor
track, column ``i*mul + u`` being basis dim ``i``, channel ``u``.
"""

from __future__ import annotations

import functools

import torch

from ..lib.irreps import Irreps


@functools.lru_cache(maxsize=None)
def device_index(values: tuple, device: torch.device) -> torch.Tensor:
    """An index table on ``device``, uploaded once: an upload per call would
    make the host wait for the device."""
    return torch.as_tensor(values, device=device)


class MakeWeightedChannels:
    def __init__(self, irreps_in, multiplicity_out: int):
        self.irreps_in = Irreps(irreps_in)
        if not all(mi.mul == 1 for mi in self.irreps_in):
            raise ValueError("basis must be multiplicity-1")
        self.mul_out = int(multiplicity_out)
        self.weight_numel = self.mul_out * len(self.irreps_in)
        self.dim_to_irr = tuple(
            k for k, sl in enumerate(self.irreps_in.slices()) for _ in range(sl.stop - sl.start)
        )

    def flat_dim_major(self, edge_attr: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """edge_attr [E, dim], weights [E, n_irr*mul] → [E, dim*mul]."""
        E, dim = edge_attr.shape
        idx = device_index(self.dim_to_irr, weights.device)
        w = weights.reshape(E, len(self.irreps_in), self.mul_out).index_select(1, idx)
        return (edge_attr[:, :, None] * w).reshape(E, dim * self.mul_out)
