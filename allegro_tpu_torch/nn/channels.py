"""Broadcast a multiplicity-1 tensor basis into ``mul`` weighted channels
(twin of ``allegro_tpu/nn/channels.py``, flat dim-major layout only).

With ``weight_individual_irreps`` (the default) there is one weight per
channel and irrep, irrep-major: column ``irr*mul + u`` weights channel ``u``
of irrep ``irr``. Without it there is one weight per channel, shared by all
irreps (``weight_numel = mul``). The output is the flat dim-major
``[E, dim*mul]`` tensor track, column ``i*mul + u`` being basis dim ``i``,
channel ``u``.
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
    def __init__(self, irreps_in, multiplicity_out: int, weight_individual_irreps: bool = True):
        self.irreps_in = Irreps(irreps_in)
        if not all(mi.mul == 1 for mi in self.irreps_in):
            raise ValueError("basis must be multiplicity-1")
        self.mul_out = int(multiplicity_out)
        self.weight_individual_irreps = bool(weight_individual_irreps)
        self.n_irr = len(self.irreps_in)
        self.weight_numel = self.mul_out * (self.n_irr if weight_individual_irreps else 1)
        self.dim_to_irr = tuple(
            k for k, sl in enumerate(self.irreps_in.slices()) for _ in range(sl.stop - sl.start)
        )

    def per_irrep(self, weights: torch.Tensor) -> torch.Tensor:
        """The weights as ``[E, n_irr*mul]`` irrep-major columns: the shared
        weights tiled over the irreps (as JAX's fused layer does)."""
        return weights if self.weight_individual_irreps else weights.repeat(1, self.n_irr)

    def flat_dim_major(self, edge_attr: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """edge_attr [E, dim], weights [E, weight_numel] → [E, dim*mul].

        Each irrep's weight block is broadcast over its basis dims and the
        blocks concatenated, not gathered with a repeated index: the gather's
        backward would be an ``index_add`` with colliding rows, which sums in
        a run-to-run order on the card; this one's is a slice and a sum."""
        E = edge_attr.shape[0]
        U = self.mul_out
        w = weights.reshape(E, -1, U)
        blocks = []
        for k, sl in enumerate(self.irreps_in.slices()):
            col = w[:, k : k + 1] if self.weight_individual_irreps else w
            blocks.append(col.expand(E, sl.stop - sl.start, U))
        w = torch.cat(blocks, dim=1) if len(blocks) > 1 else blocks[0]
        return (edge_attr[:, :, None] * w).reshape(E, -1)
