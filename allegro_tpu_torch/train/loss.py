"""Energy/force losses and metrics (twin of ``allegro_tpu/train/loss.py``).

Weighted MSE on the total energy (optionally per atom) and the forces, and
MAE/RMSE metrics. Every reduction is masked, so padded atoms and frames add
nothing.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..data import keys


def _masks(data: Dict):
    e = data[keys.TOTAL_ENERGY]
    fm, nm = data.get(keys.FRAME_MASK), data.get(keys.NODE_MASK)
    frame_mask = fm.to(e.dtype) if fm is not None else e.new_ones(e.shape[0])
    node_mask = nm.to(e.dtype) if nm is not None else e.new_ones(data[keys.POSITIONS].shape[0])
    return frame_mask, node_mask, data[keys.NUM_NODES].to(e.dtype)


class EnergyForceLoss:
    """``coeffs`` maps {"total_energy", "per_atom_energy", "forces"} → weight."""

    def __init__(self, coeffs: Optional[Dict[str, float]] = None):
        self.coeffs = dict(coeffs or {"per_atom_energy": 1.0, "forces": 1.0})

    def __call__(self, pred: Dict, ref: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        frame_mask, node_mask, n_per_frame = _masks(ref)
        n_frames = frame_mask.sum().clamp_min(1.0)
        n_nodes = node_mask.sum().clamp_min(1.0)
        de = (pred[keys.TOTAL_ENERGY] - ref[keys.TOTAL_ENERGY])[:, 0] * frame_mask
        terms = {}
        if "total_energy" in self.coeffs:
            terms["total_energy"] = (de**2).sum() / n_frames
        if "per_atom_energy" in self.coeffs:
            terms["per_atom_energy"] = ((de / n_per_frame.clamp_min(1.0)) ** 2).sum() / n_frames
        if "forces" in self.coeffs:
            df = (pred[keys.FORCES] - ref[keys.FORCES]) * node_mask[:, None]
            terms["forces"] = (df**2).sum() / (3.0 * n_nodes)
        loss = sum(self.coeffs[k] * v for k, v in terms.items())
        return loss, terms


class EnergyForceMetrics:
    """MAE/RMSE metrics (masked means)."""

    def __call__(self, pred: Dict, ref: Dict) -> Dict[str, torch.Tensor]:
        frame_mask, node_mask, n_per_frame = _masks(ref)
        n_frames = frame_mask.sum().clamp_min(1.0)
        n_nodes = node_mask.sum().clamp_min(1.0)
        de = (pred[keys.TOTAL_ENERGY] - ref[keys.TOTAL_ENERGY])[:, 0] * frame_mask
        de_pa = de / n_per_frame.clamp_min(1.0)
        df = (pred[keys.FORCES] - ref[keys.FORCES]) * node_mask[:, None]
        return {
            "total_energy_mae": de.abs().sum() / n_frames,
            "per_atom_energy_mae": de_pa.abs().sum() / n_frames,
            "total_energy_rmse": ((de**2).sum() / n_frames).sqrt(),
            "forces_mae": df.abs().sum() / (3.0 * n_nodes),
            "forces_rmse": ((df**2).sum() / (3.0 * n_nodes)).sqrt(),
        }
