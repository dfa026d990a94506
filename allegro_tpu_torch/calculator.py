"""Single-point calculator (twin of ``allegro_tpu/calculator.py``).

``AllegroCalculator`` evaluates energy, per-atom energies, forces and stress
of one configuration at a time. It builds the neighbor list, pads atoms and
edges into sticky grow-only buckets (so repeated calls, as in a relaxation,
give the model the same shapes) and attaches the model's per-neighbor-list
statics (``Model.precompute_statics``). It runs on the CUDA card unless
``device="cpu"`` is given, and raises without a card. If the optional
``ase`` package is importable, ``as_ase()`` returns an ``ase`` calculator
wrapping it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .data import batch_frames, keys, neighbor_list, round_up, to_torch
from .data.datasets import species_to_types
from .device import resolve_device


def _host(t: torch.Tensor) -> np.ndarray:
    """A result as a numpy array. numpy has no bfloat16: a bfloat16 model's
    bfloat16 results (JAX returns them as ``ml_dtypes.bfloat16`` arrays)
    come back as float32 arrays of the same values."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


class AllegroCalculator:
    def __init__(
        self,
        model,
        r_max: Optional[float] = None,
        type_names: Optional[Sequence[str]] = None,
        atom_multiple: int = 8,
        edge_multiple: int = 256,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        self.model = model
        self.r_max = float(r_max if r_max is not None else model.config["r_max"])
        self.type_names = list(
            type_names if type_names is not None else model.config.get("type_names", [])
        )
        self.atom_multiple = atom_multiple
        self.edge_multiple = edge_multiple
        self.dtype = dtype
        self.device = resolve_device(device)
        self.n_atoms_pad = 0
        self.n_edges_pad = 0

    def calculate(
        self,
        positions: np.ndarray,
        atom_types: Optional[np.ndarray] = None,
        atomic_numbers: Optional[np.ndarray] = None,
        cell: Optional[np.ndarray] = None,
        pbc=(False, False, False),
    ) -> Dict[str, np.ndarray]:
        if atom_types is None:
            if atomic_numbers is None:
                raise ValueError("need atom_types or atomic_numbers")
            atom_types = species_to_types(atomic_numbers, self.type_names)
        n = len(positions)
        frame = {
            keys.POSITIONS: np.asarray(positions, dtype=np.float64),
            keys.ATOM_TYPES: np.asarray(atom_types, dtype=np.int32),
        }
        if cell is not None:
            frame[keys.CELL] = np.asarray(cell, dtype=np.float64).reshape(3, 3)
            frame[keys.PBC] = np.asarray(pbc, dtype=bool)
        frame = neighbor_list(frame, self.r_max)
        e = frame[keys.EDGE_INDEX].shape[1]
        # sticky grow-only buckets: the same padded shapes across calls
        self.n_atoms_pad = max(self.n_atoms_pad, round_up(n + 1, self.atom_multiple))
        self.n_edges_pad = max(self.n_edges_pad, round_up(max(e, 1), self.edge_multiple))
        batch = batch_frames([frame], n_atoms=self.n_atoms_pad, n_edges=self.n_edges_pad,
                             n_frames=1)
        batch = self.model.precompute_statics(batch)
        out = self.model.apply_with_derivatives(
            to_torch(batch, dtype=self.dtype, device=self.device)
        )
        res = {
            "energy": float(out[keys.TOTAL_ENERGY].sum()),
            "energies": _host(out[keys.PER_ATOM_ENERGY][:n, 0]),
            "forces": _host(out[keys.FORCES][:n]),
        }
        if keys.STRESS in out:
            res["stress"] = _host(out[keys.STRESS][0])
            res["virial"] = _host(out[keys.VIRIAL][0])
        return res

    def as_ase(self):
        """Return an ``ase`` Calculator wrapper (requires ase installed)."""
        from ase.calculators.calculator import Calculator, all_changes  # type: ignore

        outer = self

        class _ASEAllegro(Calculator):
            implemented_properties = ["energy", "energies", "forces", "stress"]

            def calculate(self, atoms=None, properties=("energy",), system_changes=all_changes):
                super().calculate(atoms, properties, system_changes)
                res = outer.calculate(
                    atoms.get_positions(),
                    atomic_numbers=atoms.get_atomic_numbers(),
                    cell=np.asarray(atoms.get_cell()) if atoms.pbc.any() else None,
                    pbc=atoms.pbc,
                )
                self.results = {
                    "energy": res["energy"],
                    "energies": res["energies"],
                    "forces": res["forces"],
                }
                if "stress" in res:
                    s = res["stress"]
                    self.results["stress"] = np.array(
                        [s[0, 0], s[1, 1], s[2, 2], s[1, 2], s[0, 2], s[0, 1]]
                    )

        return _ASEAllegro()
