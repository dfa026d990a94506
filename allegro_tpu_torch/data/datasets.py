"""Datasets, species mapping and dataset statistics (twin of
``allegro_tpu/data/datasets.py``, without the sGDML reader).

``InMemoryDataset`` holds frames with their neighbor lists,
``synthetic_molecular_frames`` makes labelled frames from a seed, and
``compute_statistics`` gives the values that configs interpolate as
``${training_data_stats:...}``: ``num_neighbors_mean``,
``per_atom_energy_mean``, ``per_type_energy_shifts`` and ``forces_rms``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from . import keys
from .neighborlist import neighbor_list

# Minimal periodic table (symbol → atomic number) for species mapping.
CHEMICAL_SYMBOLS = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn",
]
ATOMIC_NUMBERS = {s: i for i, s in enumerate(CHEMICAL_SYMBOLS)}


def species_to_types(atomic_numbers: np.ndarray, type_names: Sequence[str]) -> np.ndarray:
    """Map atomic numbers to contiguous type indices given ordered symbols."""
    z_to_type = -np.ones(len(CHEMICAL_SYMBOLS), dtype=np.int32)
    for t, sym in enumerate(type_names):
        z_to_type[ATOMIC_NUMBERS[sym]] = t
    types = z_to_type[np.asarray(atomic_numbers, dtype=np.int64)]
    if (types < 0).any():
        bad = sorted(set(np.asarray(atomic_numbers)[types < 0].tolist()))
        raise ValueError(f"atomic numbers {bad} not covered by type_names {type_names}")
    return types


class InMemoryDataset:
    """A list of frames with center-sorted neighbor lists precomputed; atom
    types come from ``ATOMIC_NUMBERS`` and ``type_names`` when absent."""

    def __init__(self, frames: List[Dict[str, np.ndarray]], r_max: float,
                 type_names: Optional[Sequence[str]] = None):
        self.r_max = float(r_max)
        self.type_names = list(type_names) if type_names is not None else None
        self.frames: List[Dict[str, np.ndarray]] = []
        for fr in frames:
            fr = dict(fr)
            if keys.ATOM_TYPES not in fr:
                if self.type_names is None:
                    raise ValueError("need type_names to map atomic numbers to types")
                fr[keys.ATOM_TYPES] = species_to_types(fr[keys.ATOMIC_NUMBERS], self.type_names)
            self.frames.append(neighbor_list(fr, r_max))

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return self.frames[i]

    @property
    def num_types(self) -> int:
        if self.type_names is not None:
            return len(self.type_names)
        return int(max(int(f[keys.ATOM_TYPES].max()) for f in self.frames)) + 1


def synthetic_molecular_frames(n_frames: int, n_atoms: int = 21, n_types: int = 3,
                               spread: float = 3.0, seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """Random aspirin-scale molecular frames with consistent labels: energy
    and forces of a sum of pair terms ``exp(-r) - 0.01 / r^2``."""
    rng = np.random.RandomState(seed)
    base = rng.randn(n_atoms, 3) * spread
    types = rng.randint(0, n_types, size=n_atoms).astype(np.int32)
    frames = []
    for _ in range(n_frames):
        pos = base + 0.1 * rng.randn(n_atoms, 3)
        diff = pos[:, None, :] - pos[None, :, :]
        r = np.linalg.norm(diff, axis=-1) + np.eye(n_atoms)
        e_pair = np.exp(-r) - 0.01 / (r * r)
        np.fill_diagonal(e_pair, 0.0)
        de_dr = -np.exp(-r) + 0.02 / (r ** 3)
        np.fill_diagonal(de_dr, 0.0)
        frames.append({
            keys.POSITIONS: pos,
            keys.ATOM_TYPES: types,
            keys.TOTAL_ENERGY: np.asarray([0.5 * e_pair.sum()]),
            keys.FORCES: -(de_dr[:, :, None] * diff / r[:, :, None]).sum(axis=1),
        })
    return frames


def compute_statistics(dataset: InMemoryDataset) -> Dict[str, float]:
    """The dataset statistics that configs interpolate: mean neighbor count,
    mean per-atom energy, per-type energy shifts (least squares of the total
    energies on the type counts) and the force RMS."""
    n_neigh, e_per_atom, f_sq, f_n = [], [], 0.0, 0
    comp_rows, e_rows = [], []
    n_types = dataset.num_types
    for fr in dataset.frames:
        n = fr[keys.POSITIONS].shape[0]
        n_neigh.append(np.bincount(fr[keys.EDGE_INDEX][0], minlength=n))
        if keys.TOTAL_ENERGY in fr:
            e = float(np.asarray(fr[keys.TOTAL_ENERGY]).reshape(()))
            e_per_atom.append(e / n)
            comp_rows.append(np.bincount(fr[keys.ATOM_TYPES], minlength=n_types))
            e_rows.append(e)
        if keys.FORCES in fr:
            f_sq += float((np.asarray(fr[keys.FORCES]) ** 2).sum())
            f_n += fr[keys.FORCES].size
    stats: Dict[str, float] = {
        "num_neighbors_mean": float(np.concatenate(n_neigh).mean()) if n_neigh else 0.0,
    }
    if e_per_atom:
        stats["per_atom_energy_mean"] = float(np.mean(e_per_atom))
        shifts, _, _, _ = np.linalg.lstsq(np.stack(comp_rows).astype(np.float64),
                                          np.asarray(e_rows), rcond=None)
        stats["per_type_energy_shifts"] = shifts.tolist()
    if f_n:
        stats["forces_rms"] = float(np.sqrt(f_sq / f_n))
    return stats
