"""Chemical species → atom types (twin of the species mapping of
``allegro_tpu/data/datasets.py``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

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
