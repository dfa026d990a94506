"""Extended-XYZ reader and writer, an ASE-compatible subset (twin of
``allegro_tpu/data/xyz.py``).

Per frame: ``Lattice="..."`` and ``pbc="..."``,
``Properties=species:S:1:pos:R:3[:forces:R:3]`` and an ``energy=...``
comment field. Chemical symbols become ``ATOMIC_NUMBERS``; other species
labels become contiguous ``ATOM_TYPES`` in order of appearance.
"""

from __future__ import annotations

import shlex
from typing import Dict, List, Optional

import numpy as np

from . import keys
from .datasets import ATOMIC_NUMBERS, CHEMICAL_SYMBOLS, InMemoryDataset


def _parse_comment(line: str) -> Dict[str, str]:
    out = {}
    for tok in shlex.split(line):
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k] = v
    return out


def read_extxyz(path: str, limit: Optional[int] = None) -> List[Dict[str, np.ndarray]]:
    """Parse an (ext)xyz file into a list of frame dicts (at most ``limit``)."""
    frames = []
    with open(path) as f:
        while True:
            header = f.readline()
            if not header.strip():
                break
            n = int(header)
            info = _parse_comment(f.readline())
            fields = info.get("Properties", "species:S:1:pos:R:3").split(":")
            cols = [(fields[i], int(fields[i + 2])) for i in range(0, len(fields) - 2, 3)]
            rows = [f.readline().split() for _ in range(n)]
            frame: Dict[str, np.ndarray] = {}
            c0 = 0
            for name, width in cols:
                block = [r[c0 : c0 + width] for r in rows]
                c0 += width
                if name == "species":
                    syms = [s[0] for s in block]
                    if all(s in ATOMIC_NUMBERS for s in syms):
                        frame[keys.ATOMIC_NUMBERS] = np.array(
                            [ATOMIC_NUMBERS[s] for s in syms], dtype=np.int32)
                    else:
                        seen: Dict[str, int] = {}
                        for s in syms:
                            seen.setdefault(s, len(seen))
                        frame[keys.ATOM_TYPES] = np.array([seen[s] for s in syms], dtype=np.int32)
                        frame["_species"] = list(seen)
                elif name == "pos":
                    frame[keys.POSITIONS] = np.array(block, dtype=np.float64)
                elif name in ("forces", "force"):
                    frame[keys.FORCES] = np.array(block, dtype=np.float64)
            if "Lattice" in info:
                frame[keys.CELL] = np.array(info["Lattice"].strip('"').split(),
                                            dtype=np.float64).reshape(3, 3)
                pbc = info.get("pbc", "T T T").strip('"').split()
                frame[keys.PBC] = np.array([p in ("T", "True", "1") for p in pbc])
            for k in ("energy", "Energy", "total_energy"):
                if k in info:
                    frame[keys.TOTAL_ENERGY] = np.array([float(info[k])])
                    break
            frames.append(frame)
            if limit is not None and len(frames) >= limit:
                break
    return frames


def extxyz_dataset(path: str, r_max: float, type_names=None,
                   n_frames: Optional[int] = None) -> InMemoryDataset:
    """The frames of an extxyz file with their neighbor lists; the type names
    default to the species present, in order of atomic number."""
    frames = read_extxyz(path, limit=n_frames)
    if type_names is None:
        zs = sorted({int(z) for fr in frames for z in fr[keys.ATOMIC_NUMBERS]})
        type_names = [CHEMICAL_SYMBOLS[z] for z in zs]
    return InMemoryDataset(frames, r_max, type_names=type_names)


def write_extxyz(path: str, frames: List[Dict[str, np.ndarray]], type_names=None) -> None:
    """Write frames out (round trips through :func:`read_extxyz`; the MD
    trajectory dump). Species are chemical symbols from ``ATOMIC_NUMBERS``,
    else ``type_names[ATOM_TYPES]``."""
    with open(path, "w") as f:
        for fr in frames:
            pos = np.asarray(fr[keys.POSITIONS])
            n = len(pos)
            if keys.ATOMIC_NUMBERS in fr:
                syms = [CHEMICAL_SYMBOLS[int(z)] for z in fr[keys.ATOMIC_NUMBERS]]
            else:
                syms = [type_names[int(t)] for t in fr[keys.ATOM_TYPES]]
            props = "Properties=species:S:1:pos:R:3"
            has_forces = keys.FORCES in fr
            if has_forces:
                props += ":forces:R:3"
            info = [props]
            if keys.CELL in fr:
                cell = np.asarray(fr[keys.CELL]).reshape(3, 3)
                info.insert(0, 'Lattice="' + " ".join(f"{x:.10g}" for x in cell.ravel()) + '"')
                pbc = np.asarray(fr.get(keys.PBC, np.ones(3, bool))).reshape(3)
                info.append('pbc="' + " ".join("T" if p else "F" for p in pbc) + '"')
            if keys.TOTAL_ENERGY in fr:
                info.append(f"energy={float(np.asarray(fr[keys.TOTAL_ENERGY]).sum()):.10g}")
            f.write(f"{n}\n{' '.join(info)}\n")
            forces = np.asarray(fr[keys.FORCES]) if has_forces else None
            for i in range(n):
                row = f"{syms[i]} " + " ".join(f"{x:.10g}" for x in pos[i])
                if forces is not None:
                    row += " " + " ".join(f"{x:.10g}" for x in forces[i])
                f.write(row + "\n")
