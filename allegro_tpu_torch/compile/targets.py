"""Compile targets and ghost-atom data conversion (twin of
``allegro_tpu/compile/targets.py``).

The ``pair_allegro`` target declares inputs = (positions, edge_index,
atom_types), outputs = the MD-engine set (per-atom energy, forces, total
energy), drops batch keys (single-frame specialization), and converts
periodic data into **ghost-atom format**: every (neighbor, nonzero cell
shift) pair becomes an appended shifted copy of the atom, edges are rewired
to the copies, and the cell is dropped. Forces computed on ghosts are summed
back onto their owners (what LAMMPS does over MPI; here a segment sum).
``pair_allegro_stress`` adds the frame's virial, the fdotr sum Σ rᵢ ⊗ fᵢ
over real and ghost rows.

Artifact contract: the exported force call takes ``edge_index`` **sorted by
center atom** (row 0 non-decreasing over the real edges), padding edges
masked by ``edge_mask`` and trailing; the graph gives them the sentinel
center ``n_atoms`` itself. Every producer in the port (``data.neighborlist``,
MD's re-neighboring, the C++ driver's cell list) emits this order; a caller
feeding its own lists must sort. An unsorted list poisons the energies with
NaN (``Model.graph_statics``) instead of summing the wrong environments.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..data import keys

MD_ENGINE_OUTPUTS = (keys.PER_ATOM_ENERGY, keys.FORCES, keys.TOTAL_ENERGY)
# the exported program's inputs, in order
EXPORT_INPUTS = (keys.POSITIONS, keys.EDGE_INDEX, keys.ATOM_TYPES, keys.NODE_MASK,
                 keys.EDGE_MASK)


@dataclasses.dataclass(frozen=True)
class CompileTarget:
    name: str
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    data_settings: Optional[Callable[[Dict], Dict]] = None


COMPILE_TARGETS: Dict[str, CompileTarget] = {}


def register_compile_target(target: CompileTarget) -> CompileTarget:
    COMPILE_TARGETS[target.name] = target
    return target


def ghost_atom_conversion(frame: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Convert a periodic frame to ghost-atom (open-boundary) format.

    Each distinct ``(neighbor_atom, cell_shift != 0)`` pair becomes one ghost
    atom at ``pos[j] + shift @ cell``; edges are rewired to the ghosts; CELL,
    PBC and EDGE_CELL_SHIFT are dropped. Adds ``_ghost_owner`` ([N+G] int32,
    the owner of every row: the identity for real atoms) for the force
    collapse."""
    pos = np.asarray(frame[keys.POSITIONS], dtype=np.float64)
    n = pos.shape[0]
    eidx = np.asarray(frame[keys.EDGE_INDEX])
    types = np.asarray(frame[keys.ATOM_TYPES])
    shifts = frame.get(keys.EDGE_CELL_SHIFT)
    cell = np.asarray(frame.get(keys.CELL, np.zeros((3, 3)))).reshape(3, 3)
    out = dict(frame)
    for k in (keys.CELL, keys.PBC, keys.EDGE_CELL_SHIFT):
        out.pop(k, None)
    if shifts is None or not np.abs(np.asarray(shifts)).any():
        out["_ghost_owner"] = np.arange(n, dtype=np.int32)
        return out
    sh_int = np.rint(np.asarray(shifts)).astype(np.int64)
    is_ghost_edge = np.abs(sh_int).sum(axis=1) > 0
    # the distinct (neighbor, shift) pairs
    key_arr = np.stack([eidx[1], sh_int[:, 0], sh_int[:, 1], sh_int[:, 2]], axis=1)
    ghost_keys, inverse = np.unique(key_arr[is_ghost_edge], axis=0, return_inverse=True)
    g = ghost_keys.shape[0]
    owners = ghost_keys[:, 0].astype(np.int32)
    ghost_pos = pos[owners] + ghost_keys[:, 1:].astype(np.float64) @ cell
    new_neighbors = eidx[1].copy()
    new_neighbors[is_ghost_edge] = n + inverse.reshape(-1)
    out[keys.POSITIONS] = np.concatenate([pos, ghost_pos], axis=0)
    out[keys.ATOM_TYPES] = np.concatenate([types, types[owners]]).astype(types.dtype)
    out[keys.EDGE_INDEX] = np.stack([eidx[0], new_neighbors], axis=0).astype(np.int32)
    out["_ghost_owner"] = np.concatenate([np.arange(n, dtype=np.int32), owners])
    if keys.NODE_MASK in out:
        out[keys.NODE_MASK] = np.concatenate(
            [np.asarray(out[keys.NODE_MASK], bool), np.ones(g, bool)])
    return out


def collapse_ghost_forces(forces: np.ndarray, ghost_owner: np.ndarray, n_real: int) -> np.ndarray:
    """Sum ghost-atom force contributions back onto the owning real atoms
    (the single-process form of pair_allegro's MPI force return)."""
    out = np.zeros((n_real, forces.shape[1]), dtype=forces.dtype)
    np.add.at(out, np.asarray(ghost_owner), np.asarray(forces))
    return out


def _single_frame_settings(frame: Dict) -> Dict:
    """Drop batch bookkeeping (0/1-specialization) and convert PBC to ghosts."""
    frame = dict(frame)
    for k in (keys.BATCH, keys.NUM_NODES, keys.FRAME_MASK):
        frame.pop(k, None)
    return ghost_atom_conversion(frame)


register_compile_target(
    CompileTarget(
        name="pair_allegro",
        inputs=(keys.POSITIONS, keys.EDGE_INDEX, keys.ATOM_TYPES),
        outputs=MD_ENGINE_OUTPUTS,
        data_settings=_single_frame_settings,
    )
)

# + the frame's virial (Σ rᵢ ⊗ fᵢ over real + ghost rows: exact in ghost
# format; stress = -virial / volume, computed by the consumer, who knows the
# cell): LAMMPS' virial_fdotr_compute on pair_allegro's forces
register_compile_target(
    CompileTarget(
        name="pair_allegro_stress",
        inputs=(keys.POSITIONS, keys.EDGE_INDEX, keys.ATOM_TYPES),
        outputs=MD_ENGINE_OUTPUTS + (keys.VIRIAL,),
        data_settings=_single_frame_settings,
    )
)
