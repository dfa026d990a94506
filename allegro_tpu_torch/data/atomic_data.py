"""Atomic data as flat dicts of arrays with padded sizes.

Twin of ``allegro_tpu/data/atomic_data.py``: the NumPy side (padding and
graph batching) is the same code, so a batch is the same arrays in both
packages; ``to_torch`` takes the place of ``to_jax``. Padded edges carry the
sentinel atom id ``n_atoms`` in both rows of ``EDGE_INDEX`` and sort after
every real center; padded atoms have type 0 and are masked by ``NODE_MASK``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from . import keys

AtomsData = Dict[str, np.ndarray]


def round_up(x: int, multiple: int) -> int:
    if multiple <= 0:
        return int(x)
    return int(-(-x // multiple) * multiple)


def _pad_axis(a: np.ndarray, n: int, axis: int = 0, fill=0) -> np.ndarray:
    cur = a.shape[axis]
    if cur == n:
        return a
    if cur > n:
        raise ValueError(f"cannot pad axis of size {cur} down to {n}")
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, n - cur)
    return np.pad(a, pad, constant_values=fill)


def pad_data(
    data: AtomsData,
    n_atoms: int,
    n_edges: int,
    n_frames: int | None = None,
) -> AtomsData:
    """Pad a (possibly batched) frame dict to fixed sizes, adding masks."""
    na = int(data[keys.POSITIONS].shape[0])
    ne = int(data[keys.EDGE_INDEX].shape[1])
    out: AtomsData = {}
    nf = None
    for k, v in data.items():
        v = np.asarray(v)
        if k in keys.PER_ATOM_FIELDS:
            out[k] = _pad_axis(v, n_atoms, axis=0)
        elif k == keys.EDGE_INDEX:
            # sentinel padding: padded edges point at atom id ``n_atoms``
            out[k] = _pad_axis(v, n_edges, axis=1, fill=n_atoms)
        elif k in keys.PER_EDGE_FIELDS:
            out[k] = _pad_axis(v, n_edges, axis=0)
        elif k in keys.PER_FRAME_FIELDS:
            nf = v.shape[0] if v.ndim > 0 else 1
            if n_frames is not None:
                out[k] = _pad_axis(np.atleast_1d(v), n_frames, axis=0)
            else:
                out[k] = v
        else:
            out[k] = v
    node_mask = np.zeros(n_atoms, dtype=bool)
    node_mask[:na] = (
        np.asarray(data[keys.NODE_MASK], dtype=bool)
        if keys.NODE_MASK in data
        else np.ones(na, dtype=bool)
    )
    edge_mask = np.zeros(n_edges, dtype=bool)
    edge_mask[:ne] = (
        np.asarray(data[keys.EDGE_MASK], dtype=bool)
        if keys.EDGE_MASK in data
        else np.ones(ne, dtype=bool)
    )
    out[keys.NODE_MASK] = node_mask
    out[keys.EDGE_MASK] = edge_mask
    if n_frames is not None:
        fm = np.zeros(n_frames, dtype=bool)
        nf_real = nf if nf is not None else 1
        fm[:nf_real] = True
        if keys.FRAME_MASK in data:
            fm[:nf_real] = np.asarray(data[keys.FRAME_MASK], dtype=bool)[:nf_real]
        out[keys.FRAME_MASK] = fm
        if keys.BATCH in data:
            b = _pad_axis(np.asarray(data[keys.BATCH], dtype=np.int32), n_atoms)
            # padded atoms go to the first padded frame if any, else 0 —
            # masked out by FRAME_MASK either way
            out[keys.BATCH] = np.where(node_mask, b, min(nf_real, n_frames - 1)).astype(np.int32)
    return out


def batch_frames(
    frames: Sequence[AtomsData],
    n_atoms: int | None = None,
    n_edges: int | None = None,
    n_frames: int | None = None,
    atom_multiple: int = 8,
    edge_multiple: int = 128,
) -> AtomsData:
    """Concatenate frames into one padded batch: atoms and edges of all
    frames are concatenated, ``EDGE_INDEX`` is offset per frame, ``BATCH``
    maps atoms to frames, and everything is padded to
    ``(n_atoms, n_edges, n_frames)``."""
    pos, types, eidx, shifts, batch = [], [], [], [], []
    cells, pbcs, energies, forces_l, nnodes = [], [], [], [], []
    any_cell = any(keys.CELL in fr for fr in frames)
    offset = 0
    for f, fr in enumerate(frames):
        na = fr[keys.POSITIONS].shape[0]
        pos.append(np.asarray(fr[keys.POSITIONS], dtype=np.float64))
        types.append(np.asarray(fr[keys.ATOM_TYPES], dtype=np.int32))
        eidx.append(np.asarray(fr[keys.EDGE_INDEX], dtype=np.int32) + offset)
        if keys.EDGE_CELL_SHIFT in fr:
            shifts.append(np.asarray(fr[keys.EDGE_CELL_SHIFT], dtype=np.float64))
        else:
            shifts.append(np.zeros((fr[keys.EDGE_INDEX].shape[1], 3)))
        batch.append(np.full(na, f, dtype=np.int32))
        cells.append(np.asarray(fr.get(keys.CELL, np.zeros((3, 3)))).reshape(3, 3))
        pbcs.append(np.asarray(fr.get(keys.PBC, np.zeros(3, dtype=bool))).reshape(3))
        if keys.TOTAL_ENERGY in fr:
            energies.append(np.asarray(fr[keys.TOTAL_ENERGY]).reshape(1))
        if keys.FORCES in fr:
            forces_l.append(np.asarray(fr[keys.FORCES], dtype=np.float64))
        nnodes.append(na)
        offset += na
    data: AtomsData = {
        keys.POSITIONS: np.concatenate(pos, axis=0),
        keys.ATOM_TYPES: np.concatenate(types, axis=0),
        keys.EDGE_INDEX: np.concatenate(eidx, axis=1),
        keys.BATCH: np.concatenate(batch, axis=0),
        keys.NUM_NODES: np.asarray(nnodes, dtype=np.int32),
    }
    if any_cell:
        # no cell anywhere → no CELL/PBC/shifts: the system is open-boundary
        data[keys.EDGE_CELL_SHIFT] = np.concatenate(shifts, axis=0)
        data[keys.CELL] = np.stack(cells, axis=0)
        data[keys.PBC] = np.stack(pbcs, axis=0)
    if energies:
        data[keys.TOTAL_ENERGY] = np.stack(energies, axis=0)
    if forces_l:
        data[keys.FORCES] = np.concatenate(forces_l, axis=0)
    na_tot = data[keys.POSITIONS].shape[0]
    ne_tot = data[keys.EDGE_INDEX].shape[1]
    n_atoms = n_atoms if n_atoms is not None else round_up(na_tot, atom_multiple)
    n_edges = n_edges if n_edges is not None else round_up(max(ne_tot, 1), edge_multiple)
    n_frames = n_frames if n_frames is not None else len(frames)
    return pad_data(data, n_atoms, n_edges, n_frames)


def to_torch(data: AtomsData, dtype: torch.dtype | None = None, device=None) -> Dict:
    """NumPy data dict → tensors on ``device``, floats cast to ``dtype``;
    integer and boolean fields keep their type."""
    out = {}
    for k, v in data.items():
        t = torch.as_tensor(np.asarray(v), device=device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[k] = t
    return out
