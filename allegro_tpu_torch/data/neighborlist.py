"""Periodic neighbor lists (host-side, NumPy/scipy).

Twin of the scipy branch of ``allegro_tpu/data/neighborlist.py``: directed
edges ``(i=center, j=neighbor)`` with integer cell shifts such that

    r_ij = pos[j] - pos[i] + shift @ cell   and   |r_ij| < r_max,

both directions emitted, zero-shift self-edges excluded, and the edges sorted
by center (stable), which is the order the port's CSR kernels require.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

from . import keys


def _n_repeats(cell: np.ndarray, pbc: np.ndarray, r_max: float) -> np.ndarray:
    """Number of periodic images needed per axis to cover ``r_max``."""
    reps = np.zeros(3, dtype=np.int64)
    if not pbc.any():
        return reps
    # distance between opposite faces along axis k is 1 / |row k of inv(cell)|
    heights = 1.0 / np.linalg.norm(np.linalg.inv(cell), axis=1)
    for k in range(3):
        if pbc[k]:
            reps[k] = int(np.ceil(r_max / heights[k]))
    return reps


def primitive_neighbor_list(
    positions: np.ndarray,
    r_max: float,
    cell: Optional[np.ndarray] = None,
    pbc=(False, False, False),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Directed neighbor list: centers [E] int32, neighbors [E] int32,
    cell_shifts [E, 3] float64 (integer-valued)."""
    positions = np.asarray(positions, dtype=np.float64)
    n = positions.shape[0]
    pbc = np.asarray(pbc, dtype=bool)
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros((0, 3)))
    if cell is None or not pbc.any():
        pairs = cKDTree(positions).query_pairs(r_max, output_type="ndarray")
        if pairs.size == 0:
            return empty
        i = np.concatenate([pairs[:, 0], pairs[:, 1]]).astype(np.int32)
        j = np.concatenate([pairs[:, 1], pairs[:, 0]]).astype(np.int32)
        return i, j, np.zeros((len(i), 3))

    cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
    reps = _n_repeats(cell, pbc, r_max)
    ranges = [np.arange(-reps[k], reps[k] + 1) for k in range(3)]
    shifts = np.stack(np.meshgrid(*ranges, indexing="ij"), axis=-1).reshape(-1, 3)
    # zero shift first, so self-pairs are cheap to exclude
    order = np.argsort(np.abs(shifts).sum(axis=1), kind="stable")
    shifts = shifts[order].astype(np.float64)
    images = (positions[None, :, :] + (shifts @ cell)[:, None, :]).reshape(-1, 3)
    neigh = cKDTree(images).query_ball_point(positions, r_max)
    ci, cj, cs = [], [], []
    for i in range(n):
        idx = np.asarray(neigh[i], dtype=np.int64)
        if idx.size == 0:
            continue
        s_idx, j = idx // n, idx % n
        keep = ~((j == i) & (s_idx == 0))
        j, s_idx = j[keep], s_idx[keep]
        # exact filter: query_ball_point is inclusive of r_max
        d = np.linalg.norm(images[idx[keep]] - positions[i], axis=1)
        keep2 = d < r_max
        j, s_idx = j[keep2], s_idx[keep2]
        ci.append(np.full(len(j), i, dtype=np.int32))
        cj.append(j.astype(np.int32))
        cs.append(shifts[s_idx])
    if not ci:
        return empty
    return np.concatenate(ci), np.concatenate(cj), np.concatenate(cs, axis=0)


def neighbor_list(frame: dict, r_max: float) -> dict:
    """Attach center-sorted ``EDGE_INDEX``/``EDGE_CELL_SHIFT`` to a frame dict."""
    pos = np.asarray(frame[keys.POSITIONS], dtype=np.float64)
    cell = frame.get(keys.CELL)
    pbc = np.asarray(frame.get(keys.PBC, (False, False, False))).reshape(-1)[-3:]
    i, j, shifts = primitive_neighbor_list(pos, r_max, cell, pbc)
    if len(i):
        order = np.argsort(i, kind="stable")
        i, j, shifts = i[order], j[order], shifts[order]
    out = dict(frame)
    out[keys.EDGE_INDEX] = np.stack([i, j], axis=0)
    out[keys.EDGE_CELL_SHIFT] = shifts
    return out
