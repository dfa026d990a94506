"""Slab decomposition with ghost-atom halo exchange (twin of
``allegro_tpu/parallel/domain.py``).

- Space is split into ``D`` slabs along one cell axis (the slab width must
  be >= r_max + skin, so halos only touch nearest neighbors).
- Each domain owns the atoms of one slab (padded to a common size ``No``)
  plus ghost slots for boundary atoms of its two neighbors.
- Every force call, owners send boundary-atom positions one hop left and
  one hop right; receivers add the periodic seam shift. Local neighbor
  lists (built on the host at decomposition) reference owned and ghost
  rows; only owned-centered edges exist, so the domains' energies add up
  to the system's exactly.
- Forces: each domain's force call gives forces on owned and ghost rows;
  the ghost rows' forces go back to their owners (``halo.DomainForceCall``).

The mesh is a list of devices, one per domain, run by one process (JAX: a
``dp`` mesh under ``shard_map``); an entry may repeat. The host build is
JAX's: owned and ghost slots, send lists, seam shifts and padded local edge
lists (``arrays``, numpy, the same keys).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..data import round_up
from ..device import resolve_mesh
from .halo import DomainForceCall, Stage, as_domains, local_frame, numpy_dtype, real_neighbor_list


class SlabDecomposition:
    def __init__(
        self,
        positions: np.ndarray,
        atom_types: np.ndarray,
        cell: Optional[np.ndarray],
        pbc,
        r_max: float,
        mesh: Sequence,
        axis: int = 0,
        skin: float = 0.0,
        atom_multiple: int = 8,
        edge_multiple: int = 128,
        dtype: torch.dtype = torch.float32,
        min_owned_pad: int = 0,
        min_send_pad: int = 0,
        min_edges_pad: int = 0,
    ):
        self.devices = resolve_mesh(mesh)
        self.D = len(self.devices)
        self.r_max = float(r_max) + float(skin)
        self.axis = int(axis)
        self.dtype = dtype
        positions = np.asarray(positions, dtype=np.float64)
        atom_types = np.asarray(atom_types, dtype=np.int32)
        self.n_atoms = len(positions)
        pbc = np.asarray(pbc, dtype=bool)
        self.pbc = pbc
        if cell is None:
            # open boundaries: a bounding box for the slab geometry
            lo = positions.min(0) - 1e-6
            hi = positions.max(0) + 1e-6
            cell = np.diag(hi - lo)
            positions = positions - lo
            self._origin = lo
        else:
            cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
            self._origin = np.zeros(3)
        self.cell = cell
        D = self.D

        # wrap into the cell along periodic axes: slab assignment, ghost
        # regions and local neighbor lists all assume in-cell coordinates
        frac = positions @ np.linalg.inv(cell)
        frac[:, pbc] -= np.floor(frac[:, pbc])
        positions = frac @ cell
        fx = np.clip(frac[:, self.axis], 0.0, np.nextafter(1.0, 0.0))
        slab_of = np.minimum((fx * D).astype(np.int64), D - 1)
        # slab width in real distance along the axis normal
        h = 1.0 / np.linalg.norm(np.linalg.inv(cell)[:, self.axis]) / D
        if D > 1 and h < self.r_max:
            raise AssertionError(
                f"slab width {h:.3f} < r_max(+skin) {self.r_max:.3f}: "
                "too many domains for this box"
            )

        owned = [np.where(slab_of == d)[0] for d in range(D)]
        self.n_own = np.array([len(o) for o in owned])
        # sticky minima keep the sizes of earlier decompositions (MD)
        No = max(
            round_up(max(int(self.n_own.max()), 1) + 1, atom_multiple), min_owned_pad
        )
        self.No = No
        self.owned = owned

        # --- halo construction ---
        # boundary width in fractional units along the slab axis
        w = self.r_max / (h * D)
        send_right = []  # per d: owned-local indices within w of the right face
        send_left = []
        for d in range(D):
            f = fx[owned[d]]
            lo_d, hi_d = d / D, (d + 1) / D
            send_right.append(np.where(f >= hi_d - w)[0])
            send_left.append(np.where(f <= lo_d + w)[0])
        S = max(
            round_up(
                max(max((len(s) for s in send_right + send_left), default=1), 1),
                atom_multiple,
            ),
            min_send_pad,
        )
        self.S = S

        def _pad_idx(idx):
            out = np.zeros(S, np.int32)
            out[: len(idx)] = idx
            m = np.zeros(S, bool)
            m[: len(idx)] = True
            return out, m

        sr_idx = np.zeros((D, S), np.int32)
        sr_mask = np.zeros((D, S), bool)
        sl_idx = np.zeros((D, S), np.int32)
        sl_mask = np.zeros((D, S), bool)
        for d in range(D):
            sr_idx[d], sr_mask[d] = _pad_idx(send_right[d])
            sl_idx[d], sl_mask[d] = _pad_idx(send_left[d])

        # ghost slots on domain d: [from the left neighbor (its send_right),
        # then from the right neighbor (its send_left)], each padded to S;
        # ghosts arriving across the periodic seam get -/+ cell[axis]
        ghost_shift = np.zeros((D, 2 * S, 3))
        if D > 1 and pbc[self.axis]:
            ghost_shift[0, :S] = -cell[self.axis]  # domain 0's left neighbor is D-1
            ghost_shift[D - 1, S:] = cell[self.axis]
        self._ghost_shift = ghost_shift

        # --- local arrays + edges (host build) ---
        own_pos = np.zeros((D, No, 3))
        own_types = np.zeros((D, No), np.int32)
        own_mask = np.zeros((D, No), bool)
        for d in range(D):
            n = len(owned[d])
            own_pos[d, :n] = positions[owned[d]]
            own_types[d, :n] = atom_types[owned[d]]
            own_mask[d, :n] = True

        ghost_types = np.zeros((D, 2 * S), np.int32)
        ghost_mask = np.zeros((D, 2 * S), bool)
        local_edges = []
        max_edges = 1
        pbc_local = pbc.copy()
        if D > 1:
            # ghosts open the slab axis (the seam shifts re-close the wrap)
            pbc_local[self.axis] = False
        # D == 1: no ghosts exist; the axis stays periodic so wrap edges
        # survive (a decomposition of one domain equals the plain model)
        for d in range(D):
            left, right = (d - 1) % D, (d + 1) % D
            if D > 1:
                g_idx_left = owned[left][sr_idx[left]]
                g_idx_right = owned[right][sl_idx[right]]
                ghost_types[d, :S] = atom_types[g_idx_left]
                ghost_types[d, S:] = atom_types[g_idx_right]
                m_left = sr_mask[left].copy()
                m_right = sl_mask[right].copy()
                # an open slab axis: the ring still wraps, but there is no
                # neighbor across an open face; an unmasked wrap ghost at its
                # true position would duplicate a direct ghost when the slab
                # is narrower than 2 r_max (D = 2)
                if not pbc[self.axis]:
                    if d == 0:
                        m_left[:] = False
                    if d == D - 1:
                        m_right[:] = False
                ghost_mask[d, :S] = m_left
                ghost_mask[d, S:] = m_right
                gpos = np.concatenate(
                    [
                        positions[g_idx_left] + ghost_shift[d, :S],
                        positions[g_idx_right] + ghost_shift[d, S:],
                    ]
                )
                gm = np.concatenate([m_left, m_right])
            else:
                gpos = np.zeros((2 * S, 3))
                gm = np.zeros(2 * S, bool)
            n = len(owned[d])
            local_pos = np.zeros((No + 2 * S, 3))
            local_pos[:n] = positions[owned[d]]
            local_pos[No:][gm] = gpos[gm]
            real = np.zeros(No + 2 * S, bool)
            real[:n] = True
            real[No:] = gm
            i, j, sh = real_neighbor_list(local_pos, real, self.r_max, cell, pbc_local)
            keep = i < n  # owned centers only
            i, j, sh = i[keep], j[keep], sh[keep]
            local_edges.append((i, j, sh))
            max_edges = max(max_edges, len(i))

        El = max(round_up(max_edges, edge_multiple), min_edges_pad)
        eidx = np.zeros((D, 2, El), np.int32)
        eshift = np.zeros((D, El, 3))
        emask = np.zeros((D, El), bool)
        for d, (i, j, sh) in enumerate(local_edges):
            order = np.argsort(i, kind="stable")
            i, j, sh = i[order], j[order], sh[order]
            eidx[d, 0, : len(i)] = i
            eidx[d, 1, : len(i)] = j
            eshift[d, : len(i)] = sh
            emask[d, : len(i)] = True
        self.El = El
        self.L = No + 2 * S
        self.pbc_local = pbc_local

        self.arrays = {
            "own_pos": own_pos.astype(numpy_dtype(dtype)),
            "own_types": own_types,
            "own_mask": own_mask,
            "ghost_types": ghost_types,
            "ghost_mask": ghost_mask,
            "ghost_shift": ghost_shift,
            "send_right_idx": sr_idx,
            "send_right_mask": sr_mask,
            "send_left_idx": sl_idx,
            "send_left_mask": sl_mask,
            "edge_index": eidx,
            "edge_shift": eshift,
            "edge_mask": emask,
        }
        # the exchange in the staged form of halo.DomainForceCall: one stage,
        # minus = left, plus = right
        ring = np.arange(D)
        self.exchange = [] if D == 1 else [Stage(
            minus=(ring - 1) % D, plus=(ring + 1) % D, send_minus_idx=sl_idx,
            send_plus_idx=sr_idx, ghost_shift=ghost_shift, ghost_mask=ghost_mask,
        )]

    def local_frames(self):
        """Each domain's local frame without positions (``halo.local_frame``)."""
        a = self.arrays
        return [local_frame(np.concatenate([a["own_types"][d], a["ghost_types"][d]]),
                            np.concatenate([a["own_mask"][d], np.zeros(2 * self.S, bool)]),
                            a["edge_index"][d], a["edge_shift"][d], a["edge_mask"][d],
                            self.cell, self.pbc_local)
                for d in range(self.D)]

    # --- global <-> local mappings (host-side) ---
    def scatter_positions(self, positions: np.ndarray, wrap: bool = True) -> np.ndarray:
        """Distribute positions to their owners, [D, No, 3]. ``wrap=True``
        only for the positions the decomposition was built from: wrapping
        moving positions mid-validity would move boundary-crossers away
        from their static ghost metadata (energy jumps)."""
        positions = np.asarray(positions, dtype=np.float64) - self._origin
        if wrap:
            frac = positions @ np.linalg.inv(self.cell)
            frac[:, self.pbc] -= np.floor(frac[:, self.pbc])
            positions = frac @ self.cell
        return self.scatter_vectors(positions)

    def scatter_vectors(self, vectors: np.ndarray) -> np.ndarray:
        """Distribute per-atom vectors (velocities etc.) without wrapping."""
        out = np.zeros((self.D, self.No, 3))
        v = np.asarray(vectors, dtype=np.float64)
        for d, idx in enumerate(self.owned):
            out[d, : len(idx)] = v[idx]
        return out.astype(numpy_dtype(self.dtype))

    def gather_vectors(self, local) -> np.ndarray:
        """Collect per-atom vectors ([D, No, 3], or one [No, 3] tensor per
        domain) back to the global ordering."""
        out = np.zeros((self.n_atoms, 3))
        f = as_domains(local, self.D, self.No)
        for d, idx in enumerate(self.owned):
            out[idx] = f[d, : len(idx)]
        return out

    gather_forces = gather_vectors

    def gather_positions(self, local) -> np.ndarray:
        return self.gather_vectors(local) + self._origin

    # --- the distributed force call ---
    def make_energy_forces_fn(self, model, models=None) -> DomainForceCall:
        """``fn(own_pos) -> (E_total, forces)`` over the mesh
        (``halo.DomainForceCall``); ``models``: one per distinct device
        (``device.replicate``), kept across re-decompositions by MD."""
        return DomainForceCall(self, model, models)
