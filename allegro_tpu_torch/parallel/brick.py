"""3-D brick decomposition with a staged halo exchange (twin of
``allegro_tpu/parallel/brick.py``).

The multi-axis generalization of :class:`SlabDecomposition` (LAMMPS' brick
decomposition; 6 transfers instead of 26):

- The mesh has the shape ``(Dx[, Dy[, Dz]])``; mesh axis ``k`` splits cell
  axis ``k`` into ``D_k`` equal fractional intervals. Each domain owns the
  atoms of its brick (padded to a common ``No``). The devices are a flat
  list in C order over the mesh shape (``mesh_shape`` beside it, since a
  list has no shape); an entry may repeat.
- Halos are exchanged dimension by dimension: along x (each brick sends
  the rows within ``r_max`` of its two x-faces to its two x-neighbors),
  then along y, where the send sets may include the x-ghosts just
  received, so edge- and corner-adjacent atoms are forwarded, then along z.
  The receiver adds the periodic seam shift, one cell vector per wrap
  crossing; later stages forward already shifted positions.
- Local neighbor lists (built on the host) reference owned and ghost rows;
  only owned-centered edges are kept, so the domains' energies add up to
  the system's exactly.
- Forces: the ghost rows' forces go back through the stages in reverse, z,
  y, x, so corner contributions ride two or three hops home
  (``halo.DomainForceCall``).

Open axes: the ring still wraps, but wrap-crossing transfers are masked
out (an unmasked wrap ghost at its true position can duplicate a direct
ghost when the brick is narrower than ``2 r_max`` at ``D_a == 2``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..data import round_up
from ..device import resolve_mesh
from .halo import DomainForceCall, Stage, as_domains, local_frame, numpy_dtype, real_neighbor_list


class BrickDecomposition:
    def __init__(
        self,
        positions: np.ndarray,
        atom_types: np.ndarray,
        cell: Optional[np.ndarray],
        pbc,
        r_max: float,
        mesh: Sequence,
        mesh_shape: Optional[Sequence[int]] = None,
        skin: float = 0.0,
        atom_multiple: int = 8,
        edge_multiple: int = 128,
        dtype: torch.dtype = torch.float32,
        min_owned_pad: int = 0,
        min_send_pad=(0, 0, 0),
        min_edges_pad: int = 0,
    ):
        self.devices = resolve_mesh(mesh)
        dims = tuple(int(s) for s in (mesh_shape or (len(self.devices),)))
        if len(dims) > 3:
            raise ValueError("a brick mesh has at most three axes")
        if int(np.prod(dims)) != len(self.devices):
            raise ValueError(f"mesh_shape {dims} does not hold the {len(self.devices)} devices")
        self.mesh_shape = dims
        self.dims = dims + (1,) * (3 - len(dims))  # (Dx, Dy, Dz)
        self.D = int(np.prod(dims))
        self.r_max = float(r_max) + float(skin)
        self.dtype = dtype
        positions = np.asarray(positions, dtype=np.float64)
        atom_types = np.asarray(atom_types, dtype=np.int32)
        self.n_atoms = len(positions)
        pbc = np.asarray(pbc, dtype=bool)
        self.pbc = pbc
        if cell is None:
            lo = positions.min(0) - 1e-6
            hi = positions.max(0) + 1e-6
            cell = np.diag(hi - lo)
            positions = positions - lo
            self._origin = lo
        else:
            cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
            self._origin = np.zeros(3)
        self.cell = cell
        Dx, Dy, Dz = self.dims
        D = self.D

        inv_cell = np.linalg.inv(cell)
        frac = positions @ inv_cell
        frac[:, pbc] -= np.floor(frac[:, pbc])
        positions = frac @ cell
        # fractional halo width and brick width per axis
        heights = 1.0 / np.linalg.norm(inv_cell, axis=0)  # cell height per axis
        self._w_frac = self.r_max / heights
        for a in range(3):
            if self.dims[a] > 1:
                bw = heights[a] / self.dims[a]
                if bw < self.r_max:
                    raise AssertionError(
                        f"brick width {bw:.3f} along axis {a} < r_max(+skin) "
                        f"{self.r_max:.3f}: too many domains for this box"
                    )

        # --- brick assignment ---
        fclip = np.clip(frac, 0.0, np.nextafter(1.0, 0.0))
        bidx = [
            np.minimum((fclip[:, a] * self.dims[a]).astype(np.int64), self.dims[a] - 1)
            for a in range(3)
        ]
        flat = (bidx[0] * Dy + bidx[1]) * Dz + bidx[2]  # C order over the mesh
        owned = [np.where(flat == d)[0] for d in range(D)]
        self.owned = owned
        self.n_own = np.array([len(o) for o in owned])
        No = max(
            round_up(max(int(self.n_own.max()), 1) + 1, atom_multiple), min_owned_pad
        )
        self.No = No

        # --- staged halo construction (host mirror of the exchange) ---
        # per-domain local state: positions (true, shifted), types, real mask
        loc_pos = []
        loc_type = []
        loc_mask = []
        for d in range(D):
            n = len(owned[d])
            p = np.full((No, 3), np.nan)
            p[:n] = positions[owned[d]]
            t = np.zeros(No, np.int32)
            t[:n] = atom_types[owned[d]]
            m = np.zeros(No, bool)
            m[:n] = True
            loc_pos.append(p)
            loc_type.append(t)
            loc_mask.append(m)

        def brick_of(d):  # flat -> (bx, by, bz)
            return (d // (Dy * Dz), (d // Dz) % Dy, d % Dz)

        def flat_of(b):
            return (b[0] * Dy + b[1]) * Dz + b[2]

        self.S = [0, 0, 0]
        self._stage_arrays = []  # per split axis: dict of numpy arrays
        self.stages = []  # axis ids with D_a > 1, in exchange order
        self.exchange = []  # the same stages in halo.DomainForceCall's form
        for a in range(3):
            if self.dims[a] == 1:
                continue
            Da = self.dims[a]
            w = self._w_frac[a]
            # send sets: local rows (owned or earlier-stage ghosts) within w
            # of each face along axis a, real rows only
            send_minus, send_plus = [], []
            for d in range(D):
                b = brick_of(d)
                lo, hi = b[a] / Da, (b[a] + 1) / Da
                m = loc_mask[d]
                f = np.where(m[:, None], loc_pos[d], 0.0) @ inv_cell[:, a]
                send_minus.append(np.where(m & (f <= lo + w))[0])
                send_plus.append(np.where(m & (f >= hi - w))[0])
            S = max(
                round_up(
                    max(max((len(s) for s in send_minus + send_plus), default=1), 1),
                    atom_multiple,
                ),
                (min_send_pad[len(self.stages)] if len(self.stages) < 3 else 0),
            )
            self.S[a] = S

            def _pad(idx):
                out = np.zeros(S, np.int32)
                out[: len(idx)] = idx
                m = np.zeros(S, bool)
                m[: len(idx)] = True
                return out, m

            sm_idx = np.zeros((D, S), np.int32)
            sm_mask = np.zeros((D, S), bool)
            sp_idx = np.zeros((D, S), np.int32)
            sp_mask = np.zeros((D, S), bool)
            for d in range(D):
                sm_idx[d], sm_mask[d] = _pad(send_minus[d])
                sp_idx[d], sp_mask[d] = _pad(send_plus[d])

            # receive: from-minus slots [:S] (the minus neighbor's send_plus),
            # from-plus slots [S:] (the plus neighbor's send_minus)
            ghost_shift = np.zeros((D, 2 * S, 3))
            ghost_type = np.zeros((D, 2 * S), np.int32)
            ghost_mask = np.zeros((D, 2 * S), bool)
            minus = np.zeros(D, np.int64)
            plus = np.zeros(D, np.int64)
            for d in range(D):
                b = brick_of(d)
                bm = list(b)
                bm[a] = (b[a] - 1) % Da
                bp = list(b)
                bp[a] = (b[a] + 1) % Da
                dm, dp = flat_of(bm), flat_of(bp)
                minus[d], plus[d] = dm, dp
                wrap_m = b[a] == 0  # the minus neighbor is across the seam
                wrap_p = b[a] == Da - 1
                m_mask = sp_mask[dm].copy()
                p_mask = sm_mask[dp].copy()
                if wrap_m:
                    if pbc[a]:
                        ghost_shift[d, :S] = -cell[a]
                    else:
                        m_mask[:] = False  # no neighbor across an open face
                if wrap_p:
                    if pbc[a]:
                        ghost_shift[d, S:] = cell[a]
                    else:
                        p_mask[:] = False
                ghost_mask[d, :S] = m_mask
                ghost_mask[d, S:] = p_mask
                ghost_type[d, :S] = loc_type[dm][sp_idx[dm]]
                ghost_type[d, S:] = loc_type[dp][sm_idx[dp]]
                gpos = np.full((2 * S, 3), np.nan)
                gpos[:S][m_mask] = (
                    loc_pos[dm][sp_idx[dm]] + ghost_shift[d, :S]
                )[m_mask]
                gpos[S:][p_mask] = (
                    loc_pos[dp][sm_idx[dp]] + ghost_shift[d, S:]
                )[p_mask]
                loc_pos[d] = np.concatenate([loc_pos[d], gpos])
                loc_type[d] = np.concatenate([loc_type[d], ghost_type[d]])
                loc_mask[d] = np.concatenate([loc_mask[d], ghost_mask[d]])
            self.stages.append(a)
            self._stage_arrays.append(
                dict(
                    send_minus_idx=sm_idx,
                    send_minus_mask=sm_mask,
                    send_plus_idx=sp_idx,
                    send_plus_mask=sp_mask,
                    ghost_shift=ghost_shift,
                    ghost_type=ghost_type,
                    ghost_mask=ghost_mask,
                )
            )
            self.exchange.append(Stage(minus=minus, plus=plus, send_minus_idx=sm_idx,
                                       send_plus_idx=sp_idx, ghost_shift=ghost_shift,
                                       ghost_mask=ghost_mask))

        self.L = No + 2 * sum(self.S)  # local rows after all stages

        # --- local edges (host build) ---
        pbc_local = pbc.copy()
        for a in self.stages:
            pbc_local[a] = False  # the seam shifts re-close the wrap via ghosts
        self.pbc_local = pbc_local
        local_edges = []
        max_edges = 1
        for d in range(D):
            i, j, sh = real_neighbor_list(loc_pos[d], loc_mask[d], self.r_max, cell, pbc_local)
            keep = i < len(owned[d])  # owned (real) centers only
            i, j, sh = i[keep], j[keep], sh[keep]
            local_edges.append((i, j, sh))
            max_edges = max(max_edges, len(i))

        El = max(round_up(max_edges, edge_multiple), min_edges_pad)
        self.El = El
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

        # --- the arrays, a leading domain axis (flat over the mesh) ---
        own_pos = np.zeros((D, No, 3))
        own_types = np.zeros((D, No), np.int32)
        own_mask = np.zeros((D, No), bool)
        for d in range(D):
            n = len(owned[d])
            own_pos[d, :n] = positions[owned[d]]
            own_types[d, :n] = atom_types[owned[d]]
            own_mask[d, :n] = True

        arrays = {
            "own_pos": own_pos.astype(numpy_dtype(dtype)),
            "own_types": own_types,
            "own_mask": own_mask,
            "edge_index": eidx,
            "edge_shift": eshift,
            "edge_mask": emask,
        }
        gtypes, gmasks = [], []
        for k, st in enumerate(self._stage_arrays):
            sfx = f"_{k}"
            arrays["send_minus_idx" + sfx] = st["send_minus_idx"]
            arrays["send_plus_idx" + sfx] = st["send_plus_idx"]
            arrays["ghost_shift" + sfx] = st["ghost_shift"]
            gtypes.append(st["ghost_type"])
            gmasks.append(st["ghost_mask"])
        # local types/mask of the model input: [L] per domain
        arrays["local_types"] = np.concatenate([own_types] + gtypes, axis=1)
        arrays["local_mask"] = np.concatenate([own_mask] + gmasks, axis=1)
        self.arrays = arrays

    def local_frames(self):
        """Each domain's local frame without positions (``halo.local_frame``)."""
        a = self.arrays
        pad = np.zeros(self.L - self.No, bool)
        return [local_frame(a["local_types"][d], np.concatenate([a["own_mask"][d], pad]),
                            a["edge_index"][d], a["edge_shift"][d], a["edge_mask"][d],
                            self.cell, self.pbc_local)
                for d in range(self.D)]

    # --- global <-> local mappings (host-side) ---
    def scatter_positions(self, positions: np.ndarray, wrap: bool = True) -> np.ndarray:
        """Distribute positions to their owners, [D, No, 3]. ``wrap=True``
        only for the positions the decomposition was built from: wrapping
        mid-validity moves boundary-crossers away from their static ghost
        metadata."""
        positions = np.asarray(positions, dtype=np.float64) - self._origin
        if wrap:
            frac = positions @ np.linalg.inv(self.cell)
            frac[:, self.pbc] -= np.floor(frac[:, self.pbc])
            positions = frac @ self.cell
        return self.scatter_vectors(positions)

    def scatter_vectors(self, vectors: np.ndarray) -> np.ndarray:
        out = np.zeros((self.D, self.No, 3))
        v = np.asarray(vectors, dtype=np.float64)
        for d, idx in enumerate(self.owned):
            out[d, : len(idx)] = v[idx]
        return out.astype(numpy_dtype(self.dtype))

    def gather_vectors(self, local) -> np.ndarray:
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
        (``halo.DomainForceCall``)."""
        return DomainForceCall(self, model, models)
