"""The decomposed force call: halo exchange, one force call per domain, and
the ghost forces sent back (the run-time half of ``domain.py`` and
``brick.py``; JAX runs it as one ``shard_map`` program with ``ppermute``
halos).

The mesh is a list of devices run by one process; an entry may repeat
(``[cuda:0] * D`` runs D domains on one card, ``["cpu"] * D`` plays JAX's
virtual host devices). A call:

1. **Exchange** (no autograd): stage by stage, each domain takes the rows
   of its local array within the halo of its two faces (``index_select``),
   they move to the neighbors' devices (``.to``), and each receiver appends
   them, plus its periodic seam shift, as ghost rows: from-minus slots
   first, then from-plus. Later stages forward earlier stages' ghosts.
2. **Force call** per domain on its device: the model's own force call
   (``Model.energy_forces``) on the local frame (owned rows, then ghost
   rows with ``NODE_MASK`` False and no edges of their own), which gives
   forces on owned and ghost rows.
3. **Ghost return**: the forces on each stage's ghost slots go back to the
   rows that sent them, stages in reverse order, and per domain first the
   payload it sent minus-ward, then plus-ward, each one ``index_add_`` on
   the sender's device. This is the adjoint of the exchange written out:
   JAX differentiates through ``ppermute``, but autograd across devices
   would accumulate a leaf's gradient in arrival order (one engine thread
   per device), and two identical calls would not give the same bits.
   A send list holds a row at most once, and only real slots go back, so
   each ``index_add_`` has unique targets: exact and deterministic.

The total energy is the domains' owned energies summed in domain order on
the first device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data import keys, to_torch
from ..data.neighborlist import primitive_neighbor_list
from ..device import replicate


@dataclasses.dataclass
class Stage:
    """One stage of the exchange over the D domains (slab: one stage, minus
    = left; brick: one per split axis), host arrays. Domain d's ghost slots
    of this stage are ``[:S]`` from its minus neighbor (that neighbor's
    ``send_plus``) and ``[S:]`` from its plus neighbor (``send_minus``)."""

    minus: np.ndarray  # [D] the minus neighbor of each domain
    plus: np.ndarray  # [D]
    send_minus_idx: np.ndarray  # [D, S] local rows sent minus-ward (0-padded)
    send_plus_idx: np.ndarray  # [D, S]
    ghost_shift: np.ndarray  # [D, 2S, 3] added by the receiver
    ghost_mask: np.ndarray  # [D, 2S] real ghost slots

    @property
    def S(self) -> int:
        return int(self.send_minus_idx.shape[1])

    def returned(self) -> Tuple[np.ndarray, np.ndarray]:
        """[D] each: how many rows of domain s's minus-ward and plus-ward
        payloads land in real slots of the receiver. Those are the first
        rows of the payload (the real sends lead each list, and a seam on an
        open axis masks a payload whole)."""
        S = self.S
        ret = []
        for side, recv in ((slice(S, 2 * S), self.minus), (slice(0, S), self.plus)):
            n = np.array([int(self.ghost_mask[recv[s], side].sum())
                          for s in range(len(recv))])
            for s, k in enumerate(n):
                if not self.ghost_mask[recv[s], side][:k].all():
                    raise ValueError("a ghost payload's real slots must lead it")
            ret.append(n)
        return ret[0], ret[1]


class DomainForceCall:
    """``fn(own_pos) -> (E_total, forces)`` of a decomposition ``dd``:
    ``own_pos`` is a [D, No, 3] array (``dd.scatter_positions``) or a list
    of D tensors [No, 3], one per domain on its device; the energy is a 0-d
    tensor on the first device, the forces a list of [No, 3] tensors, one
    per domain on its device (``dd.gather_forces`` takes either). ``models``:
    one model per distinct device of the mesh (``device.replicate``; built
    from ``model`` when None). The local frames' statics
    (``Model.precompute_statics``) are computed here, once per
    decomposition."""

    def __init__(self, dd, model, models: Optional[Dict[torch.device, object]] = None):
        self.devices = list(dd.devices)
        self.dtype = dd.dtype
        self.No = dd.No
        self.models = models if models is not None else replicate(model, self.devices)
        self.data = []
        for d, frame in enumerate(dd.local_frames()):
            m = self.models[self.devices[d]]
            self.data.append(to_torch(m.precompute_statics(frame), dtype=self.dtype,
                                      device=self.devices[d]))
        self.stages = []
        off = self.No
        for st in dd.exchange:
            n_minus, n_plus = st.returned()
            on = [dict(dev=dev,
                       send_minus=torch.as_tensor(st.send_minus_idx[d], dtype=torch.long,
                                                  device=dev),
                       send_plus=torch.as_tensor(st.send_plus_idx[d], dtype=torch.long,
                                                 device=dev),
                       shift=torch.as_tensor(st.ghost_shift[d], dtype=self.dtype, device=dev))
                  for d, dev in enumerate(self.devices)]
            for d, o in enumerate(on):
                o["ret_minus"] = o["send_minus"][: n_minus[d]]
                o["ret_plus"] = o["send_plus"][: n_plus[d]]
            self.stages.append((st, off, on))
            off += 2 * st.S
        self.pad = dd.L - off  # ghost slots no stage fills (a slab of one domain)

    def exchange(self, own_pos: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The local positions of every domain, owned rows then ghosts."""
        loc = [p.detach() for p in own_pos]
        with torch.no_grad():
            for st, _, on in self.stages:
                to_plus = [loc[d].index_select(0, o["send_plus"]) for d, o in enumerate(on)]
                to_minus = [loc[d].index_select(0, o["send_minus"]) for d, o in enumerate(on)]
                loc = [torch.cat([loc[d], to_plus[st.minus[d]].to(o["dev"]),
                                  to_minus[st.plus[d]].to(o["dev"])]) for d, o in enumerate(on)]
                for d, o in enumerate(on):
                    loc[d][-2 * st.S:] += o["shift"]
            if self.pad:
                loc = [torch.cat([p, p.new_zeros(self.pad, 3)]) for p in loc]
        return loc

    def __call__(self, own_pos: Union[np.ndarray, Sequence[torch.Tensor]]):
        if isinstance(own_pos, np.ndarray):
            own_pos = [torch.as_tensor(p, dtype=self.dtype, device=dev)
                       for p, dev in zip(own_pos, self.devices)]
        energies, forces = [], []
        for d, pos in enumerate(self.exchange(own_pos)):
            e, f = self.models[self.devices[d]].energy_forces({**self.data[d],
                                                               keys.POSITIONS: pos})
            energies.append(e)
            forces.append(f)
        for st, off, on in reversed(self.stages):
            S = st.S
            for s, o in enumerate(on):
                n = len(o["ret_minus"])
                if n:
                    src = forces[st.minus[s]][off + S: off + S + n]
                    forces[s].index_add_(0, o["ret_minus"], src.to(o["dev"]))
                n = len(o["ret_plus"])
                if n:
                    src = forces[st.plus[s]][off: off + n]
                    forces[s].index_add_(0, o["ret_plus"], src.to(o["dev"]))
        first = self.devices[0]
        energy = energies[0]
        for e in energies[1:]:
            energy = energy + e.to(first)
        return energy, [f[: self.No] for f in forces]


def local_frame(types: np.ndarray, node_mask: np.ndarray, edge_index: np.ndarray,
                edge_shift: np.ndarray, edge_mask: np.ndarray, cell: np.ndarray,
                pbc_local: np.ndarray) -> Dict[str, np.ndarray]:
    """A domain's local frame without positions: padded edges get the
    sentinel row ``L`` (the local row count) in both rows, as the kernels'
    center-sorted CSR statics need (JAX pads with row 0 and masks)."""
    L = len(types)
    return {
        keys.ATOM_TYPES: types.astype(np.int32),
        keys.NODE_MASK: node_mask.astype(bool),
        keys.EDGE_INDEX: np.where(edge_mask[None], edge_index, L).astype(np.int32),
        keys.EDGE_CELL_SHIFT: edge_shift,
        keys.EDGE_MASK: edge_mask.astype(bool),
        keys.CELL: cell[None],
        keys.PBC: pbc_local[None],
    }


def real_neighbor_list(pos: np.ndarray, real: np.ndarray, r_max: float, cell: np.ndarray,
                       pbc: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The neighbor list among the real rows of ``pos`` (``real`` a mask),
    in local row ids. JAX lists every row, with the padded ones placed far
    apart; listing only the real rows gives the same edges whatever list
    runs (the native cell list wraps positions along periodic axes, and so
    would wrap the far rows back into the cell)."""
    rows = np.nonzero(real)[0]
    i, j, sh = primitive_neighbor_list(pos[rows], r_max, cell=cell, pbc=pbc)
    return rows[i], rows[j], sh


def as_domains(local, D: int, No: int) -> np.ndarray:
    """[D, No, 3] float64 from a [D, No, 3] array (or one of the mesh's
    shape) or a list of D tensors."""
    if isinstance(local, (list, tuple)):
        local = np.stack([t.detach().double().cpu().numpy() if isinstance(t, torch.Tensor)
                          else np.asarray(t, dtype=np.float64) for t in local])
    return np.asarray(local, dtype=np.float64).reshape(D, No, 3)


def numpy_dtype(dtype: torch.dtype):
    return {torch.float64: np.float64, torch.float32: np.float32}[dtype]
