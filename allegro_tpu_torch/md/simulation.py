"""MD engine: velocity Verlet (+ optional Langevin) on the device, host
re-neighboring (twin of ``allegro_tpu/md/simulation.py``, single device).

- A block of ``steps_per_block`` steps runs on the device against a fixed
  neighbor list, with no host synchronization inside the block: forces are
  ``-∂E/∂pos`` by autograd through the model's energy, and the Langevin noise
  comes from a ``torch.Generator`` on the device. The host reads positions,
  velocities and the potential energy once per block.
- The neighbor list is built on the host with a skin margin
  (``r_max + skin``) and kept until an atom has moved more than ``skin/2``.
  Rebuilds pad the edges into a sticky bucket (grow-only, rounded up to
  ``edge_multiple``) with sentinel edges, and take their per-neighbor-list
  statics (edge types, the kernels' CSR arrays) from
  ``Model.precompute_statics``.
- One device and the ``edge_shard`` strategy only: a mesh of more than one
  device and the ``slab`` / ``brick`` decompositions are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..data import keys, round_up, to_torch
from ..data.neighborlist import primitive_neighbor_list
from ..device import resolve_device

_MULTI_DEVICE = "ROADMAP.md queue 1, item 11"


@dataclasses.dataclass
class MDState:
    positions: np.ndarray  # [N, 3]
    velocities: np.ndarray  # [N, 3]
    step: int = 0


def kinetic_energy(velocities, masses) -> float:
    v = np.asarray(velocities)
    return float(0.5 * (np.asarray(masses)[:, None] * v * v).sum())


def temperature(velocities, masses, k_B: float = 1.0) -> float:
    n = len(velocities)
    return 2.0 * kinetic_energy(velocities, masses) / (3.0 * n * k_B)


def maxwell_boltzmann_velocities(
    masses_per_atom: np.ndarray,
    kT: float,
    seed: int = 0,
    zero_momentum: bool = True,
) -> np.ndarray:
    """Draw initial velocities at temperature ``kT`` (units with k_B = 1)."""
    rng = np.random.RandomState(seed)
    m = np.asarray(masses_per_atom, dtype=np.float64)[:, None]
    v = rng.randn(len(m), 3) * np.sqrt(kT / m)
    if zero_momentum:
        p = (m * v).sum(axis=0) / m.sum()
        v = v - p
    return v


class Simulation:
    """MD of one system with a port ``Model`` (its energy; forces by
    autograd). ``mesh`` is the devices to run on: one, or None for
    ``device`` (default: the CUDA card; raises without one unless
    ``device="cpu"`` is given)."""

    def __init__(
        self,
        model,
        atom_types: np.ndarray,
        masses: np.ndarray,  # per-type masses
        r_max: float,
        dt: float = 1e-3,
        cell: Optional[np.ndarray] = None,
        pbc=(False, False, False),
        skin: float = 0.5,
        steps_per_block: int = 10,
        edge_multiple: int = 1024,
        mesh: Optional[Sequence[torch.device]] = None,
        dtype: torch.dtype = torch.float32,
        langevin_gamma: Optional[float] = None,
        langevin_kT: float = 0.0,
        seed: int = 0,
        strategy: str = "edge_shard",
        device=None,
    ):
        if strategy in ("slab", "brick"):
            raise NotImplementedError(
                f"MD strategy {strategy!r} (spatial decomposition) is not ported to "
                f"allegro_tpu_torch yet ({_MULTI_DEVICE})"
            )
        if strategy != "edge_shard":
            raise ValueError(f"unknown MD strategy {strategy}")
        if mesh is not None:
            if len(mesh) != 1:
                raise NotImplementedError(
                    f"MD on a mesh of {len(mesh)} devices is not ported to allegro_tpu_torch "
                    f"yet ({_MULTI_DEVICE}); pass one device"
                )
            device = mesh[0]
        self.device = resolve_device(device)
        self.model = model
        self.types = np.asarray(atom_types, dtype=np.int32)
        self.n_atoms = len(self.types)
        self.masses_per_atom = np.asarray(masses, dtype=np.float64)[self.types]
        self.r_max = float(r_max)
        self.skin = float(skin)
        self.dt = float(dt)
        self.cell = None if cell is None else np.asarray(cell, dtype=np.float64).reshape(3, 3)
        self.pbc = np.asarray(pbc, dtype=bool)
        self.steps_per_block = int(steps_per_block)
        self.edge_multiple = int(edge_multiple)
        self.dtype = dtype
        self.langevin_gamma = langevin_gamma
        self.langevin_kT = float(langevin_kT)
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self._edge_bucket = 0
        self._ref_positions: Optional[np.ndarray] = None
        self._static: dict = {}
        self.bucket_grows = 0  # times a rebuild grew the edge bucket
        self.rebuilds = 0
        self._inv_m = torch.as_tensor(1.0 / self.masses_per_atom, dtype=dtype,
                                      device=self.device)[:, None]

    # --- neighbor management ---
    def _needs_rebuild(self, positions: np.ndarray) -> bool:
        if self._ref_positions is None:
            return True
        disp = positions - self._ref_positions
        return bool((np.linalg.norm(disp, axis=1) > 0.5 * self.skin).any())

    def _wrap(self, positions: np.ndarray) -> np.ndarray:
        """Wrap positions into the cell along periodic axes (the image
        enumeration of the neighbor list needs them inside)."""
        if self.cell is None or not self.pbc.any():
            return positions
        frac = positions @ np.linalg.inv(self.cell)
        frac[:, self.pbc] -= np.floor(frac[:, self.pbc])
        return frac @ self.cell

    def _rebuild(self, positions: np.ndarray) -> None:
        i, j, shifts = primitive_neighbor_list(
            positions, self.r_max + self.skin, self.cell, self.pbc
        )
        E = len(i)
        bucket = round_up(max(E, 1), self.edge_multiple)
        if bucket > self._edge_bucket:
            if self._edge_bucket:
                self.bucket_grows += 1
            self._edge_bucket = bucket
        bucket = self._edge_bucket
        order = np.argsort(i, kind="stable")
        i, j, shifts = i[order], j[order], shifts[order]
        # sentinel padding (atom id n_atoms): dropped by the sums, read as
        # zero rows by the gathers, and sorted after every real center
        eidx = np.full((2, bucket), self.n_atoms, dtype=np.int32)
        eidx[0, :E], eidx[1, :E] = i, j
        sh = np.zeros((bucket, 3))
        sh[:E] = shifts
        mask = np.zeros(bucket, dtype=bool)
        mask[:E] = True
        static = {
            keys.ATOM_TYPES: self.types,
            keys.EDGE_INDEX: eidx,
            keys.EDGE_CELL_SHIFT: sh,
            keys.EDGE_MASK: mask,
        }
        if self.cell is not None:
            static[keys.CELL] = self.cell[None]
            static[keys.PBC] = self.pbc[None]
        static = self.model.precompute_statics(static)
        self._static = to_torch(static, dtype=self.dtype, device=self.device)
        self._ref_positions = positions.copy()
        self.rebuilds += 1

    # --- the block of steps on the device ---
    def _energy_forces(self, pos: torch.Tensor):
        with torch.enable_grad():
            pos = pos.detach().requires_grad_(True)
            data = dict(self._static)
            data[keys.POSITIONS] = pos
            energy = self.model.apply(data)[keys.TOTAL_ENERGY].sum()
            (grad,) = torch.autograd.grad(energy, pos)
        return energy.detach(), -grad

    def _block(self, pos: torch.Tensor, vel: torch.Tensor):
        dt, inv_m = self.dt, self._inv_m
        gamma = self.langevin_gamma
        if gamma is not None:
            c1 = float(np.exp(-gamma * dt))
            sigma = torch.sqrt(self.langevin_kT * (1 - c1**2) * inv_m)
        e_pot, f = self._energy_forces(pos)
        for _ in range(self.steps_per_block):
            vel = vel + (0.5 * dt) * f * inv_m
            pos = pos + dt * vel
            e_pot, f = self._energy_forces(pos)
            vel = vel + (0.5 * dt) * f * inv_m
            if gamma is not None:
                noise = torch.randn(vel.shape, generator=self._gen, dtype=vel.dtype,
                                    device=vel.device)
                vel = c1 * vel + sigma * noise
        return pos, vel, e_pot

    # --- public API ---
    def run(self, state: MDState, n_steps: int, callback: Optional[Callable] = None) -> MDState:
        """Advance ``n_steps`` (whole blocks); ``callback(state, e_pot)`` after
        each block, with the potential energy at the block's last positions."""
        pos = np.asarray(state.positions, dtype=np.float64)
        vel = np.asarray(state.velocities, dtype=np.float64)
        done = 0
        while done < n_steps:
            if self._needs_rebuild(pos):
                pos = self._wrap(pos)
                self._rebuild(pos)
            p, v, e_pot = self._block(
                torch.as_tensor(pos, dtype=self.dtype, device=self.device),
                torch.as_tensor(vel, dtype=self.dtype, device=self.device),
            )
            pos = p.double().cpu().numpy()
            vel = v.double().cpu().numpy()
            done += self.steps_per_block
            state = MDState(pos, vel, state.step + self.steps_per_block)
            if callback is not None:
                callback(state, float(e_pot))
        return state
