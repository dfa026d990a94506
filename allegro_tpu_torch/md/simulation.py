"""MD engine: velocity Verlet (+ optional Langevin) on the device, host
re-neighboring (twin of ``allegro_tpu/md/simulation.py``).

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
- ``per_edge_type_cutoff`` ([T, T], <= r_max) keeps each edge within its
  type pair's cutoff plus the skin; beyond its pair's cutoff an edge adds
  exactly zero (the model's envelope), as in JAX.
- A mesh of several devices (a list run by one process; an entry may
  repeat, so ``[cuda:0] * D`` runs on one card): ``edge_shard`` splits the
  center-sorted edges over the devices as evenly as whole centers allow,
  each running the force call on its shard with the positions replicated;
  forces are summed onto the first device in device order, and the energy
  is the shards' sum less ``(D - 1)`` times the per-atom constant
  (``_compute_e_const``), which every shard counts. ``slab`` and ``brick`` decompose space
  (``parallel.SlabDecomposition`` / ``BrickDecomposition``, ``mesh_shape``
  for the brick): each domain integrates its own atoms (NVE velocity Verlet,
  no thermostat, as JAX's block), ghosts ride the halo exchange every force
  call, and atoms migrate between domains when the skin is exceeded and
  space is decomposed anew on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..data import keys, round_up, to_torch
from ..data.neighborlist import edge_lengths, primitive_neighbor_list
from ..device import replicate, resolve_mesh


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
    autograd). ``mesh``: the devices to run on, in order (an entry may
    repeat), or None for ``device`` alone (default: the CUDA card; raises
    without one unless ``device="cpu"`` is given). ``strategy``:
    ``"edge_shard"``, ``"slab"`` or ``"brick"`` (with ``mesh_shape``, the
    brick mesh's ``(Dx[, Dy[, Dz]])``, default ``(len(mesh),)``). The model
    runs where its parameters are; on every other device of the mesh a copy
    of it does (``device.replicate``)."""

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
        per_edge_type_cutoff: Optional[np.ndarray] = None,  # [T, T] <= r_max
        device=None,
        mesh_shape: Optional[Sequence[int]] = None,
    ):
        if strategy not in ("edge_shard", "slab", "brick"):
            raise ValueError(f"unknown MD strategy {strategy}")
        if strategy != "edge_shard" and langevin_gamma is not None:
            # JAX's slab block integrates NVE whatever langevin_gamma says
            raise ValueError(f"MD strategy {strategy!r} integrates NVE: no Langevin thermostat")
        if mesh_shape is not None and strategy != "brick":
            raise ValueError("mesh_shape is the brick strategy's")
        self.mesh = resolve_mesh(mesh, device)
        self.n_dev = len(self.mesh)
        self.device = self.mesh[0]
        self.mesh_shape = None if mesh_shape is None else tuple(int(s) for s in mesh_shape)
        self.strategy = strategy
        self.model = model
        self._models = replicate(model, self.mesh)
        self.types = np.asarray(atom_types, dtype=np.int32)
        self.n_atoms = len(self.types)
        self.masses_per_atom = np.asarray(masses, dtype=np.float64)[self.types]
        self.r_max = float(r_max)
        self.skin = float(skin)
        # the per-(center, neighbor)-type cutoff matrix: at (re-)neighboring
        # an edge is kept within its pair's cutoff plus the skin, as in JAX
        if per_edge_type_cutoff is not None:
            per_edge_type_cutoff = np.asarray(per_edge_type_cutoff, np.float64)
            if not (per_edge_type_cutoff <= self.r_max + 1e-12).all():
                raise ValueError("per-edge-type cutoffs must be <= r_max")
        self.per_edge_type_cutoff = per_edge_type_cutoff
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
        self._shards: list = []  # edge_shard: the statics of each device's edges
        self._slab_mins = None  # slab / brick: the sticky sizes (No, S, El)
        self.bucket_grows = 0  # times a rebuild grew the edge bucket (slab: a size)
        self.rebuilds = 0
        self._inv_m = torch.as_tensor(1.0 / self.masses_per_atom, dtype=dtype,
                                      device=self.device)[:, None]
        # the per-atom constant (type shifts) that each of the D edge shards
        # counts: subtracted D - 1 times from their summed energy
        shards = strategy == "edge_shard" and self.n_dev > 1
        self._e_const = self._compute_e_const() if shards else 0.0

    def _compute_e_const(self) -> float:
        """The model's energy with every edge masked (sentinel edges)."""
        n = self.n_atoms
        data = {
            keys.POSITIONS: np.zeros((n, 3)),
            keys.ATOM_TYPES: self.types,
            keys.EDGE_INDEX: np.full((2, 2), n, np.int32),
            keys.EDGE_CELL_SHIFT: np.zeros((2, 3)),
            keys.EDGE_MASK: np.zeros(2, bool),
        }
        data = to_torch(self.model.precompute_statics(data), dtype=self.dtype, device=self.device)
        return float(self.model.apply(data, frozen=True)[keys.TOTAL_ENERGY].sum())

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
        if self.per_edge_type_cutoff is not None and len(i):
            # the skin margin per type pair (the rebuild trigger's safety)
            r = edge_lengths(positions, self.cell, i, j, shifts)
            keep = r < self.per_edge_type_cutoff[self.types[i], self.types[j]] + self.skin
            i, j, shifts = i[keep], j[keep], shifts[keep]
        D = self.n_dev
        order = np.argsort(i, kind="stable")
        i, j, shifts = i[order], j[order], shifts[order]
        cuts = self._shard_cuts(i)
        per = round_up(max(int(np.diff(cuts).max()), 1), self.edge_multiple)
        if per * D > self._edge_bucket:
            if self._edge_bucket:
                self.bucket_grows += 1
            self._edge_bucket = per * D
        per = self._edge_bucket // D
        # D shards of the center-sorted list, each padded to ``per`` edges
        # with sentinel edges (atom id n_atoms: dropped by the sums, read as
        # zero rows by the gathers, sorted after every real center)
        self._shards = []
        for d, device in enumerate(self.mesh):
            part = slice(cuts[d], cuts[d + 1])
            n = cuts[d + 1] - cuts[d]
            eidx = np.full((2, per), self.n_atoms, dtype=np.int32)
            eidx[0, :n], eidx[1, :n] = i[part], j[part]
            sh = np.zeros((per, 3))
            sh[:n] = shifts[part]
            mask = np.zeros(per, dtype=bool)
            mask[:n] = True
            static = {
                keys.ATOM_TYPES: self.types,
                keys.EDGE_INDEX: eidx,
                keys.EDGE_CELL_SHIFT: sh,
                keys.EDGE_MASK: mask,
            }
            if self.cell is not None:
                static[keys.CELL] = self.cell[None]
                static[keys.PBC] = self.pbc[None]
            static = self._models[device].precompute_statics(static)
            self._shards.append(to_torch(static, dtype=self.dtype, device=device))
        self._ref_positions = positions.copy()
        self.rebuilds += 1

    def _shard_cuts(self, centers: np.ndarray) -> np.ndarray:
        """[D + 1] bounds of the edge shards in the center-sorted list: the
        even cuts moved forward to the next center's first edge, so every
        center's edges lie in one shard. A center's environment sums over
        all its edges, so a shard holding part of them would give it the
        energy of another environment. (JAX cuts evenly, through a center's
        edges: its shards' energies are off by that, ROADMAP queue 3.)"""
        E, D = len(centers), self.n_dev
        cuts = [0]
        for d in range(1, D):
            t = max(-(-d * E // D), cuts[-1])
            cuts.append(t if t in (0, E) else int(np.searchsorted(centers, centers[t - 1],
                                                                  side="right")))
        return np.asarray(cuts + [E])

    # --- the block of steps on the device ---
    def _energy_forces(self, pos: torch.Tensor):
        """Energy and forces of the edge shards at ``pos`` (on the first
        device): each shard's force call on its device, forces summed in
        device order on the first (the cross-device copies hold values, not
        graphs: nothing differentiates through them)."""
        first = self.device
        energy = forces = None
        for device, static in zip(self.mesh, self._shards):
            e, f = self._models[device].energy_forces(
                {**static, keys.POSITIONS: pos.to(device)})
            energy = e if energy is None else energy + e.to(first)
            forces = f if forces is None else forces + f.to(first)
        if self.n_dev > 1:
            energy = energy - (self.n_dev - 1) * self._e_const
        return energy, forces

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

    # --- spatial decomposition (slab / brick) ---
    def _decompose(self, positions: np.ndarray):
        """A decomposition of ``positions`` at least as large as the last
        (sticky sizes, so shapes do not shrink), and its force call."""
        from ..parallel import BrickDecomposition, SlabDecomposition

        brick = self.strategy == "brick"
        mins = self._slab_mins or {"No": 0, "S": (0, 0, 0) if brick else 0, "El": 0}
        common = dict(skin=self.skin, edge_multiple=self.edge_multiple, dtype=self.dtype,
                      min_owned_pad=mins["No"], min_send_pad=mins["S"],
                      min_edges_pad=mins["El"])
        if brick:
            dd = BrickDecomposition(positions, self.types, self.cell, self.pbc, self.r_max,
                                    self.mesh, mesh_shape=self.mesh_shape, **common)
        else:
            dd = SlabDecomposition(positions, self.types, self.cell, self.pbc, self.r_max,
                                   self.mesh, **common)
        sizes = {"No": dd.No, "S": tuple(dd.S) if brick else dd.S, "El": dd.El}
        if sizes != mins:
            if self._slab_mins is not None:
                self.bucket_grows += 1
            self._slab_mins = sizes
        return dd, dd.make_energy_forces_fn(self.model, self._models)

    def _slab_block(self, force, pos, vel, inv_m):
        """NVE velocity Verlet of each domain's owned atoms (lists of
        per-domain tensors; padded rows have inv_m 0 and stay put)."""
        dt = self.dt
        e_pot, f = force(pos)
        for _ in range(self.steps_per_block):
            vel = [v + (0.5 * dt) * fd * m for v, fd, m in zip(vel, f, inv_m)]
            pos = [p + dt * v for p, v in zip(pos, vel)]
            e_pot, f = force(pos)
            vel = [v + (0.5 * dt) * fd * m for v, fd, m in zip(vel, f, inv_m)]
        return pos, vel, e_pot

    def _run_slab(self, state: MDState, n_steps: int, callback: Optional[Callable]) -> MDState:
        """MD on a spatial decomposition: each domain integrates its own
        atoms, ghosts ride the halo exchange every force call, and atoms
        migrate between domains when space is decomposed anew (host)."""
        pos = np.asarray(state.positions, dtype=np.float64)
        vel = np.asarray(state.velocities, dtype=np.float64)
        done = 0
        dd = None
        while done < n_steps:
            if dd is None or self._needs_rebuild(pos):
                pos = self._wrap(pos)
                dd, force = self._decompose(pos)
                self.rebuilds += 1
                self._ref_positions = pos.copy()
                inv_m = []
                for d, idx in enumerate(dd.owned):
                    m = np.zeros((dd.No, 1))
                    m[: len(idx), 0] = 1.0 / self.masses_per_atom[idx]
                    inv_m.append(torch.as_tensor(m, dtype=self.dtype, device=self.mesh[d]))

            def local(a):
                return [torch.as_tensor(x, dtype=self.dtype, device=dev)
                        for x, dev in zip(a, self.mesh)]

            p, v, e_pot = self._slab_block(force, local(dd.scatter_positions(pos, wrap=False)),
                                           local(dd.scatter_vectors(vel)), inv_m)
            pos = dd.gather_positions(p)
            vel = dd.gather_vectors(v)
            done += self.steps_per_block
            state = MDState(pos, vel, state.step + self.steps_per_block)
            if callback is not None:
                callback(state, float(e_pot))
        return state

    # --- public API ---
    def run(self, state: MDState, n_steps: int, callback: Optional[Callable] = None) -> MDState:
        """Advance ``n_steps`` (whole blocks); ``callback(state, e_pot)`` after
        each block, with the potential energy at the block's last positions."""
        if self.strategy in ("slab", "brick"):
            return self._run_slab(state, n_steps, callback)
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
