"""The CLI's MD stage (twin of ``allegro_tpu/md/cli.py``): build a system
and a model from the config, run, report."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from ..data import keys
from ..device import resolve_device, visible_cards
from ..train import load_checkpoint
from ..train.config import build_model, resolve
from .simulation import MDState, Simulation, kinetic_energy


def run_md(config: Dict[str, Any], workdir: str, device=None) -> MDState:
    """The ``md`` block of ``config``: NVE (or Langevin) on a noisy periodic
    cubic crystal of ``n_atoms`` (rounded to a cube) with the ``model``
    block's model, its parameters from ``Model.init(model.seed)`` or, with
    ``md.ckpt``, the EMA parameters of a port checkpoint. Writes
    ``md_log.json`` (per block: step, potential, kinetic and total energy)
    and, with ``dump_trajectory``, ``trajectory.extxyz`` into ``workdir``.
    ``device``: None is the CUDA card (raises without one).

    ``md.strategy`` (``edge_shard``, ``slab`` or ``brick``) and, for the
    brick, ``md.mesh_shape`` ``[Dx, Dy, Dz]`` choose the devices as JAX's
    CLI does (``md_mesh``)."""
    device = resolve_device(device)
    mcfg = dict(config.get("md", {}))
    cfg = resolve(config, stats=None)
    model = build_model(cfg["model"]).init(int(cfg["model"].get("seed", 0)))

    n_atoms = int(mcfg.get("n_atoms", 1000))
    rng = np.random.RandomState(int(mcfg.get("seed", 0)))
    type_names = cfg["model"].get("type_names", ["A"])
    spacing = float(mcfg.get("spacing", 2.2))
    side = int(round(n_atoms ** (1 / 3)))
    n_atoms = side**3
    grid = np.stack(np.meshgrid(*(np.arange(side),) * 3, indexing="ij"), -1).reshape(-1, 3)
    pos = grid * spacing + 0.05 * rng.randn(n_atoms, 3)
    types = rng.randint(0, len(type_names), n_atoms).astype(np.int32)
    cell = np.eye(3) * side * spacing

    ckpt = mcfg.get("ckpt")
    if ckpt:
        ema = load_checkpoint(ckpt, mcfg.get("ckpt_name", "best")).ema_params
        live = model.parameters()
        if sorted(ema) != sorted(live):
            raise KeyError(f"checkpoint parameters {sorted(ema)} do not match {sorted(live)}")
        with torch.no_grad():
            for k, p in live.items():
                p.copy_(ema[k])
    model.to(device)

    strategy = str(mcfg.get("strategy", "edge_shard"))
    mesh, mesh_shape = md_mesh(strategy, mcfg.get("mesh_shape"), device)
    sim = Simulation(
        model,
        atom_types=types,
        masses=np.ones(len(type_names)) * float(mcfg.get("mass", 1.0)),
        r_max=float(cfg["model"]["r_max"]),
        dt=float(mcfg.get("dt", 1e-3)),
        cell=cell,
        pbc=(True, True, True),
        skin=float(mcfg.get("skin", 0.4)),
        steps_per_block=int(mcfg.get("steps_per_block", 20)),
        langevin_gamma=mcfg.get("langevin_gamma"),
        langevin_kT=float(mcfg.get("langevin_kT", 0.0)),
        strategy=strategy,
        mesh=mesh,
        mesh_shape=mesh_shape,
    )
    st = MDState(pos, rng.randn(n_atoms, 3) * float(mcfg.get("v0", 0.05)))
    log, traj = [], []
    dump = bool(mcfg.get("dump_trajectory", False))

    def cb(s, e_pot):
        ke = kinetic_energy(s.velocities, sim.masses_per_atom)
        log.append({"step": s.step, "e_pot": e_pot, "e_kin": ke, "e_tot": e_pot + ke})
        print(f"step {s.step}: E_pot={e_pot:.6f} E_kin={ke:.6f} E_tot={e_pot + ke:.6f}")
        if dump:
            traj.append({keys.POSITIONS: s.positions.copy(), keys.ATOM_TYPES: types,
                         keys.CELL: cell, keys.PBC: np.ones(3, bool)})

    t0 = time.perf_counter()
    st = sim.run(st, int(mcfg.get("n_steps", 100)), callback=cb)
    seconds = time.perf_counter() - t0
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "md_log.json"), "w") as f:
        json.dump(log, f)
    if traj:
        from ..data.xyz import write_extxyz

        path = os.path.join(workdir, "trajectory.extxyz")
        write_extxyz(path, traj, type_names=type_names)
        print(f"trajectory written: {path}")
    print(f"MD done: {st.step} steps of {n_atoms} atoms in {seconds:.3f} s "
          f"({1e3 * seconds / max(st.step, 1):.3f} ms/step), {sim.rebuilds} neighbor rebuilds, "
          f"{sim.bucket_grows} bucket growths")
    return st


def md_mesh(strategy: str, mesh_shape, device: torch.device):
    """(mesh, mesh_shape) of the CLI's MD, as JAX's CLI builds its mesh:
    ``edge_shard`` runs on ``device`` alone; ``slab`` on every device (every
    visible card; on the CPU, the one CPU device); ``brick`` on
    ``mesh_shape`` (default ``[every device, 1, 1]``), the first
    ``prod(mesh_shape)`` cards, or on the CPU the CPU device for each entry
    (the role of JAX's virtual host devices)."""
    every = visible_cards() if device.type == "cuda" else [device]
    if strategy == "slab":
        return every, None
    if strategy != "brick":
        return [device], None
    shape = tuple(int(s) for s in (mesh_shape or [len(every), 1, 1]))
    n = int(np.prod(shape))
    if device.type != "cuda":
        return [device] * n, shape
    if n > len(every):
        raise ValueError(f"md.mesh_shape {list(shape)} needs {n} cards; {len(every)} visible")
    return every[:n], shape
