"""Molecular dynamics with a port model (twin of ``allegro_tpu.md``): one
device, or a mesh of devices run by one process (``edge_shard``, ``slab``,
``brick``)."""

from .simulation import (
    MDState,
    Simulation,
    kinetic_energy,
    maxwell_boltzmann_velocities,
    temperature,
)

__all__ = [
    "MDState",
    "Simulation",
    "kinetic_energy",
    "maxwell_boltzmann_velocities",
    "temperature",
]
