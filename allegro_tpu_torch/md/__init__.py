"""Molecular dynamics with a port model (twin of ``allegro_tpu.md``, one
device)."""

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
