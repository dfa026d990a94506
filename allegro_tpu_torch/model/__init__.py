"""Model builders and the JAX parameter converter."""

from .builders import (
    MODEL_BUILDERS,
    AllegroEnergyModel,
    AllegroModel,
    FieldMLP,
    FullAllegroEnergyModel,
    FullAllegroModel,
    FusedEdgeReadoutSum,
    Model,
)
from .convert import params_from_jax

__all__ = [
    "MODEL_BUILDERS",
    "AllegroEnergyModel",
    "AllegroModel",
    "FieldMLP",
    "FullAllegroEnergyModel",
    "FullAllegroModel",
    "FusedEdgeReadoutSum",
    "Model",
    "params_from_jax",
]
