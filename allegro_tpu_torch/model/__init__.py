"""Model builders, model modifiers and the JAX parameter converter."""

from .builders import (
    MODEL_BUILDERS,
    MODEL_MODIFIERS,
    AllegroEnergyModel,
    AllegroModel,
    FieldMLP,
    FullAllegroEnergyModel,
    FullAllegroModel,
    FusedEdgeReadoutSum,
    Model,
    modify,
)
from .convert import params_from_jax

__all__ = [
    "MODEL_BUILDERS",
    "MODEL_MODIFIERS",
    "AllegroEnergyModel",
    "AllegroModel",
    "FieldMLP",
    "FullAllegroEnergyModel",
    "FullAllegroModel",
    "FusedEdgeReadoutSum",
    "Model",
    "modify",
    "params_from_jax",
]
