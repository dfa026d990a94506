"""Training: loss and metrics, the one-device train loop with EMA, and
checkpoints (twin of ``allegro_tpu.train``, without ``package``).

The loop's steps are force-loss steps: the parameter gradient goes through
the forces (second order), on the ``fused`` backend through the kernels'
closed derivative family.
"""

from .loss import EnergyForceLoss, EnergyForceMetrics
from .loop import Trainer, TrainState, shard_stack
from .checkpoint import save_checkpoint, load_checkpoint

__all__ = [
    "EnergyForceLoss",
    "EnergyForceMetrics",
    "Trainer",
    "TrainState",
    "shard_stack",
    "save_checkpoint",
    "load_checkpoint",
]
