"""Multi-device parallelism (twin of ``allegro_tpu.parallel``): spatial
domain decomposition with ghost-atom halo exchange over a mesh of devices
run by one process (slab and brick), and its exact communication
accounting. Data-parallel training is ``train.Trainer(mesh=...)``."""

from .brick import BrickDecomposition
from .domain import SlabDecomposition

__all__ = ["BrickDecomposition", "SlabDecomposition"]
