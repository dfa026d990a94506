"""Ordered composition of graph stages over a data dict (twin of
``allegro_tpu/nn/sequential.py``).

Learned stages become named submodules, so the ``state_dict`` is keyed by
the stage names (``allegro.tps.0.path_weights``); stateless stages are plain
callables.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

from torch import nn


class SequentialGraphNet(nn.Module):
    def __init__(self, layers: Sequence[Tuple[str, Any]]):
        super().__init__()
        self.stage_names = tuple(name for name, _ in layers)
        self._stateless: Dict[str, Callable] = {}
        for name, layer in layers:
            if isinstance(layer, nn.Module):
                self.add_module(name, layer)
            else:
                self._stateless[name] = layer

    def stage(self, name: str) -> Callable:
        return self._modules[name] if name in self._modules else self._stateless[name]

    def forward(self, data: Dict) -> Dict:
        for name in self.stage_names:
            data = self.stage(name)(data)
        return data
