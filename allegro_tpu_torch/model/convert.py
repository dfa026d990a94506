"""Carry JAX parameters over to the port: ``params_from_jax``.

The JAX package keys its parameters by the ``SequentialGraphNet`` stage
index (``params/layers_4_1/tps_0/path_weights``: stage 4, the ``allegro``
stage); the port keys its ``state_dict`` by stage name
(``allegro.tps.0.path_weights``). Weight orientation is the same in both
(``[fan_in, fan_out]``), so conversion is renaming. This module imports no
JAX: it takes the parameter tree as nested dicts of array-likes.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

# stage index → name in the JAX builder's stage list (``FullAllegroEnergyModel``);
# stages with parameters only. Later indices differ between backends (the
# einsum backend has a separate edge_sum), so they are resolved by content.
_STAGES = {
    1: "radial_chemical_embed",
    2: "scalar_embed_mlp",
    3: "tensor_embed",
    4: "allegro",
    5: "edge_readout",
}
_STAGE_KEY = re.compile(r"layers_(\d+)_1$")
_LIST_KEY = re.compile(r"(latents|tps)_(\d+)$")


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX params (``{"params": {...}}`` or the inner dict, leaves array-like)
    → the port's ``state_dict``, for ``load_state_dict(strict=True)``."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        m = _STAGE_KEY.fullmatch(path[0])
        if m is None:
            raise KeyError(f"unexpected parameter path {'/'.join(path)}")
        idx = int(m.group(1))
        if idx in _STAGES:
            stage = _STAGES[idx]
        elif path[-1] in ("scales", "shifts") and len(path) == 2:
            stage = "per_type_scale_shift"
        else:
            raise KeyError(f"no port stage for parameter {'/'.join(path)}")
        rest = [_LIST_KEY.sub(r"\1.\2", p) for p in path[1:]]
        out[".".join([stage, *rest])] = torch.from_numpy(np.array(leaf))
    return out
