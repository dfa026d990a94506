"""Config files with ``_target_`` builders and dataset-statistics
interpolation (twin of ``allegro_tpu/train/config.py``).

``${training_data_stats:KEY}`` resolves from ``compute_statistics`` and
``${a.b}`` from the config itself; ``build_model`` picks a builder of the
port's ``MODEL_BUILDERS`` by the last component of ``_target_``, so a JAX
config (``allegro_tpu.model.AllegroModel``) builds the port's model.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

_STATS_RE = re.compile(r"^\$\{training_data_stats:([a-zA-Z_0-9]+)\}$")
_REF_RE = re.compile(r"^\$\{([a-zA-Z_0-9.]+)\}$")


def load_config(path: str) -> Dict[str, Any]:
    """A YAML config file as a dict (needs PyYAML, imported here only)."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def _lookup(root: Dict, dotted: str):
    cur: Any = root
    for part in dotted.split("."):
        cur = cur[part]
    return cur


def resolve(cfg, stats: Optional[Dict[str, Any]] = None, root=None):
    """Recursively resolve ``${training_data_stats:...}`` and ``${a.b}``."""
    if root is None:
        root = cfg
    if isinstance(cfg, dict):
        return {k: resolve(v, stats, root) for k, v in cfg.items()}
    if isinstance(cfg, list):
        return [resolve(v, stats, root) for v in cfg]
    if isinstance(cfg, str):
        m = _STATS_RE.match(cfg)
        if m:
            if stats is None:
                raise ValueError(f"no dataset statistics available to resolve {cfg}")
            return stats[m.group(1)]
        m = _REF_RE.match(cfg)
        if m:
            return resolve(_lookup(root, m.group(1)), stats, root)
    return cfg


def build_model(model_cfg: Dict[str, Any]):
    """Build a model from a ``_target_`` config block (``seed`` and
    ``compile_mode`` are read elsewhere and dropped here)."""
    from ..model.builders import MODEL_BUILDERS

    cfg = dict(model_cfg)
    target = cfg.pop("_target_", "allegro_tpu.model.AllegroModel")
    cfg.pop("seed", None)
    cfg.pop("compile_mode", None)
    builder = MODEL_BUILDERS.get(target) or MODEL_BUILDERS.get(target.rsplit(".", 1)[-1])
    if builder is None:
        raise ValueError(f"unknown model builder {target}")
    return builder(**cfg)
