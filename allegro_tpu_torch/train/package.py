"""Model packages: one archive with everything needed to rebuild a model
(twin of ``allegro_tpu/train/package.py``).

An ``.atpkg`` zip holds ``config.json`` (the resolved model config),
``params.npz`` (every entry of the model's ``state_dict``: the EMA values of
its trainable parameters, and its persistent buffers) and ``meta.json``
(``format``, the port's version, the number of arrays and ``extra``). The
npz keys are the JAX pytree's flattened names (``params/layers_4_1/tps_0/
path_weights``), so ``model.convert.params_from_jax`` reads them back, and a
parameter set trained in JAX and carried over packages to the same keys.
"""

from __future__ import annotations

import io
import json
import os
import re
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import __version__
from ..model.convert import params_from_jax

FORMAT = "allegro-tpu-torch-package-v1"
_LIST = re.compile(r"^(latents|tps)\.(\d+)(?=\.|$)")


def jax_param_names(model) -> Dict[str, str]:
    """Each ``state_dict`` name of ``model`` (a port ``Model``) → its JAX
    pytree path joined by ``/``: the stage's index in the module chain
    (``layers_<i>_1``), then the stage's own names with ``latents.<k>`` and
    ``tps.<k>`` as ``latents_<k>`` and ``tps_<k>``; the inverse of
    ``params_from_jax``."""
    stages = model.module.stage_names
    names = {}
    for name in model.state_dict():
        stage, rest = name.split(".", 1)
        rest = _LIST.sub(r"\1_\2", rest)
        names[name] = "/".join(["params", f"layers_{stages.index(stage)}_1", *rest.split(".")])
    return names


def _nested(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def save_package(path: str, model_config: Dict[str, Any], model,
                 extra: Optional[Dict] = None) -> str:
    """Write ``model``'s ``state_dict`` (a port ``Model``, parameters as
    they are now) with ``model_config`` into the archive ``path``. numpy has
    no bfloat16: a bfloat16 model's arrays are stored as float32 arrays of
    the same values, which load back to the same bits."""
    names = jax_param_names(model)
    arrays = {names[k]: (v.float() if v.dtype == torch.bfloat16 else v).detach().cpu().numpy()
              for k, v in model.state_dict().items()}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    meta = {"format": FORMAT, "version": __version__, "n_params": len(arrays),
            "extra": extra or {}}
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("config.json", json.dumps(model_config, indent=2, default=str))
        z.writestr("params.npz", buf.getvalue())
        z.writestr("meta.json", json.dumps(meta, indent=2))
    return path


def load_package(path: str) -> Tuple[Any, Dict[str, torch.Tensor], Dict]:
    """(model, its ``state_dict`` as loaded, meta): the model is rebuilt from
    the packaged config, on the CPU, with the packaged values."""
    from .config import build_model

    with zipfile.ZipFile(path) as z:
        cfg = json.loads(z.read("config.json"))
        meta = json.loads(z.read("meta.json"))
        npz = np.load(io.BytesIO(z.read("params.npz")))
        flat = {k: npz[k] for k in npz.files}
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: package format {meta.get('format')!r}, expected {FORMAT!r}")
    if len(flat) != meta["n_params"]:
        raise ValueError(f"{path}: {len(flat)} arrays, meta says {meta['n_params']}")
    model = build_model(cfg)
    params = params_from_jax(_nested(flat))
    model.load_state_dict(params)
    return model, params, meta


def resolved_config_for(config: Dict, workdir: str) -> Dict:
    """The statistics-resolved config the train stage saved in ``workdir``,
    else ``config`` resolved without statistics."""
    from .config import resolve

    path = os.path.join(workdir, "resolved_config.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return resolve(config, stats=None)


def trained_model(config: Dict, workdir: str,
                  ckpt: Optional[str]) -> Tuple[Dict, Any, Optional[str], Dict]:
    """``(model_cfg, model, checkpoint, cfg)``: the model of the resolved
    config with the EMA parameters of the ``best`` checkpoint in ``ckpt``
    (or ``workdir``), else ``last``, else its initial parameters
    (``checkpoint`` None), on the CPU."""
    from .checkpoint import load_checkpoint
    from .config import build_model

    src = ckpt or workdir
    cfg = resolved_config_for(config, src)
    model_cfg = cfg["model"]
    model = build_model(model_cfg).init(int(model_cfg.get("seed", 0)))
    name = next((n for n in ("best", "last") if os.path.exists(os.path.join(src, f"{n}.pt"))),
                None)
    if name is not None:
        ema = load_checkpoint(src, name).ema_params
        live = model.parameters()
        if sorted(ema) != sorted(live):
            raise KeyError(f"checkpoint parameters {sorted(ema)} do not match {sorted(live)}")
        with torch.no_grad():
            for k, p in live.items():
                p.copy_(ema[k])
    return model_cfg, model, name, cfg


def output_path(workdir: str, output: str) -> str:
    """``output`` relative to ``workdir`` (unless absolute), its folder made."""
    path = output if os.path.isabs(output) else os.path.join(workdir, output)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return path


def run_package(config: Dict, workdir: str, ckpt: Optional[str], output: str) -> str:
    """The CLI's ``package`` stage: ``trained_model``'s model written to
    ``output`` (relative to ``workdir``); ``extra`` says which checkpoint
    its parameters came from."""
    model_cfg, model, name, _ = trained_model(config, workdir, ckpt)
    path = output_path(workdir, output)
    save_package(path, model_cfg, model,
                 extra={"from_checkpoint": name is not None, "checkpoint": name})
    print(f"wrote package: {path}")
    return path
