"""Train-state checkpoints in the port's own format (``torch.save``): the
parameters, the EMA parameters, the optimizer's state, the step and the
learning-rate schedule's state (where there is one), as in
``allegro_tpu/train/checkpoint.py``. Parameters are keyed by their
``state_dict`` names, which do not depend on the kernel backend, so a
checkpoint moves between backends."""

from __future__ import annotations

import os

import torch


def _cpu(tensors):
    return {k: v.detach().cpu().clone() for k, v in tensors.items()}


def save_checkpoint(ckpt_dir: str, state, name: str = "last") -> str:
    """Write ``state`` (a ``TrainState``) to ``ckpt_dir/name.pt``; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"{name}.pt"))
    opt = state.opt_state
    torch.save({
        "params": _cpu(state.params),
        "ema_params": _cpu(state.ema_params),
        "opt_state": opt.state_dict() if hasattr(opt, "state_dict") else opt,
        "step": int(state.step),
        "lr_scheduler": None if state.lr_scheduler is None else state.lr_scheduler.state_dict(),
    }, path)
    return path


def load_checkpoint(ckpt_dir: str, name: str = "last", template=None):
    """Read ``ckpt_dir/name.pt``. With a ``template`` (the ``TrainState`` of
    a trainer), the values are copied into it in place (parameters, EMA
    parameters, the optimizer) and it is returned; without one, a
    ``TrainState`` of CPU tensors whose ``opt_state`` is the optimizer's
    ``state_dict``."""
    from .loop import TrainState

    payload = torch.load(os.path.join(ckpt_dir, f"{name}.pt"), map_location="cpu",
                         weights_only=True)
    if template is None:
        return TrainState(payload["params"], payload["ema_params"], payload["opt_state"],
                          payload["step"], payload.get("lr_scheduler"))
    with torch.no_grad():
        for dst, src in ((template.params, payload["params"]),
                         (template.ema_params, payload["ema_params"])):
            if sorted(dst) != sorted(src):
                raise KeyError(f"checkpoint parameters {sorted(src)} do not match {sorted(dst)}")
            for k, v in src.items():
                dst[k].copy_(v)
    template.opt_state.load_state_dict(payload["opt_state"])
    if template.lr_scheduler is not None and payload.get("lr_scheduler") is not None:
        template.lr_scheduler.load_state_dict(payload["lr_scheduler"])
    template.step = payload["step"]
    return template
