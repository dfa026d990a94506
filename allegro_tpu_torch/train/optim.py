"""The config's optax optimizers and learning-rate schedules as
``torch.optim`` (twin of the ``trainer.optimizer`` / ``trainer.lr_scheduler``
blocks of ``allegro_tpu/cli.py``).

Optimizers: ``optax.adam``, ``optax.adamw`` and ``optax.sgd``, each with
optax's defaults passed to torch explicitly (torch's differ: ``AdamW``'s
weight decay is 1e-2 there, 1e-4 in optax; optax's ``sgd`` without momentum
is the plain ``-lr·g``). Schedules: ``optax.exponential_decay`` and
``optax.cosine_decay_schedule``, as a ``LambdaLR`` whose factor is optax's
formula over the schedule's initial value (``exponential_decay`` in float32,
as optax evaluates it). optax counts updates from 0 and
update t uses ``schedule(t)``; ``Trainer`` steps the scheduler once per
optimizer step (not per epoch), after the update, so update t runs at
factor(t) too. Any other name or option raises, naming its ROADMAP item.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

_ITEM = "queue 1, item 8"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to allegro_tpu_torch yet (ROADMAP.md {_ITEM})")


def _name(target: str) -> str:
    return str(target).rsplit(".", 1)[-1]


def optimizer_from_config(opt_cfg: Dict[str, Any]) -> Tuple[Callable, float]:
    """(factory of the ``torch.optim`` optimizer over a parameter list, its
    learning rate) for an optax ``optimizer`` block."""
    cfg = dict(opt_cfg)
    name = _name(cfg.pop("_target_", "optax.adam"))
    lr = float(cfg.pop("learning_rate", cfg.pop("lr", 1e-3)))
    if name in ("adam", "adamw"):
        kw = dict(lr=lr, betas=(float(cfg.pop("b1", 0.9)), float(cfg.pop("b2", 0.999))),
                  eps=float(cfg.pop("eps", 1e-8)))
        if float(cfg.pop("eps_root", 0.0)) != 0.0 or cfg.pop("nesterov", False):
            raise _not_ported(f"optax.{name} with eps_root or nesterov")
        if name == "adamw":
            kw["weight_decay"] = float(cfg.pop("weight_decay", 1e-4))
        opt = torch.optim.AdamW if name == "adamw" else torch.optim.Adam
    elif name == "sgd":
        momentum = cfg.pop("momentum", None)
        kw = dict(lr=lr, momentum=0.0 if momentum is None else float(momentum), dampening=0.0,
                  nesterov=bool(cfg.pop("nesterov", False)), weight_decay=0.0)
        opt = torch.optim.SGD
    else:
        raise _not_ported(f"optimizer {name}")
    if cfg:
        raise _not_ported(f"optax.{name} with {sorted(cfg)}")
    return functools.partial(opt, **kw), lr


def exponential_decay(transition_steps: int, decay_rate: float, transition_begin: int = 0,
                      staircase: bool = False, end_value: Optional[float] = None,
                      init_value: float = 1.0) -> Callable[[int], float]:
    """optax's ``exponential_decay`` over ``init_value``: the factor at
    update t. optax evaluates it in float32 (its update count is an int32,
    so the rate comes out float32 even where float64 is enabled), and so
    does this: the learning rate is optax's to the last bit but for the
    rounding of ``pow``."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda t: 1.0  # optax's constant schedule
    transition_begin = max(int(transition_begin), 0)
    f32 = np.float32

    def factor(t: int) -> float:
        count = t - transition_begin
        if count <= 0:
            value = f32(init_value)
        else:
            p = f32(count) / f32(transition_steps)
            if staircase:
                p = np.floor(p)
            value = f32(init_value) * np.power(f32(decay_rate), p)
        if end_value is not None:
            clip = np.maximum if decay_rate < 1.0 else np.minimum
            value = clip(value, f32(end_value))
        return float(value) / init_value

    return factor


def cosine_decay_schedule(decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule`` over its initial value: the factor
    at update t."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def factor(t: int) -> float:
        count = min(float(t), float(decay_steps))
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return (1.0 - alpha) * cosine**exponent + alpha

    return factor


def schedule_from_config(sched_cfg: Dict[str, Any], lr: float) -> Callable:
    """The factory of a ``LambdaLR`` over an optimizer for an optax
    ``lr_scheduler`` block (optax's ``init_value`` is the optimizer's ``lr``)."""
    cfg = dict(sched_cfg)
    name = _name(cfg.pop("_target_", "optax.exponential_decay"))
    if name == "exponential_decay":
        factor = exponential_decay(init_value=lr, **cfg)
    elif name == "cosine_decay_schedule":
        factor = cosine_decay_schedule(**cfg)
    else:
        raise _not_ported(f"lr_scheduler {name}")
    return functools.partial(torch.optim.lr_scheduler.LambdaLR, lr_lambda=factor)
