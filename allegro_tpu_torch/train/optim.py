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

Over bfloat16 parameters (a ``model_dtype="bfloat16"`` model) the update is
:class:`OptaxBf16`'s, not ``torch.optim``'s: optax computes every op of
its update in the parameters' dtype, each a float32 op rounded once to
bfloat16 (XLA's bfloat16 arithmetic), with its Python constants (the betas,
eps, the weight decay, the learning rate) rounded to bfloat16 first, as JAX
rounds a weak-typed scalar; the bias corrections ``1 - b**t`` and a
schedule's learning rate are float32 values (optax computes them under
``jax.jit`` with 64-bit types off, as JAX runs by default) rounded to
bfloat16; ``torch.optim`` keeps its scalars and some intermediates in
float32. Float32 and float64 parameters keep ``torch.optim``.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

_ITEM = "queue 1, item 8"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to allegro_tpu_torch yet (ROADMAP.md {_ITEM})")


def _name(target: str) -> str:
    return str(target).rsplit(".", 1)[-1]


def _bf(v: float) -> float:
    """``v`` rounded to float32, then to bfloat16: a weak-typed JAX scalar in
    a bfloat16 op (ml_dtypes rounds a float64 through float32), or a float32
    value that optax casts to the update's dtype."""
    return float(torch.tensor(np.float32(v)).to(torch.bfloat16))


def bias_correction(b: float, t: int) -> float:
    """optax's ``1 - b**t`` for update ``t`` in bfloat16: float32 (``b`` a
    weak float32, ``t`` its int32 count), cast to the moments' dtype."""
    return _bf(np.float32(1) - np.power(np.float32(b), np.float32(t)))


class OptaxBf16(torch.optim.Optimizer):
    """optax's ``adam``, ``adamw`` or ``sgd`` (``kind``) over bfloat16
    parameters, with optax's rounding points: every op of the update is a
    bfloat16 op (torch computes a bfloat16 op in float32 and rounds once,
    as XLA does) and its scalars are rounded to bfloat16 first. The state
    (``exp_avg`` = optax's mu, ``exp_avg_sq`` = nu, ``momentum_buffer`` =
    the trace) is bfloat16; the parameter takes ``apply_updates``'
    ``(p + u).astype(p.dtype)``. The learning rate is the group's ``lr``
    (a ``LambdaLR`` schedules it: optax casts the schedule's value to the
    update's dtype)."""

    def __init__(self, params: Iterable[torch.Tensor], kind: str, lr: float,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, momentum: float = 0.0, nesterov: bool = False):
        if kind not in ("adam", "adamw", "sgd"):
            raise ValueError(f"OptaxBf16: kind {kind!r} is not adam, adamw or sgd")
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      momentum=momentum, nesterov=nesterov))
        self.kind = kind
        for group in self.param_groups:
            for p in group["params"]:
                if p.dtype != torch.bfloat16:
                    raise TypeError(f"OptaxBf16 takes bfloat16 parameters, got {p.dtype}")

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxBf16.step takes no closure")
        for group in self.param_groups:
            lr = _bf(-group["lr"])
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                u = self._adam(p, p.grad, group, state) if self.kind != "sgd" else \
                    self._sgd(p.grad, group, state)
                p.add_(u * lr)

    def _adam(self, p, g, group, state):
        b1, b2 = group["betas"]
        if not state:
            state.update(step=0, exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))
        state["step"] += 1
        t = state["step"]
        # optax.tree.update_moment(_per_elem_norm): (1 - b) * g**k + b * m
        mu = g * _bf(1 - b1) + state["exp_avg"] * _bf(b1)
        nu = (g * g) * _bf(1 - b2) + state["exp_avg_sq"] * _bf(b2)
        state["exp_avg"], state["exp_avg_sq"] = mu, nu
        u = (mu / bias_correction(b1, t)) / ((nu / bias_correction(b2, t)).sqrt()
                                             + _bf(group["eps"]))
        if self.kind == "adamw":
            u = u + p * _bf(group["weight_decay"])
        return u

    def _sgd(self, g, group, state):
        m = group["momentum"]
        if not m:
            return g
        trace = g + state.get("momentum_buffer", torch.zeros_like(g)) * _bf(m)
        state["momentum_buffer"] = trace
        return g + trace * _bf(m) if group["nesterov"] else trace


def _optimizer(name: str, params, **kw) -> torch.optim.Optimizer:
    """optax's ``name`` over ``params``: ``torch.optim``'s over float32 or
    float64 parameters, :class:`OptaxBf16` over bfloat16 ones."""
    params = list(params)
    if not any(p.dtype == torch.bfloat16 for p in params):
        if name == "sgd":
            return torch.optim.SGD(params, dampening=0.0, **kw)
        return (torch.optim.AdamW if name == "adamw" else torch.optim.Adam)(params, **kw)
    return OptaxBf16(params, name, **kw)


def optimizer(name: str, **kw) -> Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]:
    """The factory of optax's ``name`` (``adam``, ``adamw`` or ``sgd``) over a
    parameter list, with ``torch.optim``'s keywords (``lr``, ``betas``,
    ``eps``, ``weight_decay``, ``momentum``, ``nesterov``)."""
    return functools.partial(_optimizer, name, **kw)


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
    elif name == "sgd":
        momentum = cfg.pop("momentum", None)
        kw = dict(lr=lr, momentum=0.0 if momentum is None else float(momentum),
                  nesterov=bool(cfg.pop("nesterov", False)), weight_decay=0.0)
    else:
        raise _not_ported(f"optimizer {name}")
    if cfg:
        raise _not_ported(f"optax.{name} with {sorted(cfg)}")
    return optimizer(name, **kw), lr


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
