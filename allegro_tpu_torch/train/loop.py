"""The training loop on one device (twin of ``allegro_tpu/train/loop.py``).

A step evaluates the energy and the forces with the graph of the forces
kept (``Model.apply_with_derivatives(create_graph=True)``), takes the
gradient of the loss in the parameters (second order through the forces:
on the ``fused`` backend, through the kernels' closed derivative family),
applies the optimizer (Adam by default, whose update is ``optax.adam``'s)
and its learning-rate schedule, if any (stepped once per update), and
updates the exponential moving average of the parameters. Each batch from
the loader gets the model's statics on the host
(``Model.precompute_statics``) before it goes to the device. With
``profile_dir`` the steps ``[profile_steps)`` are traced by
``torch.profiler`` into that directory (``utils.profiling.profile_trace``).

One device only: data parallelism over several (the JAX loop's ``dp`` mesh
axis) is ROADMAP.md queue 1, item 11 (DDP, with multi-device MD).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data import keys, to_torch
from ..device import resolve_device
from ..model.builders import Model
from ..utils.profiling import profile_trace
from .checkpoint import save_checkpoint
from .loss import EnergyForceLoss, EnergyForceMetrics

_DDP = "ROADMAP.md queue 1, item 11 (DDP, with multi-device MD)"


def shard_stack(batches: List[Dict]) -> Dict:
    """Stack per-device batches along a new leading device axis."""
    return {k: np.stack([np.asarray(b[k]) for b in batches], axis=0) for k in batches[0]}


@dataclasses.dataclass
class TrainState:
    """``params``: the model's trainable parameters by name (the live
    tensors); ``ema_params``: their moving average; ``opt_state``: the
    optimizer, which holds its own state (a checkpoint keeps its
    ``state_dict``); ``step``: updates taken; ``lr_scheduler``: the
    learning-rate schedule over ``opt_state``, or None (a checkpoint keeps
    its ``state_dict`` too)."""

    params: Dict[str, torch.Tensor]
    ema_params: Dict[str, torch.Tensor]
    opt_state: Any
    step: int
    lr_scheduler: Any = None


class Trainer:
    """fit / evaluate with EMA and best/last checkpoints.

    ``optimizer``: a callable that takes the parameter list and returns a
    ``torch.optim.Optimizer`` (default ``torch.optim.Adam`` at
    ``learning_rate``); ``lr_scheduler``: None, or a callable that takes the
    optimizer and returns a ``torch.optim.lr_scheduler`` stepped after each
    update (``train.optim.schedule_from_config``: optax's schedules, whose
    update t runs at ``schedule(t)``). ``profile_dir``: trace the steps
    ``[profile_steps[0], profile_steps[1])`` (counted from 0, as JAX's loop
    does) into it with ``torch.profiler``. ``ema_use_num_updates``: the EMA decay at update t
    is ``min(ema_decay, (1 + t) / (10 + t))``, so early averages follow the
    parameters instead of staying near their initial values. ``device``:
    None is the CUDA card; without one this raises unless ``device="cpu"``.
    """

    def __init__(
        self,
        model: Model,
        optimizer: Optional[Callable[[List[torch.Tensor]], torch.optim.Optimizer]] = None,
        learning_rate: float = 1e-3,
        loss: Optional[EnergyForceLoss] = None,
        metrics: Optional[EnergyForceMetrics] = None,
        ema_decay: float = 0.999,
        ema_use_num_updates: bool = True,
        log_every: int = 10,
        logger: Callable[[str], None] = print,
        device=None,
        lr_scheduler: Optional[Callable[[torch.optim.Optimizer], Any]] = None,
        profile_dir: Optional[str] = None,
        profile_steps: Tuple[int, int] = (5, 10),
    ):
        if isinstance(device, (list, tuple)):
            raise NotImplementedError(f"training on several devices is not ported yet ({_DDP})")
        if (torch.distributed.is_available() and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise NotImplementedError(f"data-parallel training is not ported yet ({_DDP})")
        self.device = resolve_device(device)
        self.model = model
        self.optimizer = optimizer or functools.partial(torch.optim.Adam, lr=learning_rate)
        self.loss = loss or EnergyForceLoss()
        self.metrics = metrics or EnergyForceMetrics()
        self.ema_decay = float(ema_decay)
        self.ema_use_num_updates = bool(ema_use_num_updates)
        self.log_every = log_every
        self.logger = logger
        self.lr_scheduler = lr_scheduler
        self.profile_dir = profile_dir
        self.profile_steps = tuple(profile_steps)
        self.history: List[Dict[str, float]] = []

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Moves the model to the device and starts a state from its
        parameters (first drawn anew from ``seed``, if given)."""
        if seed is not None:
            self.model.init(seed)
        self.model.to(self.device)
        params = self.model.parameters()
        opt = self.optimizer(list(params.values()))
        return TrainState(
            params=params,
            ema_params={k: v.detach().clone() for k, v in params.items()},
            opt_state=opt,
            step=0,
            lr_scheduler=None if self.lr_scheduler is None else self.lr_scheduler(opt),
        )

    def to_device(self, batch: Dict) -> Dict:
        """A loader batch (NumPy) with the model's statics, on the device."""
        return to_torch(self.model.precompute_statics(batch), dtype=self.model.model_dtype,
                        device=self.device)

    def loss_and_grads(self, state: TrainState, data: Dict):
        """(loss, loss terms, gradients by parameter name) on one batch,
        under the model's matrix-product policy (``Model.matmul_policy``)."""
        with self.model.matmul_policy():
            out = self.model.apply_with_derivatives(data, create_graph=True)
            loss, terms = self.loss(out, data)
            grads = torch.autograd.grad(loss, list(state.params.values()), allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in terms.items()}, dict(zip(state.params,
                                                                                grads))

    def train_step(self, state: TrainState, data: Dict):
        """One optimizer and EMA update on one device batch; returns (loss, terms)."""
        loss, terms, grads = self.loss_and_grads(state, data)
        for k, p in state.params.items():
            p.grad = grads[k]
        state.opt_state.step()
        if state.lr_scheduler is not None:
            state.lr_scheduler.step()
        # the decay and its complement in float32, as the JAX loop computes them
        decay = np.float32(self.ema_decay)
        if self.ema_use_num_updates:
            t = np.float32(state.step)
            decay = min(decay, (np.float32(1.0) + t) / (np.float32(10.0) + t))
        keep, take = float(decay), float(np.float32(1.0) - decay)
        with torch.no_grad():
            for k, p in state.params.items():
                state.ema_params[k].mul_(keep).add_(p, alpha=take)
        state.step += 1
        return loss, terms

    def fit(self, state: TrainState, train_loader, val_loader=None, max_epochs: int = 1,
            ckpt_dir: Optional[str] = None) -> TrainState:
        best = np.inf
        with contextlib.ExitStack() as trace:
            for epoch in range(max_epochs):
                t0 = time.time()
                losses = []
                for batch in train_loader:
                    data = self.to_device(batch)
                    if self.profile_dir and state.step == self.profile_steps[0]:
                        trace.enter_context(profile_trace(self.profile_dir))
                    loss, terms = self.train_step(state, data)
                    if self.profile_dir and state.step == self.profile_steps[1]:
                        trace.close()
                    losses.append(float(loss))
                    if state.step % self.log_every == 0:
                        self.logger(f"epoch {epoch} step {state.step} loss {float(loss):.6f} "
                                    + " ".join(f"{k}={float(v):.6f}" for k, v in terms.items()))
                rec = {"epoch": epoch, "train_loss": float(np.mean(losses)),
                       "time": time.time() - t0}
                if val_loader is not None:
                    val = self.evaluate(state.ema_params, val_loader)
                    rec.update({f"val_{k}": v for k, v in val.items()})
                    score = val.get("forces_mae", val.get("per_atom_energy_mae", np.inf))
                    if ckpt_dir is not None and score < best:
                        best = score
                        save_checkpoint(ckpt_dir, state, name="best")
                if ckpt_dir is not None:
                    save_checkpoint(ckpt_dir, state, name="last")
                self.history.append(rec)
                self.logger("  ".join(f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
                                      for k, v in rec.items()))
        return state

    def evaluate(self, params: Dict[str, torch.Tensor], loader) -> Dict[str, float]:
        """The metrics of the model with ``params`` (e.g. the EMA ones) over
        the loader, energies averaged over real frames and forces over real
        atoms; the model's own parameters are restored afterwards."""
        acc: Dict[str, float] = {}
        tot_frames = tot_nodes = 0.0
        with _loaded(self.model, params):
            for batch in loader:
                data = self.to_device(batch)
                m = self.metrics(self.model.apply_with_derivatives(data), data)
                nf = float(data[keys.FRAME_MASK].sum())
                nn = float(data[keys.NODE_MASK].sum())
                for k, v in m.items():
                    acc[k] = acc.get(k, 0.0) + float(v) * (nn if k.startswith("forces") else nf)
                tot_frames += nf
                tot_nodes += nn
        return {k: v / max(tot_nodes if k.startswith("forces") else tot_frames, 1.0)
                for k, v in acc.items()}


@contextlib.contextmanager
def _loaded(model: Model, params: Dict[str, torch.Tensor]):
    """The model's parameters set to ``params`` inside the block."""
    live = model.parameters()
    with torch.no_grad():
        saved = {k: p.detach().clone() for k, p in live.items()}
        for k, p in live.items():
            p.copy_(params[k])
    try:
        yield
    finally:
        with torch.no_grad():
            for k, p in live.items():
                p.copy_(saved[k])
