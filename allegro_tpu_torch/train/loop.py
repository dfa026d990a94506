"""The training loop (twin of ``allegro_tpu/train/loop.py``).

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

Data parallelism (JAX's ``dp`` mesh axis) over a mesh of devices run by one
process: a step takes one loader batch per mesh entry (the last group of an
epoch filled with all-padding rows, ``_empty_like_batch``); the other
devices' model copies take the first device's parameters (one copy per
distinct device; rows on one device share it); each row's loss and its
gradient are computed on its device; the gradient is the mean over rows,
summed onto the first device in row order; one optimizer step and EMA
update run there. The loss and its terms are the rows' means, as JAX's
step computes them.

A bfloat16 model (``model_dtype="bfloat16"``) trains as JAX's does: its
parameters, gradients, EMA and optimizer state are bfloat16; the batch's
floats are float32 (JAX's, without x64), so the forces and the loss are
float32 and the energy bfloat16 (``EnergyForceLoss`` promotes); the
optimizer rounds where optax does (``optim.OptaxBf16``); the EMA is
computed in float32 and rounded once (``(decay * e + (1 - decay) *
p).astype(p.dtype)``); over a mesh the rows' gradients are summed in
float32, divided by the rows and rounded once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data import keys, to_torch
from ..device import replicate, resolve_mesh, visible_cards
from ..model.builders import Model
from ..utils.profiling import profile_trace
from .checkpoint import save_checkpoint
from .loss import EnergyForceLoss, EnergyForceMetrics
from .optim import optimizer as optax_optimizer


def shard_stack(batches: List[Dict]) -> Dict:
    """Stack per-device batches along a new leading device axis."""
    return {k: np.stack([np.asarray(b[k]) for b in batches], axis=0) for k in batches[0]}


def _empty_like_batch(batch: Dict) -> Dict:
    """An all-padding batch (fills the last device rows of an epoch)."""
    out = {}
    for k, v in batch.items():
        if k in (keys.NODE_MASK, keys.EDGE_MASK, keys.FRAME_MASK, keys.NUM_NODES):
            out[k] = np.zeros_like(v)
        else:
            out[k] = np.asarray(v)
    return out


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
    ``torch.optim.Optimizer`` (default optax's ``adam`` at ``learning_rate``,
    ``train.optim.optimizer``: ``torch.optim.Adam``, or ``OptaxBf16`` over
    bfloat16 parameters); ``lr_scheduler``: None, or a callable that takes the
    optimizer and returns a ``torch.optim.lr_scheduler`` stepped after each
    update (``train.optim.schedule_from_config``: optax's schedules, whose
    update t runs at ``schedule(t)``). ``profile_dir``: trace the steps
    ``[profile_steps[0], profile_steps[1])`` (counted from 0, as JAX's loop
    does) into it with ``torch.profiler``. ``ema_use_num_updates``: the EMA decay at update t
    is ``min(ema_decay, (1 + t) / (10 + t))``, so early averages follow the
    parameters instead of staying near their initial values.

    ``mesh``: the devices of the data-parallel rows, in order (an entry may
    repeat: ``["cpu"] * D`` on the CPU, ``[cuda:0] * D`` on one card);
    ``device``: one device. Both None: every visible CUDA card, as JAX's
    default mesh is every device (raises without a card unless
    ``device="cpu"``). A ``torch.distributed`` world of several processes
    raises: the port runs one process over a mesh, as JAX does.
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
        mesh: Optional[Sequence] = None,
    ):
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise NotImplementedError(
                f"a torch.distributed world of {dist.get_world_size()} processes: "
                "allegro_tpu_torch trains in one process over a mesh of devices, as JAX does "
                "(Trainer(mesh=[...]))"
            )
        if mesh is None and device is None:
            mesh = visible_cards()
        self.mesh = resolve_mesh(mesh, device)
        self.n_dev = len(self.mesh)
        self.device = self.mesh[0]
        self.model = model
        self._models = {self.device: model}  # one model per distinct device (init_state)
        self.optimizer = optimizer or optax_optimizer("adam", lr=learning_rate)
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
        """Moves the model to the first device of the mesh (a copy to each
        other distinct device) and starts a state from its parameters (first
        drawn anew from ``seed``, if given)."""
        if seed is not None:
            self.model.init(seed)
        self.model.to(self.device)
        self._models = replicate(self.model, self.mesh)
        params = self.model.parameters()
        opt = self.optimizer(list(params.values()))
        return TrainState(
            params=params,
            ema_params={k: v.detach().clone() for k, v in params.items()},
            opt_state=opt,
            step=0,
            lr_scheduler=None if self.lr_scheduler is None else self.lr_scheduler(opt),
        )

    def to_device(self, batch: Dict, device=None) -> Dict:
        """A loader batch (NumPy) with the model's statics, on ``device``
        (default: the first of the mesh), its floats in the model dtype
        (float32 for a bfloat16 model: JAX's data without x64)."""
        dtype = torch.promote_types(torch.float32, self.model.model_dtype)
        return to_torch(self.model.precompute_statics(batch), dtype=dtype,
                        device=self.device if device is None else device)

    def _device_batches(self, loader_iter) -> Iterable[List[Dict]]:
        """Groups of ``n_dev`` loader batches, one per mesh entry, each on
        its device; the last group is filled with all-padding rows."""
        group: List[Dict] = []
        for b in loader_iter:
            group.append(b)
            if len(group) == self.n_dev:
                yield [self.to_device(b, dev) for b, dev in zip(group, self.mesh)]
                group = []
        if group:
            filler = _empty_like_batch(group[0])
            group += [filler] * (self.n_dev - len(group))
            yield [self.to_device(b, dev) for b, dev in zip(group, self.mesh)]

    def _sync_replicas(self) -> None:
        """The first device's parameters copied to the other devices' models."""
        live = self.model.parameters()
        with torch.no_grad():
            for model in self._models.values():
                if model is not self.model:
                    for k, p in model.parameters().items():
                        p.copy_(live[k])

    def loss_and_grads(self, state: TrainState, data):
        """(loss, loss terms, gradients by parameter name) on one batch, or
        on a list of rows, one per mesh entry: each row's on its device,
        under the model's matrix-product policy (``Model.matmul_policy``);
        then the means over the rows, summed on the first device in row
        order (in float32 at least: a bfloat16 model's gradients are
        rounded once, after the division)."""
        rows = [data] if isinstance(data, dict) else list(data)
        if len(rows) != (1 if isinstance(data, dict) else self.n_dev):
            raise ValueError(f"{len(rows)} rows for a mesh of {self.n_dev} devices")
        self._sync_replicas()
        first = self.device
        total = terms = grads = None
        for row, device in zip(rows, self.mesh):
            model = self._models[device]
            params = state.params if model is self.model else model.parameters()
            with model.matmul_policy():
                out = model.apply_with_derivatives(row, create_graph=True)
                loss, t = self.loss(out, row)
                g = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                        materialize_grads=True)
            loss, t = loss.detach().to(first), {k: v.detach().to(first) for k, v in t.items()}
            g = [v.to(first, torch.promote_types(torch.float32, v.dtype)) for v in g]
            if grads is None:
                total, terms, grads = loss, t, g
            else:
                total = total + loss
                terms = {k: v + t[k] for k, v in terms.items()}
                grads = [a + b for a, b in zip(grads, g)]
        if len(rows) > 1:
            n = len(rows)
            total, terms = total / n, {k: v / n for k, v in terms.items()}
            grads = [g / n for g in grads]
        grads = [g.to(p.dtype) for g, p in zip(grads, state.params.values())]
        return total, terms, dict(zip(state.params, grads))

    def train_step(self, state: TrainState, data):
        """One optimizer and EMA update on one device batch, or on a list
        of rows, one per mesh entry; returns (loss, terms)."""
        loss, terms, grads = self.loss_and_grads(state, data)
        for k, p in state.params.items():
            p.grad = grads[k]
        state.opt_state.step()
        if state.lr_scheduler is not None:
            state.lr_scheduler.step()
        self.update_ema(state)
        state.step += 1
        return loss, terms

    def update_ema(self, state: TrainState) -> None:
        """The EMA of ``state.params`` after update ``state.step``; the decay
        and its complement in float32, as the JAX loop computes them."""
        decay = np.float32(self.ema_decay)
        if self.ema_use_num_updates:
            t = np.float32(state.step)
            decay = min(decay, (np.float32(1.0) + t) / (np.float32(10.0) + t))
        keep, take = float(decay), float(np.float32(1.0) - decay)
        with torch.no_grad():
            for k, p in state.params.items():
                ema = state.ema_params[k]
                if p.dtype == torch.bfloat16:
                    # JAX's (decay * e + (1 - decay) * p).astype(p.dtype): float32, rounded once
                    ema.copy_(ema.float() * keep + p.float() * take)
                else:
                    ema.mul_(keep).add_(p, alpha=take)

    def fit(self, state: TrainState, train_loader, val_loader=None, max_epochs: int = 1,
            ckpt_dir: Optional[str] = None) -> TrainState:
        best = np.inf
        with contextlib.ExitStack() as trace:
            for epoch in range(max_epochs):
                t0 = time.time()
                losses = []
                for rows in self._device_batches(iter(train_loader)):
                    if self.profile_dir and state.step == self.profile_steps[0]:
                        trace.enter_context(profile_trace(self.profile_dir))
                    loss, terms = self.train_step(state, rows)
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
        atoms (each row weighted by its real frames and atoms, the rows that
        fill the last group by none); the models' own parameters are
        restored afterwards."""
        acc: Dict[str, float] = {}
        tot_frames = tot_nodes = 0.0
        with contextlib.ExitStack() as loaded:
            for model in self._models.values():
                loaded.enter_context(_loaded(model, params))
            for rows in self._device_batches(iter(loader)):
                for data, device in zip(rows, self.mesh):
                    model = self._models[device]
                    m = self.metrics(model.apply_with_derivatives(data), data)
                    nf = float(data[keys.FRAME_MASK].sum())
                    nn = float(data[keys.NODE_MASK].sum())
                    for k, v in m.items():
                        acc[k] = acc.get(k, 0.0) + float(v) * (nn if k.startswith("forces")
                                                               else nf)
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
