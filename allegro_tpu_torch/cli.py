"""Command-line entry points (twin of ``allegro_tpu/cli.py``):

    python -m allegro_tpu_torch train -c configs/tutorial.yaml [-w workdir]
    python -m allegro_tpu_torch test  -c configs/tutorial.yaml --ckpt <dir>
    python -m allegro_tpu_torch run   -c configs/tutorial.yaml   # the config's `run:` list
    python -m allegro_tpu_torch md    -c configs/md.yaml

    python -m allegro_tpu_torch package -c configs/tutorial.yaml -w <dir> [-o model.atpkg]
    python -m allegro_tpu_torch compile -c configs/tutorial.yaml -w <dir> [-o model.pt2]

The JAX package's config files run as they are: ``_target_`` names under
``allegro_tpu.`` build the port's builders and datasets, ``optax.adam``,
``optax.adamw`` and ``optax.sgd`` are ``torch.optim`` optimizers and
``optax.exponential_decay`` / ``optax.cosine_decay_schedule`` learning-rate
schedules (``train/optim.py``), ``trainer.profile_dir`` traces training
steps with ``torch.profiler``, the ``package`` stage writes an ``.atpkg``
(``train/package.py``) and the ``compile`` stage an AOTInductor ``.pt2`` of
the force call (``compile/export.py``, with the config's ``compile:``
block). Everything runs on the CUDA card unless
``--device cpu`` is given; without a card the CLI raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np

from .model.builders import _not_ported

_NOT_PORTED = {
    "benchmark": "queue 1, item 4 (the port bench)",
}


def _build_data(cfg: Dict[str, Any], seed: int = 0):
    """(datasets, loaders) by split from the ``data`` block: ``_target_``
    ``synthetic``, ``sgdml_npz_dataset`` or ``extxyz_dataset``, split by a
    seeded permutation into train / val / test (fractions or counts)."""
    from .data import DataLoader, InMemoryDataset
    from .data.datasets import sgdml_npz_dataset, synthetic_molecular_frames

    dcfg = dict(cfg)
    target = dcfg.pop("_target_", "synthetic")
    r_max = float(dcfg.pop("r_max"))
    split = dcfg.pop("split", {"train": 0.8, "val": 0.1, "test": 0.1})
    batch_size = int(dcfg.pop("batch_size", 1))
    type_names = dcfg.pop("type_names", None)
    shuffle_seed = int(dcfg.pop("seed", seed))
    if target.endswith("sgdml_npz_dataset"):
        ds = sgdml_npz_dataset(dcfg.pop("path"), r_max=r_max, type_names=type_names)
    elif target.endswith("extxyz_dataset"):
        from .data.xyz import extxyz_dataset

        ds = extxyz_dataset(dcfg.pop("path"), r_max=r_max, type_names=type_names)
    elif target == "synthetic":
        frames = synthetic_molecular_frames(
            n_frames=int(dcfg.pop("n_frames", 64)),
            n_atoms=int(dcfg.pop("n_atoms", 21)),
            n_types=len(type_names) if type_names else 3,
            spread=float(dcfg.pop("spread", 1.8)),
            seed=shuffle_seed,
        )
        ds = InMemoryDataset(frames, r_max=r_max, type_names=type_names)
    else:
        raise ValueError(f"unknown dataset {target}")
    n = len(ds)
    idx = np.random.RandomState(shuffle_seed).permutation(n)
    parts, ofs = {}, 0
    for k in ("train", "val", "test"):
        if k in split:
            v = split[k]
            size = int(v * n) if isinstance(v, float) and v <= 1.0 else int(v)
            sub = InMemoryDataset([], r_max=ds.r_max, type_names=ds.type_names)
            sub.frames = [ds.frames[int(i)] for i in idx[ofs : ofs + size]]
            parts[k] = sub
            ofs += size
    loaders = {
        k: DataLoader(v, batch_size=batch_size, shuffle=(k == "train"), seed=shuffle_seed)
        for k, v in parts.items()
    }
    return parts, loaders


def _optimizer(tcfg: Dict[str, Any]) -> Dict[str, Any]:
    """``Trainer``'s ``optimizer`` and ``lr_scheduler`` for the trainer
    block (both popped from ``tcfg``): ``train/optim.py``'s mapping of the
    optax names."""
    from .train.optim import optimizer_from_config, schedule_from_config

    optimizer, lr = optimizer_from_config(tcfg.pop("optimizer", {"learning_rate": 1e-3}))
    sched_cfg = tcfg.pop("lr_scheduler", None)
    return {"optimizer": optimizer,
            "lr_scheduler": schedule_from_config(sched_cfg, lr) if sched_cfg else None}


def run_train(config: Dict[str, Any], workdir: str, device=None) -> str:
    """Train the ``model`` block on the ``data`` block with the ``trainer``
    block; checkpoints ``best.pt`` / ``last.pt`` and ``resolved_config.json``
    go into ``workdir``."""
    from .data import compute_statistics
    from .train import EnergyForceLoss, Trainer
    from .train.config import build_model, resolve

    os.makedirs(workdir, exist_ok=True)
    parts, loaders = _build_data(config["data"])
    stats = compute_statistics(parts["train"])
    print(f"dataset statistics: {json.dumps(stats)}")
    cfg = resolve(config, stats)
    model = build_model(cfg["model"])
    tcfg = dict(cfg.get("trainer", {}))
    trainer = Trainer(
        model,
        **_optimizer(tcfg),
        profile_dir=tcfg.pop("profile_dir", None),
        loss=EnergyForceLoss(tcfg.pop("loss_coeffs", None)),
        ema_decay=float(tcfg.pop("ema_decay", 0.999)),
        ema_use_num_updates=bool(tcfg.pop("ema_use_num_updates", True)),
        log_every=int(tcfg.pop("log_every", 10)),
        device=device,
    )
    state = trainer.init_state(int(cfg["model"].get("seed", 0)))
    t0 = time.perf_counter()
    state = trainer.fit(state, loaders["train"], val_loader=loaders.get("val"),
                        max_epochs=int(tcfg.pop("max_epochs", 5)), ckpt_dir=workdir)
    seconds = time.perf_counter() - t0
    with open(os.path.join(workdir, "resolved_config.json"), "w") as f:
        json.dump(cfg, f, indent=2, default=str)
    n_samples = state.step * loaders["train"].batch_size
    print(f"trained {state.step} steps in {seconds:.3f} s ({1e3 * seconds / max(state.step, 1):.3f} "
          f"ms/step, {n_samples / seconds:.2f} samples/s, validation and checkpoints included)")
    print(f"checkpoints written to {workdir}")
    return workdir


def run_test(config: Dict[str, Any], workdir: str, ckpt: Optional[str] = None,
             device=None) -> Dict[str, float]:
    """The test split's metrics with the EMA parameters of the ``best``
    checkpoint (``last`` if there is none) in ``ckpt`` or ``workdir``."""
    from .data import compute_statistics
    from .train import Trainer, load_checkpoint
    from .train.config import build_model, resolve

    parts, loaders = _build_data(config["data"])
    cfg = resolve(config, compute_statistics(parts["train"]))
    # the trainer block's optimizer, so that the checkpoint's state loads
    trainer = Trainer(build_model(cfg["model"]), device=device,
                      **_optimizer(dict(cfg.get("trainer", {}))))
    state = trainer.init_state(0)
    ckpt_dir = ckpt or workdir
    name = "best" if os.path.exists(os.path.join(ckpt_dir, "best.pt")) else "last"
    state = load_checkpoint(ckpt_dir, name, template=state)
    metrics = trainer.evaluate(state.ema_params, loaders["test"])
    print("test metrics: " + json.dumps(metrics))
    return metrics


def _global_options(gopt: Dict[str, Any]) -> Dict[str, Any]:
    """The model's matrix-product policy from the config's ``global_options``
    (JAX's process-wide precision, here the model kwargs each model call
    sets): ``matmul_precision`` high or highest → ``precision``;
    ``allow_tf32: false`` pins "highest" over any ``matmul_precision``, as
    JAX's CLI does; ``allow_tf32: true`` → the model's ``allow_tf32`` (TF32
    for the products outside the kernels), where JAX's CLI leaves its model
    at "highest" (a departure, ROADMAP queue 3). Other values are not ported
    and raise."""
    mp = gopt.get("matmul_precision")
    if mp not in (None, "high", "highest") or gopt.get("allow_tf32") not in (None, True, False):
        raise _not_ported(f"global_options {gopt}", "queue 1, item 6")
    if gopt.get("allow_tf32") is False:
        return {"precision": "highest"}
    policy = {"allow_tf32": True} if gopt.get("allow_tf32") else {}
    return {**policy, **({"precision": mp} if mp else {})}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="allegro_tpu_torch")
    p.add_argument("command",
                   choices=["train", "test", "run", "compile", "package", "md", "benchmark"])
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-w", "--workdir", default=None)
    p.add_argument("--ckpt", default=None)
    p.add_argument("-o", "--output", default=None,
                   help="the package stage's archive (default model.atpkg in the workdir) or "
                        "the compile stage's package (default model.pt2)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)

    from .device import resolve_device
    from .train.config import load_config

    device = resolve_device(args.device)
    config = load_config(args.config)
    policy = _global_options(config.get("global_options") or {})
    if policy and isinstance(config.get("model"), dict):
        # the model block's own kwargs win over the global defaults
        config["model"] = {**policy, **config["model"]}
    workdir = args.workdir or os.path.join(
        "outputs", os.path.splitext(os.path.basename(args.config))[0])
    stages = config.get("run", ["train", "test"]) if args.command == "run" else [args.command]
    for stage in stages:
        if stage in _NOT_PORTED:
            raise _not_ported(f"the {stage} stage", _NOT_PORTED[stage])
    for stage in stages:
        if stage == "train":
            run_train(config, workdir, device)
        elif stage == "test":
            run_test(config, workdir, ckpt=args.ckpt, device=device)
        elif stage == "package":
            from .train.package import run_package

            run_package(config, workdir, args.ckpt, args.output or "model.atpkg")
        elif stage == "compile":
            from .compile import compile_model

            compile_model(config, workdir, args.ckpt, args.output or "model.pt2", device)
        elif stage == "md":
            from .md.cli import run_md

            run_md(config, workdir, device)
        else:
            raise ValueError(f"unknown stage {stage}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
