"""The rest of single-device training against the JAX package, on the CPU:
optimizers, learning-rate schedules, model packages, profiling and the data
helpers.

- ``Trainer`` on ``fused`` (the kernels' plain versions) under
  ``optax.sgd`` with momentum 0.9, ``optax.adamw`` (optax's default weight
  decay 1e-4) and ``optax.adam`` on an ``optax.exponential_decay``
  schedule, each mapped by ``train.optim`` from its config block, against
  the JAX ``Trainer`` on ``einsum`` with the optax optimizer: 3 steps,
  losses, parameters and EMA parameters at 1e-9 (float64).
- The learning rate of the first 10 updates under ``exponential_decay``
  (with ``transition_begin``, ``staircase`` and ``end_value``) and
  ``cosine_decay_schedule`` against optax's schedule; other optimizers,
  options and schedules raise naming ROADMAP item 8.
- Packages: a round trip gives the same bits (parameters and a force call);
  a parameter set trained in JAX, carried over and packaged, is stored
  under the JAX pytree's flattened names and reloads to JAX's force call
  (1e-10); the CLI's ``package`` stage with ``-o`` writes the checkpoint's
  EMA parameters, after a ``train`` stage under sgd with momentum, an
  exponential decay and ``profile_dir``.
- ``profile_dir`` writes a ``torch.profiler`` trace of the steps asked for.
- ``num_nodes``, ``num_frames``, ``count_real_atoms`` and
  ``count_real_edges`` against JAX's.
"""

import contextlib
import copy
import importlib.util
import io
import json
import zipfile
from pathlib import Path

import numpy as np
import jax
import optax
import pytest
import torch
import yaml

from allegro_tpu.data import DataLoader as JaxDataLoader
from allegro_tpu.data import InMemoryDataset as JaxInMemoryDataset
from allegro_tpu.data import atomic_data as jax_atomic_data
from allegro_tpu.data import to_jax
from allegro_tpu.data.datasets import synthetic_molecular_frames as jax_synthetic_frames
from allegro_tpu.model import AllegroModel as JaxAllegroModel
from allegro_tpu.train import Trainer as JaxTrainer

from allegro_tpu_torch.cli import main
from allegro_tpu_torch.data import (
    DataLoader,
    InMemoryDataset,
    batch_frames,
    compute_statistics,
    count_real_atoms,
    count_real_edges,
    keys,
    num_frames,
    num_nodes,
    synthetic_molecular_frames,
    to_torch,
)
from allegro_tpu_torch.model import AllegroModel, params_from_jax
from allegro_tpu_torch.train import Trainer, load_checkpoint
from allegro_tpu_torch.train.optim import optimizer_from_config, schedule_from_config
from allegro_tpu_torch.train.package import (
    FORMAT,
    jax_param_names,
    load_package,
    save_package,
)
from torch_threads import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
LR = 5e-3
DECAY = {"_target_": "optax.exponential_decay", "transition_steps": 1, "decay_rate": 0.5}
TRAIN_CASES = {
    "sgd_momentum": ({"_target_": "optax.sgd", "learning_rate": LR, "momentum": 0.9}, None,
                     lambda: optax.sgd(LR, momentum=0.9)),
    "adamw": ({"_target_": "optax.adamw", "learning_rate": LR}, None,
              lambda: optax.adamw(LR)),
    "exponential_decay": ({"_target_": "optax.adam", "learning_rate": LR}, DECAY,
                          lambda: optax.adam(optax.exponential_decay(
                              LR, transition_steps=1, decay_rate=0.5))),
}


def _setup(n_frames=6):
    frames = synthetic_molecular_frames(n_frames, n_atoms=8, spread=1.2)
    ds = InMemoryDataset(frames, r_max=2.0)
    st = compute_statistics(ds)
    kw = dict(
        r_max=2.0, type_names=["A", "B", "C"], l_max=1, num_layers=2, num_scalar_features=16,
        num_tensor_features=4, scalar_embed_mlp_hidden_layers_width=16,
        allegro_mlp_hidden_layers_width=16, readout_mlp_hidden_layers_width=8,
        avg_num_neighbors=max(st["num_neighbors_mean"], 1.0),
        per_type_energy_scales=max(st.get("forces_rms", 1.0), 1e-3),
        per_type_energy_shifts=st["per_type_energy_shifts"], model_dtype="float64",
    )
    return frames, ds, kw


def _by_name(tree):
    return {k: v.numpy() for k, v in params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                          tree)).items()}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_trainer_matches_jax(case):
    opt_cfg, sched_cfg, jax_opt = TRAIN_CASES[case]
    _, ds, kw = _setup()
    jds = JaxInMemoryDataset(jax_synthetic_frames(6, n_atoms=8, spread=1.2), r_max=2.0)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))
    jt = JaxTrainer(JaxAllegroModel(**kw), optimizer=jax_opt(), mesh=mesh,
                    logger=lambda s: None)
    jstate = jt.init_state(0, next(iter(JaxDataLoader(jds, batch_size=2))))
    m = AllegroModel(**kw, tp_kernel_backend="fused")
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params)))
    jstate = jt.fit(jstate, JaxDataLoader(jds, batch_size=2, shuffle=True, seed=0),
                    max_epochs=1)

    optimizer, lr = optimizer_from_config(opt_cfg)
    trainer = Trainer(m, optimizer=optimizer, device="cpu", logger=lambda s: None,
                      lr_scheduler=schedule_from_config(sched_cfg, lr) if sched_cfg else None)
    state = trainer.fit(trainer.init_state(), DataLoader(ds, batch_size=2, shuffle=True, seed=0))
    assert state.step == jstate.step == 3
    np.testing.assert_allclose(trainer.history[0]["train_loss"], jt.history[0]["train_loss"],
                               rtol=1e-9, atol=1e-9)
    for got, want in ((state.params, _by_name(jstate.params)),
                      (state.ema_params, _by_name(jstate.ema_params))):
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            np.testing.assert_allclose(v.detach().numpy(), want[k], rtol=0, atol=1e-9,
                                       err_msg=k)
    if sched_cfg:
        assert state.opt_state.param_groups[0]["lr"] == pytest.approx(LR * 0.5**3, rel=1e-7)


SCHEDULES = {
    "exponential": {"_target_": "optax.exponential_decay", "transition_steps": 3,
                    "decay_rate": 0.7},
    "exponential_begin_staircase_end": {
        "_target_": "optax.exponential_decay", "transition_steps": 2, "decay_rate": 0.5,
        "transition_begin": 3, "staircase": True, "end_value": 2e-4},
    "exponential_growth_end": {"_target_": "optax.exponential_decay", "transition_steps": 2,
                               "decay_rate": 1.5, "end_value": 3e-3},
    "cosine": {"_target_": "optax.cosine_decay_schedule", "decay_steps": 6, "alpha": 0.1,
               "exponent": 2.0},
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lr_sequence_matches_optax(name):
    cfg = SCHEDULES[name]
    kw = {k: v for k, v in cfg.items() if k != "_target_"}
    want = getattr(optax, cfg["_target_"].split(".")[1])(init_value=1e-3, **kw)
    optimizer, lr = optimizer_from_config({"_target_": "optax.sgd", "learning_rate": 1e-3})
    p = torch.nn.Parameter(torch.zeros(2, dtype=torch.float64))
    opt = optimizer([p])
    sched = schedule_from_config(cfg, lr)(opt)
    got = []
    for _ in range(10):
        got.append(opt.param_groups[0]["lr"])  # the rate of this update
        p.grad = torch.ones_like(p)
        opt.step()
        sched.step()
    # optax's update count is int32: its exponential decay comes out float32
    # (the port computes it so too; pow may round differently in the last
    # float32 bit), its cosine in the default float type
    rtol = 2.4e-7 if "exponential" in name else 1e-12
    np.testing.assert_allclose(got, [float(want(jax.numpy.int32(t))) for t in range(10)],
                               rtol=rtol, atol=0)


@pytest.mark.parametrize("block", [
    {"optimizer": {"_target_": "optax.lamb", "learning_rate": 1e-3}},
    {"optimizer": {"_target_": "optax.sgd", "learning_rate": 1e-3,
                   "accumulator_dtype": "bfloat16"}},
    {"optimizer": {"_target_": "optax.adam", "learning_rate": 1e-3, "eps_root": 1e-8}},
    {"lr_scheduler": {"_target_": "optax.warmup_cosine_decay_schedule"}},
], ids=["lamb", "sgd_accumulator_dtype", "adam_eps_root", "warmup_cosine"])
def test_other_optimizers_and_schedules_raise(block):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 8"):
        if "optimizer" in block:
            optimizer_from_config(block["optimizer"])
        else:
            schedule_from_config(block["lr_scheduler"], 1e-3)


def test_optax_defaults_are_passed_explicitly():
    adamw, _ = optimizer_from_config({"_target_": "optax.adamw", "learning_rate": 1e-3})
    sgd, _ = optimizer_from_config({"_target_": "optax.sgd", "learning_rate": 1e-3})
    p = [torch.nn.Parameter(torch.zeros(1))]
    assert adamw(p).defaults["weight_decay"] == 1e-4
    assert sgd(p).defaults["momentum"] == 0.0 and sgd(p).defaults["weight_decay"] == 0.0


def _force_call(model, batch, dtype=torch.float64):
    return model.apply_with_derivatives(to_torch(model.precompute_statics(batch), dtype))


def test_package_round_trip_gives_the_same_bits(tmp_path):
    _, ds, kw = _setup(n_frames=2)
    cfg = {**kw, "tp_kernel_backend": "fused_infer"}
    m = AllegroModel(**cfg).init(3)
    path = save_package(str(tmp_path / "m.atpkg"), cfg, m, extra={"note": 1})
    with zipfile.ZipFile(path) as z:
        assert sorted(z.namelist()) == ["config.json", "meta.json", "params.npz"]
        meta = json.loads(z.read("meta.json"))
    assert meta["format"] == FORMAT and meta["extra"] == {"note": 1}
    back, params, meta2 = load_package(path)
    assert meta2 == meta and meta["n_params"] == len(m.state_dict())
    for k, v in m.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    batch = batch_frames(ds.frames, n_frames=2)
    a, b = _force_call(m, batch), _force_call(back, batch)
    for k in (keys.TOTAL_ENERGY, keys.FORCES):
        assert torch.equal(a[k], b[k]), k


def test_jax_trained_parameters_package_and_reload(tmp_path):
    _, _, kw = _setup()
    jds = JaxInMemoryDataset(jax_synthetic_frames(6, n_atoms=8, spread=1.2), r_max=2.0)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))
    jm = JaxAllegroModel(**kw)
    jt = JaxTrainer(jm, optimizer=optax.adam(LR), mesh=mesh, logger=lambda s: None)
    jstate = jt.init_state(0, next(iter(JaxDataLoader(jds, batch_size=2))))
    jstate = jt.fit(jstate, JaxDataLoader(jds, batch_size=2, shuffle=True, seed=0), max_epochs=1)
    trained = jax.tree_util.tree_map(np.asarray, jstate.ema_params)
    m = AllegroModel(**kw)
    m.load_state_dict(params_from_jax(trained))
    path = save_package(str(tmp_path / "jax.atpkg"), kw, m)
    with zipfile.ZipFile(path) as z:
        keys_npz = sorted(np.load(io.BytesIO(z.read("params.npz"))).files)
    flat = jax.tree_util.tree_flatten_with_path(trained)[0]
    assert keys_npz == sorted("/".join(p.key for p in path_) for path_, _ in flat)
    assert sorted(jax_param_names(m).values()) == keys_npz
    back, _, _ = load_package(path)
    batch = batch_frames([jds[0], jds[1]], n_frames=2)
    want = jm.apply_with_derivatives(trained, to_jax(batch, dtype=np.float64))
    got = _force_call(back, batch)
    for k in (keys.TOTAL_ENERGY, keys.FORCES):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-10, err_msg=k)


def _tiny_cfg():
    spec = importlib.util.spec_from_file_location("_jax_cli_test", REPO / "tests/train/test_cli.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return copy.deepcopy(mod.TINY_CFG)


def test_cli_package_stage_with_output(tmp_path):
    cfg = _tiny_cfg()
    cfg["run"] = ["train", "package"]
    cfg["trainer"]["optimizer"] = {"_target_": "optax.sgd", "learning_rate": 1e-2,
                                   "momentum": 0.9}
    cfg["trainer"]["lr_scheduler"] = {"_target_": "optax.exponential_decay",
                                      "transition_steps": 2, "decay_rate": 0.8}
    cfg["trainer"]["profile_dir"] = str(tmp_path / "trace")
    path = tmp_path / "c.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    workdir = tmp_path / "out"
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["run", "-c", str(path), "-w", str(workdir), "-o", "pkg/tiny.atpkg",
                     "--device", "cpu"]) == 0
    pkg = workdir / "pkg" / "tiny.atpkg"
    model, params, meta = load_package(str(pkg))
    assert meta["extra"] == {"from_checkpoint": True, "checkpoint": "best"}
    state = load_checkpoint(str(workdir), "best")
    for k, v in state.ema_params.items():
        assert torch.equal(params[k], v), k
    # 4 steps in the one epoch: steps [5, 10) are not reached, so no trace
    assert not (tmp_path / "trace").exists()
    assert state.step == 4 and state.lr_scheduler["last_epoch"] == 4


def test_profile_dir_writes_a_trace(tmp_path):
    _, ds, kw = _setup(n_frames=6)
    trainer = Trainer(AllegroModel(**kw, tp_kernel_backend="fused"), device="cpu",
                      logger=lambda s: None, profile_dir=str(tmp_path / "prof"),
                      profile_steps=(1, 3))
    state = trainer.fit(trainer.init_state(0), DataLoader(ds, batch_size=2))
    assert state.step == 3
    (trace,) = list((tmp_path / "prof").glob("trace_*.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_data_helpers_match_jax():
    frames = [f for f in jax_synthetic_frames(3, n_atoms=7, spread=1.2)]
    ds = InMemoryDataset(frames, r_max=2.0)
    batch = batch_frames(list(ds.frames), n_frames=4)
    for data in (batch, to_torch(batch, torch.float64)):
        assert num_nodes(data) == jax_atomic_data.num_nodes(batch) == batch[
            keys.POSITIONS].shape[0]
        assert num_frames(data) == jax_atomic_data.num_frames(batch) == 4
        assert count_real_atoms(data) == jax_atomic_data.count_real_atoms(batch) == 21
        assert count_real_edges(data) == jax_atomic_data.count_real_edges(batch) == sum(
            f[keys.EDGE_INDEX].shape[1] for f in ds.frames)
    bare = {keys.POSITIONS: np.zeros((5, 3)), keys.EDGE_INDEX: np.zeros((2, 9), np.int32)}
    assert (num_nodes(bare), num_frames(bare), count_real_atoms(bare), count_real_edges(bare)) \
        == (jax_atomic_data.num_nodes(bare), jax_atomic_data.num_frames(bare),
            jax_atomic_data.count_real_atoms(bare), jax_atomic_data.count_real_edges(bare))
