"""The port's data-parallel ``Trainer`` (a mesh of devices run by one
process) and ``RankedLogger`` against the JAX package's, on the CPU.

- ``Trainer(mesh=["cpu", "cpu"])`` with SGD on 3 frames at batch 1 (so the
  epoch's last group is filled with an all-padding row) against JAX's
  Trainer on a 2-device ``dp`` mesh: losses, parameters and EMA parameters
  within 1e-10 after one epoch, and ``evaluate`` on the same loader;
- rows on one device share one model, and a step's gradient is the mean of
  the rows' gradients summed in row order, to the bits;
- a ``torch.distributed`` world of several processes raises;
- ``RankedLogger`` is silent away from rank 0.
"""

import logging

import numpy as np
import jax
import optax
import pytest
import torch

from allegro_tpu.data import DataLoader as JaxDataLoader
from allegro_tpu.data import InMemoryDataset as JaxInMemoryDataset
from allegro_tpu.data.datasets import synthetic_molecular_frames as jax_synthetic_frames
from allegro_tpu.model import AllegroModel as JaxAllegroModel
from allegro_tpu.train import Trainer as JaxTrainer
from allegro_tpu.utils import RankedLogger as JaxRankedLogger

from allegro_tpu_torch.data import (DataLoader, InMemoryDataset, compute_statistics,
                                    synthetic_molecular_frames)
from allegro_tpu_torch.model import AllegroModel, params_from_jax
from allegro_tpu_torch.train import Trainer
from allegro_tpu_torch.train.optim import optimizer_from_config
from allegro_tpu_torch.utils import RankedLogger
from torch_threads import one_thread  # noqa: F401

LR = 0.05
N_FRAMES = 3


def _setup():
    ds = InMemoryDataset(synthetic_molecular_frames(N_FRAMES, n_atoms=8, spread=1.2), r_max=2.0)
    st = compute_statistics(ds)
    kw = dict(
        r_max=2.0, type_names=["A", "B", "C"], l_max=1, num_layers=2, num_scalar_features=16,
        num_tensor_features=4, scalar_embed_mlp_hidden_layers_width=16,
        allegro_mlp_hidden_layers_width=16, readout_mlp_hidden_layers_width=8,
        avg_num_neighbors=max(st["num_neighbors_mean"], 1.0),
        per_type_energy_scales=max(st.get("forces_rms", 1.0), 1e-3),
        per_type_energy_shifts=st["per_type_energy_shifts"], model_dtype="float64",
    )
    return ds, kw


def _by_name(tree):
    return {k: v.numpy() for k, v in params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                          tree)).items()}


@pytest.fixture(scope="module")
def trained():
    """One epoch of SGD on both sides, from the same initial parameters."""
    ds, kw = _setup()
    jds = JaxInMemoryDataset(jax_synthetic_frames(N_FRAMES, n_atoms=8, spread=1.2), r_max=2.0)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("dp",))
    jt = JaxTrainer(JaxAllegroModel(**kw), optimizer=optax.sgd(LR), mesh=mesh,
                    logger=lambda s: None)
    jstate = jt.init_state(0, next(iter(JaxDataLoader(jds, batch_size=1))))
    m = AllegroModel(**kw, tp_kernel_backend="fused")
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params)))
    jstate = jt.fit(jstate, JaxDataLoader(jds, batch_size=1), max_epochs=1)

    optimizer, _ = optimizer_from_config({"_target_": "optax.sgd", "learning_rate": LR})
    trainer = Trainer(m, optimizer=optimizer, mesh=["cpu", "cpu"], logger=lambda s: None)
    state = trainer.fit(trainer.init_state(), DataLoader(ds, batch_size=1))
    return (jt, jstate, jds), (trainer, state, ds)


def test_two_device_trainer_matches_jax(trained):
    (jt, jstate, _), (trainer, state, _) = trained
    assert trainer.n_dev == 2 and list(trainer._models) == [torch.device("cpu")]
    assert state.step == jstate.step == 2  # 3 frames on 2 rows: the last group filled
    np.testing.assert_allclose(trainer.history[0]["train_loss"], jt.history[0]["train_loss"],
                               rtol=1e-10, atol=1e-10)
    for got, want in ((state.params, _by_name(jstate.params)),
                      (state.ema_params, _by_name(jstate.ema_params))):
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            np.testing.assert_allclose(v.detach().numpy(), want[k], rtol=0, atol=1e-10,
                                       err_msg=k)


def test_evaluate_matches_jax(trained):
    (jt, jstate, jds), (trainer, state, ds) = trained
    want = jt.evaluate(jstate.ema_params, JaxDataLoader(jds, batch_size=1))
    got = trainer.evaluate(state.ema_params, DataLoader(ds, batch_size=1))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v == pytest.approx(want[k], rel=1e-10, abs=1e-12), k


def test_mean_gradient_is_the_rows_mean_in_row_order():
    ds, kw = _setup()
    one = Trainer(AllegroModel(**kw, tp_kernel_backend="fused"), device="cpu",
                  logger=lambda s: None)
    state = one.init_state(0)
    three = Trainer(AllegroModel(**kw, tp_kernel_backend="fused"), mesh=["cpu"] * 3,
                    logger=lambda s: None)
    state3 = three.init_state(0)
    rows = [one.to_device(b) for b in DataLoader(ds, batch_size=1)]
    singles = [one.loss_and_grads(state, r) for r in rows]
    loss, _, grads = three.loss_and_grads(state3, rows)
    assert float(loss) == float((singles[0][0] + singles[1][0] + singles[2][0]) / 3)
    for k, g in grads.items():
        want = (singles[0][2][k] + singles[1][2][k] + singles[2][2][k]) / 3
        assert torch.equal(g, want), k
    with pytest.raises(ValueError, match="2 rows for a mesh of 3"):
        three.loss_and_grads(state3, rows[:2])


def test_mesh_and_device_arguments():
    _, kw = _setup()
    with pytest.raises(ValueError, match="a mesh or a device"):
        Trainer(AllegroModel(**kw), mesh=["cpu"], device="cpu")
    assert Trainer(AllegroModel(**kw), device="cpu").mesh == [torch.device("cpu")]


def test_a_world_of_several_processes_raises(monkeypatch):
    _, kw = _setup()
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    with pytest.raises(NotImplementedError, match="one process over a mesh"):
        Trainer(AllegroModel(**kw), device="cpu")


def test_ranked_logger_logs_on_rank_zero_only(monkeypatch, caplog):
    caplog.set_level(logging.INFO)
    for cls, name in ((RankedLogger, "allegro_tpu_torch"), (JaxRankedLogger, "allegro_tpu")):
        caplog.clear()
        cls(name).info("on rank 0")
        assert [r.message for r in caplog.records] == ["on rank 0"]
    monkeypatch.setattr("allegro_tpu_torch.utils.logging.process_rank", lambda: 1)
    caplog.clear()
    RankedLogger().warning("on rank 1")
    RankedLogger(rank_zero_only=False).warning("every rank")
    assert [r.message for r in caplog.records] == ["every rank"]
    with pytest.raises(AttributeError):
        RankedLogger().trace
