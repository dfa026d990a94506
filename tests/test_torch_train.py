"""The port's training stack against the JAX package, on the CPU.

- The whole model on the trainable ``fused`` backend (the kernels' plain
  versions) against JAX ``einsum`` from the same weights (``params_from_jax``),
  float64: energy and forces at 1e-10, the force-loss parameter gradients
  (second order) at atol 1e-9 / rtol 1e-7: the port's twin of
  ``tests/model/test_fused_backend.py::test_training_grads_through_fused``.
- The port's ``Trainer`` on ``fused``, 3 Adam steps with EMA, against the
  JAX ``Trainer`` on ``einsum`` on a one-device mesh: losses, parameters and
  EMA parameters at 1e-9.
- ``DataLoader`` batches, ``synthetic_molecular_frames``,
  ``compute_statistics``, ``resolve`` and ``build_model`` against JAX's; the
  checkpoint round trip.
- ``Trainer``, ``AllegroCalculator`` and ``md.Simulation`` run on the card
  by default and raise without one unless ``device="cpu"`` is given.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from allegro_tpu.data import DataLoader as JaxDataLoader
from allegro_tpu.data import InMemoryDataset as JaxInMemoryDataset
from allegro_tpu.data import compute_statistics as jax_compute_statistics
from allegro_tpu.data import to_jax
from allegro_tpu.data.datasets import synthetic_molecular_frames as jax_synthetic_frames
from allegro_tpu.model import AllegroModel as JaxAllegroModel
from allegro_tpu.train import Trainer as JaxTrainer
from allegro_tpu.train.config import resolve as jax_resolve

from allegro_tpu_torch.calculator import AllegroCalculator
from allegro_tpu_torch.data import (
    DataLoader,
    InMemoryDataset,
    batch_frames,
    compute_statistics,
    keys,
    neighbor_list,
    synthetic_molecular_frames,
    to_torch,
)
from allegro_tpu_torch.md import Simulation
from allegro_tpu_torch.model import AllegroModel, params_from_jax
from allegro_tpu_torch.train import Trainer, load_checkpoint, save_checkpoint
from allegro_tpu_torch.train.config import build_model, resolve

R_MAX = 4.0


def _crystal(side, seed, spacing=2.2):
    rng = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(*(np.arange(s) for s in side), indexing="ij"), -1).reshape(-1, 3)
    n = grid.shape[0]
    return neighbor_list({
        keys.POSITIONS: grid * spacing + 0.1 * rng.randn(n, 3),
        keys.ATOM_TYPES: rng.randint(0, 3, n).astype(np.int32),
        keys.CELL: np.diag(np.asarray(side, dtype=np.float64) * spacing),
        keys.PBC: np.ones(3, dtype=bool),
    }, R_MAX)


def _model_kwargs(avg_n):
    return dict(
        r_max=R_MAX, type_names=["A", "B", "C"], l_max=2, parity=True, num_layers=2,
        num_scalar_features=16, num_tensor_features=4, avg_num_neighbors=avg_n,
        per_type_energy_scales=[1.0, 0.5, 2.0], per_type_energy_shifts=[0.1, -0.2, 0.3],
        model_dtype="float64",
    )


def _by_name(tree):
    """A JAX parameter (or gradient) tree as numpy arrays under the port's names."""
    return {k: v.numpy() for k, v in params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                          tree)).items()}


@pytest.fixture(scope="module")
def crystal_run():
    """JAX einsum outputs and force-loss gradients on a padded 2-frame batch."""
    frames = [_crystal((3, 3, 3), 0), _crystal((2, 2, 3), 1)]
    avg_n = sum(f[keys.EDGE_INDEX].shape[1] for f in frames) / sum(
        f[keys.POSITIONS].shape[0] for f in frames)
    batch = batch_frames(frames, n_frames=2)
    jm = JaxAllegroModel(**_model_kwargs(avg_n))
    jb = to_jax(batch, dtype=np.float64)
    params = jm.init(0, jb)

    def loss(p):
        out = jm.apply_with_derivatives(p, jb)
        return jnp.sum(out[keys.FORCES] ** 2) + out[keys.TOTAL_ENERGY].sum() ** 2

    out = jax.jit(jm.apply_with_derivatives)(params, jb)
    grads = jax.jit(jax.grad(loss))(params)
    want = {k: np.asarray(out[k]) for k in (keys.TOTAL_ENERGY, keys.FORCES)}
    return avg_n, batch, _by_name(params), want, _by_name(grads)


def test_fused_model_and_force_loss_gradients_match_jax_einsum(crystal_run):
    avg_n, batch, params, want, want_grads = crystal_run
    m = AllegroModel(**_model_kwargs(avg_n), tp_kernel_backend="fused")
    m.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    out = m.apply_with_derivatives(to_torch(m.precompute_statics(batch), torch.float64),
                                   create_graph=True)
    for k in (keys.TOTAL_ENERGY, keys.FORCES):
        np.testing.assert_allclose(out[k].detach().numpy(), want[k], rtol=0, atol=1e-10,
                                   err_msg=k)
    loss = (out[keys.FORCES] ** 2).sum() + out[keys.TOTAL_ENERGY].sum() ** 2
    ps = m.parameters()
    assert sorted(ps) == sorted(want_grads)
    for name, g in zip(ps, torch.autograd.grad(loss, list(ps.values()))):
        np.testing.assert_allclose(g.numpy(), want_grads[name], atol=1e-9, rtol=1e-7,
                                   err_msg=name)


def test_first_order_force_call_is_unchanged_on_fused(crystal_run):
    """Without create_graph the force call hands back plain values."""
    avg_n, batch, params, want, _ = crystal_run
    m = AllegroModel(**_model_kwargs(avg_n), tp_kernel_backend="fused")
    m.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    out = m.apply_with_derivatives(to_torch(m.precompute_statics(batch), torch.float64))
    assert not out[keys.FORCES].requires_grad and not out[keys.TOTAL_ENERGY].requires_grad
    np.testing.assert_allclose(out[keys.FORCES].numpy(), want[keys.FORCES], rtol=0, atol=1e-10)


def _train_setup(n_frames=6):
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


def test_trainer_on_fused_matches_jax_trainer_on_einsum():
    frames, ds, kw = _train_setup()
    jds = JaxInMemoryDataset(jax_synthetic_frames(6, n_atoms=8, spread=1.2), r_max=2.0)
    jax_loader = JaxDataLoader(jds, batch_size=2, shuffle=True, seed=0)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))
    jt = JaxTrainer(JaxAllegroModel(**kw), optimizer=optax.adam(5e-3), mesh=mesh,
                    logger=lambda s: None)
    # an example batch from a loader of its own: iterating jax_loader would
    # advance its shuffle
    jstate = jt.init_state(0, next(iter(JaxDataLoader(jds, batch_size=2))))
    m = AllegroModel(**kw, tp_kernel_backend="fused")
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params)))
    jstate = jt.fit(jstate, jax_loader, max_epochs=1)

    trainer = Trainer(m, learning_rate=5e-3, device="cpu", logger=lambda s: None)
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


def test_data_pipeline_matches_jax(monkeypatch):
    # the JAX package's scipy neighbor list, which the port's matches edge for
    # edge (its native one orders each center's neighbors otherwise)
    monkeypatch.setenv("ALLEGRO_TPU_NATIVE", "0")
    frames, ds, _ = _train_setup(n_frames=5)
    jframes = jax_synthetic_frames(5, n_atoms=8, spread=1.2)
    for a, b in zip(frames, jframes):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    jds = JaxInMemoryDataset(jframes, r_max=2.0)
    assert compute_statistics(ds) == jax_compute_statistics(jds)
    ours = DataLoader(ds, batch_size=2, shuffle=True, seed=3)
    theirs = JaxDataLoader(jds, batch_size=2, shuffle=True, seed=3)
    assert (ours.n_atoms, ours.n_edges, len(ours)) == (theirs.n_atoms, theirs.n_edges, len(theirs))
    for _ in range(2):  # two epochs: the shuffles advance alike
        for a, b in zip(ours, theirs):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_config_resolve_and_build_fused_model():
    _, ds, _ = _train_setup()
    stats = compute_statistics(ds)
    cfg = {
        "r_max": 2.0,
        "model": {
            "_target_": "allegro_tpu.model.AllegroModel", "seed": 1, "r_max": "${r_max}",
            "type_names": ["A", "B", "C"], "l_max": 1, "num_layers": 2,
            "num_scalar_features": 8, "num_tensor_features": 4,
            "avg_num_neighbors": "${training_data_stats:num_neighbors_mean}",
            "per_type_energy_shifts": "${training_data_stats:per_type_energy_shifts}",
            "tp_kernel_backend": "fused",
        },
    }
    resolved = resolve(cfg, stats)
    assert resolved == jax_resolve(cfg, stats)
    model = build_model(resolved["model"])
    assert model.builder_kwargs["tp_kernel_backend"] == "fused"
    assert model.config["avg_num_neighbors"] == stats["num_neighbors_mean"]
    with pytest.raises(ValueError, match="unknown model builder"):
        build_model({"_target_": "allegro_tpu.model.NoSuchModel"})


def test_checkpoint_round_trip(tmp_path):
    _, ds, kw = _train_setup(n_frames=4)
    trainer = Trainer(AllegroModel(**kw, tp_kernel_backend="fused"), device="cpu",
                      logger=lambda s: None)
    state = trainer.fit(trainer.init_state(0), DataLoader(ds, batch_size=2),
                        ckpt_dir=str(tmp_path))
    plain = load_checkpoint(str(tmp_path), "last")
    assert plain.step == state.step == 2
    fresh = Trainer(AllegroModel(**kw, tp_kernel_backend="fused"), device="cpu",
                    logger=lambda s: None)
    restored = load_checkpoint(str(tmp_path), "last", template=fresh.init_state(7))
    assert restored.step == 2
    for k, v in state.params.items():
        torch.testing.assert_close(restored.params[k], v, rtol=0, atol=0)
        torch.testing.assert_close(restored.ema_params[k], state.ema_params[k], rtol=0, atol=0)
        torch.testing.assert_close(plain.params[k], v.detach(), rtol=0, atol=0)
    want, got = state.opt_state.state_dict(), restored.opt_state.state_dict()
    for i, s in want["state"].items():
        for k, v in s.items():
            torch.testing.assert_close(got["state"][i][k], v, rtol=0, atol=0)
    save_checkpoint(str(tmp_path), restored, name="again")
    assert (tmp_path / "again.pt").exists()


@pytest.mark.parametrize("entry", ["Trainer", "AllegroCalculator", "Simulation"])
def test_entry_points_raise_without_cuda_unless_asked_for_the_cpu(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, kw = _train_setup(n_frames=2)
    model = AllegroModel(**kw, tp_kernel_backend="fused")
    make = {
        "Trainer": lambda **d: Trainer(model, **d),
        "AllegroCalculator": lambda **d: AllegroCalculator(model, **d),
        "Simulation": lambda **d: Simulation(model, np.zeros(4, np.int32), np.ones(3), 2.0, **d),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(device="cuda")
    assert make(device="cpu").device == torch.device("cpu")


def test_trainer_refuses_several_devices():
    _, _, kw = _train_setup(n_frames=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(AllegroModel(**kw), device=["cpu", "cpu"])
