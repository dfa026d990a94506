"""The port's command line, ZBL and dataset readers, on the CPU.

- ``python -m allegro_tpu_torch run`` (train → test) on the JAX CLI test's
  tiny config (``tests/train/test_cli.py:TINY_CFG``) with the ZBL block of
  ``configs/tutorial.yaml``, on ``--device cpu``: checkpoints and the
  resolved config written, the loss falls, finite test metrics that the
  ``test`` stage reproduces from the checkpoint.
- ``md`` on ``configs/md.yaml`` cut to 27 atoms, l_max 1 and 10 steps, on the
  ``pallas`` backend it ships with: ``md_log.json`` and a trajectory that
  reads back (with the port's reader and JAX's).
- The stages and options the port does not run (the ``compile`` and
  ``benchmark`` stages, optimizers, options and schedules it does not map,
  matrix-product precisions other than high and highest) raise ``NotImplementedError``
  naming their ROADMAP item; without a card the CLI raises unless
  ``--device cpu`` is given.
- ZBL against JAX's (energies, forces, virial at 1e-10, f64, with
  ``chemical_species`` names); ``sgdml_npz_dataset`` and extxyz write → read
  against JAX's readers, frame for frame.
"""

import contextlib
import copy
import importlib.util
import io
import json
import os
import re
from pathlib import Path

import numpy as np
import jax
import pytest
import torch
import yaml

from allegro_tpu.data import to_jax
from allegro_tpu.data.datasets import sgdml_npz_dataset as jax_sgdml_npz_dataset
from allegro_tpu.data.xyz import read_extxyz as jax_read_extxyz
from allegro_tpu.model import AllegroModel as JaxAllegroModel

from allegro_tpu_torch.cli import main
from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, sgdml_npz_dataset, to_torch
from allegro_tpu_torch.data.xyz import read_extxyz, write_extxyz
from allegro_tpu_torch.model import AllegroModel, params_from_jax
from torch_threads import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
ZBL = {"_target_": "allegro_tpu.nn.ZBLPairPotential", "chemical_species": "${data.type_names}"}


def _jax_tiny_cfg():
    spec = importlib.util.spec_from_file_location("_jax_cli_test", REPO / "tests/train/test_cli.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return copy.deepcopy(mod.TINY_CFG)


def _write(cfg, path):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _test_metrics(stdout):
    (line,) = [ln for ln in stdout.splitlines() if ln.startswith("test metrics: ")]
    return json.loads(line[len("test metrics: "):])


@pytest.fixture(scope="module")
def tutorial_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    cfg = _jax_tiny_cfg()
    cfg["model"]["pair_potential"] = dict(ZBL)
    cfg["trainer"]["max_epochs"] = 3
    path = _write(cfg, tmp / "tiny.yaml")
    workdir = str(tmp / "out")
    return path, workdir, _main(["run", "-c", path, "-w", workdir, "--device", "cpu"])


def test_cli_run_trains_and_checkpoints(tutorial_run):
    _, workdir, stdout = tutorial_run
    assert {"best.pt", "last.pt", "resolved_config.json"} <= set(os.listdir(workdir))
    with open(os.path.join(workdir, "resolved_config.json")) as f:
        resolved = json.load(f)
    assert resolved["model"]["pair_potential"]["chemical_species"] == ["C", "H", "O"]
    assert isinstance(resolved["model"]["avg_num_neighbors"], float)
    losses = [float(v) for v in re.findall(r"^epoch=\d+\s+train_loss=(\S+)", stdout, re.M)]
    assert len(losses) == 3 and np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert "samples/s" in stdout


def test_cli_test_stage_reloads_the_checkpoint(tutorial_run):
    path, workdir, stdout = tutorial_run
    metrics = _test_metrics(stdout)
    assert metrics and all(np.isfinite(v) for v in metrics.values())
    again = _test_metrics(_main(["test", "-c", path, "--ckpt", workdir, "--device", "cpu"]))
    assert again == pytest.approx(metrics, rel=1e-12, abs=0)


def test_cli_md_on_pallas(tmp_path):
    with open(REPO / "configs/md.yaml") as f:
        cfg = yaml.safe_load(f)
    assert cfg["model"]["tp_kernel_backend"] == "pallas"
    cfg["model"].update(l_max=1, num_scalar_features=8, num_tensor_features=4)
    cfg["md"].update(n_atoms=27, n_steps=10, steps_per_block=5, dump_trajectory=True)
    workdir = tmp_path / "md"
    stdout = _main(["md", "-c", _write(cfg, tmp_path / "md.yaml"), "-w", str(workdir),
                    "--device", "cpu"])
    assert "MD done: 10 steps of 27 atoms" in stdout
    with open(workdir / "md_log.json") as f:
        log = json.load(f)
    assert [r["step"] for r in log] == [5, 10]
    assert all(np.isfinite([r["e_pot"], r["e_kin"], r["e_tot"]]).all() for r in log)
    frames = read_extxyz(str(workdir / "trajectory.extxyz"))
    assert len(frames) == 2 and frames[-1][keys.POSITIONS].shape == (27, 3)
    assert np.isfinite(frames[-1][keys.POSITIONS]).all()
    want = jax_read_extxyz(str(workdir / "trajectory.extxyz"))
    for a, b in zip(frames, want):
        np.testing.assert_array_equal(a[keys.POSITIONS], np.asarray(b[keys.POSITIONS]))


@pytest.mark.parametrize("change", [
    # the compile stage exports every model the builder makes
    # (tests/test_torch_export_rest.py); the one it cannot build raises,
    # before any build
    {"run": ["compile"], "model": {"avg_num_neighbors": 5.0, "per_type_energy_shifts": 0.0,
                                   "per_type_energy_scales": 1.0,
                                   "model_dtype": "bfloat16"}},
    # the package stage runs (tests/test_torch_train_rest.py), but a run list
    # that holds it and an unported stage is refused before any stage runs
    {"run": ["train", "package", "benchmark"]},
    {"run": ["benchmark"]},
    # sgd runs; an optax option the port does not map raises
    {"trainer": {"optimizer": {"_target_": "optax.sgd", "learning_rate": 0.1,
                               "accumulator_dtype": "bfloat16"}}},
    # exponential_decay and cosine_decay_schedule run; other schedules raise
    {"trainer": {"lr_scheduler": {"_target_": "optax.warmup_cosine_decay_schedule"}}},
    # allow_tf32 and matmul_precision high/highest run; other precisions raise
    {"global_options": {"matmul_precision": "bfloat16"}},
], ids=["compile", "package", "benchmark", "sgd", "lr_scheduler", "allow_tf32"])
def test_cli_unported_stages_and_options_raise(tmp_path, change):
    cfg = _jax_tiny_cfg()
    for k, v in change.items():
        cfg[k] = {**cfg[k], **v} if isinstance(v, dict) and k in cfg else v
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _main(["run", "-c", _write(cfg, tmp_path / "c.yaml"), "-w", str(tmp_path / "out"),
               "--device", "cpu"])


def test_cli_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _write(_jax_tiny_cfg(), tmp_path / "c.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["run", "-c", path, "-w", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_zbl_matches_jax():
    rng = np.random.RandomState(3)
    frame = neighbor_list({keys.POSITIONS: rng.randn(10, 3) * 1.2,
                           keys.ATOM_TYPES: rng.randint(0, 3, 10).astype(np.int32),
                           keys.CELL: np.eye(3) * 6.0, keys.PBC: np.ones(3, bool)}, 2.2)
    batch = batch_frames([frame], n_frames=1)
    kw = dict(r_max=2.2, type_names=["H", "C", "O"], l_max=1, num_layers=1,
              num_scalar_features=8, num_tensor_features=4, avg_num_neighbors=3.0,
              per_type_energy_scales=1.0, per_type_energy_shifts=0.0, model_dtype="float64",
              pair_potential={**ZBL, "chemical_species": ["H", "C", "O"]})
    jm = JaxAllegroModel(**kw)
    jb = to_jax(batch, dtype=np.float64)
    params = jm.init(0, jb)
    want = jax.jit(jm.apply_with_derivatives)(params, jb)
    m = AllegroModel(**kw)
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    plain = AllegroModel(**{**kw, "pair_potential": None})
    plain.load_state_dict(m.state_dict())
    data = to_torch(m.precompute_statics(batch), torch.float64)
    out = m.apply_with_derivatives(data)
    for k in (keys.TOTAL_ENERGY, keys.PER_ATOM_ENERGY, keys.FORCES, keys.VIRIAL):
        want_k = np.asarray(want[k])
        scale = max(1.0, float(np.abs(want_k).max()))
        np.testing.assert_allclose(out[k].numpy(), want_k, rtol=0, atol=1e-10 * scale, err_msg=k)
    # repulsive and parameter-free: the same parameters, more energy
    assert sorted(m.state_dict()) == sorted(plain.state_dict())
    assert out[keys.TOTAL_ENERGY].item() > plain.apply_with_derivatives(data)[keys.TOTAL_ENERGY].item()


def _same_frames(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_sgdml_npz_dataset_matches_jax(tmp_path, monkeypatch):
    # the JAX package's scipy neighbor list, which the port's matches edge for edge
    monkeypatch.setenv("ALLEGRO_TPU_NATIVE", "0")
    rng = np.random.RandomState(0)
    path = str(tmp_path / "mol.npz")
    np.savez(path, R=rng.randn(5, 7, 3) * 1.5, z=np.array([6, 1, 1, 8, 6, 1, 1]),
             E=rng.randn(5), F=rng.randn(5, 7, 3))
    got = sgdml_npz_dataset(path, r_max=2.5, n_frames=3, offset=1)
    want = jax_sgdml_npz_dataset(path, r_max=2.5, n_frames=3, offset=1)
    assert got.type_names == want.type_names == ["H", "C", "O"]
    _same_frames(got.frames, want.frames)


def test_extxyz_write_read_matches_jax(tmp_path):
    rng = np.random.RandomState(1)
    frames = [{keys.POSITIONS: rng.randn(4, 3), keys.ATOMIC_NUMBERS: np.array([1, 6, 8, 1]),
               keys.FORCES: rng.randn(4, 3), keys.TOTAL_ENERGY: np.array([-3.25]),
               keys.CELL: np.eye(3) * 5.0, keys.PBC: np.array([True, True, False])},
              {keys.POSITIONS: rng.randn(3, 3), keys.ATOM_TYPES: np.array([0, 1, 1])}]
    path = str(tmp_path / "frames.extxyz")
    write_extxyz(path, frames, type_names=["A", "B"])
    got = read_extxyz(path)
    _same_frames(got, jax_read_extxyz(path))
    np.testing.assert_allclose(got[0][keys.POSITIONS], frames[0][keys.POSITIONS], rtol=1e-9)
    assert got[1]["_species"] == ["A", "B"] and len(read_extxyz(path, limit=1)) == 1
