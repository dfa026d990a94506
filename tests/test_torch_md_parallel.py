"""The port's multi-device MD (``md.Simulation`` over a mesh) against the
JAX package's, on the CPU, float64.

The one-layer model and the 12x3x3 and 5³ lattices of
``tests/md/test_slab_md.py`` and ``test_brick_md.py``; the port on meshes of
``["cpu"] * D`` with its default ``fused_infer`` route (the kernels' plain
versions), JAX on its virtual host devices:

- ``edge_shard`` over 2 devices: the port cuts the edge list between
  centers, so its shards' energies add up exactly, and its trajectory is
  JAX's one-device trajectory; JAX's even cut, through a center's edges, is
  off (ROADMAP queue 3);
- ``slab`` (D = 4) and ``brick`` (2 x 2) with re-decompositions (atoms
  migrating between domains) against JAX's same strategy, 20 steps at 1e-9;
- the MD CLI's ``strategy`` and ``mesh_shape``: the devices they choose, and
  the brick and slab trajectories of ``python -m allegro_tpu_torch md``
  (float32) equal to its ``edge_shard`` one within float32 rounding.
"""

import numpy as np
import jax
import pytest
import torch

from allegro_tpu.md import MDState as JaxMDState, Simulation as JaxSimulation
from allegro_tpu.model import AllegroEnergyModel as JaxAllegroEnergyModel

from allegro_tpu_torch.data import keys
from allegro_tpu_torch.md import MDState, Simulation
from allegro_tpu_torch.md.cli import md_mesh, run_md
from allegro_tpu_torch.model import AllegroEnergyModel, params_from_jax
from torch_threads import one_thread  # noqa: F401

MODEL_KW = dict(
    r_max=1.6, type_names=["A", "B"], l_max=1, num_layers=1, num_scalar_features=8,
    num_tensor_features=4, scalar_embed_mlp_hidden_layers_width=8,
    allegro_mlp_hidden_layers_width=8, readout_mlp_hidden_layers_width=8,
    avg_num_neighbors=6.0, per_type_energy_scales=0.05, per_type_energy_shifts=[0.1, -0.3],
    model_dtype="float64",
)
# small skin, fast atoms: the domains are rebuilt within 20 steps
SIM_KW = dict(masses=np.ones(2), r_max=1.6, dt=4e-3, pbc=(True, True, True), skin=0.06,
              steps_per_block=5, edge_multiple=32)


def _system(seed, nx, n, a=1.4):
    rng = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(np.arange(nx), np.arange(n), np.arange(n), indexing="ij"), -1
                    ).reshape(-1, 3).astype(np.float64)
    pos = grid * a + 0.04 * rng.randn(len(grid), 3)
    types = rng.randint(0, 2, len(grid)).astype(np.int32)
    return pos, types, np.diag([nx * a, n * a, n * a]), rng.randn(len(grid), 3) * 0.5


@pytest.fixture(scope="module")
def models():
    jm = JaxAllegroEnergyModel(**MODEL_KW)
    pos, types, _, _ = _system(0, 2, 2)
    params = jm.init(0, {
        keys.POSITIONS: pos, keys.ATOM_TYPES: types,
        keys.EDGE_INDEX: np.zeros((2, 4), np.int32), keys.EDGE_CELL_SHIFT: np.zeros((4, 3)),
        keys.EDGE_MASK: np.zeros(4, bool),
    })
    m = AllegroEnergyModel(**MODEL_KW, tp_kernel_backend="fused_infer")
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, m


def _jax_run(models, types, cell, state, strategy, shape):
    jm, params, _ = models
    names = ("dp",) if strategy != "brick" else ("bx", "by", "bz")[: len(shape)]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape),
                             names)
    sim = JaxSimulation(jm, params, atom_types=types, cell=cell, mesh=mesh, dtype=np.float64,
                        strategy=strategy, **SIM_KW)
    return sim.run(JaxMDState(*state), 20), sim


def _port_run(models, types, cell, state, strategy, shape):
    sim = Simulation(models[2], atom_types=types, cell=cell, mesh=["cpu"] * int(np.prod(shape)),
                     dtype=torch.float64, strategy=strategy,
                     mesh_shape=shape if strategy == "brick" else None, **SIM_KW)
    return sim.run(MDState(*state), 20), sim


def test_edge_shard_over_two_devices_matches_jax(models):
    pos, types, cell, v0 = _system(0, 5, 5)
    want, jsim = _jax_run(models, types, cell, (pos.copy(), v0.copy()), "edge_shard", (1,))
    got, sim = _port_run(models, types, cell, (pos.copy(), v0.copy()), "edge_shard", (2,))
    assert sim.rebuilds == jsim.rebuilds >= 2
    # each shard holds whole centers: the cut is where a center's edges begin
    centers = sim._shards[0][keys.EDGE_INDEX][0]
    last = int(centers[sim._shards[0][keys.EDGE_MASK]].max())
    assert int(sim._shards[1][keys.EDGE_INDEX][0][0]) == last + 1
    np.testing.assert_allclose(got.positions, want.positions, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.velocities, want.velocities, rtol=0, atol=1e-9)


def test_an_even_cut_through_a_center_is_off(models, monkeypatch):
    """Why the port cuts between centers: JAX's even cut (``per_dev`` edges
    per shard, ``allegro_tpu/md/simulation.py:_rebuild``) lands inside a
    center's edges here, and each shard then sums only part of that atom's
    environment."""
    pos, types, cell, _ = _system(0, 5, 5)
    x = torch.as_tensor(pos)

    def forces(n_dev):
        # edge_multiple 1: the even cut falls at edge 375 of 750, inside a
        # center's edges
        sim = Simulation(models[2], atom_types=types, cell=cell, mesh=["cpu"] * n_dev,
                         dtype=torch.float64, **{**SIM_KW, "edge_multiple": 1})
        sim._rebuild(pos)
        return sim._energy_forces(x)[1]

    one, port = forces(1), forces(2)
    assert (port - one).abs().max() < 1e-12

    def even(self, centers):
        E, m = len(centers), self.edge_multiple
        cut = min(-(-(-(-E // 2)) // m) * m, E)
        assert centers[cut - 1] == centers[cut]  # inside a center's edges
        return np.array([0, cut, E])

    monkeypatch.setattr(Simulation, "_shard_cuts", even)
    assert (forces(2) - one).abs().max() > 1e-6


@pytest.mark.parametrize("strategy,shape,lattice", [
    ("slab", (4,), (12, 3)), ("brick", (2, 2), (5, 5)),
], ids=["slab4", "brick2x2"])
def test_decomposed_md_with_migration_matches_jax(models, strategy, shape, lattice):
    pos, types, cell, v0 = _system(1, *lattice)
    want, jsim = _jax_run(models, types, cell, (pos.copy(), v0.copy()), strategy, shape)
    got, sim = _port_run(models, types, cell, (pos.copy(), v0.copy()), strategy, shape)
    assert sim.rebuilds == jsim.rebuilds >= 2
    assert got.step == want.step == 20
    np.testing.assert_allclose(got.positions, want.positions, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.velocities, want.velocities, rtol=0, atol=1e-9)


def test_decomposed_md_refuses_a_thermostat(models):
    pos, types, cell, _ = _system(1, 12, 3)
    with pytest.raises(ValueError, match="NVE"):
        Simulation(models[2], atom_types=types, cell=cell, mesh=["cpu"] * 2, strategy="slab",
                   langevin_gamma=1.0, **SIM_KW)


def test_cli_mesh_follows_strategy_and_mesh_shape(monkeypatch):
    cpu = torch.device("cpu")
    assert md_mesh("edge_shard", None, cpu) == ([cpu], None)
    assert md_mesh("slab", None, cpu) == ([cpu], None)
    assert md_mesh("brick", None, cpu) == ([cpu], (1, 1, 1))
    assert md_mesh("brick", [2, 2, 1], cpu) == ([cpu] * 4, (2, 2, 1))
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr("allegro_tpu_torch.md.cli.visible_cards", lambda: cards)
    assert md_mesh("edge_shard", None, cards[0]) == ([cards[0]], None)
    assert md_mesh("slab", None, cards[0]) == (cards, None)
    assert md_mesh("brick", None, cards[0]) == (cards, (2, 1, 1))
    assert md_mesh("brick", [1, 2], cards[0]) == (cards, (1, 2))
    with pytest.raises(ValueError, match="needs 4 cards"):
        md_mesh("brick", [2, 2, 1], cards[0])


def test_cli_brick_and_slab_runs_match_edge_shard(tmp_path):
    cfg = {
        "model": {"_target_": "allegro_tpu.model.AllegroEnergyModel", "seed": 1,
                  "model_dtype": "float64", "r_max": 3.0, "type_names": ["A", "B"], "l_max": 1,
                  "num_layers": 1, "num_scalar_features": 8, "num_tensor_features": 4,
                  "avg_num_neighbors": 10.0, "tp_kernel_backend": "fused_infer"},
        "md": {"n_atoms": 64, "spacing": 2.2, "dt": 2e-3, "n_steps": 10, "steps_per_block": 5,
               "skin": 0.4, "v0": 0.05, "seed": 0},
    }
    runs = {}
    for name, extra in (("edge_shard", {}), ("slab", {"strategy": "slab"}),
                        ("brick", {"strategy": "brick", "mesh_shape": [2, 1, 1]})):
        c = {**cfg, "md": {**cfg["md"], **extra}}
        runs[name] = run_md(c, str(tmp_path / name), device="cpu")
    for name in ("slab", "brick"):
        assert runs[name].step == 10
        # the CLI's MD integrates in float32 (positions up to 8.8 A)
        np.testing.assert_allclose(runs[name].positions, runs["edge_shard"].positions, rtol=0,
                                   atol=1e-6, err_msg=name)
