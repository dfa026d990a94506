"""The port's MD engine against the JAX package's, on the CPU.

The 27-atom periodic box of ``tests/md/test_simulation.py``: the port's
``Simulation`` (float64, on its ``einsum`` backend and on ``fused_infer``
with ``use_mega=False`` and with its default mega-fused layers; the
one-layer model runs kernels 7-10 there, without the split output)
against JAX's ``Simulation`` on the ``einsum`` backend with the same
parameters, positions and velocities, through neighbor rebuilds; NVE energy
conservation and the Langevin equipartition band to the JAX tests' bounds;
the multi-device strategies raise.
"""

import numpy as np
import jax
import pytest
import torch

from allegro_tpu.md import MDState as JaxMDState, Simulation as JaxSimulation
from allegro_tpu.model import AllegroEnergyModel as JaxAllegroEnergyModel

from allegro_tpu_torch.data import keys
from allegro_tpu_torch.md import MDState, Simulation, kinetic_energy
from allegro_tpu_torch.model import AllegroEnergyModel, params_from_jax
from allegro_tpu_torch.ops import fused_tp

N_TYPES = 2
MODEL_KW = dict(
    r_max=2.0, type_names=["A", "B"], l_max=1, num_layers=1, num_scalar_features=8,
    num_tensor_features=4, scalar_embed_mlp_hidden_layers_width=8,
    allegro_mlp_hidden_layers_width=8, readout_mlp_hidden_layers_width=8,
    avg_num_neighbors=6.0, per_type_energy_scales=0.05, per_type_energy_shifts=[0.1, -0.3],
    model_dtype="float64",
)
SIM_KW = dict(masses=np.ones(N_TYPES), r_max=2.0, dt=2e-3, pbc=(True, True, True), skin=0.4,
              steps_per_block=10, edge_multiple=32)


def _system(seed=0, n=27, spacing=1.5):
    rng = np.random.RandomState(seed)
    side = round(n ** (1 / 3))
    grid = np.stack(np.meshgrid(*(np.arange(side),) * 3, indexing="ij"), -1).reshape(-1, 3)
    pos = grid * spacing + 0.05 * rng.randn(len(grid), 3)
    types = rng.randint(0, N_TYPES, len(grid)).astype(np.int32)
    return pos, types, np.eye(3) * side * spacing, rng


@pytest.fixture(scope="module")
def jax_params():
    pos, types, _, _ = _system()
    jm = JaxAllegroEnergyModel(**MODEL_KW)
    data = {
        keys.POSITIONS: pos, keys.ATOM_TYPES: types,
        keys.EDGE_INDEX: np.zeros((2, 4), np.int32), keys.EDGE_CELL_SHIFT: np.zeros((4, 3)),
        keys.EDGE_MASK: np.zeros(4, bool),
    }
    return jm, jm.init(0, data)


def _port_model(jax_params, backend):
    """``"mega"`` is ``fused_infer`` with its default ``use_mega``."""
    if backend == "mega":
        m = AllegroEnergyModel(**MODEL_KW, tp_kernel_backend="fused_infer")
        assert m.module.allegro.mega
    else:
        extra = {"use_mega": False} if backend == "fused_infer" else {}
        m = AllegroEnergyModel(**MODEL_KW, tp_kernel_backend=backend, **extra)
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params[1])))
    return m


def _port_sim(model, types, cell, **kw):
    return Simulation(model, atom_types=types, cell=cell, dtype=torch.float64, device="cpu",
                      **{**SIM_KW, **kw})


@pytest.mark.parametrize("backend", ["einsum", "fused_infer", "mega"])
def test_trajectory_matches_jax_through_rebuilds(jax_params, backend):
    pos, types, cell, rng = _system()
    v0 = rng.randn(len(pos), 3) * 0.4
    # a small skin and fast atoms: the neighbor list is rebuilt within 20 steps
    kw = dict(skin=0.05, steps_per_block=5, dt=4e-3)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))
    jsim = JaxSimulation(jax_params[0], jax_params[1], atom_types=types, cell=cell, mesh=mesh,
                         dtype=np.float64, **{**SIM_KW, **kw})
    want = jsim.run(JaxMDState(pos.copy(), v0.copy()), 20)
    sim = _port_sim(_port_model(jax_params, backend), types, cell, **kw)
    fused_tp.reset_launch_counts()
    got = sim.run(MDState(pos.copy(), v0.copy()), 20)
    assert sim.rebuilds >= 2 and sim.rebuilds == jsim.rebuilds
    assert got.step == want.step == 20
    np.testing.assert_allclose(got.positions, want.positions, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.velocities, want.velocities, rtol=0, atol=1e-8)
    assert fused_tp.LAUNCHES == {k: 0 for k in fused_tp.LAUNCHES}


def test_nve_energy_conservation(jax_params):
    pos, types, cell, rng = _system()
    sim = _port_sim(_port_model(jax_params, "fused_infer"), types, cell)
    v0 = rng.randn(len(pos), 3) * 0.05
    energies = []
    sim.run(MDState(pos, v0), 100, callback=lambda s, e: energies.append(
        e + kinetic_energy(s.velocities, sim.masses_per_atom)))
    e = np.asarray(energies)
    assert len(e) == 10
    assert np.abs(e - e[0]).max() < 5e-5 * max(abs(e[0]), 1.0), (e[0], e[-1])
    assert sim.rebuilds >= 1


def test_langevin_heats_system(jax_params):
    pos, types, cell, _ = _system()
    sim = _port_sim(_port_model(jax_params, "fused_infer"), types, cell, langevin_gamma=2.0,
                    langevin_kT=0.5, dt=1e-3)
    st = sim.run(MDState(pos, np.zeros_like(pos)), 200)
    ke = kinetic_energy(st.velocities, sim.masses_per_atom)
    # equipartition: KE ≈ 1.5 N kT = 1.5*27*0.5 ≈ 20; loose band
    assert 5.0 < ke < 60.0, ke


@pytest.mark.parametrize("kw", [
    {"strategy": "slab"}, {"strategy": "brick"},
    {"mesh": [torch.device("cpu"), torch.device("cpu")]},
], ids=["slab", "brick", "mesh2"])
def test_multi_device_strategies_raise(jax_params, kw):
    pos, types, cell, _ = _system()
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 11"):
        _port_sim(_port_model(jax_params, "einsum"), types, cell, **kw)
