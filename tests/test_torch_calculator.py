"""The port's single-point calculator against the JAX package's, on the CPU.

A small periodic crystal in float64: energy, per-atom energies, forces and
stress at 1e-10 (the port on its ``einsum`` backend and on ``fused_infer``
with ``use_mega=False`` and with its default mega-fused layers, JAX on
``einsum``); the padded buckets only grow, and growing them does not
change the answer.
"""

import numpy as np
import jax
import pytest
import torch

from allegro_tpu.calculator import AllegroCalculator as JaxAllegroCalculator
from allegro_tpu.data import batch_frames as jax_batch_frames, to_jax
from allegro_tpu.data.neighborlist import neighbor_list as jax_neighbor_list
from allegro_tpu.model import AllegroModel as JaxAllegroModel

from allegro_tpu_torch.calculator import AllegroCalculator
from allegro_tpu_torch.data import keys
from allegro_tpu_torch.model import AllegroModel, params_from_jax

R_MAX = 3.0
MODEL_KW = dict(
    r_max=R_MAX, type_names=["H", "C", "O"], l_max=2, num_layers=2, num_scalar_features=16,
    num_tensor_features=4, avg_num_neighbors=10.0, per_type_energy_scales=[1.0, 0.5, 2.0],
    per_type_energy_shifts=[0.1, -0.2, 0.3], model_dtype="float64",
)
TOL = 1e-10


def _crystal(seed=0, side=(2, 2, 3), spacing=1.6):
    rng = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(*(np.arange(s) for s in side), indexing="ij"), -1).reshape(-1, 3)
    pos = grid * spacing + 0.1 * rng.randn(len(grid), 3)
    types = rng.randint(0, 3, len(grid)).astype(np.int32)
    return pos, types, np.diag(np.asarray(side, dtype=np.float64) * spacing), rng


@pytest.fixture(scope="module")
def jax_calc():
    pos, types, cell, _ = _crystal()
    jm = JaxAllegroModel(**MODEL_KW)
    fr = jax_neighbor_list({keys.POSITIONS: pos, keys.ATOM_TYPES: types, keys.CELL: cell,
                            keys.PBC: np.ones(3, bool)}, R_MAX)
    params = jm.init(0, to_jax(jax_batch_frames([fr], n_frames=1), dtype=np.float64))
    return JaxAllegroCalculator(jm, params, dtype=np.float64), params


def _port_calc(params, backend):
    """``"mega"`` is ``fused_infer`` with its default ``use_mega``."""
    if backend == "mega":
        m = AllegroModel(**MODEL_KW, tp_kernel_backend="fused_infer")
        assert m.module.allegro.mega
    else:
        extra = {"use_mega": False} if backend == "fused_infer" else {}
        m = AllegroModel(**MODEL_KW, tp_kernel_backend=backend, **extra)
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return AllegroCalculator(m, dtype=torch.float64, device="cpu")


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), f"{what}: max abs err {err:.3e}"


@pytest.mark.parametrize("backend", ["einsum", "fused_infer", "mega"])
def test_calculator_matches_jax(jax_calc, backend):
    jcalc, params = jax_calc
    calc = _port_calc(params, backend)
    pos, types, cell, rng = _crystal()
    for trial in range(2):
        p = pos + 0.02 * trial * rng.randn(*pos.shape)
        want = jcalc.calculate(p, atom_types=types, cell=cell, pbc=(True,) * 3)
        got = calc.calculate(p, atom_types=types, cell=cell, pbc=(True,) * 3)
        assert sorted(got) == sorted(want)
        for k in ("energy", "energies", "forces", "stress", "virial"):
            _close(got[k], want[k], f"{backend} call {trial} {k}")
    # atomic numbers through the species mapping; an open-boundary call
    z = np.array([1, 6, 8])[types]
    _close(calc.calculate(pos, atomic_numbers=z)["forces"],
           jcalc.calculate(pos, atomic_numbers=z)["forces"], f"{backend} open forces")


def test_buckets_are_sticky(jax_calc):
    _, params = jax_calc
    calc = _port_calc(params, "fused_infer")
    pos, types, cell, rng = _crystal()
    first = calc.calculate(pos, atom_types=types, cell=cell, pbc=(True,) * 3)
    pads = (calc.n_atoms_pad, calc.n_edges_pad)
    assert pads[0] > len(pos) and pads[1] % calc.edge_multiple == 0
    # a smaller system keeps the buckets
    small = calc.calculate(pos[:6], atom_types=types[:6])
    assert (calc.n_atoms_pad, calc.n_edges_pad) == pads and small["forces"].shape == (6, 3)
    # a bigger one grows them, and the first system's answer does not change
    big_pos, big_types, big_cell, _ = _crystal(seed=1, side=(3, 3, 3))
    calc.calculate(big_pos, atom_types=big_types, cell=big_cell, pbc=(True,) * 3)
    assert calc.n_atoms_pad > pads[0] and calc.n_edges_pad > pads[1]
    again = calc.calculate(pos, atom_types=types, cell=cell, pbc=(True,) * 3)
    for k in ("energy", "energies", "forces", "stress"):
        np.testing.assert_allclose(again[k], first[k], rtol=0, atol=1e-12)
