"""Per-edge-type cutoffs and the native neighbor list against the JAX
package, on the CPU.

- The model at JAX's ``MODEL_GRID`` per-edge-type row
  (``tests/model/test_allegro_model.py``: ``{"A": 2.0, "B": {"A": 1.5, "B":
  2.2, "C": 2.4}}`` at r_max 2.5) on the port's ``einsum`` and
  ``fused_infer`` (mega and not; the kernels' plain versions here) against
  JAX ``einsum`` from the same weights: energy, per-atom energies and forces
  at 1e-10 in float64 and 5e-5 in float32, on the full r_max list and on the
  list filtered per type pair.
- ``neighbor_list`` with the per-type filter against JAX's, edge for edge,
  on both lists (native and scipy).
- The port's C++ cell list against its scipy list on the cases of JAX's
  ``tests/data/test_native_neighborlist.py`` (open, periodic cubic,
  triclinic, mixed pbc, a tiny cell, unwrapped positions) and a crystal:
  the same edges with the same integer shifts, sorted.
- ``md.Simulation`` with a per-type matrix against JAX's on the CPU: the
  same rebuilds, positions and velocities at 1e-8.
- An edge beyond its pair's cutoff but within the skin adds exactly 0: its
  edge energy and its energy gradient are exact zeros.
"""

import numpy as np
import jax
import pytest
import torch

from allegro_tpu.data import batch_frames as jax_batch_frames, to_jax
from allegro_tpu.data import neighborlist as jax_nl
from allegro_tpu.md import MDState as JaxMDState, Simulation as JaxSimulation
from allegro_tpu.model import AllegroModel as JaxAllegroModel

from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
from allegro_tpu_torch.data import neighborlist as port_nl
from allegro_tpu_torch.md import MDState, Simulation
from allegro_tpu_torch.model import AllegroModel, params_from_jax
from allegro_tpu_torch.model.builders import _per_edge_type_cutoff_matrix
from allegro_tpu_torch.native import native_available, native_neighbor_list
from torch_threads import one_thread  # noqa: F401

R_MAX = 2.5
TYPES = ["A", "B", "C"]
PER_TYPE = {"A": 2.0, "B": {"A": 1.5, "B": 2.2, "C": 2.4}}
MATRIX = _per_edge_type_cutoff_matrix(PER_TYPE, TYPES, R_MAX)
TOL = {"float64": 1e-10, "float32": 5e-5}


def _kwargs(dtype="float64", **over):
    """JAX's ``tests/model/test_allegro_model.py:_model`` kwargs."""
    kw = dict(r_max=R_MAX, type_names=TYPES, l_max=2, parity=True, num_layers=2,
              num_scalar_features=16, num_tensor_features=4,
              scalar_embed_mlp_hidden_layers_width=16, allegro_mlp_hidden_layers_width=16,
              readout_mlp_hidden_layers_width=16, avg_num_neighbors=6.0,
              per_type_energy_scales=1.3, per_type_energy_shifts=[0.1, -0.2, 0.3],
              model_dtype=dtype, per_edge_type_cutoff=PER_TYPE)
    kw.update(over)
    return kw


def _frame(seed=42, n_atoms=10, spread=1.6):
    rng = np.random.RandomState(seed)
    return {keys.POSITIONS: rng.randn(n_atoms, 3) * spread,
            keys.ATOM_TYPES: rng.randint(0, 3, n_atoms).astype(np.int32)}


def _crystal(side=(3, 3, 3), seed=0, spacing=1.4):
    rng = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(*(np.arange(s) for s in side), indexing="ij"), -1).reshape(-1, 3)
    n = grid.shape[0]
    return {keys.POSITIONS: grid * spacing + 0.1 * rng.randn(n, 3),
            keys.ATOM_TYPES: rng.randint(0, 3, n).astype(np.int32),
            keys.CELL: np.diag(np.asarray(side, dtype=np.float64) * spacing),
            keys.PBC: np.ones(3, dtype=bool)}


def test_cutoff_matrix_matches_jax():
    from allegro_tpu.model.builders import _per_edge_type_cutoff_matrix as jax_matrix

    np.testing.assert_array_equal(MATRIX, jax_matrix(PER_TYPE, TYPES, R_MAX))
    assert MATRIX[1, 0] == 1.5 and MATRIX[0, 2] == 2.0 and MATRIX[2, 1] == R_MAX
    m = AllegroModel(**_kwargs())
    np.testing.assert_array_equal(m.module.edge_norm.flat_cutoffs.numpy(), MATRIX.reshape(-1))
    assert not any("cutoff" in k for k in m.state_dict())


@pytest.mark.parametrize("filtered", [False, True], ids=["r_max_list", "per_type_list"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("backend", ["einsum", "fused_infer", "mega"])
def test_per_type_model_matches_jax(backend, dtype, filtered):
    frame = _frame()
    cut = MATRIX if filtered else None
    jm = JaxAllegroModel(**_kwargs(dtype))
    jb = to_jax(jax_batch_frames([jax_nl.neighbor_list(frame, R_MAX, cut)], n_frames=1),
                dtype=np.dtype(dtype))
    params = jm.init(0, jb)
    want = jm.apply_with_derivatives(params, jb)
    extra = {"use_mega": False} if backend == "fused_infer" else {}
    m = AllegroModel(**_kwargs(dtype), tp_kernel_backend="einsum" if backend == "einsum"
                     else "fused_infer", **extra)
    assert m.module.allegro.mega == (backend == "mega")
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    b = batch_frames([neighbor_list(frame, R_MAX, cut)], n_frames=1)
    np.testing.assert_array_equal(b[keys.EDGE_INDEX], np.asarray(jb[keys.EDGE_INDEX]))
    got = m.apply_with_derivatives(to_torch(m.precompute_statics(b), getattr(torch, dtype)))
    for k in (keys.TOTAL_ENERGY, keys.PER_ATOM_ENERGY, keys.FORCES):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=0,
                                   atol=TOL[dtype], err_msg=k)


@pytest.mark.parametrize("native", ["1", "0"], ids=["native", "scipy"])
@pytest.mark.parametrize("case", ["crystal", "molecule"])
def test_per_type_neighbor_list_matches_jax_edge_for_edge(case, native, monkeypatch):
    monkeypatch.setenv("ALLEGRO_TPU_NATIVE", native)
    frame = _crystal() if case == "crystal" else _frame(n_atoms=30)
    want = jax_nl.neighbor_list(frame, R_MAX, MATRIX)
    got = neighbor_list(frame, R_MAX, MATRIX)
    full = neighbor_list(frame, R_MAX)
    assert 0 < got[keys.EDGE_INDEX].shape[1] < full[keys.EDGE_INDEX].shape[1]
    np.testing.assert_array_equal(got[keys.EDGE_INDEX], want[keys.EDGE_INDEX])
    np.testing.assert_array_equal(got[keys.EDGE_CELL_SHIFT], want[keys.EDGE_CELL_SHIFT])
    ei, types = got[keys.EDGE_INDEX], frame[keys.ATOM_TYPES]
    r = port_nl.edge_lengths(frame[keys.POSITIONS], frame.get(keys.CELL), ei[0], ei[1],
                             got[keys.EDGE_CELL_SHIFT])
    assert (r < MATRIX[types[ei[0]], types[ei[1]]]).all()


def _sorted_edges(i, j, s):
    s = np.rint(s).astype(np.int64)
    order = np.lexsort((s[:, 2], s[:, 1], s[:, 0], j, i))
    return np.stack([i[order], j[order]]), s[order]


def _scipy(monkeypatch, pos, r_max, cell, pbc):
    monkeypatch.setenv("ALLEGRO_TPU_NATIVE", "0")
    try:
        return port_nl.primitive_neighbor_list(pos, r_max, cell, pbc)
    finally:
        monkeypatch.setenv("ALLEGRO_TPU_NATIVE", "1")


def _native_cases():
    rng = np.random.RandomState(0)
    tri = np.array([[4.0, 0, 0], [1.2, 3.8, 0], [-0.5, 0.8, 3.5]])
    crystal = _crystal((6, 6, 6), 1, spacing=2.2)
    return {
        "open": (rng.rand(50, 3) * 6.0, 1.5, None, (False,) * 3),
        "periodic_cubic": (rng.rand(40, 3) * 5.0, 1.7, np.eye(3) * 5.0, (True,) * 3),
        "triclinic": (rng.rand(30, 3) @ tri, 1.6, tri, (True,) * 3),
        "mixed_pbc": (rng.rand(25, 3) * 4.0, 1.5, np.eye(3) * 4.0, (True, False, True)),
        "tiny_cell": (np.zeros((1, 3)), 2.05, np.eye(3), (True,) * 3),
        "unwrapped": (rng.rand(20, 3) * 4.0 + np.array([9.0, -4.0, 2.5]), 1.5, np.eye(3) * 4.0,
                      (True,) * 3),
        "crystal": (crystal[keys.POSITIONS], 4.0, crystal[keys.CELL], (True,) * 3),
    }


@pytest.mark.parametrize("case", list(_native_cases()))
def test_native_list_matches_scipy(case, monkeypatch):
    assert native_available()
    pos, r_max, cell, pbc = _native_cases()[case]
    got = native_neighbor_list(pos, r_max, cell, pbc)
    want = _scipy(monkeypatch, pos, r_max, cell, pbc)
    g, w = _sorted_edges(*got), _sorted_edges(*want)
    np.testing.assert_array_equal(g[0], w[0])
    np.testing.assert_array_equal(g[1], w[1])
    np.testing.assert_array_equal(got[2], np.rint(got[2]))
    c = np.zeros((3, 3)) if cell is None else cell
    r = np.linalg.norm(pos[got[1]] - pos[got[0]] + got[2] @ c, axis=1)
    assert (r < r_max).all()
    if case == "tiny_cell":
        assert len(got[0]) == 6 + 12 + 8 + 6


def test_neighbor_list_reports_which_list_ran(monkeypatch):
    frame = _crystal()
    port_nl.reset_neighbor_list_counts()
    neighbor_list(frame, R_MAX)
    assert port_nl.NEIGHBOR_LISTS == {"native": 1, "scipy": 0}
    monkeypatch.setenv("ALLEGRO_TPU_NATIVE", "0")
    neighbor_list(frame, R_MAX)
    assert port_nl.NEIGHBOR_LISTS == {"native": 1, "scipy": 1}


MD_KW = dict(r_max=R_MAX, type_names=TYPES, l_max=1, num_layers=1, num_scalar_features=8,
             num_tensor_features=4, scalar_embed_mlp_hidden_layers_width=8,
             allegro_mlp_hidden_layers_width=8, readout_mlp_hidden_layers_width=8,
             avg_num_neighbors=6.0, per_type_energy_scales=0.05,
             per_type_energy_shifts=[0.1, -0.3, 0.2], model_dtype="float64",
             per_edge_type_cutoff=PER_TYPE)
SIM_KW = dict(masses=np.ones(3), r_max=R_MAX, dt=4e-3, pbc=(True, True, True), skin=0.05,
              steps_per_block=5, edge_multiple=32, per_edge_type_cutoff=MATRIX)


@pytest.mark.parametrize("backend", ["einsum", "mega"])
def test_per_type_md_matches_jax(backend):
    frame = _crystal((3, 3, 3), 2, spacing=1.5)
    pos, types, cell = frame[keys.POSITIONS], frame[keys.ATOM_TYPES], frame[keys.CELL]
    v0 = np.random.RandomState(3).randn(len(pos), 3) * 0.4
    from allegro_tpu.model import AllegroEnergyModel as JaxAllegroEnergyModel
    from allegro_tpu_torch.model import AllegroEnergyModel

    jm = JaxAllegroEnergyModel(**MD_KW)
    params = jm.init(0, to_jax(jax_batch_frames([jax_nl.neighbor_list(frame, R_MAX)],
                                                n_frames=1), dtype=np.float64))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))
    jsim = JaxSimulation(jm, params, atom_types=types, cell=cell, mesh=mesh, dtype=np.float64,
                         **SIM_KW)
    want = jsim.run(JaxMDState(pos.copy(), v0.copy()), 20)
    m = AllegroEnergyModel(**MD_KW, tp_kernel_backend="einsum" if backend == "einsum"
                           else "fused_infer")
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    sim = Simulation(m, atom_types=types, cell=cell, dtype=torch.float64, device="cpu",
                     **SIM_KW)
    got = sim.run(MDState(pos.copy(), v0.copy()), 20)
    assert sim.rebuilds >= 2 and sim.rebuilds == jsim.rebuilds
    np.testing.assert_allclose(got.positions, want.positions, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.velocities, want.velocities, rtol=0, atol=1e-8)


def test_md_refuses_cutoffs_above_r_max():
    m = AllegroModel(**_kwargs())
    with pytest.raises(ValueError, match="<= r_max"):
        Simulation(m, atom_types=np.zeros(4, np.int32), device="cpu",
                   **{**SIM_KW, "per_edge_type_cutoff": MATRIX + 1.0})


def test_edge_beyond_its_pair_cutoff_adds_exactly_zero():
    """Two B atoms at 2.3 (their cutoff 2.2, r_max 2.5) and an A atom near
    one of them: the B-B edges are in the list (as within an MD skin), and
    their edge energies and the energy's gradient in their edge vectors are
    exact zeros; the model's energy and forces equal those on the list
    without them."""
    pos = np.array([[0.0, 0.0, 0.0], [2.3, 0.0, 0.0], [0.0, 1.2, 0.3]])
    types = np.array([1, 1, 0], np.int32)
    frame = neighbor_list({keys.POSITIONS: pos, keys.ATOM_TYPES: types}, R_MAX)
    ei = frame[keys.EDGE_INDEX]
    far = (types[ei[0]] == 1) & (types[ei[1]] == 1)
    assert far.sum() == 2
    m = AllegroModel(**_kwargs(), tp_kernel_backend="einsum").init(0)
    exact = batch_frames([frame], n_frames=1, atom_multiple=1, edge_multiple=1)
    data = to_torch(m.precompute_statics(exact), torch.float64)
    vec = (torch.as_tensor(pos[ei[1]] - pos[ei[0]])).requires_grad_(True)
    data[keys.EDGE_VECTORS] = vec
    data[keys.EDGE_LENGTH] = vec.norm(dim=-1, keepdim=True)
    out = m.apply(data)
    assert keys.EDGE_ENERGY in out
    e_edge = out[keys.EDGE_ENERGY].detach().numpy().ravel()
    assert (e_edge[far] == 0.0).all() and (e_edge[~far] != 0.0).all()
    (grad,) = torch.autograd.grad(out[keys.TOTAL_ENERGY].sum(), vec)
    assert (grad[torch.as_tensor(far)] == 0.0).all()
    assert (grad[torch.as_tensor(~far)] != 0.0).any()
    near = neighbor_list({keys.POSITIONS: pos, keys.ATOM_TYPES: types}, R_MAX, MATRIX)
    assert near[keys.EDGE_INDEX].shape[1] == ei.shape[1] - 2
    outs = [m.apply_with_derivatives(to_torch(m.precompute_statics(batch_frames([f], n_frames=1)),
                                              torch.float64)) for f in (frame, near)]
    for k in (keys.TOTAL_ENERGY, keys.FORCES):
        np.testing.assert_allclose(outs[0][k].detach().numpy(), outs[1][k].detach().numpy(),
                                   rtol=0, atol=1e-14)
