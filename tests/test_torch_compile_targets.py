"""The port's compile targets and ghost-atom conversion (``allegro_tpu_torch/
compile/targets.py``) against JAX's, on the CPU.

- ``ghost_atom_conversion``, ``collapse_ghost_forces`` and the registry equal
  JAX's array for array on seeded periodic frames.
- The deployment contract end to end (twins of ``tests/compile/
  test_targets.py:31,66,167``): the port's float64 ``einsum`` model on the
  ghost-format frame gives the periodic frame's per-atom energies and, with
  the ghost forces collapsed, its forces within 1e-10; the exported
  ``pair_allegro_stress`` program's virial (the fdotr sum over real and
  ghost rows) equals the periodic model's strain derivative within 1e-10
  and central differences of the program's own energy.
"""

import numpy as np
import pytest
import torch

from allegro_tpu import compile as jax_compile
from allegro_tpu.data.neighborlist import neighbor_list as jax_neighbor_list

from allegro_tpu_torch.compile import (
    COMPILE_TARGETS,
    LoadedModel,
    collapse_ghost_forces,
    export_program,
    ghost_atom_conversion,
)
from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
from allegro_tpu_torch.model import AllegroModel
from torch_threads import one_thread  # noqa: F401

R_MAX = 2.6
TOL = 1e-10


def _periodic_frame(seed, side=2, a=2.4):
    rng = np.random.RandomState(seed)
    n = side**3
    grid = np.stack(np.meshgrid(*(np.arange(side),) * 3, indexing="ij"), -1).reshape(-1, 3)
    return {
        keys.POSITIONS: grid * a + 0.1 * rng.randn(n, 3),
        keys.ATOM_TYPES: rng.randint(0, 2, n).astype(np.int32),
        keys.CELL: np.eye(3) * side * a,
        keys.PBC: np.ones(3, bool),
    }


@pytest.mark.parametrize("seed,side", [(0, 2), (1, 2), (2, 3)])
def test_ghost_conversion_and_collapse_equal_jax(seed, side):
    frame = _periodic_frame(seed, side)
    fr = neighbor_list(frame, R_MAX)
    jfr = jax_neighbor_list(frame, R_MAX)
    for k in (keys.EDGE_INDEX, keys.EDGE_CELL_SHIFT):
        np.testing.assert_array_equal(fr[k], jfr[k])
    got, want = ghost_atom_conversion(fr), jax_compile.ghost_atom_conversion(jfr)
    assert sorted(got) == sorted(want)
    for k in got:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["_ghost_owner"].shape[0] > fr[keys.POSITIONS].shape[0]  # ghosts exist
    rng = np.random.RandomState(seed)
    forces = rng.randn(got["_ghost_owner"].shape[0], 3)
    n = fr[keys.POSITIONS].shape[0]
    np.testing.assert_array_equal(collapse_ghost_forces(forces, got["_ghost_owner"], n),
                                  jax_compile.collapse_ghost_forces(forces, got["_ghost_owner"], n))


def test_open_frame_conversion_is_the_identity():
    frame = _periodic_frame(3)
    for k in (keys.CELL, keys.PBC):
        frame.pop(k)
    fr = neighbor_list(frame, R_MAX)
    got = ghost_atom_conversion(fr)
    want = jax_compile.ghost_atom_conversion(jax_neighbor_list(frame, R_MAX))
    np.testing.assert_array_equal(got["_ghost_owner"], np.arange(8))
    for k in (keys.POSITIONS, keys.EDGE_INDEX, "_ghost_owner"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", ["pair_allegro", "pair_allegro_stress"])
def test_registry_equals_jax(name):
    got, want = COMPILE_TARGETS[name], jax_compile.COMPILE_TARGETS[name]
    assert (got.name, got.inputs, got.outputs) == (want.name, want.inputs, want.outputs)
    frame = {**neighbor_list(_periodic_frame(4), R_MAX), keys.BATCH: np.zeros(8, np.int32)}
    a, b = got.data_settings(frame), want.data_settings(frame)
    assert sorted(a) == sorted(b) and keys.BATCH not in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert sorted(COMPILE_TARGETS) == sorted(jax_compile.COMPILE_TARGETS)


def _model():
    return AllegroModel(
        r_max=R_MAX, type_names=["A", "B"], l_max=1, num_layers=1, num_scalar_features=8,
        num_tensor_features=4, scalar_embed_mlp_hidden_layers_width=8,
        allegro_mlp_hidden_layers_width=8, readout_mlp_hidden_layers_width=8,
        avg_num_neighbors=6.0, per_type_energy_scales=1.0, per_type_energy_shifts=0.0,
        model_dtype="float64", tp_kernel_backend="einsum",
    ).init(0)


def _call(model, frame, **pad):
    batch = batch_frames([frame], n_frames=1, edge_multiple=1, **pad)
    return model.apply_with_derivatives(to_torch(model.precompute_statics(batch), torch.float64))


@pytest.mark.parametrize("seed", [0, 1])
def test_ghost_forces_match_pbc(seed):
    """The model on the ghost-format frame gives the periodic frame's
    per-atom energies and, collapsed, its forces: the strict-locality
    contract of the deployment."""
    model = _model()
    fr = neighbor_list(_periodic_frame(seed), R_MAX)
    n = fr[keys.POSITIONS].shape[0]
    out_pbc = _call(model, fr)
    g = ghost_atom_conversion(fr)
    owner = g.pop("_ghost_owner")
    out_g = _call(model, g)
    n_tot = out_g[keys.FORCES].shape[0]
    np.testing.assert_allclose(out_g[keys.PER_ATOM_ENERGY][:n].numpy(),
                               out_pbc[keys.PER_ATOM_ENERGY][:n].numpy(), atol=TOL, rtol=0)
    owner_padded = np.concatenate([owner, np.arange(len(owner), n_tot)])
    f = collapse_ghost_forces(out_g[keys.FORCES].numpy(), owner_padded, n_tot)[:n]
    np.testing.assert_allclose(f, out_pbc[keys.FORCES][:n].numpy(), atol=TOL, rtol=0)


def _padded_inputs(g, n_pad, e_pad):
    n, e = g[keys.POSITIONS].shape[0], g[keys.EDGE_INDEX].shape[1]
    pos = np.zeros((n_pad, 3))
    pos[:n] = g[keys.POSITIONS]
    ei = np.zeros((2, e_pad), np.int32)
    ei[:, :e] = g[keys.EDGE_INDEX]
    at = np.zeros(n_pad, np.int32)
    at[:n] = g[keys.ATOM_TYPES]
    nm = np.zeros(n_pad, bool)
    nm[:n] = True
    em = np.zeros(e_pad, bool)
    em[:e] = True
    return pos, ei, at, nm, em


def test_stress_target_virial_vs_pbc_and_differences():
    """``pair_allegro_stress``: the exported program's VIRIAL equals the
    periodic model's strain-derivative virial, and central differences of
    the program's energy under symmetric strain."""
    model = _model()
    fr = neighbor_list(_periodic_frame(0), R_MAX)
    n = fr[keys.POSITIONS].shape[0]
    w_ref = _call(model, fr)[keys.VIRIAL].numpy().reshape(3, 3)
    g = ghost_atom_conversion(fr)
    g.pop("_ghost_owner")
    n_pad, e_pad = g[keys.POSITIONS].shape[0] + 4, g[keys.EDGE_INDEX].shape[1] + 16
    program, meta = export_program(model, "pair_allegro_stress", n_atoms=n_pad, n_edges=e_pad)
    loaded = LoadedModel(program.module(), meta)
    pos, ei, at, nm, em = _padded_inputs(g, n_pad, e_pad)
    out = loaded(pos, ei, at, nm, em)
    assert list(out) == list(COMPILE_TARGETS["pair_allegro_stress"].outputs)
    w = out[keys.VIRIAL].numpy().reshape(3, 3)
    np.testing.assert_allclose(w, w_ref, atol=TOL, rtol=0)

    def energy_at(eps):
        o = loaded(pos @ (np.eye(3) + eps), ei, at, nm, em)
        return float(o[keys.PER_ATOM_ENERGY][:n].sum())

    h = 1e-6
    for a, c in [(0, 0), (1, 1), (0, 1), (2, 0)]:
        eps = np.zeros((3, 3))
        eps[a, c] = h
        eps = 0.5 * (eps + eps.T)
        de = (energy_at(eps) - energy_at(-eps)) / 2
        expect = -h * w[a, a] if a == c else -(h / 2) * (w[a, c] + w[c, a])
        np.testing.assert_allclose(de, expect, rtol=1e-4, atol=1e-10)
