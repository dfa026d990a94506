"""The port's exported force call (``compile/export.py``) against JAX's
compiled artifact, on the CPU.

The port's ``ExportedProgram`` (``make_fx`` + ``torch.export``, the kernels
as ``atpt::`` ops running their plain versions here) and JAX's
``export_model`` + ``load_exported`` (its Pallas kernels in interpret mode)
take the same inputs at JAX's test sizes (``tests/compile/
test_targets.py:137,223``: the ghost-format frame padded by 4 atoms and 16
zero edges) with the parameters carried across by ``params_from_jax``:
within 1e-10 in float64 (``einsum`` and ``fused_infer``), 5e-5 in float32.
An edge list whose real edges are out of center order gives NaN energies on
the kernel route. No ``.pt2`` is built here (AOTInductor takes about a
minute for three ops on this CPU); the card builds it (``chip_smoke.py``
phase 9).
"""

import jax
import numpy as np
import pytest
import torch

import allegro_tpu.ops.fused_tp as jax_fused_tp
from allegro_tpu.compile import export_model as jax_export_model
from allegro_tpu.compile import load_exported as jax_load_exported
from allegro_tpu.data import batch_frames as jax_batch_frames
from allegro_tpu.data import to_jax
from allegro_tpu.model import AllegroModel as JaxAllegroModel

from allegro_tpu_torch.compile import LoadedModel, export_program, ghost_atom_conversion
from allegro_tpu_torch.data import keys, neighbor_list
from allegro_tpu_torch.model import AllegroModel, params_from_jax
from torch_threads import one_thread  # noqa: F401

R_MAX = 2.6
TOLS = {"float64": 1e-10, "float32": 5e-5}


def _ghost_frame():
    rng = np.random.RandomState(0)
    grid = np.stack(np.meshgrid(*(np.arange(2),) * 3, indexing="ij"), -1).reshape(-1, 3)
    frame = {keys.POSITIONS: grid * 2.4 + 0.1 * rng.randn(8, 3),
             keys.ATOM_TYPES: rng.randint(0, 2, 8).astype(np.int32),
             keys.CELL: np.eye(3) * 4.8, keys.PBC: np.ones(3, bool)}
    g = ghost_atom_conversion(neighbor_list(frame, R_MAX))
    g.pop("_ghost_owner")
    return g


def _inputs(g, dtype, sentinel=False):
    """JAX's test inputs: padded by 4 atoms and 16 edges, the edges zero
    (or, with ``sentinel``, the sentinel atom) and masked."""
    n, e = g[keys.POSITIONS].shape[0], g[keys.EDGE_INDEX].shape[1]
    n_pad, e_pad = n + 4, e + 16
    pos = np.zeros((n_pad, 3), dtype)
    pos[:n] = g[keys.POSITIONS]
    ei = np.full((2, e_pad), n_pad if sentinel else 0, np.int32)
    ei[:, :e] = g[keys.EDGE_INDEX]
    at = np.zeros(n_pad, np.int32)
    at[:n] = g[keys.ATOM_TYPES]
    nm = np.zeros(n_pad, bool)
    nm[:n] = True
    em = np.zeros(e_pad, bool)
    em[:e] = True
    return pos, ei, at, nm, em


def _kwargs(backend, dtype):
    return dict(
        r_max=R_MAX, type_names=["A", "B"], l_max=1, num_layers=1, num_scalar_features=8,
        num_tensor_features=4, scalar_embed_mlp_hidden_layers_width=8,
        allegro_mlp_hidden_layers_width=8, readout_mlp_hidden_layers_width=8,
        avg_num_neighbors=6.0, per_type_energy_scales=1.0, per_type_energy_shifts=0.0,
        model_dtype=dtype, tp_kernel_backend=backend,
    )


CASES = [("einsum", "float64"), ("fused_infer", "float64"), ("fused_infer", "float32")]


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def case(request):
    """(backend, dtype, JAX's loaded artifact's outputs, the port's loaded
    program, the inputs)."""
    backend, dtype = request.param
    g = _ghost_frame()
    inputs = _inputs(g, np.dtype(dtype))
    n_pad, e_pad = inputs[0].shape[0], inputs[1].shape[1]
    jm = JaxAllegroModel(**_kwargs(backend, dtype))
    jb = to_jax(jax_batch_frames([g], n_atoms=n_pad, n_edges=e_pad, n_frames=1), dtype=dtype)
    params = jm.init(0, jb)
    jax_fused_tp.INTERPRET = True
    try:
        blob = jax_export_model(jm, params, n_atoms=n_pad, n_edges=e_pad, dtype=np.dtype(dtype))
        want = {k: np.asarray(v) for k, v in jax_load_exported(blob)(*inputs).items()}
    finally:
        jax_fused_tp.INTERPRET = False
    model = AllegroModel(**_kwargs(backend, dtype))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    program, meta = export_program(model, n_atoms=n_pad, n_edges=e_pad)
    return backend, dtype, want, LoadedModel(program.module(), meta), inputs


def test_exported_program_matches_jax_artifact(case):
    backend, dtype, want, loaded, inputs = case
    got = loaded(*inputs)
    assert list(got) == list(want)
    tol = TOLS[dtype]
    for k in want:
        assert got[k].dtype == getattr(torch, dtype), k
        np.testing.assert_allclose(got[k].numpy().reshape(want[k].shape), want[k], atol=tol,
                                   rtol=0 if dtype == "float64" else tol, err_msg=k)
    assert np.abs(want[keys.FORCES]).max() > 1e-3  # not a vacuous comparison


def test_sentinel_and_zero_padding_give_the_same_program_outputs(case):
    backend, dtype, _, loaded, inputs = case
    n_pad = inputs[0].shape[0]
    zero = loaded(*inputs)
    sentinel = loaded(*_inputs(_ghost_frame(), np.dtype(dtype), sentinel=True))
    for k in zero:
        assert torch.equal(zero[k], sentinel[k]), k
    assert sentinel[keys.FORCES].shape == (n_pad, 3)


def test_out_of_order_edges_poison_the_kernel_route(case):
    """JAX's rule: real edges must be center-sorted with the padding
    trailing, or the energies are NaN (``einsum``, which needs no order,
    gives the same numbers)."""
    backend, dtype, _, loaded, inputs = case
    pos, ei, at, nm, em = inputs
    e = int(em.sum())
    swapped = ei.copy()
    first, last = swapped[:, 0].copy(), swapped[:, e - 1].copy()
    assert first[0] != last[0]
    swapped[:, 0], swapped[:, e - 1] = last, first
    masked_inside = em.copy()
    masked_inside[e // 2] = False  # a pad before real edges
    ref = loaded(*inputs)
    for bad_ei, bad_em in ((swapped, em), (ei, masked_inside)):
        out = loaded(pos, bad_ei, at, nm, bad_em)
        if backend == "einsum":
            assert torch.isfinite(out[keys.TOTAL_ENERGY]).all()
        else:
            assert torch.isnan(out[keys.TOTAL_ENERGY]).all()
            # every atom with edges (the 8 real ones; a ghost row is a center of none)
            assert torch.isnan(out[keys.PER_ATOM_ENERGY][:8]).all()
    if backend == "einsum":
        out = loaded(pos, swapped, at, nm, em)
        torch.testing.assert_close(out[keys.TOTAL_ENERGY], ref[keys.TOTAL_ENERGY],
                                   atol=TOLS[dtype], rtol=TOLS[dtype])
