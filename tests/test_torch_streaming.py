"""The center-chunked streaming evaluator (``md/streaming.py``) on the CPU.

- ``build_chunks`` against JAX's ``build_chunks``, array by array (the
  ``einsum`` model, whose statics both attach the same: ``EDGE_TYPE``).
- ``StreamedEvaluator`` against the port's monolithic force call for K in
  {1, 3, 5}: energy, forces and virial within rtol 1e-4 / atol 1e-5 (the
  virial rtol 1e-3 / atol 1e-4) in float32, as JAX's
  ``tests/md/test_streaming.py``, and 1e-10 in float64; on ``einsum`` and on
  the default mega path of ``fused_infer`` (the kernels' plain versions,
  the position gather on the center kernels' pair).
- Against JAX's ``StreamedEvaluator`` with the same (converted) weights,
  float64 at 1e-10.
"""

import numpy as np
import jax
import pytest
import torch

from allegro_tpu.data import to_jax
from allegro_tpu.data.neighborlist import neighbor_list as jax_neighbor_list
from allegro_tpu.md.streaming import StreamedEvaluator as JaxStreamedEvaluator
from allegro_tpu.md.streaming import build_chunks as jax_build_chunks
from allegro_tpu.model import AllegroModel as JaxAllegroModel

from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
from allegro_tpu_torch.md.streaming import LOCAL_IDX, StreamedEvaluator, build_chunks
from allegro_tpu_torch.model import AllegroModel, params_from_jax
from torch_threads import one_thread  # noqa: F401

R_MAX = 2.5
TOL = 1e-10
F_TOL = dict(rtol=1e-4, atol=1e-5)
V_TOL = dict(rtol=1e-3, atol=1e-4)


def _frame(side=4, a=2.0, seed=0, jax_list=False):
    rng = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(*(np.arange(side),) * 3, indexing="ij"), -1).reshape(-1, 3)
    frame = {keys.POSITIONS: grid * a + 0.05 * rng.randn(len(grid), 3),
             keys.ATOM_TYPES: rng.randint(0, 2, len(grid)).astype(np.int32),
             keys.CELL: np.eye(3) * (side * a), keys.PBC: np.ones(3, bool)}
    return (jax_neighbor_list if jax_list else neighbor_list)(frame, R_MAX), len(grid)


def _kwargs(avg_n, dtype, backend="einsum"):
    return dict(r_max=R_MAX, type_names=["A", "B"], l_max=2, parity=True, num_layers=2,
                num_scalar_features=16, num_tensor_features=4, avg_num_neighbors=avg_n,
                per_type_energy_scales=0.2, per_type_energy_shifts=[0.1, -0.2],
                model_dtype=dtype, tp_kernel_backend=backend)


def test_build_chunks_matches_jax():
    frame, n_atoms = _frame(seed=3)
    batch = batch_frames([frame], n_frames=1)
    avg_n = frame[keys.EDGE_INDEX].shape[1] / n_atoms
    want = jax_build_chunks(to_jax(batch, dtype=np.float32),
                            JaxAllegroModel(**_kwargs(avg_n, "float32")), n_chunks=4)
    got = build_chunks(batch, AllegroModel(**_kwargs(avg_n, "float32")), n_chunks=4)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    # every real edge in exactly one chunk; the owned atoms partition the frame
    assert int(got[keys.EDGE_MASK].sum()) == frame[keys.EDGE_INDEX].shape[1]
    own = np.concatenate([got[LOCAL_IDX][k][got[keys.NODE_MASK][k]] for k in range(4)])
    np.testing.assert_array_equal(np.sort(own), np.arange(n_atoms))


def _close(got, want, dtype, tol):
    if dtype == torch.float64:
        w = want.double()
        assert (got.double() - w).abs().max().item() <= TOL * max(1.0, w.abs().max().item())
    else:
        torch.testing.assert_close(got.double(), want.double(), **tol)


@pytest.mark.parametrize("backend", ["einsum", "fused_infer"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n_chunks", [1, 3, 5])
def test_streamed_matches_monolithic(n_chunks, dtype, backend):
    frame, n_atoms = _frame()
    batch = batch_frames([frame], n_frames=1)
    avg_n = frame[keys.EDGE_INDEX].shape[1] / n_atoms
    model = AllegroModel(**_kwargs(avg_n, str(dtype).split(".")[1], backend)).init(0)
    out = model.apply_with_derivatives(to_torch(model.precompute_statics(batch), dtype=dtype))
    ev = StreamedEvaluator(model, batch, n_chunks=n_chunks, with_stress=True, device="cpu")
    e, f, v = ev(batch[keys.POSITIONS])
    assert f.dtype == dtype and not f.requires_grad
    _close(e, out[keys.TOTAL_ENERGY].sum(), dtype, F_TOL)
    _close(f[:n_atoms], out[keys.FORCES][:n_atoms], dtype, F_TOL)
    _close(v, out[keys.VIRIAL][0], dtype, V_TOL)


def test_streamed_matches_jax_streamed():
    frame, n_atoms = _frame(seed=1, jax_list=True)
    batch = batch_frames([frame], n_frames=1)
    avg_n = frame[keys.EDGE_INDEX].shape[1] / n_atoms
    kw = _kwargs(avg_n, "float64")
    jm = JaxAllegroModel(**kw)
    jb = to_jax(batch, dtype=np.float64)
    params = jm.init(2, jb)
    e_j, f_j, v_j = JaxStreamedEvaluator(jm, params, jb, n_chunks=3, with_stress=True)(
        jb[keys.POSITIONS])
    model = AllegroModel(**kw)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    e, f, v = StreamedEvaluator(model, batch, n_chunks=3, with_stress=True, device="cpu")(
        batch[keys.POSITIONS])
    for got, want in ((e, e_j), (f[:n_atoms], np.asarray(f_j)[:n_atoms]), (v, v_j)):
        w = np.asarray(want)
        assert float(np.abs(got.numpy() - w).max()) <= TOL * max(1.0, float(np.abs(w).max()))
