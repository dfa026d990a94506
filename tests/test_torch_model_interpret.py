"""The port's ``fused_infer`` force call against JAX ``fused_infer`` with
its Pallas kernels in interpret mode (float64, 1e-10).

With ``use_mega=False`` each layer goes through ``env_scatter``,
``gather_tp_raw``, ``bwd_fused_raw`` and ``unweight_both_raw`` on both sides.
With the port's default (``use_mega=None``) against JAX's ``use_mega=True``,
both run the mega-fused layers: ``latent_env_scatter`` / ``latent_env_bwd``,
``gather_tp_embed`` / ``bwd_embed`` at layer 0, and ``gather_tp`` /
``bwd_fused`` with the split scalar output and its cotangent at the layers
between (three layers exercise them).

- Without precomputed statics and with ``use_fused_readout=False``, JAX's
  edge vectors and edge sum take the plain gather branch, as the port's do.
- With JAX's own ``precompute_statics`` and ``use_fused_readout=True``, JAX
  also runs the center gathers and scatters and the fused readout (kernels
  5, 6, 11, 12; the test checks that its program contains them), and the
  port runs its statics through the same four.
"""

import numpy as np
import jax
import pytest
import torch

from allegro_tpu.data import to_jax
from allegro_tpu.model import AllegroModel as JaxAllegroModel
from allegro_tpu.ops import fused_tp as jax_ftp

from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
from allegro_tpu_torch.model import AllegroModel, params_from_jax

R_MAX = 4.0
TOL = 1e-10


def _frame():
    """12 atoms: a jittered 2x2x3 periodic lattice, three types."""
    rng = np.random.RandomState(1)
    grid = np.stack(np.meshgrid(*(np.arange(s) for s in (2, 2, 3)), indexing="ij"), -1)
    grid = grid.reshape(-1, 3)
    frame = {
        keys.POSITIONS: grid * 2.2 + 0.1 * rng.randn(12, 3),
        keys.ATOM_TYPES: rng.randint(0, 3, 12).astype(np.int32),
        keys.CELL: np.diag([4.4, 4.4, 6.6]),
        keys.PBC: np.ones(3, dtype=bool),
    }
    return neighbor_list(frame, R_MAX)


def _kwargs(batch, num_layers=2):
    return dict(
        r_max=R_MAX, type_names=["A", "B", "C"], l_max=2, parity=True, num_layers=num_layers,
        num_scalar_features=16, num_tensor_features=4,
        avg_num_neighbors=float(batch[keys.EDGE_MASK].sum()) / 12.0,
        per_type_energy_scales=[1.0, 0.5, 2.0], per_type_energy_shifts=[0.1, -0.2, 0.3],
        model_dtype="float64", tp_kernel_backend="fused_infer", use_mega=False,
    )


def _run_jax(jm, params, jb):
    old = jax_ftp.INTERPRET
    jax_ftp.INTERPRET = True
    try:
        return jm.apply_with_derivatives(params, jb)
    finally:
        jax_ftp.INTERPRET = old


def _check(out, want):
    for k in (keys.TOTAL_ENERGY, keys.PER_ATOM_ENERGY, keys.FORCES, keys.VIRIAL):
        w = np.asarray(want[k])
        got = out[k].numpy()
        assert got.shape == w.shape, k
        err = float(np.abs(got - w).max())
        assert err <= TOL * max(1.0, float(np.abs(w).max())), f"{k}: max abs err {err:.3e}"


def test_port_matches_jax_fused_infer_interpret():
    batch = batch_frames([_frame()], n_frames=1)
    kw = _kwargs(batch)
    jm = JaxAllegroModel(**kw, use_fused_readout=False)
    jb = to_jax(batch, dtype=np.float64)
    params = jm.init(3, jb)
    want = _run_jax(jm, params, jb)
    m = AllegroModel(**kw, use_fused_readout=False)
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    _check(m.apply_with_derivatives(to_torch(m.precompute_statics(batch), dtype=torch.float64)),
           want)


def test_port_matches_jax_fused_infer_with_statics_and_fused_readout_interpret():
    batch = batch_frames([_frame()], n_frames=1)
    kw = _kwargs(batch)
    jm = JaxAllegroModel(**kw, use_fused_readout=True)
    jb = jm.precompute_statics(to_jax(batch, dtype=np.float64))
    params = jm.init(3, jb)
    program = str(jax.make_jaxpr(jm.apply_with_derivatives)(params, jb))
    for name in ("readout_sum_infer", "allegro_center_gather", "allegro_center_scatter"):
        assert name in program, f"JAX did not run {name}"
    want = _run_jax(jm, params, jb)
    m = AllegroModel(**kw, use_fused_readout=True)
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    data = m.precompute_statics(batch)
    assert keys.NBR_PERM in data and keys.NBR_ROW_PTR in data
    _check(m.apply_with_derivatives(to_torch(data, dtype=torch.float64)), want)


@pytest.mark.parametrize("statics", [False, True], ids=["plain-statics", "jax-statics"])
@pytest.mark.parametrize("num_layers", [2, 3])
def test_port_mega_default_matches_jax_mega_interpret(num_layers, statics):
    """The same converted parameters give JAX's mega outputs: the port's
    default (no ``use_mega``) against JAX ``use_mega=True``, without and
    with JAX's own statics (and its fused readout)."""
    batch = batch_frames([_frame()], n_frames=1)
    kw = {**_kwargs(batch, num_layers), "use_mega": True, "use_fused_readout": statics}
    jm = JaxAllegroModel(**kw)
    jb = to_jax(batch, dtype=np.float64)
    if statics:
        jb = jm.precompute_statics(jb)
    params = jm.init(3, jb)
    program = str(jax.make_jaxpr(jm.apply_with_derivatives)(params, jb))
    for name in ("mega_latent_env", "gather_tp_embed_infer", "gather_tp_infer"):
        assert name in program, f"JAX did not run {name}"
    want = _run_jax(jm, params, jb)
    del kw["use_mega"]
    m = AllegroModel(**kw)
    assert m.module.allegro.mega
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    _check(m.apply_with_derivatives(to_torch(m.precompute_statics(batch), dtype=torch.float64)),
           want)
