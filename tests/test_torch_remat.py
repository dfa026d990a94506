"""``remat`` and ``checkpoint_energy`` (ROADMAP item 6), on the CPU.

- The force call with both against JAX's model with both, float64 at
  1e-10, on ``einsum`` (JAX's mega path under ``remat`` in interpret mode
  takes ~20 s to compile; the port's mega path with both is held to the
  port without them below, and that one to JAX's mega path by
  ``test_torch_model_interpret.py``).
- The same bits as the same port model without them, on every backend
  (every plain version sums in a fixed order), with and without the bf16
  track; with ``checkpoint_energy`` the result holds the energies and the
  inputs, not the per-edge intermediates.
- One force-loss training step on ``fused`` with ``remat`` (second order
  through the recomputed layers, as JAX allows) against JAX's ``einsum``
  force-loss gradients (atol 1e-9 / rtol 1e-7, as
  ``test_torch_train.py``) and the same step without ``remat`` (the same
  bits).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from allegro_tpu.data import to_jax
from allegro_tpu.model import AllegroModel as JaxAllegroModel

from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
from allegro_tpu_torch.model import AllegroModel, params_from_jax
from torch_threads import one_thread  # noqa: F401

R_MAX = 4.0
TOL = 1e-10
POLICY = dict(remat=True, checkpoint_energy=True)
OUTPUTS = (keys.TOTAL_ENERGY, keys.PER_ATOM_ENERGY, keys.FORCES, keys.VIRIAL)


def _batch():
    """12 atoms: a jittered 2x2x3 periodic lattice, three types."""
    rng = np.random.RandomState(5)
    grid = np.stack(np.meshgrid(*(np.arange(s) for s in (2, 2, 3)), indexing="ij"), -1)
    frame = {keys.POSITIONS: grid.reshape(-1, 3) * 2.2 + 0.1 * rng.randn(12, 3),
             keys.ATOM_TYPES: rng.randint(0, 3, 12).astype(np.int32),
             keys.CELL: np.diag([4.4, 4.4, 6.6]), keys.PBC: np.ones(3, dtype=bool)}
    return batch_frames([neighbor_list(frame, R_MAX)], n_frames=1)


def _kwargs(batch, **kw):
    return dict(
        r_max=R_MAX, type_names=["A", "B", "C"], l_max=2, parity=True, num_layers=2,
        num_scalar_features=16, num_tensor_features=4,
        avg_num_neighbors=float(batch[keys.EDGE_MASK].sum()) / 12.0,
        per_type_energy_scales=[1.0, 0.5, 2.0], per_type_energy_shifts=[0.1, -0.2, 0.3],
        model_dtype="float64", **kw,
    )


def _port(kw, state=None):
    m = AllegroModel(**kw)
    if state is None:
        m.init(0)
    else:
        m.load_state_dict(state)
    return m


def _call(m, batch, dtype=torch.float64, **kw):
    return m.apply_with_derivatives(to_torch(m.precompute_statics(batch), dtype=dtype), **kw)


def test_remat_and_checkpoint_energy_match_jax():
    batch = _batch()
    kw = _kwargs(batch, tp_kernel_backend="einsum", **POLICY)
    jm = JaxAllegroModel(**kw)
    jb = to_jax(batch, dtype=np.float64)
    params = jm.init(3, jb)
    assert jm.checkpoint_energy
    want = jax.jit(jm.apply_with_derivatives)(params, jb)
    m = _port(kw, params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    assert m.module.allegro.remat and m.checkpoint_energy
    got = _call(m, batch)
    for k in OUTPUTS:
        w = np.asarray(want[k])
        err = float(np.abs(got[k].numpy() - w).max())
        assert err <= TOL * max(1.0, float(np.abs(w).max())), f"{k}: {err:.3e}"


@pytest.mark.parametrize("backend,extra", [
    ("fused_infer", {}),
    ("fused_infer", {"tensor_dtype": "bfloat16"}),
    ("fused_infer", {"use_mega": False}),
    ("fused", {}),
    ("pallas", {}),
    ("einsum", {}),
], ids=["mega", "mega-bf16", "fused_infer", "fused", "pallas", "einsum"])
@pytest.mark.parametrize("policy", [{"remat": True}, {"checkpoint_energy": True}, POLICY],
                         ids=["remat", "checkpoint_energy", "both"])
def test_the_same_bits_as_without_them(backend, extra, policy):
    batch = _batch()
    base = _port(_kwargs(batch, tp_kernel_backend=backend, **extra))
    m = _port(_kwargs(batch, tp_kernel_backend=backend, **extra, **policy), base.state_dict())
    want, got = _call(base, batch, torch.float32), _call(m, batch, torch.float32)
    for k in OUTPUTS:
        assert torch.equal(got[k], want[k]), k
    if policy.get("checkpoint_energy"):
        # the energies and the inputs only: no per-edge intermediate is kept
        assert keys.EDGE_SCALARS not in got and keys.EDGE_SCALARS in want
        assert keys.POSITIONS in got and keys.EDGE_INDEX in got


def test_a_training_step_on_fused_with_remat():
    batch = _batch()
    kw = _kwargs(batch, tp_kernel_backend="fused")
    jm = JaxAllegroModel(**{**kw, "tp_kernel_backend": "einsum"})
    jb = to_jax(batch, dtype=np.float64)
    params = jm.init(1, jb)

    def jax_loss(p):
        out = jm.apply_with_derivatives(p, jb)
        return jnp.sum(out[keys.FORCES] ** 2) + out[keys.TOTAL_ENERGY].sum() ** 2

    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(jax_loss))(params)))
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    grads = {}
    for remat in (True, False):
        m = _port({**kw, "remat": remat}, state)
        out = _call(m, batch, create_graph=True)
        loss = (out[keys.FORCES] ** 2).sum() + out[keys.TOTAL_ENERGY].sum() ** 2
        ps = m.parameters()
        grads[remat] = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
    assert sorted(grads[True]) == sorted(want)
    for name, g in grads[True].items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-9, rtol=1e-7,
                                   err_msg=name)
        assert torch.equal(g, grads[False][name]), name
