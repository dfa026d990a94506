"""The port's ``pallas`` backend against the JAX package, on the CPU.

- ``sparse_tp_reference`` / ``sparse_tp_gradw_reference`` (the CPU path of
  the two kernels) against JAX's ``tp_contract`` / ``tp_gradw`` with the
  Pallas kernels in interpret mode, on the same ``[E, U, d]`` arrays packed
  with ``pack_edge_major`` and weights tiled as ``PallasTPBackend.tile_weights``
  does: both flagship layer dims, the table and both swaps, path-channel
  coupling on and off; the port in float64 at 1e-10 and in float32 at 1e-5
  against JAX's float64 result (one interpret-mode call per kernel and
  case: each takes seconds at layer 0's 83 entries).
- The derivative family ``SparseTp`` / ``SparseTpGradW``: f64 ``gradcheck``
  and ``gradgradcheck`` on every role order of the table.
- The port's ``pallas`` model against JAX's ``pallas`` model (interpret
  mode) from the same weights: energy, forces and virial at 1e-10 (f64);
  force-loss parameter gradients on ``pallas`` against JAX ``einsum`` at
  1e-9; the wrapper calls of a force call (6 ``sparse_tp``, no
  ``sparse_tp_gradw``).
- The model modifiers: backend round trips keep the parameters and the
  outputs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import allegro_tpu.ops.pallas_contract as jpc
from allegro_tpu.data import to_jax
from allegro_tpu.model import MODEL_MODIFIERS as JAX_MODIFIERS
from allegro_tpu.model import AllegroModel as JaxAllegroModel

from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
from allegro_tpu_torch.model import MODEL_MODIFIERS, AllegroModel, modify, params_from_jax
from allegro_tpu_torch.nn.contract import Contracter
from allegro_tpu_torch.ops import fused_tp, pallas_contract
from allegro_tpu_torch.ops.pallas_contract import ROLES, permute_entries
from allegro_tpu_torch.ops.tp_primitives import SparseTp, SparseTpGradW, TpStatics

R_MAX = 4.0
L2 = "1x0e+1x1o+1x2e"
# the flagship's layer dims: (9, 9, 9) and (9, 9, 1)
LAYERS = {"layer0": (L2, L2, L2), "layer1": (L2, L2, "1x0e")}
# the table, its a-swap (k, j, i) and its b-swap (i, k, j), as JAX builds them
SWAPS = {"table": ((0, 1, 2), lambda e: e), "swap_a": ((2, 1, 0), jpc._swap_a_out),
         "swap_b": ((0, 2, 1), jpc._swap_b_out)}
TOL = {np.float64: 1e-10, np.float32: 1e-5}
OUT_KEYS = (keys.TOTAL_ENERGY, keys.PER_ATOM_ENERGY, keys.FORCES, keys.VIRIAL)


@pytest.fixture
def interpret():
    jpc.INTERPRET = True
    try:
        yield
    finally:
        jpc.INTERPRET = False


def _flat(x):
    """[E, U, d] → the port's flat dim-major [E, d*U]."""
    E, U, d = x.shape
    return torch.as_tensor(np.ascontiguousarray(x.transpose(0, 2, 1)).reshape(E, d * U).copy())


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), f"{what}: max abs err {err:.3e}"


@pytest.mark.parametrize("coupling", [True, False], ids=["coupled", "uncoupled"])
@pytest.mark.parametrize("swap", list(SWAPS))
@pytest.mark.parametrize("layer", list(LAYERS))
def test_plain_versions_match_jax_kernels(interpret, layer, swap, coupling):
    """sparse_tp on one role order of a layer's table, and (coupled cases;
    the weights do not enter it) sparse_tp_gradw, against JAX's tp_contract
    / tp_gradw on the same packed inputs."""
    c = Contracter(*LAYERS[layer], mul=8, kernel_backend="pallas", dtype=torch.float64)
    w3j = c.w3j.numpy()
    roles, jax_swap = SWAPS[swap]
    entries = jax_swap(jpc.sparse_entries(w3j))
    r = ROLES.index(roles)
    assert permute_entries(jpc.sparse_entries(w3j), roles) == entries
    dims = tuple(w3j.shape[1:][s] for s in roles)
    P, U, E = w3j.shape[0], 8, 32
    rng = np.random.RandomState(7)
    a, b, g = (rng.randn(E, U, d) for d in dims)
    w = rng.randn(U, P) if coupling else rng.randn(P)
    ap, bp, gp = (jpc.pack_edge_major(jnp.asarray(x)) for x in (a, b, g))
    wt = jpc.PallasTPBackend(w3j).tile_weights(jnp.asarray(w), U)
    want = _flat(np.asarray(jpc.unpack_dim_major(jpc.tp_contract(ap, bp, wt, entries, dims, 8),
                                                 E, U))).numpy()
    if coupling:
        want_gw = np.asarray(jpc.tp_gradw(ap, bp, gp, entries, dims, 8))
        want_gw = want_gw.reshape(P, 128 // U, U).sum(1)  # the adjoint of the lane tiling
    w_pu = w.T if coupling else np.broadcast_to(w[:, None], (P, U))
    for dt in (torch.float64, torch.float32):
        aa, bb, gg, ww = (torch.as_tensor(np.ascontiguousarray(x), dtype=dt)
                          for x in (_flat(a), _flat(b), _flat(g), w_pu))
        idx, coef = c.tp_idx[r], c.tp_coef[r].to(dt)
        tol = TOL[np.float64 if dt == torch.float64 else np.float32]
        got = pallas_contract.sparse_tp(aa, bb, ww, idx, coef, dims[2])
        _close(got.numpy(), want, tol, f"sparse_tp {dt}")
        if coupling:
            got_gw = pallas_contract.sparse_tp_gradw(aa, bb, gg, idx, coef, P, U)
            _close(got_gw.numpy(), want_gw, tol, f"sparse_tp_gradw {dt}")


@pytest.mark.parametrize("r", range(len(ROLES)), ids=lambda r: "".join(map(str, ROLES[r])))
def test_derivative_family_gradgradcheck(r):
    """Both Functions, f64, on every role order of layer 1's table (dims
    (9, 9, 1): each order has other input and output widths): first and
    second derivatives in every input."""
    c = Contracter(*LAYERS["layer1"], mul=2, kernel_backend="pallas", dtype=torch.float64)
    st = TpStatics(c.tp_idx, c.tp_coef, (c.d1, c.d2, c.d3), c.num_paths)
    dims = [st.dims[s] for s in ROLES[r]]
    gen = torch.Generator().manual_seed(r)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64, requires_grad=True)

    a, b, g = (rand(2, d * 2) for d in dims)
    w = rand(c.num_paths, 2)
    tp = lambda a, b, w: SparseTp.apply(a, b, w, st, r)  # noqa: E731
    gw = lambda a, b, g: SparseTpGradW.apply(a, b, g, st, r)  # noqa: E731
    assert torch.autograd.gradcheck(tp, (a, b, w))
    assert torch.autograd.gradgradcheck(tp, (a, b, w))
    assert torch.autograd.gradcheck(gw, (a, b, g))
    assert torch.autograd.gradgradcheck(gw, (a, b, g))


def _crystal(side, seed, spacing=2.2, r_max=R_MAX):
    rng = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(*(np.arange(s) for s in side), indexing="ij"), -1).reshape(-1, 3)
    n = grid.shape[0]
    return neighbor_list({
        keys.POSITIONS: grid * spacing + 0.1 * rng.randn(n, 3),
        keys.ATOM_TYPES: rng.randint(0, 3, n).astype(np.int32),
        keys.CELL: np.diag(np.asarray(side, dtype=np.float64) * spacing),
        keys.PBC: np.ones(3, dtype=bool),
    }, r_max)


def _kwargs(avg_n, **extra):
    return dict(r_max=R_MAX, type_names=["H", "C", "O"], l_max=2, parity=True, num_layers=2,
                num_scalar_features=8, num_tensor_features=4, avg_num_neighbors=avg_n,
                per_type_energy_scales=[1.0, 0.5, 2.0], per_type_energy_shifts=[0.1, -0.2, 0.3],
                model_dtype="float64", **extra)


@pytest.fixture(scope="module")
def crystal():
    frames = [_crystal((3, 3, 2), 0), _crystal((2, 2, 3), 1)]
    avg_n = sum(f[keys.EDGE_INDEX].shape[1] for f in frames) / sum(
        f[keys.POSITIONS].shape[0] for f in frames)
    return avg_n, batch_frames(frames, n_frames=2)


def _port_outputs(model, batch, create_graph=False):
    return model.apply_with_derivatives(to_torch(model.precompute_statics(batch), torch.float64),
                                        create_graph=create_graph)


def test_pallas_model_matches_jax_pallas_model(interpret, crystal):
    avg_n, batch = crystal
    jm = JaxAllegroModel(**_kwargs(avg_n, tp_kernel_backend="pallas"))
    jb = to_jax(batch, dtype=np.float64)
    params = jm.init(0, jb)
    want = jax.jit(jm.apply_with_derivatives)(params, jb)
    m = AllegroModel(**_kwargs(avg_n, tp_kernel_backend="pallas"))
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    out = _port_outputs(m, batch)
    for k in OUT_KEYS:
        _close(out[k].numpy(), want[k], 1e-10, k)


def test_pallas_force_loss_gradients_match_jax_einsum(crystal):
    avg_n, batch = crystal
    jm = JaxAllegroModel(**_kwargs(avg_n))
    jb = to_jax(batch, dtype=np.float64)
    params = jm.init(0, jb)

    def loss(p):
        out = jm.apply_with_derivatives(p, jb)
        return jnp.sum(out[keys.FORCES] ** 2) + out[keys.TOTAL_ENERGY].sum() ** 2

    want = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params))).items()}
    m = AllegroModel(**_kwargs(avg_n, tp_kernel_backend="pallas"))
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    out = _port_outputs(m, batch, create_graph=True)
    got = (out[keys.FORCES] ** 2).sum() + out[keys.TOTAL_ENERGY].sum() ** 2
    ps = m.parameters()
    assert sorted(ps) == sorted(want)
    for name, g in zip(ps, torch.autograd.grad(got, list(ps.values()))):
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-9, rtol=1e-7, err_msg=name)


def test_pallas_force_call_runs_no_weight_gradient(crystal, monkeypatch):
    """Two layers: each one sparse_tp forward and its two input transposes;
    the frozen parameters need no sparse_tp_gradw (JAX's transposes skip it
    too). Training (create_graph=True) does run it."""
    avg_n, batch = crystal
    m = AllegroModel(**_kwargs(avg_n, tp_kernel_backend="pallas")).init(0)
    calls = {"sparse_tp": 0, "sparse_tp_gradw": 0}
    for name in calls:
        fn = getattr(pallas_contract, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(pallas_contract, name, counted)
    fused_tp.reset_launch_counts()
    out = _port_outputs(m, batch)
    assert calls == {"sparse_tp": 6, "sparse_tp_gradw": 0}
    assert not out[keys.FORCES].requires_grad
    assert fused_tp.LAUNCHES == {k: 0 for k in fused_tp.LAUNCHES}  # the CPU launches nothing
    out = _port_outputs(m, batch, create_graph=True)
    torch.autograd.grad((out[keys.FORCES] ** 2).sum(), list(m.parameters().values()))
    assert calls["sparse_tp_gradw"] > 0


def test_modifier_round_trips_keep_parameters_and_outputs(crystal):
    avg_n, batch = crystal
    m = AllegroModel(**_kwargs(avg_n)).init(3)
    want = _port_outputs(m, batch)
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    for name, backend in (("enable_PallasContracter", "pallas"),
                          ({"modifier": "enable_FusedContracter"}, "fused"),
                          ("enable_EinsumContracter", "einsum")):
        m = modify(m, [name])
        assert m.builder_kwargs["tp_kernel_backend"] == backend and m.has_derivatives
        assert sorted(m.state_dict()) == sorted(sd)
        for k, v in m.state_dict().items():
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
        out = _port_outputs(m, batch)
        for k in OUT_KEYS:
            torch.testing.assert_close(out[k], want[k], rtol=0, atol=1e-10)


def test_modifier_registry_names():
    names = {"enable_PallasContracter", "enable_EinsumContracter", "enable_FusedContracter",
             "enable_TritonContracter", "enable_CuEquivarianceContracter"}
    assert names <= set(MODEL_MODIFIERS) and names <= set(JAX_MODIFIERS)
    assert MODEL_MODIFIERS["enable_TritonContracter"] is MODEL_MODIFIERS["enable_FusedContracter"]
    with pytest.raises(ValueError, match="unknown model modifier"):
        modify(AllegroModel(**_kwargs(1.0)), ["enable_NoSuchContracter"])
