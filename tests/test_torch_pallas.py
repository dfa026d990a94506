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
  ``sparse_tp_gradw``) and of a training step.
- Determinism: no op adds into colliding rows outside the kernels on a
  force call of two periodic frames, on ``pallas`` and the fused backends,
  nor in a whole training step's backward on ``fused`` and ``pallas`` with
  every parameter table read by class (a dispatch mode records them); those
  models' force-loss gradients against JAX ``einsum`` at 1e-9; a kernel
  backend raises without the CSR statics and ``einsum`` ignores them.
- The model modifiers: backend round trips keep the parameters and the
  outputs.
"""

import traceback

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
from torch_threads import one_thread  # noqa: F401

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


def _count_wrapper_calls(monkeypatch):
    """Counts the calls of every kernel wrapper (the CPU launches nothing)."""
    calls = {name: 0 for name in fused_tp.LAUNCHES}
    for name in calls:
        mod = fused_tp if hasattr(fused_tp, name) else pallas_contract
        fn = getattr(mod, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


def _pallas_call_counts(L, zbl=False):
    """Per force call of an L-layer pallas model: per layer the forward
    sparse_tp and its two input transposes, no sparse_tp_gradw (frozen
    parameters); the position gathers (2) and their transposes, the
    edge-energy sum and its transpose, per layer the env sum (center_sum then
    center_gather) and its transpose, and ZBL's sum and its transpose."""
    counts = {name: 0 for name in fused_tp.LAUNCHES}
    counts.update(sparse_tp=3 * L, center_gather=3 + 2 * L + zbl, center_sum=3 + 2 * L + zbl)
    return counts


def test_pallas_force_call_runs_no_weight_gradient(crystal, monkeypatch):
    """Two layers: each one sparse_tp forward and its two input transposes;
    the frozen parameters need no sparse_tp_gradw (JAX's transposes skip it
    too). With the CSR statics the env sums, the position gathers and the
    edge-energy sum take the center kernels: the exact count of every
    wrapper. Training (create_graph=True) does run sparse_tp_gradw."""
    avg_n, batch = crystal
    m = AllegroModel(**_kwargs(avg_n, tp_kernel_backend="pallas")).init(0)
    calls = _count_wrapper_calls(monkeypatch)
    fused_tp.reset_launch_counts()
    out = _port_outputs(m, batch)
    assert calls == _pallas_call_counts(2)
    assert not out[keys.FORCES].requires_grad
    assert fused_tp.LAUNCHES == {k: 0 for k in fused_tp.LAUNCHES}  # the CPU launches nothing
    out = _port_outputs(m, batch, create_graph=True)
    torch.autograd.grad((out[keys.FORCES] ** 2).sum(), list(m.parameters().values()))
    assert calls["sparse_tp_gradw"] > 0


@pytest.mark.parametrize("L,zbl", [(2, False), (3, False), (2, True)])
def test_pallas_launch_counts_per_call_and_training_step(crystal, monkeypatch, L, zbl):
    """The exact wrapper calls of a pallas force call and of a Trainer step
    (chip_smoke.py's per_call / per_step_pallas): per step 9 L sparse_tp,
    4 L sparse_tp_gradw, 6 + 4 L center_gather and 3 + 4 L center_sum (ZBL:
    one more of each), and one center_gather and one center_sum for each of
    the two type embeddings' class lookups (the force call's frozen tables
    read with index_select)."""
    from allegro_tpu_torch.data import DataLoader, InMemoryDataset
    from allegro_tpu_torch.train import Trainer

    avg_n, batch = crystal
    extra = {"pair_potential": {"_target_": "allegro_tpu.nn.ZBLPairPotential",
                                "type_to_Z": [1, 6, 8]}} if zbl else {}
    m = AllegroModel(**{**_kwargs(avg_n, tp_kernel_backend="pallas", **extra), "num_layers": L})
    frames = [_crystal((2, 2, 2), 0), _crystal((2, 2, 3), 1)]
    for f in frames:
        f[keys.TOTAL_ENERGY] = np.zeros(1)
        f[keys.FORCES] = np.zeros_like(f[keys.POSITIONS])
    loader = DataLoader(InMemoryDataset(frames, R_MAX), batch_size=2)
    trainer = Trainer(m, device="cpu", logger=lambda s: None)
    state = trainer.init_state(0)
    calls = _count_wrapper_calls(monkeypatch)
    _port_outputs(m, batch)
    assert calls == _pallas_call_counts(L, zbl)
    for k in calls:
        calls[k] = 0
    trainer.fit(state, loader, max_epochs=1)
    want = {name: 0 for name in fused_tp.LAUNCHES}
    want.update(sparse_tp=9 * L, sparse_tp_gradw=4 * L, center_gather=6 + 4 * L + zbl + 2,
                center_sum=3 + 4 * L + zbl + 2)
    assert calls == want


class _CollidingSums(TorchDispatchMode):
    """Records every op that adds into colliding rows (an ``index_add`` or
    ``index_put(accumulate=True)`` whose index repeats, any ``scatter_add``
    or ``embedding_dense_backward``): on the card such a sum adds with
    atomics, in no fixed order. The kernels' plain versions (the
    ``*_reference`` functions of ``ops/``, which the CPU runs in place of the
    kernels) are not counted."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in ("index_add", "index_add_", "index_reduce", "index_reduce_"):
            rows = args[2].reshape(-1, 1)
        elif name in ("index_put", "index_put_", "_index_put_impl_") and (
                args[3] if len(args) > 3 else kwargs.get("accumulate", False)):
            rows = torch.stack([i.reshape(-1) for i in args[1] if i is not None], dim=1)
        elif name in ("scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
                      "embedding_dense_backward"):
            rows = None  # counted whatever its index
        else:
            return func(*args, **kwargs)
        colliding = rows is None or torch.unique(rows, dim=0).shape[0] < rows.shape[0]
        if colliding and not self._in_plain_version():
            self.found.append(name)
        return func(*args, **kwargs)

    @staticmethod
    def _in_plain_version():
        return any(f.name.endswith("_reference") and "/ops/" in f.filename.replace("\\", "/")
                   for f in traceback.extract_stack())


def test_pallas_path_sums_in_a_fixed_order(crystal):
    """The repaired fault: two identical pallas force calls differed on the
    card (the env sum's index_add adds with atomics there). On a batch of two
    periodic frames (so the per-frame cells and strains are read per edge and
    per atom), a pallas force call, ZBL included, adds into colliding rows
    nowhere outside the kernels: every sum is a center kernel, a matrix
    product or a reduction, each in a fixed order, in energy, forces and
    virial. Two calls agree bit for bit. The check itself catches a gather's
    transpose."""
    avg_n, batch = crystal
    assert batch[keys.CELL].shape[0] == 2
    zbl = {"_target_": "allegro_tpu.nn.ZBLPairPotential", "type_to_Z": [1, 6, 8]}
    m = AllegroModel(**_kwargs(avg_n, tp_kernel_backend="pallas", pair_potential=zbl)).init(0)
    with _CollidingSums() as mode:
        first = _port_outputs(m, batch)
    assert mode.found == []
    again = _port_outputs(m, batch)
    for k in OUT_KEYS:
        assert torch.equal(first[k], again[k]), k
    x = torch.ones(4, 3, requires_grad=True)
    with _CollidingSums() as mode:
        torch.autograd.grad(x.index_select(0, torch.tensor([0, 1, 1])).sum(), x)
    assert mode.found == ["index_add"]


SPLINE = {"_target_": "allegro_tpu.nn.TwoBodySplineScalarEmbed", "num_splines": 8,
          "spline_span": 6}
# every parameter table read by class: the spline's per-edge-type weights and
# the per-type scales and shifts (the Bessel embed's type embeddings: below)
TABLES = dict(radial_chemical_embed=SPLINE, per_type_energy_scales_trainable=True,
              per_type_energy_shifts_trainable=True)


def _force_loss(out):
    return (out[keys.FORCES] ** 2).sum() + out[keys.TOTAL_ENERGY].sum() ** 2


@pytest.mark.parametrize("backend", ["fused", "pallas"])
@pytest.mark.parametrize("tables", [TABLES, {}], ids=["spline_trainable_scales", "bessel"])
def test_training_step_sums_in_a_fixed_order(crystal, monkeypatch, backend, tables):
    """The repaired fault: a parameter table read by class (type embeddings,
    spline weights, trainable per-type scales and shifts) took its gradient
    through index_select's transpose, an index_add that adds with atomics on
    the card. With the class CSR statics a whole training step's backward
    (force loss, create_graph) adds into colliding rows nowhere outside the
    kernels, each table's read is a center_gather and its gradient a
    center_sum; the force call, whose tables are frozen, reads them with
    index_select and runs no more center kernels than before."""
    avg_n, batch = crystal
    m = AllegroModel(**_kwargs(avg_n, tp_kernel_backend=backend, **tables)).init(0)
    lookups = m.class_lookups
    assert set(lookups) == ({keys.EDGE_CLASS_LOOKUP, keys.ATOM_TYPE_LOOKUP} if tables else
                            {keys.CENTER_TYPE_LOOKUP, keys.NEIGHBOR_TYPE_LOOKUP})
    data = to_torch(m.precompute_statics(batch), torch.float64)
    for lookup in lookups:
        idx, row_ptr, perm = (data[k] for k in keys.class_csr_keys(lookup))
        assert idx.dtype == row_ptr.dtype == perm.dtype == torch.int32
        real = data[keys.NODE_MASK if lookup == keys.ATOM_TYPE_LOOKUP else keys.EDGE_MASK]
        rows = row_ptr.shape[0] - 1
        assert (idx[~real] == rows).all() and (idx[real] < rows).all()  # padding: the zero row
    # the tables' values, read through center_gather (live parameters) or
    # index_select (frozen), are the same bits
    live, frozen = m.apply(data), m.apply(data, frozen=True)
    for k in (keys.PER_ATOM_ENERGY, keys.TOTAL_ENERGY):
        assert torch.equal(live[k], frozen[k]), k
    calls = _count_wrapper_calls(monkeypatch)
    with _CollidingSums() as mode:
        out = m.apply_with_derivatives(data, create_graph=True)
        grads = torch.autograd.grad(_force_loss(out), list(m.parameters().values()))
    assert mode.found == []
    assert all(torch.isfinite(g).all() for g in grads)
    step = dict(calls)
    for k in calls:
        calls[k] = 0
    m.apply_with_derivatives(data)
    assert step["center_gather"] - calls["center_gather"] >= len(lookups)
    if backend == "pallas":
        assert calls == _pallas_call_counts(2)


@pytest.fixture(scope="module")
def jax_table_grads(crystal):
    """JAX einsum's parameters and force-loss gradients of the model with
    every class table trainable, under the port's names."""
    avg_n, batch = crystal
    jm = JaxAllegroModel(**_kwargs(avg_n, **TABLES))
    jb = to_jax(batch, dtype=np.float64)
    params = jm.init(0, jb)
    grads = jax.jit(jax.grad(lambda p: _force_loss(jm.apply_with_derivatives(p, jb))))(params)
    by_name = lambda tree: params_from_jax(jax.tree_util.tree_map(np.asarray, tree))  # noqa: E731
    return by_name(params), {k: v.numpy() for k, v in by_name(grads).items()}


@pytest.mark.parametrize("backend", ["fused", "pallas"])
def test_table_gradients_match_jax_einsum(crystal, jax_table_grads, backend):
    """The first step's force-loss gradients of a model with every class
    table trainable (spline embed, per-type scales and shifts), through the
    class CSR statics, against JAX's einsum model at 1e-9 (f64) in every
    parameter."""
    avg_n, batch = crystal
    state, want = jax_table_grads
    m = AllegroModel(**_kwargs(avg_n, tp_kernel_backend=backend, **TABLES))
    m.load_state_dict(state)
    out = _port_outputs(m, batch, create_graph=True)
    ps = m.parameters()
    assert sorted(ps) == sorted(want)
    assert {"per_type_scale_shift.scales", "per_type_scale_shift.shifts"} <= set(ps)
    for name, g in zip(ps, torch.autograd.grad(_force_loss(out), list(ps.values()))):
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-9, rtol=1e-7, err_msg=name)


@pytest.mark.parametrize("over", [dict(tp_kernel_backend="fused"),
                                  dict(tp_kernel_backend="fused_infer"),
                                  dict(tp_kernel_backend="fused_infer", use_mega=False)],
                         ids=["fused", "mega", "fused_infer"])
def test_fused_force_calls_add_into_no_colliding_rows(crystal, over):
    """As above on the fused backends (the mega path and use_mega=False):
    no op adds into colliding rows outside the kernels on a force call of
    two periodic frames."""
    avg_n, batch = crystal
    m = AllegroModel(**_kwargs(avg_n, **over)).init(0)
    with _CollidingSums() as mode:
        _port_outputs(m, batch)
    assert mode.found == []


@pytest.mark.parametrize("backend", ["pallas", "fused", "fused_infer"])
def test_backend_decides_the_statics(crystal, monkeypatch, backend):
    """A kernel backend raises on a batch without the CSR statics (no stage
    falls back to a plain sum); ``einsum``, the reference, drops them and
    calls no kernel wrapper, with the same outputs either way."""
    avg_n, batch = crystal
    m = AllegroModel(**_kwargs(avg_n, tp_kernel_backend=backend)).init(0)
    with pytest.raises(ValueError, match="precompute_statics"):
        m.apply_with_derivatives(to_torch(batch, torch.float64))
    ref = AllegroModel(**_kwargs(avg_n, tp_kernel_backend="einsum"))
    ref.load_state_dict(m.state_dict())
    want = ref.apply_with_derivatives(to_torch(batch, torch.float64))
    calls = _count_wrapper_calls(monkeypatch)
    out = ref.apply_with_derivatives(to_torch(m.precompute_statics(batch), torch.float64))
    assert calls == {k: 0 for k in calls}
    for k in OUT_KEYS:
        assert torch.equal(out[k], want[k]), k


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
