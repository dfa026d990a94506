"""The path tables that ``gather_tp`` and ``gather_dw`` walk on the fused
backends (``csrc/sparse_tp.cu``, the walkers of the ``pallas`` kernels with
the env row gathered by center), on the CPU.

Every layer of the flagship, l_max 3, the 3-layer l_max-3 model (dims 31)
and the l_max-4 model (paths beyond the compiled header), each case a test
of its own:

- every ``Contracter`` on ``fused`` and ``fused_infer`` carries the path
  tables of its entry order and of the role swap, equal to
  ``gen_cg_blocks.path_table(by_output=True)`` of its float64 entries, and
  the layer's calls pass them on (``FusedStatics`` on ``fused``,
  ``fused_layer_infer`` on ``fused_infer``); ``FusedStatics.swap()``
  exchanges them together with the entry tables;
- in both role orders, a plain float64 emulation of the new ``gather_tp``
  walk (the env row gathered by center, then ``sparse_tp``'s walk: output
  slices summed in a register-sized accumulator and stored once, rows no
  path writes stored as zeros; the split output ``ts`` is row 0 of that
  store; sentinel edges stored as zero rows without reading their x row)
  equals ``gather_tp_reference`` at 1e-12, with and without ``split``;
- a plain float64 emulation of the new ``gather_dw`` walk (per row, the
  block's output dotted with the cotangent slice; sentinel edges skipped)
  equals ``gather_dw_reference`` at 1e-12.

The kernels themselves run only on the card (``chip_smoke.py`` phases 2, 5a
and 7a).
"""

import functools

import numpy as np
import pytest
import torch

from allegro_tpu_torch.model import AllegroModel
from allegro_tpu_torch.nn import contract
from allegro_tpu_torch.nn.contract import Contracter
from allegro_tpu_torch.ops import fused_tp, gen_cg_blocks
from allegro_tpu_torch.ops.fused_primitives import FusedStatics
from test_torch_sparse_paths import _emulate_gradw, _emulate_tp, _one_thread  # noqa: F401

MODELS = {
    "flagship": (dict(l_max=2), 2),
    "lmax3": (dict(l_max=3), 2),
    "lmax3_3layers": (dict(l_max=3, num_layers=3), 3),
    "lmax4": (dict(l_max=4), 2),
}
BACKENDS = ("fused", "fused_infer")
ORDERS = ("own", "swapped")
LAYERS = [(m, layer) for m, (_, n) in MODELS.items() for layer in range(n)]
N_ATOMS, N_REAL, N_SENTINEL, U = 6, 30, 7, 3


@functools.lru_cache(maxsize=None)
def _layers(model, backend, dtype):
    kw, n = MODELS[model]
    m = AllegroModel(r_max=4.0, type_names=["A", "B"], num_scalar_features=8,
                     num_tensor_features=4, avg_num_neighbors=10.0, model_dtype=dtype,
                     tp_kernel_backend=backend, **kw)
    layers = [t for t in m.module.modules() if isinstance(t, Contracter)]
    assert len(layers) == n
    return layers


def _table(tp, order):
    """The layer's entry table in ``order`` (idx, float64 coef), its path
    table and its dims."""
    paths, swapped = tp.gather_paths()
    if order == "own":
        return tp.entry_idx, tp.entry_coef, paths, (tp.d1, tp.d2, tp.d3)
    return tp.entry_swapped, tp.entry_coef, swapped, (tp.d3, tp.d2, tp.d1)


def _assert_same_paths(got, want):
    for name, x, y in zip(want._fields, got, want):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def _graph(seed):
    """A few dozen center-sorted edges: N_REAL real ones over N_ATOMS atoms
    (one atom without edges), then N_SENTINEL padded edges with the sentinel
    center N_ATOMS."""
    rng = np.random.RandomState(seed)
    centers = np.sort(rng.choice([a for a in range(N_ATOMS) if a != 2], N_REAL))
    centers = np.concatenate([centers, np.full(N_SENTINEL, N_ATOMS)]).astype(np.int32)
    return rng, torch.as_tensor(centers)


def _emulate_gather_tp(x, env, w, centers, paths, d3, split):
    """gather_tp's walk in plain float64: a sentinel edge's row (and ts) is
    stored as zeros and its x row never read; a real edge's x row and its
    center's env row go through sparse_tp's walk (``_emulate_tp``: each
    output slice summed in a SLICE_MAX-row accumulator and stored once, rows
    no path writes stored as zeros); ts is row 0 of that store."""
    U = w.shape[1]
    real = (centers >= 0) & (centers < env.shape[0])
    out = x.new_zeros((x.shape[0], d3 * U))
    out[real] = _emulate_tp(x[real], env[centers[real].long()], w, paths, d3)
    return (out, out[:, :U].clone()) if split else out


def _inputs(tp, dims, order):
    """x, env, g, w and centers in float64, x and g with large values on the
    sentinel edges (a padded row may hold anything)."""
    d1, d2, d3 = dims
    rng, centers = _graph(10 + ORDERS.index(order))
    E = centers.shape[0]
    x, g = (torch.as_tensor(rng.randn(E, d * U)) for d in (d1, d3))
    x[N_REAL:] *= 1e6
    g[N_REAL:] *= 1e6
    env = torch.as_tensor(rng.randn(N_ATOMS, d2 * U))
    w = torch.as_tensor(rng.randn(tp.num_paths, U))
    return x, env, g, w, centers


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("model,layer", LAYERS, ids=[f"{m}-layer{n}" for m, n in LAYERS])
def test_layer_carries_its_path_tables(model, layer, backend):
    """The float32 layer's tables are the float64 entries' path tables (scales
    cast to float32), in both orders, kept out of the checkpoint and built
    once."""
    tp = _layers(model, backend, "float32")[layer]
    assert tp.entry_coef.dtype == torch.float64
    paths, swapped = tp.gather_paths()
    _assert_same_paths(paths, gen_cg_blocks.path_table(tp.entry_idx, tp.entry_coef,
                                                       torch.float32, by_output=True))
    _assert_same_paths(swapped, gen_cg_blocks.path_table(
        fused_tp.swap_entries(tp.entry_idx), tp.entry_coef, torch.float32, by_output=True))
    assert paths.scale.dtype == torch.float32 and swapped.entry_coef.dtype == torch.float32
    again = tp.gather_paths()
    assert again[0] is paths and again[1] is swapped
    assert not any(k.startswith("walk") for k in tp.state_dict())


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("model,layer", LAYERS, ids=[f"{m}-layer{n}" for m, n in LAYERS])
def test_calls_pass_the_tables_and_swap_exchanges_them(model, layer, backend, monkeypatch):
    """``fused_call`` hands each order's table to the kernels' Functions, and
    ``FusedStatics.swap()`` exchanges the path tables with the entries: in
    each order, the path table is that of its entries."""
    tp = _layers(model, backend, "float32")[layer]
    seen = {}
    monkeypatch.setattr(contract, "fused_layer",
                        lambda x, sh, wexp, w, st: seen.setdefault("st", st))
    monkeypatch.setattr(contract, "fused_layer_infer",
                        lambda *args: seen.setdefault("paths", args[-1]))
    _, centers = _graph(0)
    E = centers.shape[0]
    row_ptr = torch.as_tensor(fused_tp.csr_row_ptr(centers.numpy(), N_ATOMS))
    tp.fused_call(torch.zeros(E, tp.d1 * tp.mul), torch.zeros(E, tp.d2),
                  torch.zeros(E, tp.n_irr * tp.mul), centers, row_ptr)
    paths, swapped = tp.gather_paths()
    if backend == "fused_infer":
        assert seen["paths"] is paths
        return
    st = seen["st"]
    assert st.paths is paths and st.paths_swapped is swapped
    sw = st.swap()
    assert sw.entry_idx is st.entry_swapped and sw.entry_swapped is st.entry_idx
    assert sw.paths is swapped and sw.paths_swapped is paths
    assert sw.dims == (tp.d3, tp.d2, tp.d1)
    back = sw.swap()
    assert back.paths is paths and back.entry_idx is st.entry_idx and back.dims == st.dims
    for s in (st, sw):
        _assert_same_paths(s.paths, gen_cg_blocks.path_table(s.entry_idx, tp.entry_coef,
                                                             torch.float32, by_output=True))
    assert isinstance(st, FusedStatics)


@pytest.mark.parametrize("split", [False, True], ids=["out", "split"])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("model,layer", LAYERS, ids=[f"{m}-layer{n}" for m, n in LAYERS])
def test_gather_tp_walk_equals_the_plain_version(model, layer, order, split):
    """gather_tp's walk on this order's rows, float64, U = 3, 37 edges (7 of
    them sentinels, one atom without edges)."""
    tp = _layers(model, "fused", "float64")[layer]
    idx, coef, paths, dims = _table(tp, order)
    x, env, _, w, centers = _inputs(tp, dims, order)
    want = fused_tp.gather_tp_reference(x, env, w, centers, idx, coef, dims[2], split)
    got = _emulate_gather_tp(x, env, w, centers, paths, dims[2], split)
    for a, b in zip(got if split else (got,), want if split else (want,)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("model,layer", LAYERS, ids=[f"{m}-layer{n}" for m, n in LAYERS])
def test_gather_dw_walk_equals_the_plain_version(model, layer, order):
    """gather_dw's walk on this order's rows: the sentinel edges skipped, the
    real ones' x, env[c(e)] and g rows through sparse_tp_gradw's walk."""
    tp = _layers(model, "fused", "float64")[layer]
    idx, coef, paths, dims = _table(tp, order)
    x, env, g, _, centers = _inputs(tp, dims, order)
    want = fused_tp.gather_dw_reference(x, env, g, centers, idx, coef, tp.num_paths, U)
    real = centers < N_ATOMS
    got = _emulate_gradw(x[real], env[centers[real].long()], g[real], paths, tp.num_paths, U)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
