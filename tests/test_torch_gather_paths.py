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

And the tables ``tp_scatter`` walks on ``fused`` (``sparse_tp``'s walk per
edge, the rows summed over each atom's edges) with the tile schedule of
``unweight_sh`` (``csrc/train_tp.cu``), on the same models and layers:

- every ``Contracter`` on ``fused`` carries two ``tp_scatter`` tables, its
  entry order and its role swap, each with its roles permuted (0, 2, 1) so
  that the walk's out is j (the env), equal to
  ``gen_cg_blocks.path_table(by_output=True)`` of the permuted float64
  entries; ``fused_infer`` layers carry the same tables (``bwd_fused``'s
  denv walk);
- ``FusedStatics`` carries them and ``swap()`` exchanges them, and
  ``TpScatter`` passes the order's table to the kernel's wrapper, also from
  the backward of ``GatherTp``;
- in both role orders, a plain float64 emulation of the new ``tp_scatter``
  walk (per atom segment, T / U chunks of edges in edge order, each edge
  through ``sparse_tp``'s walk on the permuted table, the chunks' partials
  added in chunk order; an atom without edges, sentinel edges never read)
  equals ``tp_scatter_reference`` at 1e-12;
- a plain float64 emulation of ``unweight_sh``'s tile schedule (tiles of
  consecutive edges, the last partial; up to a number of staged center rows
  per tile, the rest read from the table; each dot over the channels started
  at the thread's rotation; sentinel edges zero) equals
  ``unweight_sh_reference`` at 1e-12, at U = 3 (4-byte copies) and U = 8
  (16-byte copies), for the full schedule (32-edge tiles, 4 staged rows) and
  for the smaller ones the launcher takes where rows are too wide for shared
  memory.

And the walks of ``bwd_fused`` without its weight gradient and the tiles of
``unweight_w``, on the same models and layers:

- ``fused_layer_infer`` (``Contracter.fused_call`` on ``fused_infer``) and
  ``gather_tp_infer`` (the mega path's layers after the first) hand
  ``bwd_fused`` the layer's role-swapped path table and its (0, 2, 1)
  table (``Contracter.infer_paths``);
- a plain float64 emulation of the new ``bwd_fused`` schedule (per atom
  segment, T / U chunks of edges in edge order; per edge, gts folded into
  g's row 0, dx by ``gather_tp``'s walk on the role-swapped table with the
  atom's env row, denv by ``tp_scatter``'s walk, the chunks' partials added
  in chunk order; an atom without edges; sentinel edges, with large x, g
  and gts, stored as zero dx rows and never read) equals
  ``bwd_fused_reference`` at 1e-12, with and without gts;
- a plain float64 emulation of ``unweight_w``'s tile schedule (the tiles
  and staged rows of ``unweight_sh``; per item (edge, 4 channels, or 1
  where U is not a multiple of 4), the edge found by the kernel's float32
  reciprocal, each irrep's sum over its contiguous dims stored once in the
  tile's one output range; sentinel edges zero) equals
  ``unweight_w_reference`` at 1e-12, for the same schedules and widths.

The kernels themselves run only on the card (``chip_smoke.py`` phases 2, 5a
and 7a).
"""

import functools

import numpy as np
import pytest
import torch

from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
from allegro_tpu_torch.model import AllegroModel
from allegro_tpu_torch.nn import contract
from allegro_tpu_torch.nn.contract import Contracter
from allegro_tpu_torch.ops import fused_tp, gen_cg_blocks
from allegro_tpu_torch.ops.fused_primitives import FusedStatics, GatherTp, TpScatter
from test_torch_sparse_paths import _emulate_gradw, _emulate_tp
from torch_threads import one_thread  # noqa: F401

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
IDS = [f"{m}-layer{n}" for m, n in LAYERS]
# (i, j, k, p) -> (i, k, j, p): the roles (0, 2, 1), written out here
ROLES_021 = [0, 2, 1, 3]
TP_THREADS = 128  # kTpThreads of csrc/sparse_tp.cu: a block is (T / U chunks, U channels)
# unweight_sh's (edges per tile, staged t rows): the full schedule (kShTile,
# kShCenters of csrc/train_tp.cu) and smaller ones its launcher takes where
# the rows do not fit in shared memory
SH_SCHEDULES = [(32, 4), (16, 1), (1, 0)]


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
                        lambda *args, **bwd: seen.setdefault("paths", args[-1]))
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


def _scatter_table(idx, coef):
    return gen_cg_blocks.path_table(idx[:, ROLES_021], coef, torch.float32, by_output=True)


def _degree_graph(degrees, n_sentinel):
    """Center-sorted edges with the given degree per atom, then n_sentinel
    padded edges with the sentinel center len(degrees)."""
    n_atoms = len(degrees)
    centers = np.concatenate([np.repeat(np.arange(n_atoms), degrees),
                              np.full(n_sentinel, n_atoms)]).astype(np.int32)
    return torch.as_tensor(centers), n_atoms


def _statics(tp, centers, n_atoms, monkeypatch):
    """The layer's FusedStatics, as ``fused_call`` builds them."""
    seen = {}
    monkeypatch.setattr(contract, "fused_layer",
                        lambda x, sh, wexp, w, st: seen.setdefault("st", st))
    E, dtype = centers.shape[0], tp.path_weights.dtype
    row_ptr = torch.as_tensor(fused_tp.csr_row_ptr(centers.numpy(), n_atoms))
    tp.fused_call(torch.zeros(E, tp.d1 * tp.mul, dtype=dtype), torch.zeros(E, tp.d2, dtype=dtype),
                  torch.zeros(E, tp.n_irr * tp.mul, dtype=dtype), centers, row_ptr)
    return seen["st"]


@pytest.mark.parametrize("model,layer", LAYERS, ids=IDS)
def test_layer_carries_its_scatter_tables(model, layer):
    """The float32 layer's tables are the permuted float64 entries' path
    tables (scales cast to float32), in both orders, out of the checkpoint,
    built once; their outputs are the env's dims. ``fused_infer`` builds the
    same tables (``bwd_fused`` walks the first)."""
    tp = _layers(model, "fused", "float32")[layer]
    assert tp.entry_coef.dtype == torch.float64
    own, swapped = tp.scatter_paths()
    _assert_same_paths(own, _scatter_table(tp.entry_idx, tp.entry_coef))
    _assert_same_paths(swapped, _scatter_table(fused_tp.swap_entries(tp.entry_idx),
                                               tp.entry_coef))
    for paths in (own, swapped):
        assert paths.scale.dtype == torch.float32 and paths.entry_coef.dtype == torch.float32
        assert int((paths.desc[:, 4] + paths.desc[:, 7]).max()) <= tp.d2
    again = tp.scatter_paths()
    assert again[0] is own and again[1] is swapped
    assert not any(k.startswith("scatter") for k in tp.state_dict())
    infer = _layers(model, "fused_infer", "float32")[layer]
    for got, want in zip(infer.scatter_paths(), (own, swapped)):
        _assert_same_paths(got, want)
    assert not any(k.startswith("scatter") for k in infer.state_dict())


@pytest.mark.parametrize("model,layer", LAYERS, ids=IDS)
def test_statics_carry_the_scatter_tables_and_swap_exchanges_them(model, layer, monkeypatch):
    tp = _layers(model, "fused", "float32")[layer]
    centers, n_atoms = _degree_graph([3, 0, 2], 2)
    st = _statics(tp, centers, n_atoms, monkeypatch)
    own, swapped = tp.scatter_paths()
    assert isinstance(st, FusedStatics)
    assert st.scatter_paths is own and st.scatter_paths_swapped is swapped
    sw = st.swap()
    assert sw.scatter_paths is swapped and sw.scatter_paths_swapped is own
    assert sw.paths is st.paths_swapped and sw.entry_idx is st.entry_swapped
    back = sw.swap()
    assert back.scatter_paths is own and back.entry_idx is st.entry_idx
    for s in (st, sw):
        _assert_same_paths(s.scatter_paths, _scatter_table(s.entry_idx, tp.entry_coef))


@pytest.mark.parametrize("model,layer", LAYERS, ids=IDS)
def test_tp_scatter_gets_the_orders_table(model, layer, monkeypatch):
    """TpScatter hands its statics' table to the wrapper in both orders, and
    GatherTp's backward reaches it with the same order's table."""
    tp = _layers(model, "fused", "float64")[layer]
    centers, n_atoms = _degree_graph([3, 0, 2], 2)
    st = _statics(tp, centers, n_atoms, monkeypatch)
    seen = []
    real = fused_tp.tp_scatter

    def spy(*args, **kwargs):
        seen.append(args[8] if len(args) > 8 else kwargs.get("paths"))
        return real(*args, **kwargs)

    monkeypatch.setattr(fused_tp, "tp_scatter", spy)
    E, U = centers.shape[0], tp.mul
    rng = np.random.RandomState(layer)
    for s in (st, st.swap()):
        d1, d2, d3 = s.dims
        x, g = (torch.as_tensor(rng.randn(E, d * U)) for d in (d1, d3))
        w = torch.as_tensor(rng.randn(tp.num_paths, U))
        TpScatter.apply(x, g, w, s)
        env = torch.as_tensor(rng.randn(n_atoms, d2 * U)).requires_grad_()
        GatherTp.apply(x, env, w, s).backward(g)
    own, swapped = tp.scatter_paths()
    assert [p is q for p, q in zip(seen, (own, own, swapped, swapped))] == [True] * 4


def _emulate_tp_scatter(x, g, w, row_ptr, paths, d2):
    """tp_scatter's walk in plain float64: per atom, chunk q of T / U walks
    the segment's edges q, q + chunks, ... in edge order, each edge's x and g
    rows through sparse_tp's walk on the permuted table (``_emulate_tp``),
    its rows added to the chunk's partial; the partials are added in chunk
    order. Edges past row_ptr[n_atoms] are never read."""
    U = w.shape[1]
    chunks = max(1, TP_THREADS // U)
    n_atoms = row_ptr.shape[0] - 1
    n_real = int(row_ptr[n_atoms])
    rows = _emulate_tp(x[:n_real], g[:n_real], w, paths, d2)  # each edge's walk
    denv = torch.full((n_atoms, d2 * U), float("nan"), dtype=x.dtype)
    for a in range(n_atoms):
        start, end = int(row_ptr[a]), int(row_ptr[a + 1])
        total = x.new_zeros(d2 * U)
        for q in range(chunks):
            part = x.new_zeros(d2 * U)
            for e in range(start + q, end, chunks):
                part += rows[e]
            total += part
        denv[a] = total
    return denv


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("model,layer", LAYERS, ids=IDS)
def test_tp_scatter_walk_equals_the_plain_version(model, layer, order):
    """float64, U = 16 (8 chunks): one 21-edge segment (3 edges a chunk), an
    atom without edges, 7 sentinel edges with large x and g."""
    tp = _layers(model, "fused", "float64")[layer]
    own, swapped = tp.scatter_paths()
    idx, paths = (tp.entry_idx, own) if order == "own" else (tp.entry_swapped, swapped)
    d1, d2, d3 = (tp.d1, tp.d2, tp.d3) if order == "own" else (tp.d3, tp.d2, tp.d1)
    centers, n_atoms = _degree_graph([21, 4, 0, 9, 1], 7)
    real = int((centers < n_atoms).sum())
    row_ptr = torch.as_tensor(fused_tp.csr_row_ptr(centers.numpy(), n_atoms))
    U, E = 16, centers.shape[0]
    rng = np.random.RandomState(20 + ORDERS.index(order))
    x, g = (torch.as_tensor(rng.randn(E, d * U)) for d in (d1, d3))
    x[real:] *= 1e6
    g[real:] *= 1e6
    w = torch.as_tensor(rng.randn(tp.num_paths, U))
    want = fused_tp.tp_scatter_reference(x, g, w, centers, n_atoms, idx, tp.entry_coef, d2)
    got = _emulate_tp_scatter(x, g, w, row_ptr, paths, d2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    assert (got[2] == 0).all()


def _tile_stage(centers, e0, n_e, n_atoms, n_stage):
    """The t rows a tile of the row kernels stages (``tile_centers`` of
    csrc/train_tp.cu): [c_lo, c_lo + n_c), from its first edge's center to
    its last real one's, at most ``n_stage``, none where the first edge is a
    sentinel."""
    c_lo, n_c = int(centers[e0]), 0
    if 0 <= c_lo < n_atoms:
        c_hi = min(int(centers[e0 + n_e - 1]), n_atoms - 1)
        n_c = max(0, min(n_stage, c_hi - c_lo + 1))
    return c_lo, n_c


def _emulate_unweight_sh(t, wexp, centers, dim_to_irr, n_atoms, tile, n_stage):
    """unweight_sh's tile schedule in plain float64: per ``tile``-edge tile
    (the last partial), the t rows of :func:`_tile_stage` staged; output o =
    (edge, j) of the tile is the dot of its wexp irrep row and its t row over
    the U channels, summed in order in float4 (U a multiple of 4) or element
    steps starting at o mod (steps per row); sentinel edges zero. Returns dsh
    and how many dots read an unstaged row."""
    E, d2 = wexp.shape[0], dim_to_irr.shape[0]
    U = t.shape[1] // d2
    vec = 4 if U % 4 == 0 else 1
    period = U // vec
    t_np, w_np, c_np = t.numpy(), wexp.numpy(), centers.numpy()
    d2i = [int(r) for r in dim_to_irr]
    dsh = np.full((E, d2), np.nan)
    unstaged = 0
    for e0 in range(0, E, tile):
        n_e = min(tile, E - e0)
        s_w = w_np[e0:e0 + n_e].copy()
        c_lo, n_c = _tile_stage(c_np, e0, n_e, n_atoms, n_stage)
        s_t = t_np[c_lo:c_lo + n_c].copy() if n_c else None
        for o in range(n_e * d2):
            el, j = divmod(o, d2)
            c = int(c_np[e0 + el])
            if not 0 <= c < n_atoms:
                dsh[e0 + el, j] = 0.0
                continue
            wr = s_w[el, d2i[j] * U:(d2i[j] + 1) * U]
            staged = 0 <= c - c_lo < n_c
            unstaged += not staged
            tr = (s_t[c - c_lo] if staged else t_np[c])[j * U:(j + 1) * U]
            order = (np.arange(U) + (o % period) * vec) % U  # from the thread's rotation
            s = 0.0
            for p in (wr[order] * tr[order]).tolist():
                s += p
            dsh[e0 + el, j] = s
    return torch.as_tensor(dsh), unstaged


@pytest.mark.parametrize("tile,n_stage", SH_SCHEDULES,
                         ids=[f"tile{a}-staged{b}" for a, b in SH_SCHEDULES])
@pytest.mark.parametrize("U", [3, 8])
@pytest.mark.parametrize("model,layer", LAYERS, ids=IDS)
def test_unweight_sh_tile_schedule_equals_the_plain_version(model, layer, U, tile, n_stage):
    """float64, 75 edges: whole tiles and a partial one, tiles over more
    centers than are staged, an atom without edges, 5 sentinel edges (wexp
    large there)."""
    tp = _layers(model, "fused", "float64")[layer]
    centers, n_atoms = _degree_graph([9, 3, 0, 7, 5, 6, 4, 12, 10, 14], 5)
    E = centers.shape[0]
    rng = np.random.RandomState(30 + U)
    t = torch.as_tensor(rng.randn(n_atoms, tp.d2 * U))
    wexp = torch.as_tensor(rng.randn(E, tp.n_irr * U))
    wexp[E - 5:] *= 1e6
    want = fused_tp.unweight_sh_reference(t, wexp, centers, tp.dim_to_irr)
    got, unstaged = _emulate_unweight_sh(t, wexp, centers, tp.dim_to_irr, n_atoms, tile,
                                         n_stage)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    assert unstaged > 0 and (got[E - 5:] == 0).all()


def _emulate_bwd_fused(x, g, env, w, gts, centers, row_ptr, paths, scatter, d1, d2):
    """bwd_fused's schedule in plain float64: each real edge's staged g
    column with gts added to its row 0; dx by gather_tp's walk on the
    role-swapped table (``_emulate_gather_tp``: a = g over k, b = the atom's
    env row over j, out = i; sentinel rows stored as zeros, their g never
    read); denv by tp_scatter's walk on the (0, 2, 1) table
    (``_emulate_tp_scatter``: a = x, b = g, out = j; per atom, T / U chunks
    in edge order, their partials added in chunk order)."""
    U = w.shape[1]
    n_real = int(row_ptr[-1])
    gf = g.clone()
    if gts is not None:
        gf[:n_real, :U] += gts[:n_real]
    return (_emulate_gather_tp(gf, env, w, centers, paths, d1, False),
            _emulate_tp_scatter(x, gf, w, row_ptr, scatter, d2))


@pytest.mark.parametrize("gts", [False, True], ids=["g", "gts"])
@pytest.mark.parametrize("model,layer", LAYERS, ids=IDS)
def test_bwd_fused_walk_equals_the_plain_version(model, layer, gts):
    """float64, U = 16 (8 chunks): one 21-edge segment (3 edges a chunk), an
    atom without edges, 7 sentinel edges with large x, g and gts."""
    tp = _layers(model, "fused_infer", "float64")[layer]
    _, swapped, scatter = tp.infer_paths()
    centers, n_atoms = _degree_graph([21, 4, 0, 9, 1], 7)
    real = int((centers < n_atoms).sum())
    row_ptr = torch.as_tensor(fused_tp.csr_row_ptr(centers.numpy(), n_atoms))
    U, E = 16, centers.shape[0]
    rng = np.random.RandomState(40 + gts)
    x, g = (torch.as_tensor(rng.randn(E, d * U)) for d in (tp.d1, tp.d3))
    env = torch.as_tensor(rng.randn(n_atoms, tp.d2 * U))
    w = torch.as_tensor(rng.randn(tp.num_paths, U))
    t_gts = torch.as_tensor(rng.randn(E, U)) if gts else None
    for a in (x, g) if t_gts is None else (x, g, t_gts):
        a[real:] *= 1e6
    want = fused_tp.bwd_fused_reference(x, g, env, w, centers, n_atoms, tp.entry_idx,
                                        tp.entry_coef, t_gts)
    got = _emulate_bwd_fused(x, g, env, w, t_gts, centers, row_ptr, swapped, scatter, tp.d1,
                             tp.d2)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
    assert (got[0][real:] == 0).all() and (got[1][2] == 0).all()


def _frame(n_types=2):
    """A periodic 2 x 2 x 2 crystal (spacing 2.2, r_max 4.0): every atom's
    segment holds periodic images."""
    rng = np.random.RandomState(5)
    grid = np.stack(np.meshgrid(*(np.arange(2),) * 3, indexing="ij"), -1).reshape(-1, 3)
    frame = {keys.POSITIONS: grid * 2.2 + 0.1 * rng.randn(8, 3),
             keys.ATOM_TYPES: rng.randint(0, n_types, 8).astype(np.int32),
             keys.CELL: np.eye(3) * 4.4, keys.PBC: np.ones(3, dtype=bool)}
    return neighbor_list(frame, 4.0)


@functools.lru_cache(maxsize=None)
def _mega_bwd_tables(model):
    """The mega path of ``model`` on ``fused_infer`` (float64, the CPU's plain
    versions): one force call on a tiny crystal, with ``bwd_fused`` spied
    on. Returns the model's layers and the (paths, scatter_paths) of each
    ``bwd_fused`` call."""
    kw, n = MODELS[model]
    m = AllegroModel(r_max=4.0, type_names=["A", "B"], num_scalar_features=8,
                     num_tensor_features=4, avg_num_neighbors=10.0, model_dtype="float64",
                     tp_kernel_backend="fused_infer", **kw).init(0)
    assert m.module.allegro.mega
    seen = []
    real = fused_tp.bwd_fused

    def spy(*args, **kwargs):
        seen.append((kwargs.get("paths"), kwargs.get("scatter_paths")))
        return real(*args, **kwargs)

    fused_tp.bwd_fused = spy
    try:
        data = to_torch(m.precompute_statics(batch_frames([_frame()], n_frames=1)),
                        dtype=torch.float64)
        out = m.apply_with_derivatives(data)
    finally:
        fused_tp.bwd_fused = real
    assert torch.isfinite(out[keys.FORCES]).all()
    layers = [t for t in m.module.modules() if isinstance(t, Contracter)]
    assert len(layers) == n
    return layers, seen


@pytest.mark.parametrize("model,layer", LAYERS, ids=IDS)
def test_fused_infer_calls_pass_the_bwd_tables(model, layer, monkeypatch):
    """``fused_layer_infer`` (``use_mega=False``'s layers, through
    ``fused_call``) and ``gather_tp_infer`` (the mega path's layers after the
    first; layer 0 runs ``bwd_embed``) give ``bwd_fused`` the layer's role
    swap's table and its (0, 2, 1) table, the ones ``infer_paths`` names."""
    tp = _layers(model, "fused_infer", "float64")[layer]
    paths, swapped, scatter = tp.infer_paths()
    assert paths is tp.gather_paths()[0] and swapped is tp.gather_paths()[1]
    assert scatter is tp.scatter_paths()[0]
    seen = []
    real = fused_tp.bwd_fused

    def spy(*args, **kwargs):
        seen.append((kwargs.get("paths"), kwargs.get("scatter_paths")))
        return real(*args, **kwargs)

    monkeypatch.setattr(fused_tp, "bwd_fused", spy)
    centers, n_atoms = _degree_graph([3, 0, 2], 2)
    row_ptr = torch.as_tensor(fused_tp.csr_row_ptr(centers.numpy(), n_atoms))
    E, U = centers.shape[0], tp.mul
    rng = np.random.RandomState(layer)
    x = torch.as_tensor(rng.randn(E, tp.d1 * U)).requires_grad_()
    sh = torch.as_tensor(rng.randn(E, tp.d2))
    wexp = torch.as_tensor(rng.randn(E, tp.n_irr * U))
    tp.fused_call(x, sh, wexp, centers, row_ptr).sum().backward()
    assert len(seen) == 1 and seen[0][0] is swapped and seen[0][1] is scatter
    layers, mega_seen = _mega_bwd_tables(model)
    assert len(mega_seen) == len(layers) - 1
    mega = layers[layer]
    want = (mega.gather_paths()[1], mega.scatter_paths()[0])
    hits = sum(p is want[0] and q is want[1] for p, q in mega_seen)
    assert hits == (layer > 0)


def _emulate_unweight_w(t, sh, centers, dim_to_irr, n_atoms, n_irr, tile, n_stage):
    """unweight_w's tile schedule in plain float64: per ``tile``-edge tile
    (the last partial), its sh rows and the t rows of :func:`_tile_stage`
    staged; each irrep's dims the
    run [first, end) of its id in ``dim_to_irr``; thread item q of the tile
    = (edge el, group v of 4 channels, or of 1 where U is not a multiple of
    4), el found as the kernel finds it, by a float32 reciprocal; per irrep
    r, the sum over r's dims, in order, of sh times the t row, stored at its
    place in the tile's one output range; sentinel edges zero. Returns
    dwexp and how many items read an unstaged row."""
    E, d2 = sh.shape
    U = t.shape[1] // d2
    vec = 4 if U % 4 == 0 else 1
    per_irr = U // vec
    inv_irr = np.float32(1.0) / np.float32(per_irr)
    nU = n_irr * U
    d2i = [int(r) for r in dim_to_irr]
    first, end = {}, {}
    for j, r in enumerate(d2i):
        if j == 0 or d2i[j - 1] != r:
            first[r] = j
        if j == d2 - 1 or d2i[j + 1] != r:
            end[r] = j + 1
    t_np, sh_np, c_np = t.numpy(), sh.numpy(), centers.numpy()
    out = np.full(E * nU, np.nan)
    unstaged = 0
    for e0 in range(0, E, tile):
        n_e = min(tile, E - e0)
        s_sh = sh_np[e0:e0 + n_e].copy()
        c_lo, n_c = _tile_stage(c_np, e0, n_e, n_atoms, n_stage)
        s_t = t_np[c_lo:c_lo + n_c].copy() if n_c else None
        for q in range(n_e * per_irr):
            el = int((np.float32(q) + np.float32(0.5)) * inv_irr)
            assert el == q // per_irr
            v = q - el * per_irr
            c = int(c_np[e0 + el])
            real = 0 <= c < n_atoms
            if real:
                staged = 0 <= c - c_lo < n_c
                unstaged += not staged
                tr = s_t[c - c_lo] if staged else t_np[c]
            for r in range(n_irr):
                acc = np.zeros(vec)
                for j in range(first[r], end[r] if real else first[r]):
                    acc = acc + s_sh[el, j] * tr[j * U + v * vec:j * U + (v + 1) * vec]
                at = (e0 + el) * nU + r * U + v * vec
                assert np.isnan(out[at:at + vec]).all(), "an output is stored twice"
                out[at:at + vec] = acc
    return torch.as_tensor(out.reshape(E, nU)), unstaged


@pytest.mark.parametrize("tile,n_stage", SH_SCHEDULES,
                         ids=[f"tile{a}-staged{b}" for a, b in SH_SCHEDULES])
@pytest.mark.parametrize("U", [3, 8])
@pytest.mark.parametrize("model,layer", LAYERS, ids=IDS)
def test_unweight_w_tile_schedule_equals_the_plain_version(model, layer, U, tile, n_stage):
    """float64, 75 edges: whole tiles and a partial one, tiles over more
    centers than are staged, an atom without edges, 5 sentinel edges (sh
    large there)."""
    tp = _layers(model, "fused", "float64")[layer]
    centers, n_atoms = _degree_graph([9, 3, 0, 7, 5, 6, 4, 12, 10, 14], 5)
    E = centers.shape[0]
    rng = np.random.RandomState(50 + U)
    t = torch.as_tensor(rng.randn(n_atoms, tp.d2 * U))
    sh = torch.as_tensor(rng.randn(E, tp.d2))
    sh[E - 5:] *= 1e6
    want = fused_tp.unweight_w_reference(t, sh, centers, tp.dim_to_irr, tp.n_irr)
    got, unstaged = _emulate_unweight_w(t, sh, centers, tp.dim_to_irr, n_atoms, tp.n_irr, tile,
                                        n_stage)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    assert unstaged > 0 and (got[E - 5:] == 0).all()


@pytest.mark.parametrize("tile,n_stage", SH_SCHEDULES,
                         ids=[f"tile{a}-staged{b}" for a, b in SH_SCHEDULES])
@pytest.mark.parametrize("U", [3, 8])
@pytest.mark.parametrize("model,layer", LAYERS, ids=IDS)
def test_unweight_both_tile_schedule_equals_the_plain_version(model, layer, U, tile, n_stage):
    """unweight_both's schedule: unweight_sh's dots and unweight_w's items
    on one tile schedule (one staged set of t rows per tile, both outputs
    read from it) equal ``unweight_both_reference`` at 1e-12; float64, the
    75 edges of the two tests above, wexp and sh large on the 5 sentinel
    edges, whose dsh and dwexp rows are zero."""
    tp = _layers(model, "fused", "float64")[layer]
    centers, n_atoms = _degree_graph([9, 3, 0, 7, 5, 6, 4, 12, 10, 14], 5)
    E = centers.shape[0]
    rng = np.random.RandomState(70 + U)
    t = torch.as_tensor(rng.randn(n_atoms, tp.d2 * U))
    sh = torch.as_tensor(rng.randn(E, tp.d2))
    wexp = torch.as_tensor(rng.randn(E, tp.n_irr * U))
    sh[E - 5:] *= 1e6
    wexp[E - 5:] *= 1e6
    want = fused_tp.unweight_both_reference(t, sh, wexp, centers, tp.dim_to_irr)
    dsh, unstaged_sh = _emulate_unweight_sh(t, wexp, centers, tp.dim_to_irr, n_atoms, tile,
                                            n_stage)
    dwexp, unstaged_w = _emulate_unweight_w(t, sh, centers, tp.dim_to_irr, n_atoms, tp.n_irr,
                                            tile, n_stage)
    for got, ref in zip((dsh, dwexp), want):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-12)
        assert (got[E - 5:] == 0).all()
    # the same edges read unstaged rows in both phases: per (edge, dim) and per
    # (edge, channel group)
    vec = 4 if U % 4 == 0 else 1
    assert unstaged_sh > 0 and unstaged_sh // tp.d2 == unstaged_w // (U // vec)
