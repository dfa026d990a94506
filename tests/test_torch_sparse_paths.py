"""The path tables that the ``pallas`` kernels walk (``csrc/sparse_tp.cu``),
on the CPU.

Every ``pallas`` layer of the flagship, l_max 3, ``parity=False`` at 3
layers, the 3-layer l_max-3 model (dims 31) and the l_max-4 model (paths
beyond the compiled header), in each of the six role orders
(``Contracter.tp_statics().paths[r]``), each case a test of its own:

- the rows, their scales and ``gen_cg_blocks.cg_block`` rebuild the order's
  dense CG tensor at 1e-12, every entry covered exactly once;
- the rows are in the kernels' walk order: by output slice, then path; the
  slices are disjoint and at most ``SLICE_MAX`` rows wide;
- ``DEFAULT`` rows (walked entry by entry) stand for paths with some l > 3,
  and only for those;
- a plain float64 emulation of each kernel's walk (``sparse_tp``: output
  slices summed in a register-sized accumulator and stored once, rows no
  path writes stored as zeros; ``sparse_tp_gradw``: per row, the block's
  output dotted with the cotangent slice) equals the plain versions at
  1e-12.

And the float32 trap: the tables come from the float64 entries, and
``path_table`` on the model-dtype ``tp_coef`` of a float32 layer raises.
The kernels themselves run only on the card (``chip_smoke.py`` phase 6a).
"""

import functools

import numpy as np
import pytest
import torch

from allegro_tpu_torch.model import AllegroModel
from allegro_tpu_torch.nn.contract import Contracter, sparse_entries
from allegro_tpu_torch.ops import gen_cg_blocks, pallas_contract
from allegro_tpu_torch.ops.pallas_contract import ROLES, role_tables
from torch_threads import one_thread  # noqa: F401

MODELS = {
    "flagship": (dict(l_max=2), 2),
    "lmax3": (dict(l_max=3), 2),
    "parity_false_3layers": (dict(l_max=2, parity=False, num_layers=3), 3),
    "lmax3_3layers": (dict(l_max=3, num_layers=3), 3),
    "lmax4": (dict(l_max=4), 2),
}
CASES = [(m, layer, r) for m, (_, n) in MODELS.items() for layer in range(n)
         for r in range(len(ROLES))]
IDS = [f"{m}-layer{layer}-{''.join(map(str, ROLES[r]))}" for m, layer, r in CASES]


@functools.lru_cache(maxsize=None)
def _layers(model):
    kw, n = MODELS[model]
    m = AllegroModel(r_max=4.0, type_names=["A", "B"], num_scalar_features=8,
                     num_tensor_features=4, avg_num_neighbors=10.0, model_dtype="float64",
                     tp_kernel_backend="pallas", **kw)
    layers = [t for t in m.module.modules() if isinstance(t, Contracter)]
    assert len(layers) == n
    return layers


def _case(model, layer, r):
    """The layer, its table in role order r (idx, float64 coef), the order's
    path table and dims."""
    tp = _layers(model)[layer]
    st = tp.tp_statics()
    dims = tuple(st.dims[s] for s in ROLES[r])
    return tp, st.table(r), st.walk(r), dims


def _ls(idx):
    """The l's of one path's entries: half their spans in i, j and k."""
    span = idx[:, :3].max(0) - idx[:, :3].min(0)
    return tuple(int(s) // 2 for s in span)


@pytest.mark.parametrize("model,layer,r", CASES, ids=IDS)
def test_rows_rebuild_the_dense_table(model, layer, r):
    tp, (idx, coef), paths, (d1, d2, d3) = _case(model, layer, r)
    P = tp.num_paths
    want = np.zeros((P, d1, d2, d3))
    want[tuple(idx[:, [3, 0, 1, 2]].long().T)] = coef.numpy()
    got, covered = np.zeros_like(want), np.zeros(want.shape, dtype=int)
    e_idx, e_coef = paths.entry_idx.long().numpy(), paths.entry_coef.numpy()
    for q, (p, tid, i0, j0, k0, n0, n1, width) in enumerate(paths.desc.tolist()):
        if tid == gen_cg_blocks.DEFAULT:
            for n in range(n0, n1):
                i, j, k = e_idx[n, :3]
                if k0 <= k < k0 + width:
                    got[p, i, j, k] += e_coef[n]
                    covered[p, i, j, k] += 1
            continue
        block = gen_cg_blocks.cg_block(*gen_cg_blocks.TRIPLES[tid])
        a, b, c = block.shape
        assert width == c
        got[p, i0:i0 + a, j0:j0 + b, k0:k0 + c] += float(paths.scale[q]) * block
        covered[p, i0:i0 + a, j0:j0 + b, k0:k0 + c] += block != 0.0
    np.testing.assert_array_equal(covered, (want != 0.0).astype(int))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("model,layer,r", CASES, ids=IDS)
def test_rows_are_in_walk_order(model, layer, r):
    _, _, paths, (_, _, d3) = _case(model, layer, r)
    rows = paths.desc.tolist()
    keys = [(row[4], row[0]) for row in rows]
    assert keys == sorted(keys) and len(set(keys)) == len(keys)
    slices = sorted({(row[4], row[7]) for row in rows})
    assert len({k0 for k0, _ in slices}) == len(slices), "one slice, two widths"
    for (k0, w0), (k1, _) in zip(slices, slices[1:]):
        assert k0 + w0 <= k1, "output slices overlap"
    assert all(1 <= w <= gen_cg_blocks.SLICE_MAX for _, w in slices)
    assert slices[-1][0] + slices[-1][1] <= d3


@pytest.mark.parametrize("model,layer,r", CASES, ids=IDS)
def test_default_rows_only_beyond_the_header(model, layer, r):
    _, _, paths, _ = _case(model, layer, r)
    e_idx = paths.entry_idx.long().numpy()
    for p, tid, i0, j0, k0, n0, n1, width in paths.desc.tolist():
        ls = _ls(e_idx[n0:n1])
        if tid == gen_cg_blocks.DEFAULT:
            assert max(ls) > gen_cg_blocks.L_MAX, (p, ls)
        else:
            assert gen_cg_blocks.TRIPLES[tid] == ls and max(ls) <= gen_cg_blocks.L_MAX
    beyond = (paths.desc[:, 1] == gen_cg_blocks.DEFAULT).any().item()
    assert beyond == (model == "lmax4")


def _emulate_tp(a, b, w, paths, d3):
    """sparse_tp's walk in plain float64: each output slice summed over its
    rows in an accumulator of SLICE_MAX rows, then stored once; rows of out
    that no slice covers stored as zeros. Unstored rows stay NaN."""
    E, U = a.shape[0], w.shape[1]
    av, bv = a.view(E, -1, U), b.view(E, -1, U)
    out = torch.full((E, d3, U), float("nan"), dtype=a.dtype)
    acc = None
    k0, width, nxt = -1, 0, 0

    def store(k0, width):
        assert torch.isnan(out[:, k0:k0 + width]).all(), "a slice is stored twice"
        out[:, k0:k0 + width] = acc[:, :width]
        return k0 + width

    for q, (p, tid, i0, j0, s0, n0, n1, wd) in enumerate(paths.desc.tolist()):
        if s0 != k0:
            if k0 >= 0:
                nxt = store(k0, width)
            k0, width = s0, wd
            out[:, nxt:k0] = 0.0
            acc = a.new_zeros((E, gen_cg_blocks.SLICE_MAX, U))
        ws = w[p] * paths.scale[q]
        if tid == gen_cg_blocks.DEFAULT:
            for n in range(n0, n1):
                i, j, k = paths.entry_idx[n, :3].tolist()
                if 0 <= k - k0 < width:
                    acc[:, k - k0] += paths.entry_coef[n] * ws * av[:, i] * bv[:, j]
            continue
        C = torch.as_tensor(gen_cg_blocks.cg_block(*gen_cg_blocks.TRIPLES[tid]))
        na, nb, nc = C.shape
        acc[:, :nc] += torch.einsum("abc,eau,ebu->ecu", C, ws * av[:, i0:i0 + na],
                                    bv[:, j0:j0 + nb])
    nxt = store(k0, width)
    out[:, nxt:] = 0.0
    assert not torch.isnan(out).any(), "a row of out is never stored"
    return out.reshape(E, d3 * U)


def _emulate_gradw(a, b, g, paths, P, U):
    """sparse_tp_gradw's walk in plain float64: per row, the block's output
    on the a and b slices dotted with g's slice, times the scale."""
    E = a.shape[0]
    av, bv, gv = a.view(E, -1, U), b.view(E, -1, U), g.view(E, -1, U)
    gw = a.new_zeros((P, U))
    for q, (p, tid, i0, j0, k0, n0, n1, wd) in enumerate(paths.desc.tolist()):
        if tid == gen_cg_blocks.DEFAULT:
            for n in range(n0, n1):
                i, j, k = paths.entry_idx[n, :3].tolist()
                if 0 <= k - k0 < wd:
                    gw[p] += paths.entry_coef[n] * (av[:, i] * bv[:, j] * gv[:, k]).sum(0)
            continue
        C = torch.as_tensor(gen_cg_blocks.cg_block(*gen_cg_blocks.TRIPLES[tid]))
        na, nb, nc = C.shape
        t = torch.einsum("abc,eau,ebu->ecu", C, av[:, i0:i0 + na], bv[:, j0:j0 + nb])
        gw[p] += paths.scale[q] * (t * gv[:, k0:k0 + nc]).sum((0, 1))
    return gw


@pytest.mark.parametrize("model,layer,r", CASES, ids=IDS)
def test_walk_equals_the_plain_versions(model, layer, r):
    """Both kernels' walks on this order's rows, float64, U = 3, 11 edges."""
    tp, (idx, coef), paths, (d1, d2, d3) = _case(model, layer, r)
    P, U, E = tp.num_paths, 3, 11
    rng = np.random.RandomState(100 + r)
    a, b, g = (torch.as_tensor(rng.randn(E, d * U)) for d in (d1, d2, d3))
    w = torch.as_tensor(rng.randn(P, U))
    want = pallas_contract.sparse_tp_reference(a, b, w, idx, coef, d3)
    torch.testing.assert_close(_emulate_tp(a, b, w, paths, d3), want, rtol=0, atol=1e-12)
    want_gw = pallas_contract.sparse_tp_gradw_reference(a, b, g, idx, coef, P, U)
    torch.testing.assert_close(_emulate_gradw(a, b, g, paths, P, U), want_gw, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("r", range(len(ROLES)), ids=lambda r: "".join(map(str, ROLES[r])))
def test_paths_come_from_the_float64_entries(r):
    """A float32 layer keeps its role tables in float32 (the plain versions'
    dtype), and those are no CG block to 1e-12: path_table refuses them. Its
    path tables are the float64 entries' (scales cast to float32)."""
    L2 = "1x0e+1x1o+1x2e"
    tp = Contracter(L2, L2, L2, mul=4, kernel_backend="pallas", dtype=torch.float32)
    assert tp.tp_coef.dtype == torch.float32
    with pytest.raises(ValueError, match="not a multiple of the CG block"):
        gen_cg_blocks.path_table(tp.tp_idx[r], tp.tp_coef[r])
    idx64, coef64 = role_tables(sparse_entries(tp.w3j.numpy()), torch.float64)
    want = gen_cg_blocks.path_table(idx64[r], coef64[r], torch.float32, by_output=True)
    got = tp.tp_statics().walk(r)
    for name, x, y in zip(want._fields, got, want):
        assert x.dtype == y.dtype and torch.equal(x, y), name
    assert got.scale.dtype == torch.float32 and got.entry_coef.dtype == torch.float32
