"""The center gathers and the fused readout (kernels 5, 6, 11, 12), through
their plain versions (the CPU path).

- Each plain version against the JAX function that runs the Pallas kernel it
  replaces, in interpret mode on the same inputs (float64 at 1e-10, float32
  at 1e-5): ``center_gather`` / ``center_sum`` against JAX's
  ``center_gather`` / ``center_scatter`` on plans from ``make_block_plan_np``
  (the neighbor side through the neighbor-sorted plan), ``readout_sum``
  against ``readout_sum_infer`` and ``readout_bwd`` against ``jax.vjp`` of
  it. Atoms 20-23 have no edges and the edge list ends in sentinel padding.
  JAX's center kernels need every atom up to the last center to have edges
  (its rank-identity condition), so atoms without edges between others are
  checked against a plain loop instead.
- The ``autograd.Function``s: ``gradcheck`` in float64, the gather and the
  scatter as each other's transpose, the readout's backward against
  autograd of the plain chain, NaN weight gradients.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from allegro_tpu.ops import fused_primitives as jax_fp
from allegro_tpu.ops import fused_tp as jax_ftp

from allegro_tpu_torch.ops import fused_tp
from allegro_tpu_torch.ops.fused_primitives import (
    center_gather, center_scatter, readout_sum_infer,
)

EB = 128
N_ATOMS = 24
E_REAL = 150
EP = 256
S = 8
TOL = {"float64": 1e-10, "float32": 1e-5}


def _graph(seed=0):
    """Centers sorted over atoms 0-19 (each at least once), neighbors over
    all 24 atoms (each at least once), sentinel padding to EP edges."""
    rng = np.random.RandomState(seed)
    centers = np.sort(np.concatenate([np.arange(20), rng.randint(0, 20, E_REAL - 20)]))
    neighbors = np.concatenate([rng.permutation(N_ATOMS), rng.randint(0, N_ATOMS, E_REAL - 24)])
    pad = np.full(EP - E_REAL, N_ATOMS)
    return (np.concatenate([centers, pad]).astype(np.int32),
            np.concatenate([neighbors, pad]).astype(np.int32))


def _arr(rng, dt, *shape, sentinel_zero=True):
    a = rng.randn(*shape).astype(dt)
    if sentinel_zero:
        a[E_REAL:] = 0.0
    return a


def _close(got, want, dtype_name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL[dtype_name] * scale, f"max abs err {err:.3e} (scale {scale:.3e})"


@pytest.fixture(scope="module")
def interpret():
    old = jax_ftp.INTERPRET
    jax_ftp.INTERPRET = True
    yield
    jax_ftp.INTERPRET = old


@pytest.fixture(scope="module")
def graph():
    centers, neighbors = _graph()
    perm, nbr_row_ptr = fused_tp.neighbor_csr(neighbors, N_ATOMS)
    return dict(
        centers=centers, neighbors=neighbors, perm=perm,
        row_ptr=fused_tp.csr_row_ptr(centers, N_ATOMS), nbr_row_ptr=nbr_row_ptr,
        plan=jax_ftp.make_block_plan_np(centers, EB, N_ATOMS)[:2],
        nbr_plan=jax_ftp.make_block_plan_np(neighbors[perm], EB, N_ATOMS)[:2],
    )


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_neighbor_csr_lists_each_atoms_incoming_edges(graph):
    perm, rp = graph["perm"], graph["nbr_row_ptr"]
    for a in range(N_ATOMS):
        edges = perm[rp[a]:rp[a + 1]]
        np.testing.assert_array_equal(edges, np.flatnonzero(graph["neighbors"] == a))
    assert rp[N_ATOMS] == E_REAL and (graph["neighbors"][perm[E_REAL:]] == N_ATOMS).all()


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_center_gather_matches_pallas(graph, interpret, dtype_name):
    rng = np.random.RandomState(1)
    a = rng.randn(N_ATOMS, 3).astype(dtype_name) * 10.0
    win, offs = graph["plan"]
    want = jax_fp.center_gather(jnp.asarray(a), offs, win, eb=EB, n_edges=EP, passes=3)
    got = fused_tp.center_gather(_t(a), _t(graph["centers"]))
    assert got.dtype == getattr(torch, dtype_name)
    _close(got[:E_REAL], np.asarray(want)[:E_REAL], dtype_name)
    # exact: the gather is a copy, and sentinel edges read zero rows
    np.testing.assert_array_equal(got[:E_REAL].numpy(), a[graph["centers"][:E_REAL]])
    assert (got[E_REAL:] == 0).all()


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_center_sum_matches_pallas(graph, interpret, dtype_name):
    rng = np.random.RandomState(2)
    v = _arr(rng, dtype_name, EP, 3)
    win, offs = graph["plan"]
    want = jax_fp.center_scatter(jnp.asarray(v), offs, win, eb=EB, n_atoms=N_ATOMS, passes=3)
    got = fused_tp.center_sum(_t(v), _t(graph["row_ptr"]))
    _close(got, want, dtype_name)
    assert (got[20:] == 0).all()
    # the neighbor side: JAX scatters the neighbor-sorted rows over its own plan
    win2, offs2 = graph["nbr_plan"]
    want = jax_fp.center_scatter(jnp.asarray(v[graph["perm"]]), offs2, win2, eb=EB,
                                 n_atoms=N_ATOMS, passes=3)
    got = fused_tp.center_sum(_t(v), _t(graph["nbr_row_ptr"]), _t(graph["perm"]))
    _close(got, want, dtype_name)


def test_center_ops_with_gaps_match_a_loop():
    """Atoms without edges anywhere (here 0, 7 and 23) and nonzero values on
    sentinel edges, which the sum must drop and the gather must not read."""
    rng = np.random.RandomState(3)
    atoms = [a for a in range(N_ATOMS) if a not in (0, 7, 23)]
    centers = np.sort(np.concatenate([atoms, rng.choice(atoms, 60)]))
    centers = np.concatenate([centers, np.full(20, N_ATOMS)]).astype(np.int32)
    neighbors = rng.choice(atoms + [N_ATOMS], centers.size).astype(np.int32)
    v = rng.randn(centers.size, 2)
    a = rng.randn(N_ATOMS, 2)
    for idx in (centers, neighbors):
        perm, rp = fused_tp.neighbor_csr(idx, N_ATOMS)
        want = np.zeros((N_ATOMS, 2))
        for e, i in enumerate(idx):
            if i < N_ATOMS:
                want[i] += v[e]
        got = fused_tp.center_sum(_t(v), _t(rp), _t(perm))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)
        gathered = fused_tp.center_gather(_t(a), _t(idx)).numpy()
        np.testing.assert_array_equal(gathered, np.where((idx < N_ATOMS)[:, None],
                                                         a[np.minimum(idx, N_ATOMS - 1)], 0.0))
    rp = fused_tp.csr_row_ptr(centers, N_ATOMS)
    got = fused_tp.center_sum(_t(v), _t(rp))
    np.testing.assert_allclose(got.numpy()[[0, 7, 23]], 0.0)


def _readout_inputs(rng, dtype_name, n_hidden, H):
    pieces = [_arr(rng, dtype_name, EP, S) for _ in range(3)]
    K = 3 * S
    if n_hidden:
        w0 = (rng.randn(K, H) / np.sqrt(K)).astype(dtype_name)
        w1 = (rng.randn(H, 1) / np.sqrt(H)).astype(dtype_name)
    else:
        w0 = (rng.randn(K, 1) / np.sqrt(K)).astype(dtype_name)
        w1 = None
    return pieces, w0, w1


def _jax_readout(graph, pieces, w0, w1, n_hidden):
    win, offs = graph["plan"]

    def f(ps):
        return jax_fp.readout_sum_infer(
            tuple(ps), jnp.asarray(w0), None if w1 is None else jnp.asarray(w1), offs, win,
            EB, jax_ftp.num_rank_rows(N_ATOMS, EB), N_ATOMS, n_hidden,
        )
    return f


READOUT_CASES = [(1, 12, "float64"), (1, 40, "float64"), (0, 1, "float64"), (1, 12, "float32")]


@pytest.mark.parametrize("n_hidden,H,dtype_name", READOUT_CASES,
                         ids=[f"hidden{n}-H{h}-{d}" for n, h, d in READOUT_CASES])
def test_readout_sum_and_bwd_match_pallas(graph, interpret, n_hidden, H, dtype_name):
    rng = np.random.RandomState(4 + H)
    pieces, w0, w1 = _readout_inputs(rng, dtype_name, n_hidden, H)
    f = _jax_readout(graph, pieces, w0, w1, n_hidden)
    want, vjp = jax.vjp(f, [jnp.asarray(p) for p in pieces])
    tp = [_t(p) for p in pieces]
    tw1 = None if w1 is None else _t(w1)
    got = fused_tp.readout_sum(tp, _t(w0), tw1, _t(graph["row_ptr"]))
    assert got.shape == (N_ATOMS, 1)
    _close(got, want, dtype_name)
    assert (got[20:] == 0).all()
    y = rng.randn(N_ATOMS, 1).astype(dtype_name)
    (want_dp,) = vjp(jnp.asarray(y))
    got_dp = fused_tp.readout_bwd(tp, _t(w0), tw1, _t(y), _t(graph["centers"]))
    for g, w in zip(got_dp, want_dp):
        # JAX reads a garbage rank row on sentinel edges; the port writes zeros
        _close(g[:E_REAL], np.asarray(w)[:E_REAL], dtype_name)
        assert (g[E_REAL:] == 0).all()


def test_readout_reads_column_slices_in_place(graph):
    """The pieces are column slices of wider arrays (as the scalar track's
    are); only their rows are read."""
    rng = np.random.RandomState(5)
    pieces, w0, w1 = _readout_inputs(rng, "float64", 1, 12)
    wide = [torch.cat([_t(p), torch.randn(EP, 5, dtype=torch.float64)], 1) for p in pieces]
    views = [w[:, :S] for w in wide]
    assert not views[0].is_contiguous()
    a = fused_tp.readout_sum(views, _t(w0), _t(w1), _t(graph["row_ptr"]))
    b = fused_tp.readout_sum([_t(p) for p in pieces], _t(w0), _t(w1), _t(graph["row_ptr"]))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("side", ["center", "neighbor"])
def test_center_functions_gradcheck_and_transpose(graph, side):
    idx = _t(graph["centers"] if side == "center" else graph["neighbors"])
    rp = _t(graph["row_ptr"] if side == "center" else graph["nbr_row_ptr"])
    perm = None if side == "center" else _t(graph["perm"])
    rng = np.random.RandomState(6)
    a = torch.as_tensor(rng.randn(N_ATOMS, 3), dtype=torch.float64).requires_grad_(True)
    v = torch.as_tensor(_arr(rng, "float64", EP, 3)).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda x: center_gather(x, idx, rp, perm), (a,))
    assert torch.autograd.gradcheck(lambda x: center_scatter(x, idx, rp, perm), (v,))
    assert torch.autograd.gradgradcheck(lambda x: center_gather(x, idx, rp, perm), (a,))
    assert torch.autograd.gradgradcheck(lambda x: center_scatter(x, idx, rp, perm), (v,))
    # gather's backward is center_sum, center_sum's backward is the gather
    g_e = torch.as_tensor(rng.randn(EP, 3))
    g_a = torch.as_tensor(rng.randn(N_ATOMS, 3))
    (ga,) = torch.autograd.grad(center_gather(a, idx, rp, perm), a, g_e)
    torch.testing.assert_close(ga, fused_tp.center_sum(g_e, rp, perm), rtol=0, atol=0)
    (gv,) = torch.autograd.grad(center_scatter(v, idx, rp, perm), v, g_a)
    torch.testing.assert_close(gv, fused_tp.center_gather(g_a, idx), rtol=0, atol=0)


@pytest.mark.parametrize("n_hidden", [0, 1])
def test_readout_sum_infer_backward_and_nan_weight_grads(graph, n_hidden):
    rng = np.random.RandomState(7)
    pieces, w0, w1 = _readout_inputs(rng, "float64", n_hidden, 12)
    ps = [_t(p).requires_grad_(True) for p in pieces]
    tw0 = _t(w0).requires_grad_(True)
    tw1 = None if w1 is None else _t(w1).requires_grad_(True)
    centers = _t(graph["centers"])
    y = torch.as_tensor(rng.randn(N_ATOMS, 1))
    out = readout_sum_infer(ps, tw0, tw1, centers, _t(graph["row_ptr"]))
    (out * y).sum().backward()
    assert torch.isnan(tw0.grad).all() and (tw1 is None or torch.isnan(tw1.grad).all())
    # the plain chain: readout MLP per edge, then the edge sum
    ref = [_t(p).requires_grad_(True) for p in pieces]
    h = torch.cat(ref, 1) @ _t(w0)
    e = h if w1 is None else torch.nn.functional.silu(h) @ _t(w1)
    energy = fused_tp.segment_sum(e, centers, N_ATOMS)
    torch.testing.assert_close(out.detach(), energy.detach(), rtol=0, atol=1e-12)
    (energy * y).sum().backward()
    for p, r in zip(ps, ref):
        torch.testing.assert_close(p.grad[:E_REAL], r.grad[:E_REAL], rtol=0, atol=1e-12)
        assert (p.grad[E_REAL:] == 0).all()


def test_new_wrappers_check_shapes(graph):
    rng = np.random.RandomState(8)
    pieces, w0, w1 = _readout_inputs(rng, "float64", 1, 12)
    tp = [_t(p) for p in pieces]
    rp, centers = _t(graph["row_ptr"]), _t(graph["centers"])
    with pytest.raises(ValueError, match="readout shapes"):
        fused_tp.readout_sum(tp, _t(w0)[:-1], _t(w1), rp)
    with pytest.raises(ValueError, match="readout shapes"):
        fused_tp.readout_sum(tp, _t(w0), None, rp)
    with pytest.raises(ValueError, match="at most 16 pieces"):
        many = [tp[0][:, :1]] * 17
        fused_tp.readout_sum(many, torch.zeros(17, 12, dtype=torch.float64), _t(w1), rp)
    with pytest.raises(ValueError, match="center_sum shapes"):
        fused_tp.center_sum(_t(pieces[0]), rp, _t(graph["perm"])[:-1])
    with pytest.raises(ValueError, match="center_gather shapes"):
        fused_tp.center_gather(_t(pieces[0])[0], centers)
    with pytest.raises(ValueError, match="readout_bwd"):
        fused_tp.readout_bwd(tp, _t(w0), _t(w1), torch.zeros(N_ATOMS), centers)
    fused_tp.reset_launch_counts()
    fused_tp.center_gather(torch.zeros(N_ATOMS, 3), centers)
    fused_tp.readout_bwd(tp, _t(w0), _t(w1), torch.zeros(N_ATOMS, 1, dtype=torch.float64),
                         centers)
    assert fused_tp.LAUNCHES == {k: 0 for k in fused_tp.LAUNCHES}
