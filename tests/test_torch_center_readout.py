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
- ``readout_bwd``'s tile schedule (``csrc/center_readout.cu``), emulated in
  float64, against the plain version at 1e-12: tiles of 64 edges (and 16,
  the launcher's back-off for wide pieces) over a persistent grid, the last
  one partial, the piece rows staged with zero padding columns (rows a tile
  does not load keep what they held), ``dh`` selected to zero on sentinel
  edges, ``dp = dh W0ᵀ`` in chunks of 32 hidden units, stored once per
  element in float4 groups of columns within one piece where every piece
  is a multiple of 4 wide, else column by column; pieces as column slices
  and of odd widths (5, 3, 17), H = 20, 32 and 64 and no hidden layer,
  large pieces on a sentinel block.
- ``center_gather``'s work split and ``center_sum``'s summation orders
  (``csrc/center_readout.cu``), emulated in float64 against the plain
  versions, at C = 1, 3, 32, 288 and 1,024 on an odd edge count with atoms
  without edges and nonzero sentinel rows: the gather's narrow (a warp per
  32 edges) and per-row forms, each output stored once; the sum's lanes and butterfly (narrow rows) and
  edge order (wide), both sides; the chunked sum's two passes over a class
  CSR with an empty row and with one row holding every position, each
  partial written once before it is read.
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
from torch_threads import one_thread  # noqa: F401

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


def _col_chunks(width):
    """common.cu's col_chunks: (TN, first column) of each chunk of 64 columns
    (8 a thread) while they last, then of 32 (4 a thread)."""
    chunks, c0 = [], 0
    while c0 + 64 <= width:
        chunks.append((8, c0))
        c0 += 64
    while c0 < width:
        chunks.append((4, c0))
        c0 += 32
    return chunks


def _round_up(x, m):
    return (x + m - 1) // m * m


def _emulate_readout_bwd(pieces, w0, w1, y, centers, n_atoms, rows, n_blocks):
    """readout_bwd's schedule in plain float64: ``n_blocks`` blocks each walk
    the tiles b, b + n_blocks, ... of ``rows`` edges with their own piece
    buffer [rows][ldK] (NaN until loaded, padding columns zero; a partial
    tile leaves its last rows as they were); W0ᵀ zero-padded to [Hr][ldK];
    ``pre`` over the first round_up(K, 4) columns in ``_col_chunks(H)``'s
    chunks of hidden units; ``dh = y[c] w1 silu'(pre)`` (``y[c]`` without a
    hidden layer) selected to zero where the row is a sentinel or past the
    edges; ``dp = dh W0ᵀ`` in chunks of 32 hidden units (dh zero past H);
    the column groups 4 tx + 32 n, each stored once: as one float4 inside
    one piece where every piece is a multiple of 4 wide, else column by
    column, never at or past K."""
    E, dims = centers.shape[0], [p.shape[1] for p in pieces]
    offs = np.concatenate([[0], np.cumsum(dims)]).astype(int)
    K, H = int(offs[-1]), w0.shape[1]
    ldK, Hr, Kd = _round_up(K, 32) + 4, _round_up(H, 32), _round_up(K, 4)
    w0t = np.zeros((Hr, ldK))
    w0t[:H, :K] = w0.numpy().T
    vec = all(d % 4 == 0 for d in dims)  # dpieces are contiguous: then offsets too
    p_np, c_np, y_np = [p.numpy() for p in pieces], centers.numpy(), y.numpy()[:, 0]
    out = [np.full((E, d), np.nan) for d in dims]
    n_tiles = -(-E // rows)
    for b in range(n_blocks):
        A = np.full((rows, ldK), np.nan)
        A[:, K:] = 0.0
        for tile in range(b, n_tiles, n_blocks):
            e0 = tile * rows
            n = min(rows, E - e0)
            c = np.full(rows, -1)
            c[:n] = c_np[e0:e0 + n]
            ok = (c >= 0) & (c < n_atoms)
            ye = np.where(ok, y_np[np.clip(c, 0, n_atoms - 1)], 0.0)
            if w1 is not None:
                for p, o, d in zip(p_np, offs, dims):
                    A[:n, o:o + d] = p[e0:e0 + n]
                pre = np.zeros((rows, H))
                for tn, h0 in _col_chunks(H):
                    cols = slice(h0, min(H, h0 + 8 * tn))
                    pre[:, cols] = A[:, :Kd] @ w0t[cols, :Kd].T
                with np.errstate(invalid="ignore", over="ignore"):
                    sig = 1.0 / (1.0 + np.exp(-pre))
                    dh = ye[:, None] * w1.numpy()[None, :, 0] * (sig * (1.0 + pre * (1.0 - sig)))
                dh = np.where(ok[:, None], dh, 0.0)
            else:
                dh = ye[:, None]
            dhp = np.zeros((rows, Hr))
            dhp[:, :H] = dh
            dA = sum(dhp[:, hc:hc + 32] @ w0t[hc:hc + 32] for hc in range(0, H, 32))
            for g in (4 * tx + 32 * n for tx in range(8) for n in range(-(-K // 32))):
                if g >= K:
                    continue
                cols = [g] if vec else [q for q in range(g, g + 4) if q < K]
                for q in cols:
                    i = int(np.searchsorted(offs, q, side="right")) - 1
                    width = 4 if vec else 1
                    assert q + width <= offs[i + 1], "a float4 across two pieces"
                    dst = out[i][e0:e0 + n, q - offs[i]:q - offs[i] + width]
                    assert np.isnan(dst).all(), "an output stored twice"
                    dst[...] = dA[:n, q:q + width]
    assert not any(np.isnan(o).any() for o in out), "an output never stored"
    return [torch.as_tensor(o) for o in out]


RB_LAYOUTS = {"slices": (16, 16, 16), "odd": (5, 3, 17)}
RB_HIDDEN = [20, 32, 64, None]


@pytest.mark.parametrize("hidden", RB_HIDDEN, ids=[f"H{h}" if h else "no-hidden" for h in RB_HIDDEN])
@pytest.mark.parametrize("layout", list(RB_LAYOUTS))
@pytest.mark.parametrize("rows", [64, 16], ids=["tile64", "tile16"])
def test_readout_bwd_tile_schedule_equals_the_plain_version(rows, layout, hidden):
    """203 edges (no number of tiles divides them): 180 real ones over 24
    atoms (atom 5 without edges), then a block of 23 sentinel edges whose
    pieces are large; the pieces are column slices of wider rows."""
    rng = np.random.RandomState(9 + rows)
    centers = np.sort(rng.choice([a for a in range(N_ATOMS) if a != 5], 180))
    centers = torch.as_tensor(np.concatenate([centers, np.full(23, N_ATOMS)]).astype(np.int32))
    E = centers.shape[0]
    wide = [torch.as_tensor(rng.randn(E, d + 7)) for d in RB_LAYOUTS[layout]]
    for w in wide:
        w[180:] *= 1e6
    pieces = [w[:, 3:3 + d] for w, d in zip(wide, RB_LAYOUTS[layout])]
    K = sum(RB_LAYOUTS[layout])
    H = hidden or 1
    w0 = torch.as_tensor(rng.randn(K, H) / np.sqrt(K))
    w1 = None if hidden is None else torch.as_tensor(rng.randn(H, 1) / np.sqrt(H))
    y = torch.as_tensor(rng.randn(N_ATOMS, 1))
    want = fused_tp.readout_bwd_reference(pieces, w0, w1, y, centers)
    got = _emulate_readout_bwd(pieces, w0, w1, y, centers, N_ATOMS, rows, n_blocks=3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12)
        assert (g[180:] == 0).all()


RS_THREADS, RS_COLS, RS_TM = 128, 4, 4  # csrc/center_readout.cu's kRsThreads, kRsCols, kRsTM
RS_STAGE, RS_BUFS = 32, 2  # kRsStage (the columns of K a stage loads), kRsBufs


def _first_atom_from(row_ptr, lo, hi, e):
    """The first atom a in [lo, hi) with row_ptr[a] >= e (hi if none)."""
    while lo < hi:
        mid = (lo + hi) // 2
        if row_ptr[mid] < e:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _emulate_readout_sum(pieces, w0, w1, row_ptr, threads, n_blocks, cols=RS_COLS, tm=RS_TM):
    """readout_sum's schedule in plain float64: block b of ``n_blocks`` owns
    the atoms whose first edge lies in [b E' / G, (b + 1) E' / G) (the last
    block also those at E') and walks their edges in tiles of threads / cols
    * tm rows; each tile runs, for each 32-column chunk of H, each
    32-column stage of K, loaded into the next of RS_BUFS stage buffers (NaN until
    first loaded; a partial tile leaves its last rows as they were; columns
    past K up to a multiple of 4 zero); W0ᵀ zero-padded to [Hr][ldK], w1
    padded (e_0 without a hidden layer); thread (row group, column group
    tx) sums its share of its rows' energies over its chunks' columns 32 c
    + tx + cols j in order, and the row's shares are added by an xor
    butterfly; a warp whose rows all lie past the tile's edges computes
    nothing; a thread per atom adds its rows of each tile in edge order, the
    atom that crosses a tile carried in one of two slots; energy[a] written
    once, atoms left at the end get 0."""
    dims = [p.shape[1] for p in pieces]
    K, H = sum(dims), w0.shape[1]
    rows = threads // cols * tm
    ldK, Hr = _round_up(K, 32) + 4, _round_up(H, 32)
    w0t = np.zeros((Hr, ldK))
    w0t[:H, :K] = w0.numpy().T
    W1 = np.zeros(Hr)
    W1[:H] = w1.numpy()[:, 0] if w1 is not None else np.eye(1, H)[0]
    p_np = np.concatenate([p.numpy() for p in pieces], axis=1)
    rp = row_ptr.numpy().astype(np.int64)
    n_atoms, n_edges = len(rp) - 1, int(rp[-1])
    n_st, n_ch = -(-K // RS_STAGE), -(-H // 32)
    energy = np.full(n_atoms, np.nan)
    for b in range(n_blocks):
        lo, hi = b * n_edges // n_blocks, (b + 1) * n_edges // n_blocks
        a_first = _first_atom_from(rp, 0, n_atoms, lo)
        a_end = n_atoms if b == n_blocks - 1 else _first_atom_from(rp, a_first, n_atoms, hi)
        eb, ee = rp[a_first], rp[a_end]
        bufs = [np.full((rows, RS_STAGE + 4), np.nan) for _ in range(RS_BUFS)]
        g = 0
        a_lo, carry, slot = a_first, [np.nan, np.nan], 0
        for e0 in range(eb, ee, rows):
            e1 = min(e0 + rows, ee)
            assert e1 <= n_edges, "a row past row_ptr[n_atoms]"
            shares = np.zeros((rows, cols))
            for c in range(n_ch):
                acc = np.zeros((rows, 32))
                for s_ in range(n_st):
                    c0, c1 = s_ * RS_STAGE, min(K, (s_ + 1) * RS_STAGE)
                    S = bufs[g % RS_BUFS]
                    S[:e1 - e0, :c1 - c0] = p_np[e0:e1, c0:c1]
                    S[:, c1 - c0:_round_up(c1 - c0, 4)] = 0.0
                    kd = _round_up(c1 - c0, 4)
                    with np.errstate(invalid="ignore", over="ignore"):
                        acc += S[:, :kd] @ w0t[32 * c:32 * c + 32, c0:c0 + kd].T
                    g += 1
                with np.errstate(invalid="ignore", over="ignore"):
                    f = acc / (1.0 + np.exp(-acc)) if w1 is not None else acc
                    for tx in range(cols):
                        for j in range(32 // cols):
                            h = tx + cols * j
                            shares[:, tx] += f[:, h] * W1[32 * c + h]
            with np.errstate(invalid="ignore", over="ignore"):
                o = 1
                while o < cols:  # __shfl_xor_sync, lane tx adds lane tx ^ o
                    shares = shares + shares[:, np.arange(cols) ^ o]
                    o *= 2
            En = np.where(np.arange(rows) // (32 // cols * tm) * (32 // cols * tm) < e1 - e0,
                          shares[:, 0], np.nan)  # a warp past the tile's edges computes nothing
            a_hi = _first_atom_from(rp, a_lo, a_end, e1)
            for a in range(a_lo, a_hi):
                s0, s1 = rp[a], rp[a + 1]
                s = carry[slot] if s0 < e0 else 0.0
                for r in range(max(s0, e0) - e0, min(s1, e1) - e0):
                    s += En[r]
                if s1 <= e1:
                    assert np.isnan(energy[a]), "an energy written twice"
                    energy[a] = s
                else:
                    carry[slot ^ 1] = s
            a_lo = a_hi - 1 if a_hi > a_lo and rp[a_hi] > e1 else a_hi
            slot ^= 1
        for a in range(a_lo, a_end):
            assert np.isnan(energy[a]), "an energy written twice"
            energy[a] = 0.0
    assert not np.isnan(energy).any(), "an energy never written"
    return torch.as_tensor(energy[:, None])


# per-atom edge counts: atoms without edges at the start (0), on the range
# boundaries of 3 and 6 blocks (4, 5 at edge 70; 8 at 140), in the middle
# (11) and at E' = 210 (15-23); atom 6's 40 edges are longer than a whole
# range of 6 or 40 blocks
RS_COUNTS = [0, 10, 25, 35, 0, 0, 40, 30, 0, 5, 3, 0, 20, 1, 41] + [0] * 9


@pytest.mark.parametrize("n_blocks", [1, 3, 6, 40])
@pytest.mark.parametrize("hidden", RB_HIDDEN, ids=[f"H{h}" if h else "no-hidden" for h in RB_HIDDEN])
@pytest.mark.parametrize("layout", list(RB_LAYOUTS))
@pytest.mark.parametrize("threads", [RS_THREADS, RS_THREADS // 4], ids=["full", "quarter"])
def test_readout_sum_tile_schedule_equals_the_plain_version(threads, layout, hidden, n_blocks):
    """210 real edges over 24 atoms (:data:`RS_COUNTS`), then 30 sentinel
    edges whose pieces are large; the pieces are column slices of wider
    rows."""
    rng = np.random.RandomState(31 + threads + n_blocks)
    counts = np.array(RS_COUNTS)
    centers = np.concatenate([np.repeat(np.arange(len(counts)), counts),
                              np.full(30, len(counts))]).astype(np.int32)
    row_ptr = torch.as_tensor(fused_tp.csr_row_ptr(centers, len(counts)))
    assert int(row_ptr[-1]) == 210 and row_ptr[4] == row_ptr[6] == 70 and row_ptr[8] == 140
    E = centers.shape[0]
    wide = [torch.as_tensor(rng.randn(E, d + 7)) for d in RB_LAYOUTS[layout]]
    for w in wide:
        w[210:] *= 1e6
    pieces = [w[:, 3:3 + d] for w, d in zip(wide, RB_LAYOUTS[layout])]
    K = sum(RB_LAYOUTS[layout])
    H = hidden or 1
    w0 = torch.as_tensor(rng.randn(K, H) / np.sqrt(K))
    w1 = None if hidden is None else torch.as_tensor(rng.randn(H, 1) / np.sqrt(H))
    want = fused_tp.readout_sum_reference(pieces, w0, w1, row_ptr)
    got = _emulate_readout_sum(pieces, w0, w1, row_ptr, threads, n_blocks)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    assert (got[counts == 0] == 0).all()


# ---------------------------------------------------------------------------
# center_gather's and center_sum's work splits and summation orders
# (csrc/center_readout.cu), emulated in float64 against the plain versions
# ---------------------------------------------------------------------------

THREADS, NARROW, SUM_LANES, WARP = 256, 4, 16, 32
WIDTHS = [1, 3, 32, 288, 1024]
GAP_ATOMS = (0, 7, 23)  # atoms without edges on either side


def _vectors(C):
    """(vectors per row, floats per vector): float4 where C % 4 == 0."""
    return (C // 4, 4) if C % 4 == 0 else (C, 1)


def _row_lanes(cv):
    """center_readout.cu's row_lanes."""
    if cv <= 32:
        return cv
    return next((t for t in range(32, 15, -1) if cv % t == 0), 32)


def _lane_vectors(cv, tx):
    """The vectors the tx lanes of a row take (q = lane, lane + tx, ...):
    each exactly once."""
    qs = sorted(q for lane in range(tx) for q in range(lane, cv, tx))
    assert qs == list(range(cv))


def _tree(lanes):
    """block_sum_y: the ty lane sums added pairwise (y += y + h for h the
    powers of two below ty, largest first); the sum of lane 0."""
    lanes, ty = lanes.copy(), lanes.shape[0]
    h = 1
    while 2 * h < ty:
        h *= 2
    while h > 0:
        for y in range(h):
            if y + h < ty:
                lanes[y] = lanes[y] + lanes[y + h]
        h //= 2
    return lanes[0]


def _gap_graph(side):
    """191 edges (odd): 171 real over the atoms but GAP_ATOMS, then 20
    sentinel edges. ``center``: sorted centers with their CSR; ``neighbor``:
    neighbors in edge order with the neighbor-sorted CSR and perm."""
    rng = np.random.RandomState(11)
    atoms = [a for a in range(N_ATOMS) if a not in GAP_ATOMS]
    centers = np.sort(np.concatenate([atoms, rng.choice(atoms, 150)]))
    if side == "center":
        idx = np.concatenate([centers, np.full(20, N_ATOMS)]).astype(np.int32)
        return idx, fused_tp.csr_row_ptr(idx, N_ATOMS), None
    idx = np.concatenate([rng.permutation(np.resize(atoms, 171)),
                          np.full(20, N_ATOMS)]).astype(np.int32)
    perm, rp = fused_tp.neighbor_csr(idx, N_ATOMS)
    return idx, rp, perm


def _class_csr(kind):
    """A parameter table's class CSR over the same 191 positions: ``classes``,
    5 rows with row 2 empty; ``one_row``, 3 rows with every real position
    in row 1. The 20 padded positions read the sentinel row."""
    rng = np.random.RandomState(12)
    n_rows = 5 if kind == "classes" else 3
    real = rng.choice([0, 1, 3, 4], 171) if kind == "classes" else np.ones(171, int)
    idx = np.concatenate([real, np.full(20, n_rows)]).astype(np.int32)
    perm, rp = fused_tp.neighbor_csr(idx, n_rows)
    return idx, rp, perm


def _emulate_gather(a, idx):
    """center_gather's work split. Narrow rows (C <= NARROW): a warp per 32
    edges, lane l reading edge e0 + l's index (the sentinel past E) and
    storing the floats l, l + 32, ... of the warp's C x 32 outputs, each
    with the index of its edge's lane. Wider rows: a group of row_lanes
    lanes per edge. Every output must be stored exactly once."""
    E, (n, C) = idx.shape[0], a.shape
    out = np.full((E, C), np.nan)
    stores = np.zeros((E, C), int)

    def store(k, row):
        out[k] = row
        stores[k] += 1

    if C <= NARROW:
        flat, flat_stores = out.reshape(-1), stores.reshape(-1)
        for e0 in range(0, E, WARP):
            mine = [idx[e0 + lane] if e0 + lane < E else n for lane in range(WARP)]
            n_out = min(WARP, E - e0) * C
            for j in range(C):
                for lane in range(WARP):
                    f = lane + WARP * j
                    i = mine[f // C]
                    if f < n_out:
                        flat[e0 * C + f] = a[i, f - f // C * C] if 0 <= i < n else 0.0
                        flat_stores[e0 * C + f] += 1
    else:
        _lane_vectors(_vectors(C)[0], _row_lanes(_vectors(C)[0]))
        for e in range(E):
            store(e, a[idx[e]] if 0 <= idx[e] < n else 0.0)
    assert (stores == 1).all(), "an output stored twice or never"
    return torch.as_tensor(out)


def _emulate_sum(v, row_ptr, perm):
    """center_sum's order: for C <= NARROW, SUM_LANES lanes per atom, lane j
    adding the segment's rows j, j + SUM_LANES, ... in order, then the xor
    butterfly (lane j += lane j ^ m, m = SUM_LANES / 2, ..., 1) and lane 0's
    value; wider, each column's segment in edge order."""
    n, C = row_ptr.shape[0] - 1, v.shape[1]
    rows = v if perm is None else v[perm]
    out = np.zeros((n, C))
    for atom in range(n):
        seg = rows[row_ptr[atom]:row_ptr[atom + 1]]
        if C <= NARROW:
            lanes = np.zeros((SUM_LANES, C))
            for j in range(SUM_LANES):
                for r in seg[j::SUM_LANES]:
                    lanes[j] = lanes[j] + r
            m = SUM_LANES // 2
            while m:
                lanes = lanes + lanes[np.arange(SUM_LANES) ^ m]
                m //= 2
            out[atom] = lanes[0]
        else:
            for r in seg:
                out[atom] = out[atom] + r
    return torch.as_tensor(out)


def _emulate_chunked(v, row_ptr, perm, chunk):
    """The chunked center_sum: pass 1, block i over positions [i chunk, (i +
    1) chunk) (up to row_ptr[n_rows]) finds its first row by binary search,
    and for each row r meeting the chunk its ty lanes add the piece's
    positions lo + y, lo + y + ty, ... in order, then _tree; the sum goes to
    partial[i + r], which no other piece may take. Pass 2: row r's ty lanes
    add its entries [first + r, last + r] the same way (0 for an empty row),
    each of which pass 1 must have written."""
    n_rows, (E, C) = row_ptr.shape[0] - 1, v.shape
    cv = _vectors(C)[0]
    ty = THREADS // _row_lanes(cv)
    _lane_vectors(cv, _row_lanes(cv))
    rows = v if perm is None else v[perm]
    n_chunks, end = -(-E // chunk), row_ptr[n_rows]
    partial = np.full((n_chunks + n_rows, C), np.nan)

    def tree_sum(block):
        lanes = np.zeros((ty, C))
        for y in range(ty):
            for r in block[y::ty]:
                lanes[y] = lanes[y] + r
        return _tree(lanes)

    for i in range(n_chunks):
        k0 = i * chunk
        if k0 >= end:
            continue
        k1 = min(k0 + chunk, end)
        r, hi = 0, n_rows
        while hi - r > 1:
            mid = (r + hi) // 2
            r, hi = (mid, hi) if row_ptr[mid] <= k0 else (r, mid)
        while r < n_rows and row_ptr[r] < k1:
            lo, up = max(row_ptr[r], k0), min(row_ptr[r + 1], k1)
            if lo < up:
                assert np.isnan(partial[i + r]).all(), "two pieces on one partial"
                partial[i + r] = tree_sum(rows[lo:up])
            r += 1
    out = np.zeros((n_rows, C))
    for r in range(n_rows):
        b, e = row_ptr[r], row_ptr[r + 1]
        if b < e:
            mine = partial[b // chunk + r:(e - 1) // chunk + r + 1]
            assert not np.isnan(mine).any(), "a partial read before it is written"
            out[r] = tree_sum(mine)
        else:
            out[r] = tree_sum(np.zeros((0, C)))
    return torch.as_tensor(out)


def _values(rng, *shape):
    """Inputs nonzero on the sentinel rows too, which the sums must drop."""
    return torch.as_tensor(rng.randn(*shape) * 10.0)


@pytest.mark.parametrize("side", ["center", "neighbor", "class"])
@pytest.mark.parametrize("C", WIDTHS)
def test_center_gather_work_split_equals_the_plain_version(C, side):
    """Every width class (narrow, float4 rows, scalar rows) on the sorted
    center side (atoms without edges, sentinel edges), by an unsorted
    neighbor index and by class, 191 edges (the last warp partial): exact
    copies."""
    idx, rp, perm = _class_csr("classes") if side == "class" else _gap_graph(side)
    n = rp.shape[0] - 1
    a = _values(np.random.RandomState(C), n, C)
    want = fused_tp.center_gather_reference(a, _t(idx))
    got = _emulate_gather(a.numpy(), idx)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the wrapper's CPU path
    torch.testing.assert_close(fused_tp.center_gather(a, _t(idx)), want, rtol=0, atol=0)


@pytest.mark.parametrize("side", ["center", "neighbor"])
@pytest.mark.parametrize("C", WIDTHS)
def test_center_sum_order_equals_the_plain_version(C, side):
    """Lanes and butterfly for narrow rows, edge order for wide ones, on
    both sides, atoms without edges, values on the sentinel rows."""
    idx, rp, perm = _gap_graph(side)
    v = _values(np.random.RandomState(C + 1), idx.shape[0], C)
    got = _emulate_sum(v.numpy(), rp, perm)
    want = fused_tp.center_sum_reference(v, _t(rp), None if perm is None else _t(perm))
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert (got[list(GAP_ATOMS)] == 0).all()


@pytest.mark.parametrize("chunk", [16, fused_tp.CENTER_SUM_CHUNK])
@pytest.mark.parametrize("kind", ["classes", "one_row"])
@pytest.mark.parametrize("C", WIDTHS)
def test_center_sum_chunked_order_equals_the_plain_version(C, kind, chunk):
    """The two passes over a class CSR with an empty row, and with one row
    that holds every position; chunks of 16 (a row spans many, a chunk
    meets several rows) and of the wrapper's size (one chunk)."""
    idx, rp, perm = _class_csr(kind)
    v = _values(np.random.RandomState(C + 2), idx.shape[0], C)
    got = _emulate_chunked(v.numpy(), rp, perm, chunk)
    want = fused_tp.center_sum_reference(v, _t(rp), _t(perm))
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-11)
    torch.testing.assert_close(fused_tp.center_sum(v, _t(rp), _t(perm), chunked=True), want,
                               rtol=0, atol=0)
