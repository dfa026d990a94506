"""The port's mega-fused kernels, through their plain versions (the CPU path).

- Each plain version against the JAX Pallas kernel it replaces, run in
  interpret mode on the same inputs (float64 at 1e-10): ``latent_env_scatter``
  and ``latent_env_bwd`` with and without a hidden layer, ``gather_tp_embed``
  and ``bwd_embed`` with and without the split scalar output / its cotangent,
  and the split output of ``gather_tp`` and the ``gts`` input of
  ``bwd_fused``. The Pallas kernels return per-atom arrays as rank-window
  partials (eA, eB): they are combined and mapped from rank space (atoms that
  have edges, in order) to atoms. Atom 5 and the last atoms have no edges,
  and the edge list ends in sentinel padding.
- Each new ``autograd.Function``'s backward against torch.autograd through
  its plain forward composition, with nonzero cotangents on the sentinel
  edges too, and NaN weight gradients.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from allegro_tpu.ops import fused_tp as jax_ftp

from allegro_tpu_torch.lib import Irreps
from allegro_tpu_torch.nn.allegro import compute_irreps_ladder
from allegro_tpu_torch.nn.contract import enumerate_instructions, pack_w3j, sparse_entries
from allegro_tpu_torch.ops import fused_tp
from allegro_tpu_torch.ops.fused_primitives import (
    gather_tp_embed_infer,
    gather_tp_infer,
    mega_latent_env,
)

EB = 128
U = 4
S = 8
H = 16
N_ATOMS = 24
E_REAL = 150
TOL = 1e-10
SH = Irreps("1x0e+1x1o+1x2e")
DIM_TO_IRR = tuple(k for k, s in enumerate(SH.slices()) for _ in range(s.stop - s.start))
N_IRR = len(SH)


def _layer_tables(layer):
    ladder = compute_irreps_ladder(SH, Irreps("1x0e+1x0o+1x1e+1x1o+1x2e+1x2o"), 2)
    a, b = ladder[layer], ladder[layer + 1]
    w3j = pack_w3j(a, SH, b, enumerate_instructions(a, SH, b))
    return w3j, sparse_entries(w3j)


@pytest.fixture(scope="module")
def graph():
    rng = np.random.RandomState(11)
    # atom 5 and atoms >= 20 have no edges; sentinel padding to a multiple of EB
    atoms = np.array([a for a in range(20) if a != 5])
    real = np.sort(rng.choice(atoms, size=E_REAL))
    real[: len(atoms)] = atoms
    real = np.sort(real)
    Ep = -(-E_REAL // EB) * EB
    centers = np.concatenate([real, np.full(Ep - E_REAL, N_ATOMS)]).astype(np.int32)
    win, offs = jax_ftp.make_block_plan(jnp.asarray(centers), EB)
    return dict(
        atoms=atoms, Ep=Ep, centers=centers, win=win, offs=offs,
        nr=jax_ftp.num_rank_rows(N_ATOMS, EB),
        t_centers=torch.as_tensor(centers),
        row_ptr=torch.as_tensor(fused_tp.csr_row_ptr(centers, N_ATOMS)),
        d2i=torch.tensor(DIM_TO_IRR, dtype=torch.int32),
    )


@pytest.fixture(scope="module")
def interpret():
    old = jax_ftp.INTERPRET
    jax_ftp.INTERPRET = True
    yield
    jax_ftp.INTERPRET = old


def _arr(rng, *shape, edge=True):
    a = rng.randn(*shape)
    if edge:
        a[E_REAL:] = 0.0
    return a


def _atoms_of(graph, a, b):
    """Window partials → [N_ATOMS, C] atom rows (zeros for atoms without edges)."""
    rank = np.asarray(jax_ftp.combine_scatter_outputs(a, b, graph["win"], EB))
    out = np.zeros((N_ATOMS, rank.shape[1]))
    out[graph["atoms"]] = rank[: len(graph["atoms"])]
    return out


def _env_pair(graph, rng):
    """A per-atom array [N_ATOMS, 9*U] as JAX's window pair and as atom rows."""
    eA, eB = jax_ftp.env_scatter_call(
        jnp.asarray(_arr(rng, graph["Ep"], 9)), jnp.asarray(_arr(rng, graph["Ep"], N_IRR * U)),
        graph["offs"], graph["win"], dim_to_irr=DIM_TO_IRR, U=U, eb=EB, n_rank_rows=graph["nr"],
    )
    return eA, eB, torch.as_tensor(_atoms_of(graph, eA, eB))


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"max abs err {err:.3e} (scale {scale:.3e})"


def _mlp_inputs(rng, graph, n_hidden):
    """Pieces and weights of a first projection (n_hidden 0: one [E, S]
    piece, w0 [S, S+n_irr*U]) or a layer latent (n_hidden 1: pieces [E, S]
    and [E, U], w0 [S+U, H], w1 [H, S+n_irr*U])."""
    Ep, n_out = graph["Ep"], S + N_IRR * U
    if n_hidden == 0:
        pieces = [_arr(rng, Ep, S)]
        return pieces, rng.randn(S, n_out) / S**0.5, None
    pieces = [_arr(rng, Ep, S), _arr(rng, Ep, U)]
    return pieces, rng.randn(S + U, H) / (S + U) ** 0.5, rng.randn(H, n_out) / H**0.5


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("n_hidden", [0, 1])
def test_latent_env_scatter_and_bwd_match_pallas(graph, interpret, n_hidden):
    rng = np.random.RandomState(20 + n_hidden)
    pieces, w0, w1 = _mlp_inputs(rng, graph, n_hidden)
    sh = _arr(rng, graph["Ep"], 9)
    kw = dict(dim_to_irr=DIM_TO_IRR, U=U, eb=EB, S=S, n_hidden=n_hidden)
    lat_j, eA, eB = jax_ftp.latent_env_scatter_call(
        tuple(map(jnp.asarray, pieces)), jnp.asarray(sh), jnp.asarray(w0), _j(w1),
        graph["offs"], graph["win"], n_rank_rows=graph["nr"], **kw,
    )
    tp = [_t(p) for p in pieces]
    lat_s, env = fused_tp.latent_env_scatter(tp, _t(sh), _t(w0), _t(w1), graph["row_ptr"],
                                             graph["d2i"], U, S)
    _close(lat_s, lat_j)
    _close(env, _atoms_of(graph, eA, eB))

    tA, tB, t_atoms = _env_pair(graph, rng)
    g_lat = _arr(rng, graph["Ep"], S)
    dsh_j, dp_j = jax_ftp.latent_env_bwd_call(
        tuple(map(jnp.asarray, pieces)), jnp.asarray(sh), jnp.asarray(w0), _j(w1), tA, tB,
        jnp.asarray(g_lat), graph["offs"], graph["win"], **kw,
    )
    dsh, dpieces = fused_tp.latent_env_bwd(tp, _t(sh), _t(w0), _t(w1), t_atoms, _t(g_lat),
                                           graph["t_centers"], graph["d2i"], U, S)
    _close(dsh, dsh_j)
    assert len(dpieces) == len(pieces)
    for got, want in zip(dpieces, dp_j):
        _close(got, want)


@pytest.fixture(scope="module", params=[0, 1], ids=["layer0", "layer1"])
def tp_case(request, graph):
    layer = request.param
    w3j, entries = _layer_tables(layer)
    P, d1, d2, d3 = w3j.shape
    rng = np.random.RandomState(30 + layer)
    return dict(
        entries=entries, dims=(d1, d2, d3), rng=rng, w=rng.randn(P, U),
        idx=torch.tensor([e[:4] for e in entries], dtype=torch.int32),
        coef=torch.tensor([e[4] for e in entries], dtype=torch.float64),
    )


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
def test_gather_tp_split_and_bwd_fused_gts_match_pallas(graph, interpret, tp_case, split):
    c = tp_case
    rng, (d1, d2, d3), Ep = c["rng"], c["dims"], graph["Ep"]
    x, g, gts = _arr(rng, Ep, d1 * U), _arr(rng, Ep, d3 * U), _arr(rng, Ep, U)
    eA, eB, env = _env_pair(graph, rng)
    kw = dict(entries=c["entries"], dims=c["dims"], U=U, eb=EB)
    want = jax_ftp.gather_tp_raw_call(jnp.asarray(x), eA, eB, jnp.asarray(c["w"]), graph["offs"],
                                      graph["win"], split_scalars=split, **kw)
    got = fused_tp.gather_tp(_t(x), env, _t(c["w"]), graph["t_centers"], c["idx"], c["coef"], d3,
                             split)
    if split:
        assert isinstance(got, tuple) and got[1].shape == (Ep, U) and got[1].is_contiguous()
        for a, b in zip(got, want):
            _close(a, b)
    else:
        _close(got, want)
    dx_j, dA, dB = jax_ftp.bwd_fused_raw_call(
        jnp.asarray(x), jnp.asarray(g), eA, eB, jnp.asarray(c["w"]), graph["offs"], graph["win"],
        n_rank_rows=graph["nr"], gts=jnp.asarray(gts) if split else None, **kw,
    )
    dx, denv = fused_tp.bwd_fused(_t(x), _t(g), env, _t(c["w"]), graph["t_centers"],
                                  graph["row_ptr"], c["idx"], c["coef"], _t(gts) if split else None)
    _close(dx, dx_j)
    _close(denv, _atoms_of(graph, dA, dB))


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
def test_gather_tp_embed_and_bwd_embed_match_pallas(graph, interpret, split):
    w3j, entries = _layer_tables(0)
    P, d1, d2, d3 = w3j.shape
    assert d1 == 9
    rng = np.random.RandomState(40 + split)
    Ep = graph["Ep"]
    sh, w2b = _arr(rng, Ep, 9), _arr(rng, Ep, N_IRR * U)
    g, gts, w = _arr(rng, Ep, d3 * U), _arr(rng, Ep, U), rng.randn(P, U)
    specs = tuple((j, DIM_TO_IRR[j]) for j in range(d1))
    eA, eB, env = _env_pair(graph, rng)
    kw = dict(entries=entries, dims=(d1, d2, d3), U=U, eb=EB, row_specs=specs)
    want = jax_ftp.gather_tp_embed_raw_call(jnp.asarray(sh), jnp.asarray(w2b), eA, eB,
                                            jnp.asarray(w), graph["offs"], graph["win"],
                                            split_scalars=split, **kw)
    idx = torch.tensor([e[:4] for e in entries], dtype=torch.int32)
    coef = torch.tensor([e[4] for e in entries], dtype=torch.float64)
    t_specs = torch.tensor(specs, dtype=torch.int32)
    got = fused_tp.gather_tp_embed(_t(sh), _t(w2b), env, _t(w), graph["t_centers"], idx, coef,
                                   t_specs, d3, split)
    for a, b in zip(got if split else (got,), want if split else (want,)):
        _close(a, b)
    dsh_j, dw2b_j, dA, dB = jax_ftp.bwd_embed_raw_call(
        jnp.asarray(sh), jnp.asarray(w2b), jnp.asarray(g), eA, eB, jnp.asarray(w), graph["offs"],
        graph["win"], n_rank_rows=graph["nr"], gts=jnp.asarray(gts) if split else None, **kw,
    )
    dsh, dw2b, denv = fused_tp.bwd_embed(_t(sh), _t(w2b), _t(g), env, _t(w), graph["t_centers"],
                                         graph["row_ptr"], idx, coef, t_specs,
                                         _t(gts) if split else None)
    _close(dsh, dsh_j)
    _close(dw2b, dw2b_j)
    _close(denv, _atoms_of(graph, dA, dB))


# ---------------------------------------------------------------------------
# the autograd Functions against torch.autograd through the plain versions
# ---------------------------------------------------------------------------


def _leaf(rng, *shape):
    """Random rows on every edge, sentinel edges included."""
    return torch.as_tensor(rng.randn(*shape)).requires_grad_(True)


def _grads_match(out_fn, ref_fn, leaves, cotangents, nan_leaves=()):
    outs = out_fn()
    sum(o.mul(g).sum() for o, g in zip(outs, cotangents)).backward()
    got = {k: v.grad.clone() for k, v in leaves.items()}
    for k in nan_leaves:
        assert torch.isnan(got[k]).all(), k
    for v in leaves.values():
        v.grad = None
    refs = ref_fn()
    for a, b in zip(outs, refs):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=0, atol=1e-12)
    sum(o.mul(g).sum() for o, g in zip(refs, cotangents)).backward()
    for k, v in leaves.items():
        if k not in nan_leaves:
            torch.testing.assert_close(got[k], v.grad, rtol=0, atol=1e-10, msg=k)


@pytest.mark.parametrize("n_hidden", [0, 1])
def test_mega_latent_env_gradients(graph, n_hidden):
    rng = np.random.RandomState(50 + n_hidden)
    Ep = graph["Ep"]
    leaves = {"sh": _leaf(rng, Ep, 9), "p0": _leaf(rng, Ep, S), "w0": None, "w1": None}
    if n_hidden:
        leaves["p1"] = _leaf(rng, Ep, U)
        leaves["w0"], leaves["w1"] = _leaf(rng, S + U, H), _leaf(rng, H, S + N_IRR * U)
    else:
        leaves["w0"] = _leaf(rng, S, S + N_IRR * U)
        del leaves["w1"]
    pieces = [leaves[k] for k in ("p0", "p1") if k in leaves]
    w1 = leaves.get("w1")
    args = (graph["row_ptr"], graph["d2i"], U, S)
    cts = (torch.as_tensor(rng.randn(Ep, S)), torch.as_tensor(rng.randn(N_ATOMS, 9 * U)))
    _grads_match(
        lambda: mega_latent_env(pieces, leaves["sh"], leaves["w0"], w1, graph["t_centers"], *args),
        lambda: fused_tp.latent_env_scatter_reference(pieces, leaves["sh"], leaves["w0"], w1,
                                                      *args),
        leaves, cts, nan_leaves=[k for k in ("w0", "w1") if k in leaves],
    )


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
def test_gather_tp_infer_gradients(graph, tp_case, split):
    c = tp_case
    rng, (d1, d2, d3), Ep = np.random.RandomState(60 + split), c["dims"], graph["Ep"]
    leaves = {"x": _leaf(rng, Ep, d1 * U), "env": _leaf(rng, N_ATOMS, d2 * U),
              "w": _leaf(rng, *c["w"].shape)}
    cts = [torch.as_tensor(rng.randn(Ep, d3 * U)), torch.as_tensor(rng.randn(Ep, U))]
    args = (graph["t_centers"], c["idx"], c["coef"], d3, split)

    def as_tuple(r):
        return r if split else (r,)

    _grads_match(
        lambda: as_tuple(gather_tp_infer(leaves["x"], leaves["env"], leaves["w"],
                                         graph["t_centers"], graph["row_ptr"], c["idx"],
                                         c["coef"], d3, split)),
        lambda: as_tuple(fused_tp.gather_tp_reference(leaves["x"], leaves["env"], leaves["w"],
                                                      *args)),
        leaves, cts[: 1 + split], nan_leaves=["w"],
    )


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
def test_gather_tp_embed_infer_gradients(graph, split):
    w3j, entries = _layer_tables(0)
    P, d1, d2, d3 = w3j.shape
    rng, Ep = np.random.RandomState(70 + split), graph["Ep"]
    leaves = {"sh": _leaf(rng, Ep, 9), "w2b": _leaf(rng, Ep, N_IRR * U),
              "env": _leaf(rng, N_ATOMS, d2 * U), "w": _leaf(rng, P, U)}
    idx = torch.tensor([e[:4] for e in entries], dtype=torch.int32)
    coef = torch.tensor([e[4] for e in entries], dtype=torch.float64)
    specs = torch.tensor([(j, DIM_TO_IRR[j]) for j in range(d1)], dtype=torch.int32)
    cts = [torch.as_tensor(rng.randn(Ep, d3 * U)), torch.as_tensor(rng.randn(Ep, U))]

    def as_tuple(r):
        return r if split else (r,)

    _grads_match(
        lambda: as_tuple(gather_tp_embed_infer(
            leaves["sh"], leaves["w2b"], leaves["env"], leaves["w"], graph["t_centers"],
            graph["row_ptr"], idx, coef, specs, d3, split)),
        lambda: as_tuple(fused_tp.gather_tp_embed_reference(
            leaves["sh"], leaves["w2b"], leaves["env"], leaves["w"], graph["t_centers"], idx,
            coef, specs, d3, split)),
        leaves, cts[: 1 + split], nan_leaves=["w"],
    )


def test_sentinel_edges_of_the_mega_kernels(graph):
    """On sentinel edges: lat_s is the MLP of their inputs (no env), the
    backward's dsh is zero and their piece cotangents come from g_lat alone;
    bwd_embed gives zero dsh and dw2b rows."""
    rng = np.random.RandomState(80)
    Ep = graph["Ep"]
    pieces = [torch.as_tensor(rng.randn(Ep, S)), torch.as_tensor(rng.randn(Ep, U))]
    w0, w1 = torch.as_tensor(rng.randn(S + U, H)), torch.as_tensor(rng.randn(H, S + N_IRR * U))
    sh = torch.as_tensor(rng.randn(Ep, 9))
    lat_s, env = fused_tp.latent_env_scatter(pieces, sh, w0, w1, graph["row_ptr"], graph["d2i"],
                                             U, S)
    full = torch.nn.functional.silu(torch.cat(pieces, 1) @ w0) @ w1
    torch.testing.assert_close(lat_s, full[:, :S], rtol=0, atol=1e-12)
    t = torch.as_tensor(rng.randn(N_ATOMS, 9 * U))
    g_lat = torch.as_tensor(rng.randn(Ep, S))
    dsh, dpieces = fused_tp.latent_env_bwd(pieces, sh, w0, w1, t, g_lat, graph["t_centers"],
                                           graph["d2i"], U, S)
    assert (dsh[E_REAL:] == 0).all() and (dsh[:E_REAL] != 0).any()
    ref = fused_tp.latent_env_bwd(pieces, sh, w0, w1, torch.zeros_like(t), g_lat,
                                  graph["t_centers"], graph["d2i"], U, S)[1]
    for a, b in zip(dpieces, ref):
        torch.testing.assert_close(a[E_REAL:], b[E_REAL:], rtol=0, atol=1e-12)
    w3j, entries = _layer_tables(0)
    P, d1, d2, d3 = w3j.shape
    idx = torch.tensor([e[:4] for e in entries], dtype=torch.int32)
    coef = torch.tensor([e[4] for e in entries], dtype=torch.float64)
    specs = torch.tensor([(j, DIM_TO_IRR[j]) for j in range(d1)], dtype=torch.int32)
    dsh, dw2b, _ = fused_tp.bwd_embed(sh, torch.as_tensor(rng.randn(Ep, N_IRR * U)),
                                      torch.as_tensor(rng.randn(Ep, d3 * U)), t,
                                      torch.as_tensor(rng.randn(P, U)), graph["t_centers"],
                                      graph["row_ptr"], idx, coef, specs,
                                      torch.as_tensor(rng.randn(Ep, U)))
    assert (dsh[E_REAL:] == 0).all() and (dw2b[E_REAL:] == 0).all()


def test_cpu_tensors_take_the_plain_path_and_shapes_are_checked(graph):
    rng = np.random.RandomState(90)
    Ep = graph["Ep"]
    pieces, w0, w1 = _mlp_inputs(rng, graph, 1)
    tp, sh = [_t(p) for p in pieces], torch.as_tensor(_arr(rng, Ep, 9))
    fused_tp.reset_launch_counts()
    fused_tp.latent_env_scatter(tp, sh, _t(w0), _t(w1), graph["row_ptr"], graph["d2i"], U, S)
    assert fused_tp.LAUNCHES == {k: 0 for k in fused_tp.LAUNCHES}
    with pytest.raises(ValueError, match="latent_env_scatter shapes"):
        fused_tp.latent_env_scatter(tp, sh, _t(w0), _t(w1)[:, :-1], graph["row_ptr"],
                                    graph["d2i"], U, S)
    with pytest.raises(ValueError, match="latent_env_bwd shapes"):
        fused_tp.latent_env_bwd(tp, sh, _t(w0), _t(w1), torch.zeros(N_ATOMS, 9 * U),
                                torch.zeros(Ep, S + 1), graph["t_centers"], graph["d2i"], U, S)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_tp.latent_env_scatter([p.to("meta") for p in tp], sh.to("meta"),
                                    _t(w0).to("meta"), _t(w1).to("meta"),
                                    graph["row_ptr"].to("meta"), graph["d2i"].to("meta"), U, S)
