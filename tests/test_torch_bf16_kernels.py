"""The bf16 forms of the port's kernels 1-4, 7-10 and 14-17, through their
plain versions (the CPU path), against the JAX Pallas kernels they replace,
run in interpret mode on the same bf16 inputs (float64 compute where the
inputs allow it).

- ``gather_tp`` (x bf16 → out bf16, ts float64) and ``bwd_fused`` (x, g bf16
  → dx bf16, denv as JAX stores it: float32, the compute dtype of x and g),
  with and without the split output and its cotangent;
- ``gather_tp_embed`` with ``out_dtype`` bfloat16 (ts float64) and
  ``bwd_embed`` reading g in bfloat16;
- ``latent_env_scatter`` and ``latent_env_bwd`` with ``wexp_dtype``
  bfloat16 (the env weights rounded inside the kernel), with and without a
  hidden layer;
- the env weights in bfloat16: ``env_scatter`` (env float64),
  ``unweight_both`` (dsh float64, dwexp bf16, as JAX stores it),
  ``unweight_sh`` and ``unweight_w`` with its ``out_dtype`` bfloat16;
- the trainable backend's transposes on bf16 features: ``tp_scatter`` (x, g
  bf16 → denv float32, computed in float32 as JAX's kernel does: within
  ``F32_SUM_TOL``) and ``gather_dw`` (x, g bf16 → dw float32), on both
  layers' tables;
- the dtype pairs one bf16 training step reaches (each call the trainable
  family makes, enumerated on the CPU path) and the ones that raise.

Outputs stored in bfloat16 must be the same bits as JAX's (both round the
same float64 sums once); float64 ones agree at 1e-10; ``bwd_fused``'s denv,
stored in float32, within ``F32_TOL`` of its max (JAX's comes as two
float32 window partials, rounded before they are added). The per-atom
arrays come back from JAX as rank-window partials and are mapped to atoms
as in ``test_torch_mega.py``.
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
from torch_threads import one_thread  # noqa: F401

EB = 128
U = 4
S = 8
H = 16
N_ATOMS = 24
E_REAL = 150
TOL = 1e-10
F32_TOL = 2.0**-22  # two float32 roundings of the same float64 sum
# a sum computed in float32 in two orders (JAX's tp_scatter computes in the
# compute dtype of its bf16 inputs, float32): a few float32 roundings of
# each term, relative to the output's max (measured 1.2e-7)
F32_SUM_TOL = 2.0**-20
SH = Irreps("1x0e+1x1o+1x2e")
DIM_TO_IRR = tuple(k for k, s in enumerate(SH.slices()) for _ in range(s.stop - s.start))
N_IRR = len(SH)
BF = torch.bfloat16


@pytest.fixture(scope="module")
def graph():
    rng = np.random.RandomState(12)
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


def _arr(rng, *shape):
    a = rng.randn(*shape)
    a[E_REAL:] = 0.0
    return a


def _bf(a):
    """A float64 array rounded to bfloat16: the same values for both."""
    return torch.as_tensor(a).to(BF)


def _j(t):
    """A port tensor as a JAX array of the same dtype."""
    if t.dtype == BF:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _atoms_of(graph, a, b):
    rank = np.asarray(jax_ftp.combine_scatter_outputs(a, b, graph["win"], EB), dtype=np.float64)
    out = np.zeros((N_ATOMS, rank.shape[1]))
    out[graph["atoms"]] = rank[: len(graph["atoms"])]
    return out


def _env_pair(graph, rng):
    eA, eB = jax_ftp.env_scatter_call(
        jnp.asarray(_arr(rng, graph["Ep"], 9)), jnp.asarray(_arr(rng, graph["Ep"], N_IRR * U)),
        graph["offs"], graph["win"], dim_to_irr=DIM_TO_IRR, U=U, eb=EB, n_rank_rows=graph["nr"],
    )
    return eA, eB, torch.as_tensor(_atoms_of(graph, eA, eB))


def _same(got, want):
    """bfloat16: the same bits; otherwise within TOL (F32_TOL for float32)
    of max(1, max |want|)."""
    if got.dtype == BF:
        assert str(want.dtype) == "bfloat16", want.dtype
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, dtype=np.float32))
        return
    w = np.asarray(want, dtype=np.float64)
    assert got.shape == w.shape, (got.shape, w.shape)
    err = float(np.abs(got.double().numpy() - w).max())
    tol = F32_TOL if got.dtype == torch.float32 else TOL
    assert err <= tol * max(1.0, float(np.abs(w).max())), f"max abs err {err:.3e}"


def _tables(layer):
    ladder = compute_irreps_ladder(SH, Irreps("1x0e+1x0o+1x1e+1x1o+1x2e+1x2o"), 2)
    a, b = ladder[layer], ladder[layer + 1]
    w3j = pack_w3j(a, SH, b, enumerate_instructions(a, SH, b))
    entries = sparse_entries(w3j)
    return (w3j.shape, entries, torch.tensor([e[:4] for e in entries], dtype=torch.int32),
            torch.tensor([e[4] for e in entries], dtype=torch.float64))


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
def test_gather_tp_and_bwd_fused_bf16_match_pallas(graph, interpret, layer, split):
    (P, d1, d2, d3), entries, idx, coef = _tables(layer)
    rng, Ep = np.random.RandomState(80 + 2 * layer + split), graph["Ep"]
    x, g = _bf(_arr(rng, Ep, d1 * U)), _bf(_arr(rng, Ep, d3 * U))
    gts = torch.as_tensor(_arr(rng, Ep, U)) if split else None
    w = _bf(rng.randn(P, U)).double()  # JAX reads a later layer's w in the track's dtype
    eA, eB, env = _env_pair(graph, rng)
    kw = dict(entries=entries, dims=(d1, d2, d3), U=U, eb=EB)
    want = jax_ftp.gather_tp_raw_call(_j(x), eA, eB, _j(w), graph["offs"], graph["win"],
                                      split_scalars=split, **kw)
    got = fused_tp.gather_tp(x, env, w, graph["t_centers"], idx, coef, d3, split)
    for a, b in zip(got if split else (got,), want if split else (want,)):
        _same(a, b)
    dx_j, dA, dB = jax_ftp.bwd_fused_raw_call(
        _j(x), _j(g), eA, eB, _j(w), graph["offs"], graph["win"], n_rank_rows=graph["nr"],
        gts=None if gts is None else _j(gts), **kw,
    )
    dx, denv = fused_tp.bwd_fused(x, g, env, w, graph["t_centers"], graph["row_ptr"], idx, coef,
                                  gts)
    assert dx.dtype == BF and denv.dtype == torch.float32 and str(dA.dtype) == "float32"
    _same(dx, dx_j)
    _same(denv, _atoms_of(graph, dA, dB))


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
def test_gather_tp_embed_and_bwd_embed_bf16_match_pallas(graph, interpret, split):
    (P, d1, d2, d3), entries, idx, coef = _tables(0)
    rng, Ep = np.random.RandomState(90 + split), graph["Ep"]
    sh, w2b = torch.as_tensor(_arr(rng, Ep, 9)), torch.as_tensor(_arr(rng, Ep, N_IRR * U))
    g, gts, w = _bf(_arr(rng, Ep, d3 * U)), torch.as_tensor(_arr(rng, Ep, U)), rng.randn(P, U)
    w = torch.as_tensor(w)
    specs = tuple((j, DIM_TO_IRR[j]) for j in range(d1))
    t_specs = torch.tensor(specs, dtype=torch.int32)
    eA, eB, env = _env_pair(graph, rng)
    kw = dict(entries=entries, dims=(d1, d2, d3), U=U, eb=EB, row_specs=specs)
    want = jax_ftp.gather_tp_embed_raw_call(_j(sh), _j(w2b), eA, eB, _j(w), graph["offs"],
                                            graph["win"], split_scalars=split,
                                            out_dtype=jnp.bfloat16,
                                            scalar_dtype=jnp.float64, **kw)
    got = fused_tp.gather_tp_embed(sh, w2b, env, w, graph["t_centers"], graph["row_ptr"], idx,
                                   coef, t_specs, d3, split, out_dtype=BF)
    assert (got[0] if split else got).dtype == BF
    for a, b in zip(got if split else (got,), want if split else (want,)):
        _same(a, b)
    dsh_j, dw2b_j, dA, dB = jax_ftp.bwd_embed_raw_call(
        _j(sh), _j(w2b), _j(g), eA, eB, _j(w), graph["offs"], graph["win"],
        n_rank_rows=graph["nr"], gts=_j(gts) if split else None, **kw,
    )
    dsh, dw2b, denv = fused_tp.bwd_embed(sh, w2b, g, env, w, graph["t_centers"],
                                         graph["row_ptr"], idx, coef, t_specs,
                                         gts if split else None)
    _same(dsh, dsh_j)
    _same(dw2b, dw2b_j)
    _same(denv, _atoms_of(graph, dA, dB))


@pytest.mark.parametrize("n_hidden", [0, 1])
def test_latent_env_bf16_weights_match_pallas(graph, interpret, n_hidden):
    rng, Ep, n_out = np.random.RandomState(100 + n_hidden), graph["Ep"], S + N_IRR * U
    if n_hidden:
        pieces = [_arr(rng, Ep, S), _arr(rng, Ep, U)]
        w0, w1 = rng.randn(S + U, H) / (S + U) ** 0.5, rng.randn(H, n_out) / H**0.5
    else:
        pieces, w0, w1 = [_arr(rng, Ep, S)], rng.randn(S, n_out) / S**0.5, None
    sh = _arr(rng, Ep, 9)
    tp = [torch.as_tensor(p) for p in pieces]
    t_w1 = None if w1 is None else torch.as_tensor(w1)
    kw = dict(dim_to_irr=DIM_TO_IRR, U=U, eb=EB, S=S, n_hidden=n_hidden,
              wexp_dtype=jnp.bfloat16)
    jp = tuple(map(jnp.asarray, pieces))
    lat_j, eA, eB = jax_ftp.latent_env_scatter_call(
        jp, jnp.asarray(sh), jnp.asarray(w0), None if w1 is None else jnp.asarray(w1),
        graph["offs"], graph["win"], n_rank_rows=graph["nr"], **kw,
    )
    lat_s, env = fused_tp.latent_env_scatter(tp, torch.as_tensor(sh), torch.as_tensor(w0), t_w1,
                                             graph["t_centers"], graph["row_ptr"], graph["d2i"],
                                             U, S, wexp_dtype=BF)
    _same(lat_s, lat_j)
    _same(env, _atoms_of(graph, eA, eB))
    # the rounding is there: without it the env differs
    _, exact = fused_tp.latent_env_scatter(tp, torch.as_tensor(sh), torch.as_tensor(w0), t_w1,
                                           graph["t_centers"], graph["row_ptr"], graph["d2i"], U,
                                           S)
    assert not torch.allclose(exact, env, rtol=0, atol=1e-8)
    tA, tB, t_atoms = _env_pair(graph, rng)
    g_lat = _arr(rng, Ep, S)
    dsh_j, dp_j = jax_ftp.latent_env_bwd_call(
        jp, jnp.asarray(sh), jnp.asarray(w0), None if w1 is None else jnp.asarray(w1), tA, tB,
        jnp.asarray(g_lat), graph["offs"], graph["win"], **kw,
    )
    dsh, dpieces = fused_tp.latent_env_bwd(tp, torch.as_tensor(sh), torch.as_tensor(w0), t_w1,
                                           t_atoms, torch.as_tensor(g_lat), graph["t_centers"],
                                           graph["d2i"], U, S, wexp_dtype=BF)
    _same(dsh, dsh_j)
    for got, want in zip(dpieces, dp_j):
        _same(got, want)


# ---------------------------------------------------------------------------
# kernels 1, 4 and 14-17: the env weights in bfloat16, and the trainable
# backend's transposes on bf16 features
# ---------------------------------------------------------------------------


def _rank(graph, a):
    """Atom rows as the Pallas kernels' combined rank rows."""
    r = np.zeros((graph["nr"], a.shape[1]))
    r[: len(graph["atoms"])] = np.asarray(a)[graph["atoms"]]
    return jnp.asarray(r)


def test_env_weight_kernels_bf16_match_pallas(graph, interpret):
    rng, Ep = np.random.RandomState(110), graph["Ep"]
    sh, wexp = torch.as_tensor(_arr(rng, Ep, 9)), _bf(_arr(rng, Ep, N_IRR * U))
    kw = dict(dim_to_irr=DIM_TO_IRR, U=U, eb=EB)
    c, row_ptr, d2i = graph["t_centers"], graph["row_ptr"], graph["d2i"]
    eA, eB = jax_ftp.env_scatter_call(_j(sh), _j(wexp), graph["offs"], graph["win"],
                                      n_rank_rows=graph["nr"], **kw)
    env = fused_tp.env_scatter(sh, wexp, c, row_ptr, d2i, U)
    assert env.dtype == torch.float64
    _same(env, _atoms_of(graph, eA, eB))
    tA, tB, t = _env_pair(graph, rng)
    dsh_j, dwexp_j = jax_ftp.unweight_both_raw_call(tA, tB, _j(sh), _j(wexp), graph["offs"],
                                                    graph["win"], **kw)
    dsh, dwexp = fused_tp.unweight_both(t, sh, wexp, c, d2i)
    assert dsh.dtype == torch.float64 and dwexp.dtype == BF
    _same(dsh, dsh_j)
    _same(dwexp, dwexp_j)
    t_r = _rank(graph, t.numpy())
    _same(fused_tp.unweight_sh(t, wexp, c, d2i),
          jax_ftp.gather_unweight_sh_call(t_r, t_r, _j(wexp), graph["offs"], graph["win"], **kw))
    _same(fused_tp.unweight_w(t, sh, c, d2i, N_IRR, BF),
          jax_ftp.gather_unweight_w_call(t_r, t_r, _j(sh), graph["offs"], graph["win"],
                                         out_dtype=jnp.bfloat16, **kw))
    # dwexp unrounded (a mega model off the mega kernels): unweight_w's sum
    _, dwexp64 = fused_tp.unweight_both(t, sh, wexp, c, d2i, torch.float64)
    assert torch.equal(dwexp64, fused_tp.unweight_w(t, sh, c, d2i, N_IRR))


@pytest.mark.parametrize("layer", [0, 1])
def test_tp_scatter_and_gather_dw_bf16_match_pallas(graph, interpret, layer):
    (P, d1, d2, d3), entries, idx, coef = _tables(layer)
    rng, Ep = np.random.RandomState(120 + layer), graph["Ep"]
    x, g = _bf(_arr(rng, Ep, d1 * U)), _bf(_arr(rng, Ep, d3 * U))
    w = _bf(rng.randn(P, U)).double()  # the track's path weights: bf16 values
    kw = dict(entries=entries, dims=(d1, d2, d3), U=U, eb=EB)
    dA, dB = jax_ftp.tp_scatter_call(_j(x), _j(g), _j(w.to(BF)), graph["offs"], graph["win"],
                                     n_rank_rows=graph["nr"], **kw)
    denv = fused_tp.tp_scatter(x, g, w, graph["t_centers"], graph["row_ptr"], idx, coef, d2)
    assert denv.dtype == torch.float32 and str(dA.dtype) == "float32"
    want = _atoms_of(graph, dA, dB)
    err = float(np.abs(denv.double().numpy() - want).max())
    assert err <= F32_SUM_TOL * float(np.abs(want).max()), f"max abs err {err:.3e}"
    env = torch.as_tensor(rng.randn(N_ATOMS, d2 * U))
    env_r = _rank(graph, env.numpy())
    dw_j = jax_ftp.gather_dw_call(_j(x), env_r, env_r, _j(g), graph["offs"], graph["win"], **kw)
    dw = fused_tp.gather_dw(x, env, g, graph["t_centers"], idx, coef, P, U)
    assert dw.dtype == torch.float32 and str(dw_j.dtype) == "float32"
    _same(dw, dw_j)
