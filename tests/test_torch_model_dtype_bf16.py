"""A bfloat16 model (``model_dtype="bfloat16"``, ROADMAP item 6) on the
serving routes, on the CPU, against the JAX package.

- The bf16-operand forms of kernels 1-12 and 20, through their plain
  versions (the CPU path), against the JAX Pallas kernels they replace, run
  in interpret mode on the same bfloat16 inputs, the dtypes of JAX's
  bfloat16 model: sh, w2b, the scalar pieces, the features, ts / gts and the
  weights in bfloat16. The tolerances are ``chip_smoke.py`` phase 12a's:
  bfloat16 outputs within 1 bf16 ulp of JAX's, float32 ones within 1e-5 of
  their max (JAX sums in rank windows, the port in edge order).
  ``sparse_tp`` (kernel 20) rounds every op to bfloat16 in its table's entry
  order, as JAX's ``_tp_kernel`` does: the same bits.
- The toy model on each route (``einsum``, ``fused_infer`` on the mega path
  and with ``use_mega=False``, ``pallas``) against JAX's same backend on
  float32 and on bfloat16 positions: the energy and force dtypes exactly
  JAX's, the forces within JAX's own spread (``SPREAD_F32``,
  ``SPREAD_BF16``: how far JAX's backends lie from one another on these
  inputs and weights, measured first).
- ``params_from_jax`` on JAX's bfloat16 leaves, bit for bit.
- The export of a bfloat16 model raises, naming ROADMAP item 14 (training
  and the trainable ``fused`` backend run:
  ``tests/test_torch_model_dtype_bf16_train.py``); MD, the calculator and
  the CLI's ``md`` stage run it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from allegro_tpu.data import to_jax
from allegro_tpu.model import AllegroModel as JaxAllegroModel
from allegro_tpu.ops import fused_tp as jax_ftp
from allegro_tpu.ops import pallas_contract as jax_pallas

from allegro_tpu_torch.calculator import AllegroCalculator
from allegro_tpu_torch.compile.export import check_exportable
from allegro_tpu_torch.data import keys, to_torch
from allegro_tpu_torch.md import MDState, Simulation
from allegro_tpu_torch.model import AllegroModel, params_from_jax
from allegro_tpu_torch.ops import fused_tp, pallas_contract
from allegro_tpu_torch.train import Trainer
from test_torch_bf16_kernels import (DIM_TO_IRR, EB, H, N_IRR, S, U, _arr, _atoms_of, _env_pair,
                                     _j, _rank, _tables, graph, interpret)  # noqa: F401
from test_torch_bf16_track import _toy, _toy_batch
from torch_threads import one_thread  # noqa: F401

BF = torch.bfloat16
KERNEL_TOL = 1e-5  # chip_smoke.py's: a float32 output against its reference
# max |F_a - F_b| / max |F| over the pairs of JAX's five backends (einsum,
# fused_infer on mega and with use_mega=False, pallas, fused) on
# _toy_batch() with _toy("bfloat16") initialized from seed 0 (Pallas in
# interpret mode), measured on the CPU: 1.821e-2 on float32 positions
# (einsum vs use_mega=False), 3.590e-2 on bfloat16 positions (einsum vs mega)
SPREAD_F32 = 1.821e-2
SPREAD_BF16 = 3.590e-2
ROUTES = {"einsum": dict(tp_kernel_backend="einsum"),
          "mega": dict(tp_kernel_backend="fused_infer"),
          "use_mega=False": dict(tp_kernel_backend="fused_infer", use_mega=False),
          "pallas": dict(tp_kernel_backend="pallas")}


def _bf16(rng, *shape):
    """bfloat16 inputs (zero on the sentinel edges, as _arr)."""
    return torch.as_tensor(_arr(rng, *shape)).to(BF)


def _within(got, want):
    """A bfloat16 output within 1 bf16 ulp of JAX's; a float32 one within
    KERNEL_TOL of its max."""
    w = np.asarray(want, dtype=np.float64)
    g = got.double().numpy()
    assert g.shape == w.shape, (g.shape, w.shape)
    if got.dtype == BF:
        a = np.maximum(np.abs(w), np.abs(g)).clip(2.0**-126)
        ulp = np.exp2(np.floor(np.log2(a)) - 7)
        assert (np.abs(g - w) <= ulp).all(), float((np.abs(g - w) / ulp).max())
        return
    err = float(np.abs(g - w).max())
    assert err <= KERNEL_TOL * max(float(np.abs(w).max()), 1e-30), f"max abs err {err:.3e}"


def test_env_weight_forms_on_bf16_sh_match_pallas(graph, interpret):
    """Kernels 1 and 4: sh and the env weights bfloat16 (env and dsh
    float32, dwexp bfloat16, as JAX stores them)."""
    rng, Ep = np.random.RandomState(200), graph["Ep"]
    sh, wexp = _bf16(rng, Ep, 9), _bf16(rng, Ep, N_IRR * U)
    kw = dict(dim_to_irr=DIM_TO_IRR, U=U, eb=EB)
    c, row_ptr, d2i = graph["t_centers"], graph["row_ptr"], graph["d2i"]
    eA, eB = jax_ftp.env_scatter_call(_j(sh), _j(wexp), graph["offs"], graph["win"],
                                      n_rank_rows=graph["nr"], **kw)
    env = fused_tp.env_scatter(sh, wexp, c, row_ptr, d2i, U)
    assert env.dtype == torch.float32 and str(eA.dtype) == "float32"
    _within(env, _atoms_of(graph, eA, eB))
    tA, tB, t = _env_pair(graph, rng)
    t32 = t.float()
    tA, tB = tA.astype(jnp.float32), tB.astype(jnp.float32)
    dsh_j, dwexp_j = jax_ftp.unweight_both_raw_call(tA, tB, _j(sh), _j(wexp), graph["offs"],
                                                    graph["win"], **kw)
    dsh, dwexp = fused_tp.unweight_both(t32, sh, wexp, c, d2i)
    assert (dsh.dtype, dwexp.dtype) == (torch.float32, BF)
    assert (str(dsh_j.dtype), str(dwexp_j.dtype)) == ("float32", "bfloat16")
    _within(dsh, dsh_j)
    _within(dwexp, dwexp_j)


@pytest.mark.parametrize("layer", [0, 1])
def test_gather_tp_and_bwd_fused_with_bf16_scalars_match_pallas(graph, interpret, layer):
    """Kernels 2 and 3 on bfloat16 features and weights, the split scalars
    ts and their cotangent gts bfloat16 (JAX's scalar_dtype, the model's)."""
    (P, d1, d2, d3), entries, idx, coef = _tables(layer)
    rng, Ep = np.random.RandomState(210 + layer), graph["Ep"]
    x, g, gts = _bf16(rng, Ep, d1 * U), _bf16(rng, Ep, d3 * U), _bf16(rng, Ep, U)
    w = torch.as_tensor(rng.randn(P, U)).to(BF)
    eA, eB, env = _env_pair(graph, rng)
    eA, eB, env = eA.astype(jnp.float32), eB.astype(jnp.float32), env.float()
    kw = dict(entries=entries, dims=(d1, d2, d3), U=U, eb=EB)
    coef32 = coef.float()
    out_j, ts_j = jax_ftp.gather_tp_raw_call(_j(x), eA, eB, _j(w), graph["offs"], graph["win"],
                                             split_scalars=True, scalar_dtype=jnp.bfloat16, **kw)
    out, ts = fused_tp.gather_tp(x, env, w.float(), graph["t_centers"], idx, coef32, d3, True,
                                 ts_dtype=BF)
    assert (out.dtype, ts.dtype) == (BF, BF) and str(ts_j.dtype) == "bfloat16"
    _within(out, out_j)
    _within(ts, ts_j)
    dx_j, dA, dB = jax_ftp.bwd_fused_raw_call(
        _j(x), _j(g), eA, eB, _j(w), graph["offs"], graph["win"], n_rank_rows=graph["nr"],
        gts=_j(gts), **kw)
    dx, denv = fused_tp.bwd_fused(x, g, env, w.float(), graph["t_centers"], graph["row_ptr"], idx,
                                  coef32, gts)
    assert (dx.dtype, denv.dtype) == (BF, torch.float32)
    _within(dx, dx_j)
    _within(denv, _atoms_of(graph, dA, dB))


def test_embed_forms_on_bf16_factors_match_pallas(graph, interpret):
    """Kernels 9 and 10: sh, w2b, the path weights, g and gts bfloat16; out
    and ts bfloat16, dsh, dw2b and denv float32 (JAX's compute dtype)."""
    (P, d1, d2, d3), entries, idx, coef = _tables(0)
    rng, Ep = np.random.RandomState(220), graph["Ep"]
    sh, w2b = _bf16(rng, Ep, 9), _bf16(rng, Ep, N_IRR * U)
    g, gts = _bf16(rng, Ep, d3 * U), _bf16(rng, Ep, U)
    w = torch.as_tensor(rng.randn(P, U)).to(BF)
    specs = tuple((j, DIM_TO_IRR[j]) for j in range(d1))
    t_specs = torch.tensor(specs, dtype=torch.int32)
    eA, eB, env = _env_pair(graph, rng)
    eA, eB, env = eA.astype(jnp.float32), eB.astype(jnp.float32), env.float()
    kw = dict(entries=entries, dims=(d1, d2, d3), U=U, eb=EB, row_specs=specs)
    out_j, ts_j = jax_ftp.gather_tp_embed_raw_call(
        _j(sh), _j(w2b), eA, eB, _j(w), graph["offs"], graph["win"], split_scalars=True,
        out_dtype=jnp.bfloat16, scalar_dtype=jnp.bfloat16, **kw)
    out, ts = fused_tp.gather_tp_embed(sh, w2b, env, w.float(), graph["t_centers"],
                                       graph["row_ptr"], idx, coef.float(), t_specs, d3, True)
    assert (out.dtype, ts.dtype) == (BF, BF)
    _within(out, out_j)
    _within(ts, ts_j)
    dsh_j, dw2b_j, dA, dB = jax_ftp.bwd_embed_raw_call(
        _j(sh), _j(w2b), _j(g), eA, eB, _j(w), graph["offs"], graph["win"],
        n_rank_rows=graph["nr"], gts=_j(gts), **kw)
    dsh, dw2b, denv = fused_tp.bwd_embed(sh, w2b, g, env, w.float(), graph["t_centers"],
                                         graph["row_ptr"], idx, coef.float(), t_specs, gts)
    assert {dsh.dtype, dw2b.dtype, denv.dtype} == {torch.float32}
    assert {str(dsh_j.dtype), str(dw2b_j.dtype), str(dA.dtype)} == {"float32"}
    _within(dsh, dsh_j)
    _within(dw2b, dw2b_j)
    _within(denv, _atoms_of(graph, dA, dB))


@pytest.mark.parametrize("n_hidden", [0, 1])
def test_latent_env_forms_on_bf16_pieces_match_pallas(graph, interpret, n_hidden):
    """Kernels 7 and 8 as JAX's bfloat16 model runs them: the first
    projection on a bfloat16 embedding, a latent on float32 scalars beside
    bfloat16 tensor scalars; sh and the weights bfloat16; lat_s, env, dsh
    and the piece cotangents float32."""
    rng, Ep, n_out = np.random.RandomState(230 + n_hidden), graph["Ep"], S + N_IRR * U
    if n_hidden:
        pieces = [torch.as_tensor(_arr(rng, Ep, S)).float(), _bf16(rng, Ep, U)]
        w0 = torch.as_tensor(rng.randn(S + U, H) / (S + U) ** 0.5).to(BF)
        w1 = torch.as_tensor(rng.randn(H, n_out) / H**0.5).to(BF)
    else:
        pieces = [_bf16(rng, Ep, S)]
        w0, w1 = torch.as_tensor(rng.randn(S, n_out) / S**0.5).to(BF), None
    sh = _bf16(rng, Ep, 9)
    kw = dict(dim_to_irr=DIM_TO_IRR, U=U, eb=EB, S=S, n_hidden=n_hidden, wexp_dtype=None)
    jp = tuple(_j(p) for p in pieces)
    jw1 = None if w1 is None else _j(w1)
    lat_j, eA, eB = jax_ftp.latent_env_scatter_call(jp, _j(sh), _j(w0), jw1, graph["offs"],
                                                    graph["win"], n_rank_rows=graph["nr"], **kw)
    wide1 = None if w1 is None else w1.float()
    lat_s, env = fused_tp.latent_env_scatter(pieces, sh, w0.float(), wide1, graph["t_centers"],
                                             graph["row_ptr"], graph["d2i"], U, S)
    assert (lat_s.dtype, env.dtype) == (torch.float32, torch.float32)
    _within(lat_s, lat_j)
    _within(env, _atoms_of(graph, eA, eB))
    tA, tB, t = _env_pair(graph, rng)
    tA, tB, t = tA.astype(jnp.float32), tB.astype(jnp.float32), t.float()
    g_lat = torch.as_tensor(_arr(rng, Ep, S)).float()
    dsh_j, dp_j = jax_ftp.latent_env_bwd_call(jp, _j(sh), _j(w0), jw1, tA, tB, _j(g_lat),
                                              graph["offs"], graph["win"], **kw)
    dsh, dpieces = fused_tp.latent_env_bwd(pieces, sh, w0.float(), wide1, t, g_lat,
                                           graph["t_centers"], graph["d2i"], U, S)
    assert {dsh.dtype, *(d.dtype for d in dpieces)} == {torch.float32}
    _within(dsh, dsh_j)
    for got, want in zip(dpieces, dp_j):
        _within(got, want)


def test_readout_forms_on_bf16_pieces_match_pallas(graph, interpret):
    """Kernels 11 and 12 on ``use_mega=False``'s bfloat16 pieces and
    weights: the energy and the piece cotangents float32."""
    rng, Ep = np.random.RandomState(240), graph["Ep"]
    pieces = [_bf16(rng, Ep, S) for _ in range(3)]
    w0 = torch.as_tensor(rng.randn(3 * S, H) / (3 * S) ** 0.5).to(BF)
    w1 = torch.as_tensor(rng.randn(H, 1) / H**0.5).to(BF)
    jp = tuple(_j(p) for p in pieces)
    kw = dict(eb=EB, n_hidden=1, mlp_passes=6, passes=3)
    eA, eB = jax_ftp.readout_sum_call(jp, _j(w0), _j(w1), graph["offs"], graph["win"],
                                      n_rank_rows=graph["nr"], **kw)
    energy = fused_tp.readout_sum(pieces, w0.float(), w1.float(), graph["row_ptr"])
    assert energy.dtype == torch.float32 and str(eA.dtype) == "float32"
    _within(energy, _atoms_of(graph, eA, eB))
    y = torch.as_tensor(rng.randn(len(graph["row_ptr"]) - 1, 1)).float()
    dp_j = jax_ftp.readout_bwd_call(jp, _j(w0), _j(w1), _rank(graph, y.numpy()).astype(
        jnp.float32), graph["offs"], graph["win"], **kw)
    dpieces = fused_tp.readout_bwd(pieces, w0.float(), w1.float(), y, graph["t_centers"])
    for got, want in zip(dpieces, dp_j):
        assert got.dtype == torch.float32 and str(want.dtype) == "float32"
        _within(got, want)


def test_center_forms_on_bf16_rows_match_pallas(graph, interpret):
    """Kernels 5 and 6 on bfloat16 rows (positions, pallas's env rows):
    the gather a copy (JAX's is float32 of the same values), the sum in
    float32 rounded once to bfloat16 (JAX's float32 sum, rounded)."""
    rng, Ep = np.random.RandomState(250), graph["Ep"]
    n_atoms = len(graph["row_ptr"]) - 1
    for C in (3, 9 * U):
        a = torch.as_tensor(rng.randn(n_atoms, C)).to(BF)
        aT = _rank(graph, a.float().numpy()).T.astype(jnp.bfloat16)
        want = jax_ftp.center_broadcast_call(aT, graph["offs"], graph["win"], eb=EB, Ep=Ep)
        got = fused_tp.center_gather(a, graph["t_centers"])
        assert got.dtype == BF and str(want.dtype) == "float32"
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).T)
        v = _bf16(rng, Ep, C)
        sA, sB = jax_ftp.center_sum_call(_j(v).T, graph["offs"], graph["win"], eb=EB,
                                         n_rank_rows=graph["nr"])
        s = fused_tp.center_sum(v, graph["row_ptr"])
        assert s.dtype == BF and str(sA.dtype) == "float32"
        _within(s, _atoms_of(graph, sA.T, sB.T))


@pytest.mark.parametrize("order", [0, 5, 1], ids=["table", "a-swap", "b-swap"])
def test_sparse_tp_bf16_rounds_as_pallas(order, monkeypatch):
    """Kernel 20 on bfloat16 a, b and w: JAX's ``_tp_kernel`` does not
    promote, so each product and running sum rounds to bfloat16 in the
    table's entry order; the port's plain version (the form's semantics)
    gives the same bits, on the layer's table and on the role orders of its
    transposes (JAX's ``_swap_a_out`` / ``_swap_b_out``)."""
    (P, d1, d2, d3), entries, _, _ = _tables(0)
    roles = pallas_contract.ROLES[order]
    table = pallas_contract.permute_entries(entries, roles)
    dims = [(d1, d2, d3)[r] for r in roles]
    idx = torch.tensor([e[:4] for e in table], dtype=torch.int32)
    coef = torch.tensor([e[4] for e in table], dtype=torch.float32)
    rng = np.random.RandomState(260 + order)
    E, L = 64, 128  # E * U edges' channels fill the JAX kernel's 128 lanes twice
    a = torch.as_tensor(rng.randn(E, dims[0] * U)).to(BF)
    b = torch.as_tensor(rng.randn(E, dims[1] * U)).to(BF)
    w = torch.as_tensor(rng.randn(P, U)).to(BF)

    def packed(t, d):  # [E, d*U] -> JAX's [d, E*U/128, 128]
        return _j(t).reshape(E, d, U).transpose(1, 0, 2).reshape(d, E * U // L, L)

    w_lanes = jnp.tile(_j(w), (1, L // U))
    monkeypatch.setattr(jax_pallas, "INTERPRET", True)
    want = jax_pallas._run_tp(packed(a, dims[0]), packed(b, dims[1]), w_lanes, table, dims[2], 2)
    got = pallas_contract.sparse_tp(a, b, w, idx, coef, dims[2])
    assert got.dtype == BF and str(want.dtype) == "bfloat16"
    want = np.asarray(want.astype(jnp.float32)).reshape(dims[2], E, U).transpose(1, 0, 2)
    np.testing.assert_array_equal(got.float().numpy().reshape(E, dims[2], U), want)


@pytest.fixture(scope="module")
def jax_toy():
    """JAX's bfloat16 toy (seed 0) on each route and on float32 and bfloat16
    positions (Pallas in interpret mode): its parameters, and its outputs'
    forces and dtypes."""
    batch = _toy_batch()
    params = JaxAllegroModel(**_toy("bfloat16")).init(0, to_jax(batch, dtype=np.float32))
    old = jax_ftp.INTERPRET, jax_pallas.INTERPRET
    jax_ftp.INTERPRET = jax_pallas.INTERPRET = True
    want = {}
    try:
        for name, kw in ROUTES.items():
            jm = JaxAllegroModel(**_toy("bfloat16", **kw))
            jb = to_jax(jm.precompute_statics(batch), dtype=np.float32)
            for data in ("float32", "bfloat16"):
                jd = jb if data == "float32" else {
                    k: v.astype(jnp.bfloat16) if v.dtype == jnp.float32 else v
                    for k, v in jb.items()}
                out = jax.jit(jm.apply_with_derivatives)(params, jd)
                want[name, data] = (np.asarray(out[keys.FORCES], dtype=np.float64),
                                    str(out[keys.TOTAL_ENERGY].dtype), str(out[keys.FORCES].dtype))
    finally:
        jax_ftp.INTERPRET, jax_pallas.INTERPRET = old
    return batch, params_from_jax(jax.tree_util.tree_map(np.asarray, params)), want


@pytest.mark.parametrize("data", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_toy_matches_jax_on_each_route(jax_toy, route, data):
    """JAX's output dtypes exactly, on every route: a float32 or bfloat16
    force in the positions' dtype, a bfloat16 energy except on the mega
    path, whose readout reads float32 pieces (the toy has an atom without
    edges, so JAX's fused readout does not run); the forces within JAX's
    own cross-backend spread of JAX's same backend."""
    batch, params, want = jax_toy
    f_want, e_dtype, f_dtype = want[route, data]
    model = AllegroModel(**_toy("bfloat16", **ROUTES[route]))
    model.load_state_dict(params)
    tb = to_torch(model.precompute_statics(batch), torch.float32)
    if data == "bfloat16":
        tb = {k: v.to(BF) if v.dtype == torch.float32 else v for k, v in tb.items()}
    out = model.apply_with_derivatives(tb)
    assert str(out[keys.TOTAL_ENERGY].dtype) == f"torch.{e_dtype}"
    assert str(out[keys.FORCES].dtype) == f"torch.{f_dtype}"
    f = out[keys.FORCES].double().numpy()
    spread = SPREAD_F32 if data == "float32" else SPREAD_BF16
    rel = float(np.abs(f - f_want).max() / np.abs(f_want).max())
    assert rel <= spread, (route, data, rel)


def test_mega_energy_dtype_follows_jaxs_readout():
    """Where every atom has edges, JAX's fused readout runs and stores the
    energy in the model dtype; the port's too (its rank-identity marker)."""
    rng = np.random.RandomState(3)
    from allegro_tpu_torch.data import batch_frames, neighbor_list

    frame = {keys.POSITIONS: rng.randn(12, 3) * 1.4,
             keys.ATOM_TYPES: rng.randint(0, 3, 12).astype(np.int32)}
    batch = batch_frames([neighbor_list(frame, 2.5)], n_frames=1)
    jm = JaxAllegroModel(**_toy("bfloat16", tp_kernel_backend="fused_infer"))
    jb = to_jax(jm.precompute_statics(batch), dtype=np.float32)
    assert keys.CENTER_RANK_IDENTITY in jb
    params = jm.init(0, jb)
    old = jax_ftp.INTERPRET
    jax_ftp.INTERPRET = True
    try:
        want = jax.jit(jm.apply)(params, jb)[keys.TOTAL_ENERGY]
    finally:
        jax_ftp.INTERPRET = old
    model = AllegroModel(**_toy("bfloat16", tp_kernel_backend="fused_infer"))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    data = model.precompute_statics(batch)
    assert keys.CENTER_RANK_IDENTITY in data
    got = model.apply(to_torch(data, torch.float32))[keys.TOTAL_ENERGY]
    assert str(want.dtype) == "bfloat16" and got.dtype == BF


def test_params_from_jax_takes_bf16_leaves_bit_for_bit():
    """JAX's bfloat16 leaves (``ml_dtypes`` arrays in numpy) load with their
    bits; float32 arrays that hold bfloat16 values load to the same bits."""
    batch = _toy_batch()
    params = JaxAllegroModel(**_toy("bfloat16")).init(0, to_jax(batch, dtype=np.float32))
    leaves = jax.tree_util.tree_map(np.asarray, params)
    named = params_from_jax(leaves)
    flat = jax.tree_util.tree_leaves(leaves)
    assert {str(a.dtype) for a in flat} == {"bfloat16"}
    assert {t.dtype for t in named.values()} == {BF}
    want = sorted(a.view(np.int16).tobytes() for a in flat)
    assert sorted(t.view(torch.int16).numpy().tobytes() for t in named.values()) == want
    model = AllegroModel(**_toy("bfloat16"))
    model.load_state_dict(named)
    wide = params_from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params))
    other = AllegroModel(**_toy("bfloat16"))
    other.load_state_dict(wide)
    for (k, a), (_, b) in zip(model.state_dict().items(), other.state_dict().items()):
        assert a.dtype == b.dtype == BF and torch.equal(a.view(torch.int16), b.view(torch.int16)), k


def test_training_the_fused_backend_and_export_raise_naming_item_14():
    """Of the three raises naming item 14, the export's stays (the next
    slice); training (``Trainer``, a force loss's parameter gradient on
    ``pallas``) and the ``fused`` build run now
    (``tests/test_torch_model_dtype_bf16_train.py`` holds them to JAX)."""
    model = AllegroModel(**_toy("bfloat16", tp_kernel_backend="pallas"))
    with pytest.raises(NotImplementedError, match="queue 1, item 14"):
        check_exportable(AllegroModel(**_toy("bfloat16", tp_kernel_backend="fused_infer")))
    with pytest.raises(NotImplementedError, match="queue 1, item 14"):
        check_exportable(AllegroModel(**_toy("bfloat16", tp_kernel_backend="fused")))
    assert Trainer(model, device="cpu").model is model
    fused = AllegroModel(**_toy("bfloat16", tp_kernel_backend="fused"))
    assert {p.dtype for p in fused.parameters().values()} == {BF}
    model.init(0)
    data = to_torch(model.precompute_statics(_toy_batch()), torch.float32)
    out = model.apply_with_derivatives(data, create_graph=True)
    grads = torch.autograd.grad(out[keys.FORCES].float().square().sum(),
                                list(model.parameters().values()), allow_unused=True)
    assert {g.dtype for g in grads if g is not None} == {BF}


def test_md_calculator_and_cli_run_a_bf16_model(tmp_path):
    """On the default route, float32 positions (the entry points' default,
    JAX's too): MD steps with finite float positions, a calculator call
    whose bfloat16 energies come back as float32 arrays (numpy has no
    bfloat16) of the call's values, and the CLI's md stage with
    ``model_dtype: bfloat16``."""
    from allegro_tpu_torch.cli import main

    model = AllegroModel(**_toy("bfloat16", tp_kernel_backend="fused_infer")).init(0)
    rng = np.random.RandomState(0)
    grid = np.stack(np.meshgrid(*(np.arange(3),) * 3, indexing="ij"), -1).reshape(-1, 3) * 1.8
    pos = grid + 0.05 * rng.randn(*grid.shape)
    types, cell = rng.randint(0, 3, len(grid)).astype(np.int32), np.eye(3) * 5.4
    sim = Simulation(model, atom_types=types, masses=np.ones(3), r_max=2.5, cell=cell,
                     pbc=(True,) * 3, dt=0.005, steps_per_block=5, device="cpu")
    state = sim.run(MDState(pos.copy(), np.zeros_like(pos)), 10)
    assert np.isfinite(state.positions).all() and not np.allclose(state.positions, pos)
    res = AllegroCalculator(model, device="cpu").calculate(pos, atom_types=types, cell=cell,
                                                           pbc=(True,) * 3)
    assert res["energies"].dtype == np.float32 and res["forces"].dtype == np.float32
    assert np.array_equal(res["energies"], res["energies"].astype(
        jnp.bfloat16).astype(np.float32))
    with open("configs/md.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["model"].update(l_max=1, num_scalar_features=8, num_tensor_features=4,
                        model_dtype="bfloat16")
    cfg["md"].update(n_atoms=27, n_steps=10, steps_per_block=5)
    path = tmp_path / "md.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert main(["md", "-c", str(path), "-w", str(tmp_path / "md"), "--device", "cpu"]) == 0
