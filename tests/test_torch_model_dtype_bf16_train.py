"""Training a bfloat16 model (``model_dtype="bfloat16"``, ROADMAP item 14's
first half) on the CPU, against the JAX package.

- The kernels of the trainable families at a bfloat16 model's training
  dtypes, through their plain versions (the CPU path), against the JAX
  Pallas kernels they replace, run in interpret mode on the same inputs:
  13 ``gather_tp`` on the role-swapped table, 14 ``tp_scatter``, 15
  ``gather_dw`` (features and cotangents bfloat16, env float32), 16
  ``unweight_sh`` (bfloat16 env weights) and 17 ``unweight_w`` (bfloat16
  sh, dwexp stored in bfloat16): bfloat16 outputs within 1 bf16 ulp of
  JAX's, float32 ones within ``KERNEL_TOL`` of their max (JAX sums in rank
  windows, the port in edge order). 21 ``sparse_tp_gradw`` on bfloat16 a,
  b and g: the same bits as JAX's ``_gradw_kernel`` followed by the fold of
  its lane-tiled output, in each role order a ``pallas`` training step
  launches it (``pallas_contract.sparse_tp_gradw_bf16_reference`` sums the
  edges in JAX's packed groups).
- The dtype pairs: every kernel call of a bfloat16 model's training step on
  ``fused`` and ``pallas``, enumerated on the CPU path and replayed through
  each wrapper's CUDA checks (the launch recorded, not made), has a form,
  and each is a bf16 form.
- The toy's first-step force-loss gradients on ``einsum``, ``pallas`` and
  ``fused`` against ``jax.grad`` of JAX's same backend: bfloat16, as JAX's,
  and within ``SPREAD_GRAD``.
- optax's ``adam``, ``adamw`` and ``sgd`` over bfloat16 parameters, and
  adam under an exponential decay: the same bits as optax (jitted, 64-bit
  types off) after three updates; optax's bias corrections for every
  update up to 10,000; the EMA: the same bits as JAX's expression.
- ``Trainer`` for three Adam steps on each backend against JAX's
  ``Trainer`` on ``einsum`` and ``pallas`` (JAX's ``fused`` Trainer fails
  under its ``vmap`` in float32 too), the parameters' and the EMA's updates
  held, and a Trainer that skips its updates refused; a two-entry CPU mesh
  against one device; the CLI's ``train``, ``test`` and ``package``
  stages; checkpoints keep the parameters' bits.

``bf16_grad_probe.py`` beside this file measures ``SPREAD_GRAD`` and the
port's distance from JAX's gradients.
"""

import contextlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import yaml

from allegro_tpu.data import DataLoader as JaxDataLoader
from allegro_tpu.data import InMemoryDataset as JaxInMemoryDataset
from allegro_tpu.data import to_jax
from allegro_tpu.data.datasets import synthetic_molecular_frames as jax_synthetic_frames
from allegro_tpu.model import AllegroModel as JaxAllegroModel
from allegro_tpu.ops import fused_tp as jax_ftp
from allegro_tpu.ops import pallas_contract as jax_pallas
from allegro_tpu.train import Trainer as JaxTrainer

from allegro_tpu_torch.data import (DataLoader, InMemoryDataset, keys,
                                    synthetic_molecular_frames, to_torch)
from allegro_tpu_torch.model import AllegroModel, params_from_jax
from allegro_tpu_torch.ops import fused_tp, pallas_contract
from allegro_tpu_torch.train import Trainer, TrainState, load_checkpoint, save_checkpoint
from allegro_tpu_torch.train.optim import (OptaxBf16, bias_correction, optimizer_from_config,
                                           schedule_from_config)
from test_torch_bf16_kernels import (DIM_TO_IRR, EB, N_IRR, U, _arr, _atoms_of, _env_pair, _j,
                                     _rank, _tables, graph, interpret)  # noqa: F401
from test_torch_bf16_track import WRAPPERS, _signature, _toy, _toy_batch
from test_torch_model_dtype_bf16 import SPREAD_F32
from torch_threads import one_thread  # noqa: F401

BF = torch.bfloat16
KERNEL_TOL = 1e-5  # chip_smoke.py's: a float32 output against its reference
# JAX's own spread of the bf16 toy's first-step gradients: max over the
# leaves of max |g_a - g_b| / max(|g_a|, |g_b|), over every pair of JAX's
# einsum, pallas and fused gradients of _toy("bfloat16") and its float32
# einsum gradient on the same weights, on _toy_batch(b) with weights from
# seed s (Pallas in interpret mode; loss sum F^2 + (sum E)^2, E widened to
# float32). Measured on the CPU for (s, b) = (0, 9), (1, 21), (2, 22), (3,
# 23): 3.472e-2, 6.646e-2, 2.268e-2, 4.478e-2; the gate is their largest.
# The gate is held at (0, 9) only, where the port's gradients lie against
# JAX's same backend (einsum, pallas, fused) 2.083e-2, 2.308e-2, 4.255e-2
# (fused beyond that draw's own spread) and at most 6.019e-2 from the
# float32 gradient. At the other draws: 6.912e-2, 3.782e-2, 4.054e-2 (seed
# 1: einsum beyond the gate); 3.589e-2, 2.747e-2, 1.333e-2; 1.786e-2,
# 3.465e-2, 3.012e-2. The port does not round where XLA does: ROADMAP's
# recorded departure "A bfloat16 model's gradients are not JAX's bits"
# names two of the places (bfloat16 segment sums, bfloat16-rounded Python
# constants) and what they leave.
SPREAD_GRAD = 6.646e-2
# three Adam steps (lr 5e-3) of the port's Trainer against JAX's on the same
# bfloat16 weights and batches, each leaf's update d = final - initial held:
# |d_port - d_jax| / |d_jax| over all leaves and the share of the elements
# JAX moved that the port moves the other way (or not at all). Measured on
# the CPU over the three backends against JAX's einsum and pallas runs:
# parameters at most 5.94e-2 and 5.5e-3 (JAX's own einsum against pallas
# 3.89e-2 and 3.1e-3), EMA at most 0.109 and 4.03e-2 (JAX's own 4.19e-2 and
# 3.5e-3; an EMA moves by less than a bfloat16 ulp of its value in a step,
# so one rounding flip is a large share of its update); the epoch's mean
# loss at most 4.2e-4 apart (relative; JAX's own 3.0e-5). A Trainer that
# leaves the weights where they were is at 1.0 and 1.0.
TRAINER_PARAM_TOL = (0.12, 0.02)
TRAINER_EMA_TOL = (0.22, 0.08)
# and each element of the parameters and the EMA: at most 1.172e-2 apart
# (max abs; JAX's own 9.766e-3), about 2 lr, where an element's gradient
# has another sign in the two runs and Adam moves it by lr the other way
TRAINER_TOL = 3 * 5e-3
TRAINER_LOSS_TOL = 1e-3
PALLAS_GRADW_ORDERS = (0, 1, 5)  # the role orders of a pallas training step's gradw launches


@pytest.fixture(scope="module")
def interpret_all():
    old = jax_ftp.INTERPRET, jax_pallas.INTERPRET
    jax_ftp.INTERPRET = jax_pallas.INTERPRET = True
    yield
    jax_ftp.INTERPRET, jax_pallas.INTERPRET = old


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


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layer", [0, 1])
def test_gather_tp_swapped_tp_scatter_and_gather_dw_forms_match_pallas(graph, interpret, layer):
    """Kernels 13, 14 and 15 as a bfloat16 model's double backward runs them:
    the features and cotangents bfloat16, the env float32, the path weights
    bfloat16 (JAX reads them so; the port's Functions widen them, exactly);
    13's out bfloat16, 14's denv and 15's dw float32 (JAX's compute dtype)."""
    (P, d1, d2, d3), entries, idx, coef = _tables(layer)
    rng, Ep = np.random.RandomState(300 + layer), graph["Ep"]
    x, g = _bf16(rng, Ep, d1 * U), _bf16(rng, Ep, d3 * U)
    w = torch.as_tensor(rng.randn(P, U)).to(BF)
    env = torch.as_tensor(rng.randn(len(graph["row_ptr"]) - 1, d2 * U)).float()
    env_r = _rank(graph, env.numpy()).astype(np.float32)
    c, rp, coef32 = graph["t_centers"], graph["row_ptr"], coef.float()
    kw = dict(U=U, eb=EB)
    swapped = tuple((k, j, i, p, cc) for (i, j, k, p, cc) in entries)
    dx_j = jax_ftp.gather_tp_call(_j(g), env_r, env_r, _j(w), graph["offs"], graph["win"],
                                  entries=swapped, dims=(d3, d2, d1), **kw)
    dx = fused_tp.gather_tp(g, env, w.float(), c, fused_tp.swap_entries(idx), coef32, d1)
    assert dx.dtype == BF and str(dx_j.dtype) == "bfloat16"
    _within(dx, dx_j)
    dA, dB = jax_ftp.tp_scatter_call(_j(x), _j(g), _j(w), graph["offs"], graph["win"],
                                     entries=entries, dims=(d1, d2, d3),
                                     n_rank_rows=graph["nr"], **kw)
    denv = fused_tp.tp_scatter(x, g, w.float(), c, rp, idx, coef32, d2)
    assert denv.dtype == torch.float32 and str(dA.dtype) == "float32"
    _within(denv, _atoms_of(graph, dA, dB))
    dw_j = jax_ftp.gather_dw_call(_j(x), env_r, env_r, _j(g), graph["offs"], graph["win"],
                                  entries=entries, dims=(d1, d2, d3), **kw)
    dw = fused_tp.gather_dw(x, env, g, c, idx, coef32, P, U)
    assert dw.dtype == torch.float32 and str(dw_j.dtype) == "float32"
    _within(dw, dw_j)


def test_unweight_forms_on_bf16_sh_and_env_weights_match_pallas(graph, interpret):
    """Kernels 16 and 17 as EnvScatter's transposes run them in a bfloat16
    model: dsh from float32 t and bfloat16 wexp (float32, JAX's compute
    dtype), dwexp from float32 t and bfloat16 sh, stored in bfloat16 (the
    env weights' dtype, JAX's out_dtype)."""
    rng, Ep = np.random.RandomState(310), graph["Ep"]
    sh, wexp = _bf16(rng, Ep, 9), _bf16(rng, Ep, N_IRR * U)
    _, _, t = _env_pair(graph, rng)
    t = t.float()
    t_r = _rank(graph, t.numpy()).astype(np.float32)
    kw = dict(dim_to_irr=DIM_TO_IRR, U=U, eb=EB)
    c, d2i = graph["t_centers"], graph["d2i"]
    dsh_j = jax_ftp.gather_unweight_sh_call(t_r, t_r, _j(wexp), graph["offs"], graph["win"], **kw)
    dsh = fused_tp.unweight_sh(t, wexp, c, d2i)
    assert dsh.dtype == torch.float32 and str(dsh_j.dtype) == "float32"
    _within(dsh, dsh_j)
    dwexp_j = jax_ftp.gather_unweight_w_call(t_r, t_r, _j(sh), graph["offs"], graph["win"],
                                             out_dtype=jnp.bfloat16, **kw)
    dwexp = fused_tp.unweight_w(t, sh, c, d2i, N_IRR, BF)
    assert dwexp.dtype == BF and str(dwexp_j.dtype) == "bfloat16"
    _within(dwexp, dwexp_j)


@pytest.mark.parametrize("order", PALLAS_GRADW_ORDERS, ids=["table", "b-swap", "a-swap"])
@pytest.mark.parametrize("U_", [32, 4])
def test_sparse_tp_gradw_bf16_is_pallas_bits(order, U_, monkeypatch):
    """Kernel 21 on bfloat16 a, b and g: JAX's ``_gradw_kernel`` (on its
    packed [d, E*U/128, 128] layout, blocks of 64 rows) and the fold of its
    [P, 128] output (the transpose of ``tile_weights``' ``jnp.tile``, a
    bfloat16 sum over the lane tiles in order) against the port's plain
    version on the flat [E, d*U] track: the same bits. U = 32 (the
    flagship's width: 4 edges a row, 256 a block) on three blocks, so the
    bfloat16 sum over the blocks is exercised; U = 4 (the toy's: 32 edges a
    row) on one block and a partial row."""
    (P, d1, d2, d3), entries, _, _ = _tables(0)
    roles = pallas_contract.ROLES[order]
    table = pallas_contract.permute_entries(entries, roles)
    dims = [(d1, d2, d3)[r] for r in roles]
    L, Q = 128, 128 // U_
    E = 600 if U_ == 32 else 300
    Ep = -(-E // Q) * Q
    rng = np.random.RandomState(320 + order)
    a, b, g = (torch.as_tensor(rng.randn(E, d * U_)).to(BF) for d in dims)

    def packed(t, d):  # [E, d*U] -> JAX's [d, Ep*U/128, 128], zero edges past E
        t = torch.cat([t, t.new_zeros(Ep - E, t.shape[1])])
        return _j(t).reshape(Ep, d, U_).transpose(1, 0, 2).reshape(d, Ep * U_ // L, L)

    monkeypatch.setattr(jax_pallas, "INTERPRET", True)
    ow = jax_pallas._run_gradw(packed(a, dims[0]), packed(b, dims[1]), packed(g, dims[2]), P,
                               table, 64)
    (want,) = jax.linear_transpose(lambda w: jnp.tile(w.T, (1, Q)).astype(jnp.bfloat16),
                                   jnp.zeros((U_, P), jnp.bfloat16))(ow)
    idx = torch.tensor([e[:4] for e in table], dtype=torch.int32)
    coef = torch.tensor([e[4] for e in table], dtype=torch.float32)
    got = pallas_contract.sparse_tp_gradw(a, b, g, idx, coef, P, U_)
    assert got.dtype == BF and str(want.dtype) == "bfloat16"
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)).T)


def test_sparse_tp_gradw_bf16_takes_jaxs_widths_only():
    """JAX's lane tiling needs U to divide 128; a mix of bfloat16 and float32
    operands has no form."""
    a = torch.zeros(8, 3 * 3, dtype=BF)
    idx, coef = torch.zeros((1, 4), dtype=torch.int32), torch.ones(1)
    with pytest.raises(ValueError, match="must divide"):
        pallas_contract.sparse_tp_gradw(a, a, a, idx, coef, 1, 3)
    with pytest.raises(TypeError, match="all bfloat16"):
        pallas_contract.sparse_tp_gradw(a, a.float(), a, idx, coef, 1, 3)


# ---------------------------------------------------------------------------
# the dtype pairs of a training step
# ---------------------------------------------------------------------------


def _loss(out):
    return (out[keys.FORCES] ** 2).sum() + out[keys.TOTAL_ENERGY].float().sum() ** 2


def _step_calls(monkeypatch, backend):
    """Each kernel call of the bf16 toy's force-loss gradient on ``backend``
    (wrapper name, wrapper, args, kwargs), the plain versions run."""
    calls = []
    mods = {name: fused_tp for name in WRAPPERS}
    mods.update(sparse_tp=pallas_contract, sparse_tp_gradw=pallas_contract)
    for name, mod in mods.items():
        fn = getattr(mod, name)

        def wrap(*a, _fn=fn, _name=name, **k):
            calls.append((_name, _fn, a, k))
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, wrap)
    m = AllegroModel(**_toy("bfloat16", tp_kernel_backend=backend)).init(0)
    out = m.apply_with_derivatives(to_torch(m.precompute_statics(_toy_batch()), torch.float32),
                                   create_graph=True)
    grads = torch.autograd.grad(_loss(out), list(m.parameters().values()))
    assert {g.dtype for g in grads} == {BF}
    monkeypatch.undo()
    return calls


# the (kernel, dtypes) pairs of a bfloat16 model's training step: on fused,
# the bf16 track's forms (features, cotangents and env weights bfloat16,
# env, denv, t and the widened path weights float32), env_scatter and
# unweight_w also on bfloat16 sh (the model's basis); on pallas every
# operand bfloat16
MODEL_TRAIN_PAIRS = {
    ("env_scatter", (("sh", "bfloat16"), ("wexp", "bfloat16"))),
    ("env_scatter", (("sh", "float32"), ("wexp", "bfloat16"))),
    ("gather_tp", (("x", "bfloat16"), ("env", "float32"), ("w", "float32"))),
    ("tp_scatter", (("x", "bfloat16"), ("g", "bfloat16"), ("w", "float32"))),
    ("gather_dw", (("x", "bfloat16"), ("env", "float32"), ("g", "bfloat16"))),
    ("unweight_sh", (("t", "float32"), ("wexp", "bfloat16"))),
    ("unweight_w", (("t", "float32"), ("sh", "bfloat16"), ("out_dtype", "bfloat16"))),
    ("unweight_w", (("t", "float32"), ("sh", "float32"), ("out_dtype", "bfloat16"))),
    ("sparse_tp", (("a", "bfloat16"), ("b", "bfloat16"), ("w", "bfloat16"))),
    ("sparse_tp_gradw", (("a", "bfloat16"), ("b", "bfloat16"), ("g", "bfloat16"))),
}


def test_every_kernel_call_of_a_bf16_training_step_has_a_bf16_form(monkeypatch):
    calls = [c for backend in ("fused", "pallas") for c in _step_calls(monkeypatch, backend)]
    launched = []
    monkeypatch.setattr(fused_tp, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(pallas_contract, "_on_cpu", lambda *t: False)
    for mod in (fused_tp, pallas_contract):
        monkeypatch.setattr(mod, "_launch",
                            lambda name, fn, device, *args, bf16=False: launched.append(bf16))
    seen = {}
    for name, fn, a, k in calls:
        n = len(launched)
        fn(*a, **k)
        assert len(launched) == n + 1, name
        seen.setdefault((name, _signature(fn, a, k)), set()).add(launched[-1])
    assert set(seen) == MODEL_TRAIN_PAIRS, sorted(set(seen) ^ MODEL_TRAIN_PAIRS)
    assert all(flags == {True} for flags in seen.values()), seen


# ---------------------------------------------------------------------------
# the toy's gradients against JAX's
# ---------------------------------------------------------------------------

BACKENDS = ("einsum", "pallas", "fused")


@pytest.fixture(scope="module")
def jax_grads(interpret_all):
    """JAX's bfloat16 toy (seed 0) on _toy_batch(): its parameters and the
    first-step force-loss gradients of each backend, and of the float32
    einsum model on the same weights ("float32"), under the port's names."""
    batch = _toy_batch()
    params = JaxAllegroModel(**_toy("bfloat16")).init(0, to_jax(batch, dtype=np.float32))
    grads, forces = {}, {}
    for backend in (*BACKENDS, "float32"):
        dtype = "float32" if backend == "float32" else "bfloat16"
        jm = JaxAllegroModel(**_toy(dtype, tp_kernel_backend=backend if dtype != "float32"
                                    else "einsum"))
        jb = to_jax(jm.precompute_statics(batch), dtype=np.float32)

        def loss(p, jm=jm, jb=jb):
            out = jm.apply_with_derivatives(p, jb)
            return (jnp.sum(out[keys.FORCES] ** 2)
                    + out[keys.TOTAL_ENERGY].astype(jnp.float32).sum() ** 2), out[keys.FORCES]

        p = params if dtype == "bfloat16" else jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32), params)
        g, forces[backend] = jax.jit(jax.grad(loss, has_aux=True))(p)
        assert {str(v.dtype) for v in jax.tree_util.tree_leaves(g)} == {dtype}
        grads[backend] = params_from_jax(jax.tree_util.tree_map(np.asarray, g))
    return batch, params_from_jax(jax.tree_util.tree_map(np.asarray, params)), grads, forces


def _spread(got, want):
    """max over the leaves of max |a - b| / max(|a|, |b|)."""
    worst = 0.0
    for k, g in got.items():
        a, b = g.double().numpy(), want[k].double().numpy()
        worst = max(worst, float(np.abs(a - b).max() / max(np.abs(a).max(), np.abs(b).max())))
    return worst


@pytest.mark.parametrize("backend", BACKENDS)
def test_toy_gradients_match_jaxs_same_backend(jax_grads, backend):
    """bfloat16 gradients, as JAX's, within SPREAD_GRAD of JAX's on the same
    backend and of the float32 gradient."""
    batch, params, grads, _ = jax_grads
    m = AllegroModel(**_toy("bfloat16", tp_kernel_backend=backend))
    m.load_state_dict(params)
    out = m.apply_with_derivatives(to_torch(m.precompute_statics(batch), torch.float32),
                                   create_graph=True)
    assert out[keys.FORCES].dtype == torch.float32 and out[keys.TOTAL_ENERGY].dtype == BF
    ps = m.parameters()
    got = dict(zip(ps, torch.autograd.grad(_loss(out), list(ps.values()))))
    want = grads[backend]
    assert sorted(got) == sorted(want)
    assert {g.dtype for g in got.values()} == {w.dtype for w in want.values()} == {BF}
    assert _spread(got, want) <= SPREAD_GRAD, (backend, _spread(got, want))
    assert _spread(got, grads["float32"]) <= SPREAD_GRAD, (backend, _spread(got, grads["float32"]))


def test_fused_force_call_matches_jaxs_fused(jax_grads):
    """The trainable ``fused`` backend's first-order force call (serving,
    the parameters frozen) on a bfloat16 model: float32 forces on float32
    positions, as JAX's ``fused``, within JAX's own spread of the toy's
    forces (``SPREAD_F32`` of tests/test_torch_model_dtype_bf16.py); only
    forward kernels and their first transposes run, none of the weight
    gradients."""
    batch, params, _, forces = jax_grads
    m = AllegroModel(**_toy("bfloat16", tp_kernel_backend="fused"))
    m.load_state_dict(params)
    fused_tp.reset_launch_counts()
    out = m.apply_with_derivatives(to_torch(m.precompute_statics(batch), torch.float32))
    assert fused_tp.LAUNCHES["gather_dw"] == fused_tp.LAUNCHES["unweight_w"] == 0
    want = np.asarray(forces["fused"], dtype=np.float64)
    assert out[keys.FORCES].dtype == torch.float32 and str(forces["fused"].dtype) == "float32"
    rel = float(np.abs(out[keys.FORCES].double().numpy() - want).max() / np.abs(want).max())
    assert rel <= SPREAD_F32, rel


# ---------------------------------------------------------------------------
# the optimizers and the EMA against optax and JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    {"_target_": "optax.adam", "learning_rate": 5e-3},
    {"_target_": "optax.adamw", "learning_rate": 5e-3, "weight_decay": 1e-2},
    {"_target_": "optax.sgd", "learning_rate": 5e-2, "momentum": 0.9},
    {"_target_": "optax.sgd", "learning_rate": 5e-2},
], ids=["adam", "adamw", "sgd-momentum", "sgd"])
def test_bf16_updates_are_optax_bits(cfg):
    """Three updates of a seeded bfloat16 vector: the parameters and the
    optimizer's moments the same bits as optax's, under ``jax.jit`` with
    64-bit types off, as JAX's Trainer runs them by default."""
    with jax.enable_x64(False):
        _updates_are_optax_bits(cfg)


def _updates_are_optax_bits(cfg, schedule=None):
    rng = np.random.RandomState(7)
    p0 = rng.randn(4096)
    grads = [rng.randn(4096) * s for s in (1e-2, 3e-2, 1e-3)]
    kw = {k: v for k, v in cfg.items() if k not in ("_target_", "learning_rate")}
    lr = cfg["learning_rate"]
    if schedule is not None:
        lr = optax.exponential_decay(lr, **{k: v for k, v in schedule.items() if k != "_target_"})
    jopt = getattr(optax, cfg["_target_"].split(".")[1])(lr, **kw)
    p = jnp.asarray(p0).astype(jnp.bfloat16)
    state = jopt.init(p)

    @jax.jit
    def step(g, state, p):
        u, state = jopt.update(g, state, p)
        return optax.apply_updates(p, u), state

    factory, base_lr = optimizer_from_config(cfg)
    tp = torch.nn.Parameter(torch.as_tensor(p0).to(BF))
    opt = factory([tp])
    sched = None if schedule is None else schedule_from_config(schedule, base_lr)(opt)
    assert isinstance(opt, OptaxBf16)
    for g in grads:
        p, state = step(jnp.asarray(g).astype(jnp.bfloat16), state, p)
        tp.grad = torch.as_tensor(g).to(BF)
        opt.step()
        if sched is not None:
            sched.step()  # as Trainer does, once per update
        np.testing.assert_array_equal(tp.detach().float().numpy(),
                                      np.asarray(p.astype(jnp.float32)))
    moments = [np.asarray(v.astype(jnp.float32)) for v in jax.tree_util.tree_leaves(state)
               if getattr(v, "dtype", None) == jnp.bfloat16]
    mine = [v.float().numpy() for v in opt.state[tp].values() if isinstance(v, torch.Tensor)]
    assert {v.dtype for v in opt.state[tp].values() if isinstance(v, torch.Tensor)} <= {BF}
    assert len(mine) == len(moments)
    for a, b in zip(mine, moments):
        np.testing.assert_array_equal(a, b)


def test_bf16_scheduled_learning_rate_is_optax_bits():
    """adam under ``exponential_decay``: optax evaluates the schedule in
    float32 and casts it to bfloat16; the same bits over three updates."""
    with jax.enable_x64(False):
        _updates_are_optax_bits({"_target_": "optax.adam", "learning_rate": 5e-3},
                                {"_target_": "optax.exponential_decay", "transition_steps": 1,
                                 "decay_rate": 0.7})


@pytest.mark.parametrize("b", [0.9, 0.999])
def test_bias_corrections_are_optax_bits(b):
    """optax's ``tree.bias_correction`` under ``jax.jit`` with 64-bit types
    off (``1 - b**t`` in float32, cast to the moments' bfloat16) against
    ``OptaxBf16``'s division by ``optim.bias_correction(b, t)``, for every
    update t up to 10,000 (1 - 0.999**t reaches 1 in bfloat16 near there):
    the same bits."""
    m = torch.as_tensor(np.random.RandomState(9).randn(64)).to(BF)
    mj = jnp.asarray(m.float().numpy()).astype(jnp.bfloat16)
    with jax.enable_x64(False):
        for t in range(1, 10_001):
            want = np.asarray(optax.tree.bias_correction(mj, b, jnp.int32(t)).astype(jnp.float32))
            got = (m / bias_correction(b, t)).float().numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"update {t}")


def test_float_parameters_keep_torch_optim():
    factory, _ = optimizer_from_config({"_target_": "optax.adam", "learning_rate": 1e-3})
    assert type(factory([torch.nn.Parameter(torch.zeros(3))])) is torch.optim.Adam


def test_ema_is_jaxs_expression():
    """``Trainer.update_ema`` on bfloat16 parameters: JAX's ``(decay * e +
    (1 - decay) * p).astype(p.dtype)``, float32 rounded once, at several
    steps of the warm-up decay; the same bits."""
    rng = np.random.RandomState(8)
    e0, p = rng.randn(4096), rng.randn(4096)
    trainer = Trainer(AllegroModel(**_toy("bfloat16")), device="cpu", logger=lambda s: None)
    for t in (0, 1, 5, 400):
        state = TrainState({"w": torch.as_tensor(p).to(BF)}, {"w": torch.as_tensor(e0).to(BF)},
                           None, t)
        trainer.update_ema(state)
        tf = jnp.float32(t)
        decay = jnp.minimum(0.999, (1.0 + tf) / (10.0 + tf))
        e, pj = jnp.asarray(e0).astype(jnp.bfloat16), jnp.asarray(p).astype(jnp.bfloat16)
        want = (decay * e + (1.0 - decay) * pj).astype(pj.dtype)
        np.testing.assert_array_equal(state.ema_params["w"].float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

TRAIN_KW = dict(r_max=2.0, type_names=["A", "B", "C"], l_max=1, num_layers=2,
                num_scalar_features=16, num_tensor_features=4,
                scalar_embed_mlp_hidden_layers_width=16, allegro_mlp_hidden_layers_width=16,
                readout_mlp_hidden_layers_width=8, avg_num_neighbors=3.0,
                per_type_energy_scales=1.0, model_dtype="bfloat16")


class _Float32:
    """A JAX loader's batches with their floats float32 (JAX's data without
    x64, the port's for a bfloat16 model)."""

    def __init__(self, loader):
        self.loader = loader

    def __iter__(self):
        for b in self.loader:
            yield {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in b.items()}


@pytest.fixture(scope="module")
def jax_trainers(interpret_all):
    """JAX's Trainer, three Adam steps (lr 5e-3) over one epoch of six
    synthetic frames, on einsum and on pallas: the initial parameters and
    each run's parameters, EMA and mean loss."""
    jds = JaxInMemoryDataset(jax_synthetic_frames(6, n_atoms=8, spread=1.2), r_max=2.0)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))
    runs = {}
    for backend in ("einsum", "pallas"):
        jt = JaxTrainer(JaxAllegroModel(**TRAIN_KW, tp_kernel_backend=backend),
                        optimizer=optax.adam(5e-3), mesh=mesh, logger=lambda s: None)
        state = jt.init_state(0, next(iter(_Float32(JaxDataLoader(jds, batch_size=2)))))
        init = params_from_jax(jax.tree_util.tree_map(np.asarray, state.params))
        state = jt.fit(state, _Float32(JaxDataLoader(jds, batch_size=2, shuffle=True, seed=0)),
                       max_epochs=1)
        assert state.step == 3
        leaves = jax.tree_util.tree_leaves((state.params, state.ema_params, state.opt_state))
        assert {str(v.dtype) for v in leaves} == {"bfloat16", "int32"}
        runs[backend] = tuple(params_from_jax(jax.tree_util.tree_map(np.asarray, t))
                              for t in (state.params, state.ema_params)) + (
            jt.history[0]["train_loss"],)
    return init, runs


def _port_trainer(init, backend):
    """The port's Trainer, three Adam steps from ``init`` over the epoch
    JAX's runs take: (state, the epoch's mean loss)."""
    ds = InMemoryDataset(synthetic_molecular_frames(6, n_atoms=8, spread=1.2), r_max=2.0)
    m = AllegroModel(**TRAIN_KW, tp_kernel_backend=backend)
    m.load_state_dict(init)
    trainer = Trainer(m, learning_rate=5e-3, device="cpu", logger=lambda s: None)
    state = trainer.fit(trainer.init_state(), DataLoader(ds, batch_size=2, shuffle=True, seed=0))
    return state, trainer.history[0]["train_loss"]


def _update_gap(got, want, init):
    """Over all leaves, with each leaf's update d = final - init:
    |d_got - d_want| / |d_want| (2-norms), and the share of the elements
    that JAX moved whose d_got has another sign than d_want."""
    diff = norm = other = moved = 0.0
    for k, v in got.items():
        d0 = init[k].double()
        a, b = v.detach().double() - d0, want[k].double() - d0
        diff += float(((a - b) ** 2).sum())
        norm += float((b ** 2).sum())
        other += float(((a * b <= 0) & (b != 0)).sum())
        moved += float((b != 0).sum())
    return (diff / norm) ** 0.5, other / moved


def _max_abs(got, want):
    return max(float((v.detach().double() - want[k].double()).abs().max())
               for k, v in got.items())


def _trainer_gaps(state, loss, init, runs):
    """Per JAX run: (parameter update gap, its sign share, EMA update gap,
    its sign share, the mean loss's relative gap, the parameters' and the
    EMA's largest element gap)."""
    return {jb: (*_update_gap(state.params, params, init),
                 *_update_gap(state.ema_params, ema, init), abs(loss - jl) / abs(jl),
                 max(_max_abs(state.params, params), _max_abs(state.ema_params, ema)))
            for jb, (params, ema, jl) in runs.items()}


def _trainer_agrees(gaps):
    (pt, pst), (et, est) = TRAINER_PARAM_TOL, TRAINER_EMA_TOL
    return all(pg <= pt and ps <= pst and eg <= et and es <= est and lg <= TRAINER_LOSS_TOL
               and ea <= TRAINER_TOL for pg, ps, eg, es, lg, ea in gaps.values())


@pytest.mark.parametrize("backend", BACKENDS)
def test_trainer_matches_jaxs_trainer(jax_trainers, backend):
    """The parameters' and the EMA's updates (final - initial) after three
    steps against JAX's Trainer's on einsum and on pallas, and the epoch's
    mean loss; parameters, EMA and moments bfloat16."""
    init, runs = jax_trainers
    state, loss = _port_trainer(init, backend)
    assert state.step == 3 and isinstance(state.opt_state, OptaxBf16)
    moments = [v for s in state.opt_state.state.values() for v in s.values()
               if isinstance(v, torch.Tensor)]
    assert {t.dtype for t in (*state.params.values(), *state.ema_params.values(), *moments)} \
        == {BF}
    gaps = _trainer_gaps(state, loss, init, runs)
    assert _trainer_agrees(gaps), gaps


def test_the_trainer_gate_fails_a_trainer_that_skips_its_updates(jax_trainers, monkeypatch):
    """A planted fault: the optimizer's step does nothing, so the weights
    stay where they started. The update terms of the gate of
    test_trainer_matches_jaxs_trainer refuse it, each of them."""
    init, runs = jax_trainers
    monkeypatch.setattr(OptaxBf16, "step", lambda self, closure=None: None)
    state, loss = _port_trainer(init, "einsum")
    gaps = _trainer_gaps(state, loss, init, runs)
    assert not _trainer_agrees(gaps), gaps
    (pt, pst), (et, est) = TRAINER_PARAM_TOL, TRAINER_EMA_TOL
    for pg, ps, eg, es, *_ in gaps.values():
        assert pg > pt and ps > pst and eg > et and es > est, gaps


def test_a_two_device_mesh_is_the_rows_mean(tmp_path):
    """Two rows on ``["cpu", "cpu"]``: the bfloat16 gradient is the two
    one-row gradients summed in float32, halved and rounded once; the step's
    parameters and checkpoint keep their bits."""
    ds = InMemoryDataset(synthetic_molecular_frames(2, n_atoms=8, spread=1.2), r_max=2.0)
    one = Trainer(AllegroModel(**TRAIN_KW, tp_kernel_backend="fused"), device="cpu",
                  logger=lambda s: None)
    state = one.init_state(0)
    two = Trainer(AllegroModel(**TRAIN_KW, tp_kernel_backend="fused"), mesh=["cpu", "cpu"],
                  logger=lambda s: None)
    state2 = two.init_state(0)
    rows = [one.to_device(b) for b in DataLoader(ds, batch_size=1)]
    assert rows[0][keys.POSITIONS].dtype == torch.float32
    _, _, g0 = one.loss_and_grads(state, rows[0])
    _, _, g1 = one.loss_and_grads(state, rows[1])
    _, _, g = two.loss_and_grads(state2, rows)
    for k in g:
        assert g[k].dtype == BF
        assert torch.equal(g[k], ((g0[k].float() + g1[k].float()) / 2).to(BF)), k
    two.train_step(state2, rows)
    save_checkpoint(str(tmp_path), state2)
    back = load_checkpoint(str(tmp_path))
    for k, v in state2.params.items():
        assert back.params[k].dtype == BF
        assert torch.equal(back.params[k].view(torch.int16), v.detach().view(torch.int16)), k


def test_cli_trains_tests_and_packages_a_bf16_model(tmp_path):
    """``model_dtype: bfloat16`` through the CLI's train, test and package
    stages on ``fused`` (JAX's tiny CLI config): finite losses, bfloat16
    checkpoints, and a package that loads back to the EMA parameters'
    bits."""
    from allegro_tpu_torch.cli import main
    from allegro_tpu_torch.train.package import load_package

    repo = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("_jax_cli_cfg", repo / "tests/train/test_cli.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = dict(mod.TINY_CFG, run=["train", "test", "package"])
    cfg["model"] = dict(cfg["model"], tp_kernel_backend="fused", model_dtype="bfloat16")
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg))
    work = tmp_path / "out"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["run", "-c", str(path), "-w", str(work), "--device", "cpu"]) == 0
    losses = [float(ln.split("train_loss=")[1].split()[0]) for ln in buf.getvalue().splitlines()
              if "train_loss=" in ln]
    assert losses and np.isfinite(losses).all(), buf.getvalue()
    assert "test metrics" in buf.getvalue()
    ckpt = load_checkpoint(str(work), "best")
    assert {v.dtype for v in (*ckpt.params.values(), *ckpt.ema_params.values())} == {BF}
    model, _, _ = load_package(str(work / "model.atpkg"))
    live = model.parameters()
    assert {v.dtype for v in live.values()} == {BF}
    for k, v in ckpt.ema_params.items():
        assert torch.equal(live[k].detach().view(torch.int16), v.view(torch.int16)), k
