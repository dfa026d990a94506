"""The bf16 tensor track off the mega route (ROADMAP item 6), on the CPU.

- Training on ``fused`` with ``tensor_dtype="bfloat16"``: a float64 toy
  model's force-loss parameter gradients against ``jax.grad`` of JAX's
  ``fused`` model (Pallas in interpret mode), the JAX side computed once in
  a module fixture. The path weights' gradients are the same bits (JAX casts
  the path weights to bfloat16 and sums their gradient's contributions in
  it; so does the port); the rest within ``F64_SCATTER_TOL`` of each
  parameter's max, because JAX's ``tp_scatter`` computes in the compute
  dtype of its two bf16 inputs, float32, also in a float64 model (measured
  2e-10). Parameters and gradients stay float32 through ``Trainer`` and
  ``python -m allegro_tpu_torch train``; two identical steps give the same
  bits.
- A model wider than the mega kernels' shared memory, routed to
  ``fused_call`` (the card's opt-in faked as in ``test_torch_routing.py``),
  runs with the track and keeps JAX's mega rounding points: against JAX's
  ``fused_infer`` (its mega path) at 1e-10 (float64) and ``F32_TRACK_TOL``
  (float32).
- The dtype pairs: every kernel call of a bf16 training step, a
  ``use_mega=False`` force call and a routed force call, enumerated on the
  CPU path, replayed through each wrapper's CUDA checks (its launch
  recorded, not made): each has a form, a bf16 one wherever an operand or
  out is bfloat16; the combinations without a form raise ``TypeError``.
- ``einsum`` and ``pallas`` ignore the track: the result is
  ``tensor_dtype=None``'s, bit for bit.
"""

import contextlib
import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from allegro_tpu.data import to_jax
from allegro_tpu.model import AllegroModel as JaxAllegroModel
from allegro_tpu.ops import fused_tp as jax_ftp

from allegro_tpu_torch.data import (DataLoader, InMemoryDataset, batch_frames, keys,
                                    neighbor_list, synthetic_molecular_frames, to_torch)
from allegro_tpu_torch.model import AllegroModel, params_from_jax
from allegro_tpu_torch.ops import fused_tp, smem_fit
from allegro_tpu_torch.train import Trainer
from torch_threads import one_thread  # noqa: F401

R_MAX = 2.5
TOL = 1e-10
F64_SCATTER_TOL = 1e-8
F32_TRACK_TOL = 1e-5  # tests/test_torch_precision.py's
OPTIN = 232448  # an H100 block's opt-in shared memory (227 KB)
BF = torch.bfloat16


def _toy(model_dtype, **kw):
    """JAX's ``tests/model/test_bf16_storage.py:_model`` kwargs."""
    return dict(
        r_max=R_MAX, type_names=["A", "B", "C"], l_max=2, parity=True, num_layers=2,
        num_scalar_features=16, num_tensor_features=4, scalar_embed_mlp_hidden_layers_width=16,
        allegro_mlp_hidden_layers_width=16, readout_mlp_hidden_layers_width=16,
        avg_num_neighbors=6.0, per_type_energy_scales=1.3,
        per_type_energy_shifts=[0.1, -0.2, 0.3], model_dtype=model_dtype, **kw,
    )


def _toy_batch(seed=9):
    rng = np.random.RandomState(seed)
    frame = {keys.POSITIONS: rng.randn(12, 3) * 1.4,
             keys.ATOM_TYPES: rng.randint(0, 3, 12).astype(np.int32)}
    return batch_frames([neighbor_list(frame, R_MAX)], n_atoms=14, n_frames=1, edge_multiple=16)


@contextlib.contextmanager
def _interpret():
    old = jax_ftp.INTERPRET
    jax_ftp.INTERPRET = True
    try:
        yield
    finally:
        jax_ftp.INTERPRET = old


def _force_loss(out):
    return (out[keys.FORCES] ** 2).sum() + out[keys.TOTAL_ENERGY].sum() ** 2


@pytest.fixture(scope="module")
def jax_training():
    """JAX's ``fused`` model with the bf16 track (float64): its parameters
    and the force-loss gradients, under the port's names."""
    kw = _toy("float64", tp_kernel_backend="fused", tensor_dtype="bfloat16")
    batch = _toy_batch()
    jm = JaxAllegroModel(**kw)
    jb = to_jax(batch, dtype=np.float64)
    params = jm.init(0, jb)

    def loss(p):
        out = jm.apply_with_derivatives(p, jb)
        return jnp.sum(out[keys.FORCES] ** 2) + out[keys.TOTAL_ENERGY].sum() ** 2

    with _interpret():
        grads = jax.jit(jax.grad(loss))(params)
    named = [params_from_jax(jax.tree_util.tree_map(np.asarray, t)) for t in (params, grads)]
    return kw, batch, named[0], {k: v.numpy() for k, v in named[1].items()}


def test_bf16_force_loss_gradients_match_jax(jax_training):
    kw, batch, params, want = jax_training
    m = AllegroModel(**kw)
    m.load_state_dict(params)
    out = m.apply_with_derivatives(to_torch(m.precompute_statics(batch), torch.float64),
                                   create_graph=True)
    ps = m.parameters()
    got = dict(zip(ps, torch.autograd.grad(_force_loss(out), list(ps.values()))))
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        assert g.dtype == torch.float64
        err = float(np.abs(g.numpy() - want[name]).max())
        if name.endswith("path_weights"):
            assert err == 0.0, (name, err)
        else:
            assert err <= F64_SCATTER_TOL * max(1.0, float(np.abs(want[name]).max())), (name, err)


def _train_loader():
    frames = synthetic_molecular_frames(4, n_atoms=8, spread=1.2)
    return DataLoader(InMemoryDataset(frames, r_max=2.0), batch_size=2)


def test_trainer_trains_fused_with_the_track_in_float32():
    """Parameters and their gradients stay float32 (JAX's
    ``test_bf16_storage_training_grads_finite_and_f32_params``); losses are
    finite; two identical steps give the same bits."""
    loader = _train_loader()
    m = AllegroModel(r_max=2.0, type_names=["A", "B", "C"], l_max=1, num_layers=2,
                     num_scalar_features=8, num_tensor_features=4, tp_kernel_backend="fused",
                     tensor_dtype="bfloat16").init(0)
    assert m.module.allegro.tensor_dtype == BF and m.routes("cpu")["allegro"] == "fused_call"
    trainer = Trainer(m, learning_rate=5e-3, device="cpu", logger=lambda s: None)
    state = trainer.fit(trainer.init_state(0), loader, max_epochs=2)
    losses = [h["train_loss"] for h in trainer.history]
    assert len(losses) == 2 and np.isfinite(losses).all(), losses
    data = trainer.to_device(next(iter(loader)))
    _, _, first = trainer.loss_and_grads(state, data)
    _, _, again = trainer.loss_and_grads(state, data)
    for k, g in first.items():
        assert state.params[k].dtype == torch.float32 and g.dtype == torch.float32, k
        assert torch.isfinite(g).all() and torch.equal(g, again[k]), k


def test_cli_trains_fused_with_the_track(tmp_path):
    import importlib.util
    import io
    from pathlib import Path

    import yaml

    from allegro_tpu_torch.cli import main

    repo = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("_jax_cli_cfg", repo / "tests/train/test_cli.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = dict(mod.TINY_CFG, run=["train"])
    cfg["model"] = dict(cfg["model"], tp_kernel_backend="fused", tensor_dtype="bfloat16")
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["run", "-c", str(path), "-w", str(tmp_path / "out"), "--device", "cpu"]) == 0
    losses = [float(ln.split("train_loss=")[1].split()[0]) for ln in buf.getvalue().splitlines()
              if "train_loss=" in ln]
    assert losses and np.isfinite(losses).all(), buf.getvalue()
    resolved = yaml.safe_load((tmp_path / "out" / "resolved_config.json").read_text())
    assert resolved["model"]["tensor_dtype"] == "bfloat16"


# the routed model: S = 128 with latent width 128 takes no mega kernel on an H100
ROUTED = dict(r_max=4.0, type_names=["A", "B", "C"], l_max=2, parity=True, num_layers=2,
              num_scalar_features=128, num_tensor_features=32, avg_num_neighbors=20.0,
              per_type_energy_scales=1.3, per_type_energy_shifts=[0.1, -0.2, 0.3],
              allegro_mlp_hidden_layers_width=128)


def _crystal():
    rng = np.random.RandomState(0)
    grid = np.stack(np.meshgrid(*(np.arange(2),) * 3, indexing="ij"), -1).reshape(-1, 3)
    return neighbor_list({keys.POSITIONS: grid * 2.2 + 0.1 * rng.randn(8, 3),
                          keys.ATOM_TYPES: rng.randint(0, 3, 8).astype(np.int32),
                          keys.CELL: np.eye(3) * 4.4, keys.PBC: np.ones(3, dtype=bool)}, 4.0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_routed_model_with_the_track_matches_jax_mega(dtype, monkeypatch):
    monkeypatch.setattr(smem_fit, "smem_optin", lambda device: OPTIN)
    npdt = np.float64 if dtype == "float64" else np.float32
    kw = dict(ROUTED, model_dtype=dtype, tp_kernel_backend="fused_infer",
              tensor_dtype="bfloat16")
    batch = batch_frames([_crystal()], n_frames=1)
    jm = JaxAllegroModel(**kw)
    jb = to_jax(batch, dtype=npdt)
    params = jm.init(0, jb)
    with _interpret():
        want = jax.jit(jm.apply_with_derivatives)(params, jb)
    m = AllegroModel(**kw)
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    assert m.module.allegro.mega and m.routes("cpu")["allegro"] == "fused_call"
    got = m.apply_with_derivatives(to_torch(m.precompute_statics(batch),
                                            torch.float64 if dtype == "float64"
                                            else torch.float32))
    for k in (keys.TOTAL_ENERGY, keys.PER_ATOM_ENERGY, keys.FORCES):
        w = np.asarray(want[k], dtype=np.float64)
        err = float(np.abs(got[k].double().numpy() - w).max())
        scale = max(1.0, float(np.abs(w).max())) if dtype == "float64" else float(np.abs(w).max())
        assert err <= (TOL if dtype == "float64" else F32_TRACK_TOL) * scale, (k, err)


# ---------------------------------------------------------------------------
# the dtype pairs the kernels meet, and those that have no form
# ---------------------------------------------------------------------------

WRAPPERS = ("env_scatter", "gather_tp", "bwd_fused", "unweight_both", "tp_scatter", "gather_dw",
            "unweight_sh", "unweight_w")


def _record_calls(monkeypatch):
    """Wraps the wrappers of ``fused_tp`` to record each call's arguments
    (the plain versions still run)."""
    calls = []
    for name in WRAPPERS:
        fn = getattr(fused_tp, name)

        def wrap(*a, _fn=fn, _name=name, **k):
            calls.append((_name, _fn, a, k))
            return _fn(*a, **k)

        monkeypatch.setattr(fused_tp, name, wrap)
    return calls


def _signature(fn, a, k):
    """(argument name, dtype) of each tensor argument and out_dtype."""
    bound = inspect.signature(fn).bind(*a, **k).arguments
    return tuple((n, str(v.dtype).replace("torch.", "")) for n, v in bound.items()
                 if isinstance(v, torch.Tensor) and v.is_floating_point()
                 and n != "entry_coef") + tuple(
        ("out_dtype", str(v).replace("torch.", "")) for n, v in bound.items()
        if n == "out_dtype" and v is not None)


def _replay_on_the_card_path(calls, monkeypatch):
    """Each recorded call through its wrapper's CUDA branch with the launch
    recorded, not made: returns {(kernel, signature): bf16 flags seen}."""
    launched = []
    monkeypatch.setattr(fused_tp, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(fused_tp, "_launch",
                        lambda name, fn, device, *args, bf16=False: launched.append(bf16))
    seen = {}
    for name, fn, a, k in calls:
        n = len(launched)
        fn(*a, **k)
        assert len(launched) == n + 1, name
        seen.setdefault((name, _signature(fn, a, k)), set()).add(launched[-1])
    return seen


def _track_runs():
    """A bf16 training step's force-loss gradients on ``fused``, a
    ``use_mega=False`` force call and a routed force call, float32."""
    batch = _toy_batch()
    kw = _toy("float32", tensor_dtype="bfloat16")
    m = AllegroModel(**kw, tp_kernel_backend="fused").init(0)
    out = m.apply_with_derivatives(to_torch(m.precompute_statics(batch), torch.float32),
                                   create_graph=True)
    torch.autograd.grad(_force_loss(out), list(m.parameters().values()))
    for extra in (dict(use_mega=False), {}):
        f = AllegroModel(**kw, tp_kernel_backend="fused_infer", **extra).init(0)
        f.module.allegro._routes[torch.device("cpu")] = "fused_call"  # as on a narrow card
        f.apply_with_derivatives(to_torch(f.precompute_statics(batch), torch.float32))


# the (kernel, dtypes) pairs of those runs: each has a CUDA form. The float32
# ones are the routed model's layer 0 (JAX's mega path reads its features
# unrounded, and splits out its scalar block: gts); every env_scatter reads
# bf16 env weights (or a bf16 cotangent in their role), and unweight_both's
# dwexp is bfloat16 off mega, float32 (unrounded) on the routed model
TRACK_PAIRS = {
    ("env_scatter", (("sh", "float32"), ("wexp", "bfloat16"))),
    ("gather_tp", (("x", "bfloat16"), ("env", "float32"), ("w", "float32"))),
    ("gather_tp", (("x", "float32"), ("env", "float32"), ("w", "float32"))),
    ("bwd_fused", (("x", "bfloat16"), ("g", "bfloat16"), ("env", "float32"), ("w", "float32"))),
    ("bwd_fused", (("x", "float32"), ("g", "float32"), ("env", "float32"), ("w", "float32"),
                   ("gts", "float32"))),
    ("unweight_both", (("t", "float32"), ("sh", "float32"), ("wexp", "bfloat16"))),
    ("unweight_both", (("t", "float32"), ("sh", "float32"), ("wexp", "bfloat16"),
                       ("out_dtype", "float32"))),
    ("tp_scatter", (("x", "bfloat16"), ("g", "bfloat16"), ("w", "float32"))),
    ("gather_dw", (("x", "bfloat16"), ("env", "float32"), ("g", "bfloat16"))),
    ("unweight_sh", (("t", "float32"), ("wexp", "bfloat16"))),
    ("unweight_w", (("t", "float32"), ("sh", "float32"), ("out_dtype", "bfloat16"))),
}


def test_every_dtype_pair_of_the_track_has_a_cuda_form(monkeypatch):
    calls = _record_calls(monkeypatch)
    _track_runs()
    monkeypatch.undo()
    seen = _replay_on_the_card_path(calls, monkeypatch)
    assert set(seen) == TRACK_PAIRS, sorted(set(seen) ^ TRACK_PAIRS)
    for (name, sig), flags in seen.items():
        want = any(dt == "bfloat16" for _, dt in sig)
        assert flags == {want}, (name, sig, flags)


def _args():
    """Small CUDA-branch arguments of each wrapper (on the CPU, the launch
    replaced): the trainable backend's layer-1 table."""
    from allegro_tpu_torch.nn.contract import Contracter

    tp = Contracter("1x0e+1x1o+1x2e", "1x0e+1x1o+1x2e", "1x0e", 4, kernel_backend="fused")
    E, n_atoms, U = 6, 3, 4
    c = torch.tensor([0, 0, 1, 2, 2, 3], dtype=torch.int32)
    row_ptr = torch.tensor([0, 2, 3, 5], dtype=torch.int32)
    wk, idx, coef = (v.float() if v.is_floating_point() else v
                     for v in tp.fused_infer_parts(torch.float32))
    walk, scatter = tp.gather_paths()[0], tp.scatter_paths()[0]
    r = torch.ones
    return dict(E=E, n_atoms=n_atoms, U=U, c=c, row_ptr=row_ptr, d2i=tp.dim_to_irr, tp=tp,
                wk=wk, idx=idx, coef=coef, walk=walk, scatter=scatter,
                sh=r(E, tp.d2), wexp=r(E, tp.n_irr * U), t=r(n_atoms, tp.d2 * U),
                x=r(E, tp.d1 * U), g=r(E, tp.d3 * U), env=r(n_atoms, tp.d2 * U))


@pytest.mark.parametrize("case", [
    "env_scatter sh bf16", "env_scatter env-role f64", "unweight_both f32 wexp bf16 dwexp",
    "unweight_sh t bf16", "tp_scatter x bf16 g f32", "tp_scatter w bf16",
    "gather_dw env bf16", "gather_dw x f32 g bf16", "unweight_w out f16",
    "unweight_w sh bf16 out f32",
])
def test_combinations_without_a_cuda_form_raise(case, monkeypatch):
    monkeypatch.setattr(fused_tp, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(fused_tp, "_launch", lambda *a, **k: pytest.fail("launched"))
    s = _args()
    U, c, rp, d2i, bf = s["U"], s["c"], s["row_ptr"], s["d2i"], BF
    calls = {
        "env_scatter sh bf16":
            lambda: fused_tp.env_scatter(s["sh"].to(bf), s["wexp"], c, rp, d2i, U),
        "env_scatter env-role f64":
            lambda: fused_tp.env_scatter(s["sh"].double(), s["wexp"].to(bf), c, rp, d2i, U),
        "unweight_both f32 wexp bf16 dwexp":
            lambda: fused_tp.unweight_both(s["t"], s["sh"], s["wexp"], c, d2i, bf),
        "unweight_sh t bf16":
            lambda: fused_tp.unweight_sh(s["t"].to(bf), s["wexp"].to(bf), c, d2i),
        "tp_scatter x bf16 g f32":
            lambda: fused_tp.tp_scatter(s["x"].to(bf), s["g"], s["wk"], c, rp, s["idx"],
                                        s["coef"], s["tp"].d2, s["scatter"]),
        "tp_scatter w bf16":
            lambda: fused_tp.tp_scatter(s["x"].to(bf), s["g"].to(bf), s["wk"].to(bf), c, rp,
                                        s["idx"], s["coef"], s["tp"].d2, s["scatter"]),
        "gather_dw env bf16":
            lambda: fused_tp.gather_dw(s["x"].to(bf), s["env"].to(bf), s["g"].to(bf), c,
                                       s["idx"], s["coef"], s["wk"].shape[0], U, s["walk"]),
        "gather_dw x f32 g bf16":
            lambda: fused_tp.gather_dw(s["x"], s["env"], s["g"].to(bf), c, s["idx"],
                                       s["coef"], s["wk"].shape[0], U, s["walk"]),
        "unweight_w out f16":
            lambda: fused_tp.unweight_w(s["t"], s["sh"], c, d2i, s["tp"].n_irr, torch.float16),
        "unweight_w sh bf16 out f32":
            lambda: fused_tp.unweight_w(s["t"], s["sh"].to(bf), c, d2i, s["tp"].n_irr),
    }
    with pytest.raises(TypeError):
        calls[case]()


# ---------------------------------------------------------------------------
# einsum and pallas ignore the track
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["einsum", "pallas"])
def test_einsum_and_pallas_ignore_the_track(backend):
    batch = _toy_batch(4)
    kw = _toy("float32", tp_kernel_backend=backend)
    m = AllegroModel(**kw, tensor_dtype="bfloat16").init(3)
    plain = AllegroModel(**kw)
    plain.load_state_dict(m.state_dict())
    assert m.module.allegro.tensor_dtype is None
    got, want = (x.apply_with_derivatives(to_torch(x.precompute_statics(batch), torch.float32))
                 for x in (m, plain))
    for k in (keys.TOTAL_ENERGY, keys.PER_ATOM_ENERGY, keys.FORCES):
        assert torch.equal(got[k], want[k]), k
