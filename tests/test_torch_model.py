"""The port's flagship force call against the JAX package, on the CPU.

JAX ``einsum`` parameters go through ``params_from_jax`` into the port's
``AllegroModel``; the port's ``einsum`` backend and its ``fused_infer``
backend (the kernels' plain versions on the CPU), both its default mega-fused
layers ("mega") and ``use_mega=False``, must match JAX ``einsum`` on energy,
per-atom energy, forces and virial: 1e-10 in float64, 5e-5 in float32. ``test_torch_model_interpret.py`` holds the port against JAX
``fused_infer`` with the Pallas kernels in interpret mode.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from allegro_tpu.data import to_jax
from allegro_tpu.model import AllegroModel as JaxAllegroModel

from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
from allegro_tpu_torch.model import AllegroModel, params_from_jax
from allegro_tpu_torch.ops import fused_tp

R_MAX = 4.0
OUT_KEYS = (keys.TOTAL_ENERGY, keys.PER_ATOM_ENERGY, keys.FORCES, keys.VIRIAL)
TOL = {"float64": 1e-10, "float32": 5e-5}
REPO = Path(__file__).resolve().parent.parent


def _crystal(side, seed, spacing=2.2):
    rng = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(*(np.arange(s) for s in side), indexing="ij"), -1).reshape(-1, 3)
    n = grid.shape[0]
    frame = {
        keys.POSITIONS: grid * spacing + 0.1 * rng.randn(n, 3),
        keys.ATOM_TYPES: rng.randint(0, 3, n).astype(np.int32),
        keys.CELL: np.diag(np.asarray(side, dtype=np.float64) * spacing),
        keys.PBC: np.ones(3, dtype=bool),
    }
    return neighbor_list(frame, R_MAX)


def _model_kwargs(avg_n, dtype_name):
    return dict(
        r_max=R_MAX, type_names=["A", "B", "C"], l_max=2, parity=True, num_layers=2,
        num_scalar_features=16, num_tensor_features=4, avg_num_neighbors=avg_n,
        per_type_energy_scales=[1.0, 0.5, 2.0], per_type_energy_shifts=[0.1, -0.2, 0.3],
        model_dtype=dtype_name,
    )


def _port(backend, kw):
    """``"mega"`` is ``fused_infer`` with its default ``use_mega``."""
    if backend == "mega":
        return AllegroModel(**kw, tp_kernel_backend="fused_infer")
    extra = {"use_mega": False} if backend == "fused_infer" else {}
    return AllegroModel(**kw, tp_kernel_backend=backend, **extra)


@pytest.fixture(scope="module")
def frames():
    # a 27-atom and a 12-atom periodic frame, batched with padding
    return [_crystal((3, 3, 3), 0), _crystal((2, 2, 3), 1)]


@pytest.fixture(scope="module")
def batch(frames):
    return batch_frames(frames, n_frames=2)


@pytest.fixture(scope="module")
def avg_n(frames):
    return sum(f[keys.EDGE_INDEX].shape[1] for f in frames) / sum(
        f[keys.POSITIONS].shape[0] for f in frames
    )


@pytest.fixture(scope="module", params=["float64", "float32"])
def jax_run(request, batch, avg_n):
    """JAX einsum params and outputs on the batch."""
    dtype_name = request.param
    jm = JaxAllegroModel(**_model_kwargs(avg_n, dtype_name))
    jdt = np.float64 if dtype_name == "float64" else np.float32
    jb = to_jax(batch, dtype=jdt)
    params = jm.init(0, jb)
    out = jax.jit(jm.apply_with_derivatives)(params, jb)
    out = {k: np.asarray(out[k], np.float64) for k in OUT_KEYS}
    return dtype_name, jax.tree_util.tree_map(np.asarray, params), out


def _close(got, want, tol, what):
    got = got.detach().double().numpy()
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err:.3e} (scale {scale:.3e})"


def test_params_from_jax_is_the_state_dict(jax_run, avg_n):
    _, params, _ = jax_run
    for backend in ("einsum", "fused_infer", "mega"):
        m = _port(backend, _model_kwargs(avg_n, "float64"))
        sd = params_from_jax(params)
        assert sorted(sd) == sorted(m.state_dict())
        assert all(sd[k].shape == v.shape for k, v in m.state_dict().items())
        m.load_state_dict(sd, strict=True)
    assert "allegro.tps.0.path_weights" in sd
    assert "radial_chemical_embed.product_type_embed.radial_proj.w0" in sd


@pytest.mark.parametrize("backend", ["einsum", "fused_infer", "mega"])
def test_port_matches_jax_einsum(jax_run, batch, avg_n, backend):
    dtype_name, params, want = jax_run
    m = _port(backend, _model_kwargs(avg_n, dtype_name))
    m.load_state_dict(params_from_jax(params))
    dt = getattr(torch, dtype_name)
    assert m.state_dict()["allegro.tps.0.path_weights"].dtype == dt
    out = m.apply_with_derivatives(to_torch(m.precompute_statics(batch), dtype=dt))
    for k in OUT_KEYS:
        assert out[k].dtype == dt
        _close(out[k], want[k], TOL[dtype_name], f"{backend} {dtype_name} {k}")


@pytest.mark.parametrize("backend", ["einsum", "fused_infer", "mega"])
def test_padding_invariance(frames, avg_n, backend):
    m = _port(backend, _model_kwargs(avg_n, "float64")).init(0)
    n_real = sum(f[keys.POSITIONS].shape[0] for f in frames)
    outs = []
    for pad_atoms, pad_edges, n_frames in ((0, 0, 2), (16, 384, 3)):
        b = batch_frames(frames, n_frames=n_frames)
        b = batch_frames(frames, n_atoms=b[keys.POSITIONS].shape[0] + pad_atoms,
                         n_edges=b[keys.EDGE_INDEX].shape[1] + pad_edges, n_frames=n_frames)
        outs.append(m.apply_with_derivatives(to_torch(m.precompute_statics(b), torch.float64)))
    a, b = outs
    for k in (keys.PER_ATOM_ENERGY, keys.FORCES):
        torch.testing.assert_close(a[k][:n_real], b[k][:n_real], rtol=0, atol=1e-12)
        assert (b[k][n_real:] == 0).all()
    for k in (keys.TOTAL_ENERGY, keys.VIRIAL):
        torch.testing.assert_close(a[k][:2], b[k][:2], rtol=0, atol=1e-12)


def test_unsorted_edges_raise(frames, avg_n):
    m = _port("fused_infer", _model_kwargs(avg_n, "float64")).init(0)
    b = batch_frames(frames[:1], n_frames=1)
    ei = b[keys.EDGE_INDEX].copy()
    ei[:, [0, 40]] = ei[:, [40, 0]]
    b[keys.EDGE_INDEX] = ei
    with pytest.raises(ValueError, match="sorted by center"):
        m.precompute_statics(b)
    with pytest.raises(ValueError, match="precompute_statics"):
        m.apply_with_derivatives(to_torch(batch_frames(frames[:1]), torch.float64))


@pytest.mark.parametrize("override", [
    {"tensor_dtype": "bfloat16"},
    {"remat": True},
    {"checkpoint_energy": True},
    {"parity": False},
    {"l_max": 3},
    {"weight_individual_irreps": False},
    {"per_edge_type_cutoff": {"A": 3.0}},
    {"pair_potential": {"_target_": "allegro_tpu.nn.ZBLPairPotential"}},
    {"radial_chemical_embed": {"_target_": "allegro_tpu.nn.TwoBodySplineScalarEmbed"}},
    {"tp_kernel_backend": "pallas"},
], ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()))
def test_unported_options_raise(override, avg_n):
    kw = {**_model_kwargs(avg_n, "float32"), **override}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        AllegroModel(**kw)


# wrapper calls per fused_infer force call of the 2-layer model: on a card,
# each call is one launch (chip_smoke.py asserts the same counts there)
_MEGA_OFF = {"latent_env_scatter": 0, "latent_env_bwd": 0, "gather_tp_embed": 0, "bwd_embed": 0}
# the trainable backend's transposes never run in a fused_infer force call
_TRAIN_OFF = {"tp_scatter": 0, "gather_dw": 0, "unweight_sh": 0, "unweight_w": 0}
_PER_CALL = {
    True: {"env_scatter": 2, "gather_tp": 2, "bwd_fused": 2, "unweight_both": 2,
           "center_gather": 2, "center_sum": 2, "readout_sum": 1, "readout_bwd": 1, **_MEGA_OFF,
           **_TRAIN_OFF},
    # plain readout chain: the edge sum and its transpose take the center kernels
    False: {"env_scatter": 2, "gather_tp": 2, "bwd_fused": 2, "unweight_both": 2,
            "center_gather": 3, "center_sum": 3, "readout_sum": 0, "readout_bwd": 0, **_MEGA_OFF,
            **_TRAIN_OFF},
    # the mega-fused layers: the first projection and layer 0's latent each a
    # latent_env_scatter (and its backward), layer 0's TP on the embed's
    # factors, layer 1's on gather_tp; no env_scatter / unweight_both
    "mega": {"env_scatter": 0, "gather_tp": 1, "bwd_fused": 1, "unweight_both": 0,
             "center_gather": 2, "center_sum": 2, "readout_sum": 1, "readout_bwd": 1,
             "latent_env_scatter": 2, "latent_env_bwd": 2, "gather_tp_embed": 1, "bwd_embed": 1,
             **_TRAIN_OFF},
}


def _count_wrapper_calls(monkeypatch):
    calls = {name: 0 for name in fused_tp.LAUNCHES}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in calls:
        monkeypatch.setattr(fused_tp, name, counted(name, getattr(fused_tp, name)))
    return calls


@pytest.mark.parametrize("use_fused_readout", [None, True, False])
def test_fused_readout_options_build_and_run(batch, avg_n, use_fused_readout, monkeypatch):
    """None and True take the fused readout kernel, False the plain chain;
    all three give the einsum backend's outputs. (None used to run the plain
    chain silently.)"""
    kw = _model_kwargs(avg_n, "float64")
    ref = _port("einsum", kw).init(0)
    m = AllegroModel(**kw, tp_kernel_backend="fused_infer", use_mega=False,
                     use_fused_readout=use_fused_readout)
    m.load_state_dict(ref.state_dict())
    want = ref.apply_with_derivatives(to_torch(ref.precompute_statics(batch), torch.float64))
    data = to_torch(m.precompute_statics(batch), torch.float64)
    calls = _count_wrapper_calls(monkeypatch)
    out = m.apply_with_derivatives(data)
    assert calls == _PER_CALL[use_fused_readout is not False]
    for k in OUT_KEYS:
        torch.testing.assert_close(out[k], want[k], rtol=0, atol=1e-10)


@pytest.mark.parametrize("use_mega", [None, True])
def test_mega_default_launch_counts(batch, avg_n, use_mega, monkeypatch):
    """None (the default) and True run the mega-fused layers: each wrapper
    the counted number of times, the einsum backend's outputs, and no
    expanded EDGE_FEATURES from the tensor embed."""
    kw = _model_kwargs(avg_n, "float64")
    ref = _port("einsum", kw).init(0)
    m = AllegroModel(**kw, tp_kernel_backend="fused_infer", use_mega=use_mega)
    assert m.module.allegro.mega and not m.module.tensor_embed.build_features
    assert m.builder_kwargs["use_mega"] is use_mega
    m.load_state_dict(ref.state_dict())
    want = ref.apply_with_derivatives(to_torch(ref.precompute_statics(batch), torch.float64))
    data = to_torch(m.precompute_statics(batch), torch.float64)
    calls = _count_wrapper_calls(monkeypatch)
    out = m.apply_with_derivatives(data)
    assert calls == _PER_CALL["mega"]
    assert keys.EDGE_FEATURES not in out and keys.EDGE_FEATURE_WEIGHTS in out
    for k in OUT_KEYS:
        torch.testing.assert_close(out[k], want[k], rtol=0, atol=1e-10)


def test_mega_outside_its_condition_takes_the_non_mega_kernels(batch, avg_n, monkeypatch):
    """JAX's latent MLPs are SiLU whatever the config says, and so are the
    mega kernels: with another activation, use_mega=True runs the non-mega
    kernels (as JAX does outside its mega condition) and matches einsum."""
    kw = {**_model_kwargs(avg_n, "float64"), "allegro_mlp_nonlinearity": "mish"}
    ref = _port("einsum", kw).init(0)
    m = AllegroModel(**kw, tp_kernel_backend="fused_infer", use_mega=True)
    assert not m.module.allegro.mega and m.module.tensor_embed.build_features
    m.load_state_dict(ref.state_dict())
    calls = _count_wrapper_calls(monkeypatch)
    out = m.apply_with_derivatives(to_torch(m.precompute_statics(batch), torch.float64))
    assert calls == _PER_CALL[True]
    want = ref.apply_with_derivatives(to_torch(ref.precompute_statics(batch), torch.float64))
    for k in OUT_KEYS:
        torch.testing.assert_close(out[k], want[k], rtol=0, atol=1e-10)


@pytest.mark.parametrize("override", [
    {"readout_mlp_hidden_layers_depth": 2},
    {"readout_mlp_nonlinearity": "mish"},
], ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()))
def test_readout_outside_the_kernel_conditions_takes_the_plain_chain(batch, avg_n, override,
                                                                     monkeypatch):
    """As in JAX: more than one hidden layer, or another activation than
    SiLU, is the plain readout chain even with use_fused_readout=True."""
    kw = {**_model_kwargs(avg_n, "float64"), **override}
    ref = _port("einsum", kw).init(0)
    m = AllegroModel(**kw, tp_kernel_backend="fused_infer", use_mega=False,
                     use_fused_readout=True)
    m.load_state_dict(ref.state_dict())
    calls = _count_wrapper_calls(monkeypatch)
    out = m.apply_with_derivatives(to_torch(m.precompute_statics(batch), torch.float64))
    assert calls == _PER_CALL[False]
    want = ref.apply_with_derivatives(to_torch(ref.precompute_statics(batch), torch.float64))
    torch.testing.assert_close(out[keys.FORCES], want[keys.FORCES], rtol=0, atol=1e-10)


def test_tpu_blocking_kwargs_are_accepted_and_ignored(avg_n):
    kw = _model_kwargs(avg_n, "float64")
    a = _port("fused_infer", kw).init(0)
    b = AllegroModel(**kw, tp_kernel_backend="fused_infer", use_mega=False,
                     fused_block_edges=512, window_rows=32, onehot_passes=2)
    b.load_state_dict(a.state_dict())
    assert b.builder_kwargs["window_rows"] == 32
    batch = batch_frames([_crystal((2, 2, 3), 1)])
    outs = [m.apply_with_derivatives(to_torch(m.precompute_statics(batch), torch.float64))
            for m in (a, b)]
    torch.testing.assert_close(outs[0][keys.FORCES], outs[1][keys.FORCES], rtol=0, atol=0)


def test_cpu_force_call_launches_no_kernel(batch, avg_n):
    for backend in ("fused_infer", "mega"):
        m = _port(backend, _model_kwargs(avg_n, "float32")).init(0)
        fused_tp.reset_launch_counts()
        out = m.apply_with_derivatives(to_torch(m.precompute_statics(batch), torch.float32))
        assert torch.isfinite(out[keys.FORCES]).all()
        assert not out[keys.FORCES].requires_grad
        assert fused_tp.LAUNCHES == {k: 0 for k in fused_tp.LAUNCHES}


_NO_JAX = """
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "allegro_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, _Block())
import torch
from allegro_tpu_torch.calculator import AllegroCalculator
from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
from allegro_tpu_torch.data import DataLoader, InMemoryDataset, synthetic_molecular_frames
from allegro_tpu_torch.md import MDState, Simulation
from allegro_tpu_torch.model import AllegroModel
from allegro_tpu_torch.train import Trainer
import numpy as np

rng = np.random.RandomState(0)
grid = np.stack(np.meshgrid(*(np.arange(2),) * 3, indexing="ij"), -1).reshape(-1, 3)
frame = {keys.POSITIONS: grid * 2.2 + 0.1 * rng.randn(8, 3),
         keys.ATOM_TYPES: rng.randint(0, 2, 8).astype(np.int32),
         keys.CELL: np.eye(3) * 4.4, keys.PBC: np.ones(3, dtype=bool)}
m = AllegroModel(r_max=4.0, type_names=["H", "C"], l_max=2, num_layers=2,
                 num_scalar_features=8, num_tensor_features=4, model_dtype="float32",
                 tp_kernel_backend="fused_infer").init(0)
assert m.module.allegro.mega
b = batch_frames([neighbor_list(frame, 4.0)])
out = m.apply_with_derivatives(to_torch(m.precompute_statics(b), torch.float32))
assert torch.isfinite(out[keys.FORCES]).all() and keys.EDGE_FEATURE_WEIGHTS in out
res = AllegroCalculator(m, device="cpu").calculate(
    frame[keys.POSITIONS], atomic_numbers=np.array([1, 6])[frame[keys.ATOM_TYPES]],
    cell=frame[keys.CELL], pbc=(True,) * 3)
assert np.isfinite(res["forces"]).all()
sim = Simulation(m, frame[keys.ATOM_TYPES], np.ones(2), 4.0, cell=frame[keys.CELL],
                 pbc=(True,) * 3, steps_per_block=2, device="cpu")
st = sim.run(MDState(frame[keys.POSITIONS], np.zeros((8, 3))), 2)
assert np.isfinite(st.positions).all()
ds = InMemoryDataset(synthetic_molecular_frames(4, n_atoms=6, spread=1.2), r_max=2.0)
tm = AllegroModel(r_max=2.0, type_names=["A", "B", "C"], l_max=1, num_layers=2,
                  num_scalar_features=8, num_tensor_features=4, model_dtype="float32",
                  tp_kernel_backend="fused")
trainer = Trainer(tm, device="cpu", logger=lambda s: None)
state = trainer.fit(trainer.init_state(0), DataLoader(ds, batch_size=2))
assert state.step == 2 and np.isfinite(trainer.history[-1]["train_loss"])
assert not [n for n in sys.modules if n.split(".")[0] in ("jax", "flax", "allegro_tpu")]
print("ok")
"""


def test_port_imports_and_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
