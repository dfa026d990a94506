"""Every model the port builds, exported (``compile/export.py``), on the CPU.

- Each option the export once refused (the ``fused`` and ``pallas``
  backends, the bf16 track on the mega route and with ``use_mega=False``,
  ``remat``, ``checkpoint_energy``, ``tp_chunk_edges``, and the JAX bench's
  100k policy that combines them): the port's ``ExportedProgram`` module
  (the kernels as ``atpt::`` ops running their plain versions here) gives
  the port's eager call's bits, and matches JAX's own ``.atpu`` artifact of
  the same model (``export_model`` + ``load_exported``, Pallas in interpret
  mode) on the same inputs and parameters (``params_from_jax``): 1e-10 in
  float64, the bf16 track included; 5e-5 in float32; ``F32_TRACK_TOL`` of
  each output's max for the bf16 track in float32. The options run on the
  ghost-format frame of ``tests/test_torch_export.py``; the bf16 track in
  float32 runs on the toy model and frame on which
  ``tests/test_torch_precision.py`` holds the eager track to JAX (JAX's
  ``test_bf16_storage.py``): in float32 the two sum in other orders, and a
  sum within its noise of a bf16 rounding midpoint rounds the other way,
  which on the ghost frame's l_max-1 model moves the float32 forces by
  1.9e-5 of their max, eagerly as exported (float64: 1.5e-15).
- The JAX bench's 100k policy (the bf16 track, "high", ``remat``,
  ``checkpoint_energy``): its exported program gives the bits of the
  exported track without the policy in float32 (held to JAX above in
  float64, and eagerly in float32 by ``tests/test_torch_precision.py``;
  JAX's interpreted mega path at the toy's widths takes most of a minute to
  export on this CPU). JAX runs the policy
  in float64 on the CPU neither eagerly nor exported (its interpreted
  ``gather_tp_embed`` stores the float32 split scalars into a float64 ref),
  and its own float32 call with the policy differs from its call without
  by 1.77e-5 of max |F| on the toy (its recompute orders the float32 sums
  otherwise); the port's recomputes repeat the same launches.
- The CLI's ``compile`` stage on ``configs/md.yaml`` as shipped (``pallas``,
  fresh parameters) and on a workdir trained on ``fused``, with the
  ``.pt2`` builder replaced by a recorder: the recorded program against the
  eager model.
"""

import contextlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import allegro_tpu.ops.fused_tp as jax_fused_tp
import allegro_tpu.ops.pallas_contract as jax_pallas_contract
from allegro_tpu.compile import export_model as jax_export_model
from allegro_tpu.compile import load_exported as jax_load_exported
from allegro_tpu.data import to_jax
from allegro_tpu.model import AllegroModel as JaxAllegroModel

from allegro_tpu_torch import cli
from allegro_tpu_torch.compile import LoadedModel, export, export_program
from allegro_tpu_torch.compile.targets import EXPORT_INPUTS
from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
from allegro_tpu_torch.model import AllegroModel, params_from_jax
from allegro_tpu_torch.ops import custom_ops
from allegro_tpu_torch.train.config import build_model
from allegro_tpu_torch.train.package import trained_model

from test_torch_cli import _jax_tiny_cfg, _main, _write
from test_torch_export import R_MAX, _ghost_frame
from test_torch_precision import _toy, _toy_batch
from torch_threads import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TOLS = {"float64": 1e-10, "float32": 5e-5}
F32_TRACK_TOL = 1e-5  # tests/test_torch_bf16_track.py's

OPTIONS = {
    "fused": dict(tp_kernel_backend="fused"),
    "pallas": dict(tp_kernel_backend="pallas"),
    "bf16 track": dict(tensor_dtype="bfloat16"),
    "bf16 track, use_mega=False": dict(tensor_dtype="bfloat16", use_mega=False),
    "remat": dict(remat=True),
    "checkpoint_energy": dict(checkpoint_energy=True),
    "tp_chunk_edges": dict(tp_kernel_backend="einsum", tp_chunk_edges=64),
}
OPTIONS_KEYS = {k for option in OPTIONS.values() for k in option}
CASES = [(name, "float64") for name in OPTIONS] + [
    (name, "float32") for name in ("pallas", "bf16 track, use_mega=False")]
# allegro_tpu/bench.py's POLICY_100K
POLICY_100K = dict(tensor_dtype="bfloat16", precision="high", remat=True, checkpoint_energy=True,
                   features_layout="flat_dim_major")


@contextlib.contextmanager
def _interpret():
    """JAX's Pallas kernels in interpret mode, as JAX's own CPU tests run them."""
    before = jax_fused_tp.INTERPRET, jax_pallas_contract.INTERPRET
    jax_fused_tp.INTERPRET = jax_pallas_contract.INTERPRET = True
    try:
        yield
    finally:
        jax_fused_tp.INTERPRET, jax_pallas_contract.INTERPRET = before


def _kwargs(dtype, **option):
    return dict(
        r_max=R_MAX, type_names=["A", "B"], l_max=1, num_layers=2, num_scalar_features=8,
        num_tensor_features=4, scalar_embed_mlp_hidden_layers_width=8,
        allegro_mlp_hidden_layers_width=8, readout_mlp_hidden_layers_width=8,
        avg_num_neighbors=6.0, per_type_energy_scales=1.3, per_type_energy_shifts=0.1,
        model_dtype=dtype, **{"tp_kernel_backend": "fused_infer", **option},
    )


def _single(batch):
    """A one-frame batch as the program takes it."""
    for k in (keys.BATCH, keys.NUM_NODES, keys.FRAME_MASK):
        batch.pop(k)
    return batch


def _padded(frame, n_pad, e_pad):
    """A single frame padded to the program's shape (sentinel edges)."""
    return _single(batch_frames([frame], n_atoms=n_pad, n_edges=e_pad, n_frames=1))


def _setup(option, dtype):
    """(model kwargs, padded one-frame batch) of a case: the bf16 track in
    float32 on the precision tests' toy, every other case on the ghost
    frame."""
    if "tensor_dtype" in OPTIONS[option] and dtype == "float32":
        return _toy(dtype, **{"tp_kernel_backend": "fused_infer", **OPTIONS[option]}), \
            _single(_toy_batch())
    g = _ghost_frame()
    return _kwargs(dtype, **OPTIONS[option]), _padded(
        g, g[keys.POSITIONS].shape[0] + 4, g[keys.EDGE_INDEX].shape[1] + 16)


def _ops(program):
    """``{op name: nodes}`` of the program's ``atpt::`` calls."""
    ops = {}
    for node in program.graph.nodes:
        if str(node.target).startswith(custom_ops.NAMESPACE + "."):
            name = str(node.target).split(".")[1]
            ops[name] = ops.get(name, 0) + 1
    return ops


@pytest.fixture(scope="module")
def jax_params():
    """JAX's parameters of a case's model, initialized once per model and
    dtype: every option builds the same parameter tree."""
    cache = {}

    def params(kw, batch, dtype):
        key = (kw["l_max"], dtype)
        if key not in cache:
            base = {k: v for k, v in kw.items() if k not in OPTIONS_KEYS}
            cache[key] = JaxAllegroModel(**base).init(0, to_jax(batch, dtype=dtype))
        return cache[key]

    return params


@pytest.mark.parametrize("option,dtype", CASES, ids=[f"{o}-{d}" for o, d in CASES])
def test_exported_option_gives_the_eager_bits_and_matches_jax(option, dtype, jax_params):
    kw, batch = _setup(option, dtype)
    n_pad, e_pad = batch[keys.POSITIONS].shape[0], batch[keys.EDGE_INDEX].shape[1]
    inputs = tuple(batch[k] for k in EXPORT_INPUTS)
    jm = JaxAllegroModel(**kw)
    params = jax_params(kw, batch, dtype)
    with _interpret():
        blob = jax_export_model(jm, params, n_atoms=n_pad, n_edges=e_pad, dtype=np.dtype(dtype))
        want = {k: np.asarray(v) for k, v in jax_load_exported(blob)(*inputs).items()}

    model = AllegroModel(**kw)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    program, meta = export_program(model, n_atoms=n_pad, n_edges=e_pad)
    assert (meta["tensor_dtype"], meta["remat"], meta["checkpoint_energy"]) == (
        str(kw.get("tensor_dtype")), str(bool(kw.get("remat"))),
        str(bool(kw.get("checkpoint_energy"))))
    assert bool(_ops(program)) == (kw["tp_kernel_backend"] != "einsum")
    got = LoadedModel(program.module(), meta)(*inputs)
    eager = model.apply_with_derivatives(to_torch(model.precompute_statics(batch),
                                                  getattr(torch, dtype)))
    assert list(got) == list(want)
    track = kw.get("tensor_dtype") == "bfloat16" and kw["tp_kernel_backend"] != "pallas"
    for k, w in want.items():
        assert torch.equal(got[k], eager[k]), k
        assert got[k].dtype == getattr(torch, dtype), k
        err = float(np.abs(got[k].double().numpy().reshape(w.shape) - w).max())
        scale = float(np.abs(w).max())
        if dtype == "float64":
            tol = TOLS[dtype] * max(1.0, scale)
        else:
            tol = F32_TRACK_TOL * scale if track else TOLS[dtype] * max(1.0, scale)
        assert err <= tol, (k, err, tol)
    assert np.abs(want[keys.FORCES]).max() > 1e-3  # not a vacuous comparison


def test_exported_100k_policy_gives_the_bits_of_the_plain_track():
    batch = _single(_toy_batch())
    n_pad, e_pad = batch[keys.POSITIONS].shape[0], batch[keys.EDGE_INDEX].shape[1]
    inputs = tuple(batch[k] for k in EXPORT_INPUTS)
    outs, ops = [], []
    for option in (POLICY_100K, OPTIONS["bf16 track"]):
        model = AllegroModel(**_toy("float32", tp_kernel_backend="fused_infer", **option)).init(0)
        program, meta = export_program(model, n_atoms=n_pad, n_edges=e_pad)
        outs.append(LoadedModel(program.module(), meta)(*inputs))
        ops.append(_ops(program))
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    # remat and checkpoint_energy recompute: more launches, the same bits
    assert all(ops[0][k] >= n for k, n in ops[1].items()) and ops[0] != ops[1]


def _record_package(monkeypatch):
    """The ``.pt2`` builder replaced by a recorder of its arguments."""
    recorded = {}

    def record(program, path, meta):
        recorded.update(program=program, path=path, meta=meta)
        Path(path).write_bytes(b"recorded")
        return path

    monkeypatch.setattr(export, "_package", record)
    return recorded


def _check_recorded(recorded, model, frame, want_ops):
    """The recorded program's ops, and its outputs on ``frame`` padded to its
    shape against the eager model's, bit for bit."""
    meta = recorded["meta"]
    n_pad, e_pad = int(meta["n_atoms"]), int(meta["n_edges"])
    ops = _ops(recorded["program"])
    assert set(want_ops) <= set(ops), ops
    batch = _padded(frame, n_pad, e_pad)
    got = LoadedModel(recorded["program"].module(), meta)(*(batch[k] for k in EXPORT_INPUTS))
    eager = model.apply_with_derivatives(to_torch(model.precompute_statics(batch),
                                                  model.model_dtype))
    for k in got:
        assert torch.equal(got[k], eager[k]), k
    assert torch.isfinite(got[keys.FORCES]).all() and got[keys.FORCES].abs().max() > 0
    return ops


def test_cli_compiles_md_yaml_as_shipped(tmp_path, monkeypatch):
    recorded = _record_package(monkeypatch)
    assert cli.main(["compile", "-c", str(REPO / "configs/md.yaml"), "-w", str(tmp_path / "md"),
                     "-o", "md.pt2", "--device", "cpu"]) == 0
    meta = recorded["meta"]
    assert recorded["path"] == str(tmp_path / "md" / "md.pt2")
    assert (meta["target"], meta["n_atoms"], meta["n_edges"], meta["dtype"], meta["device"],
            meta["tensor_dtype"]) == ("pair_allegro", "512", "8192", "float32", "cpu", "None")
    with open(REPO / "configs/md.yaml") as f:
        cfg = yaml.safe_load(f)["model"]
    model = build_model(cfg).init(int(cfg["seed"]))
    rng = np.random.RandomState(0)
    pos = rng.uniform(0, 9.0, (60, 3))
    frame = neighbor_list({keys.POSITIONS: pos, keys.ATOM_TYPES: rng.randint(0, 3, 60)
                           .astype(np.int32)}, float(cfg["r_max"]))
    ops = _check_recorded(recorded, model, frame, ["sparse_tp", "center_gather", "center_sum"])
    assert ops["sparse_tp"] == 3 * cfg["num_layers"]  # each layer's forward and two transposes


def test_cli_compiles_a_workdir_trained_on_fused(tmp_path, monkeypatch):
    cfg = _jax_tiny_cfg()
    cfg["model"]["tp_kernel_backend"] = "fused"
    cfg["run"] = ["train"]
    cfg["compile"] = {"n_atoms": 12, "n_edges": 96}
    path = _write(cfg, tmp_path / "fused.yaml")
    workdir = tmp_path / "out"
    _main(["run", "-c", path, "-w", str(workdir), "--device", "cpu"])
    recorded = _record_package(monkeypatch)
    _main(["compile", "-c", path, "-w", str(workdir), "--device", "cpu"])
    assert recorded["path"] == str(workdir / "model.pt2")
    resolved = yaml.safe_load(yaml.safe_dump(cfg))
    _, model, ckpt, rcfg = trained_model(resolved, str(workdir), None)
    assert ckpt == "best" and rcfg["model"]["tp_kernel_backend"] == "fused"
    rng = np.random.RandomState(1)
    frame = neighbor_list({keys.POSITIONS: rng.randn(6, 3) * 1.5,
                           keys.ATOM_TYPES: rng.randint(0, 3, 6).astype(np.int32)},
                          float(rcfg["model"]["r_max"]))
    _check_recorded(recorded, model, frame, ["env_scatter", "gather_tp", "tp_scatter",
                                              "unweight_sh", "unweight_w"])
