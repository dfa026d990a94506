"""What the export is made of (``compile/export.py``), on the CPU.

- ``Model.graph_statics``, the CSR statics computed inside the program,
  equals ``precompute_statics`` bit for bit on sentinel-padded and on
  zero-padded masked lists, for every class lookup; an out-of-order list
  sets its ``ok`` flag False.
- The exported program holds exactly one ``atpt::`` op per kernel launch of
  the eager call on its route (mega, ``use_mega=False``, the plain readout,
  ``fused``, ``pallas``, the bf16 track on mega and with ``use_mega=False``;
  none on ``einsum``), and runs to the eager call's outputs. No route's
  force call reaches the weight-gradient kernels 15 and 21.
- ``csrc/torch_ops.cpp`` defines the Python ops' schemas letter for letter,
  the bf16 flags included.
- The CLI's ``compile`` stage on a tiny config, with the ``.pt2`` builder
  replaced by a recorder: the recorded program against the eager model.
- Eager calls on ``fused_infer``, ``fused`` and ``pallas`` use no op.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from allegro_tpu_torch import cli
from allegro_tpu_torch.compile import LoadedModel, export, export_program
from allegro_tpu_torch.compile.targets import EXPORT_INPUTS
from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
from allegro_tpu_torch.model import AllegroModel
from allegro_tpu_torch.ops import custom_ops, fused_tp, pallas_contract
from torch_threads import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
R_MAX = 2.6


def _frame(seed=0, side=2):
    rng = np.random.RandomState(seed)
    n = side**3
    grid = np.stack(np.meshgrid(*(np.arange(side),) * 3, indexing="ij"), -1).reshape(-1, 3)
    frame = {keys.POSITIONS: grid * 2.4 + 0.1 * rng.randn(n, 3),
             keys.ATOM_TYPES: rng.randint(0, 3, n).astype(np.int32)}
    return neighbor_list(frame, R_MAX)


def _model(**kw):
    base = dict(r_max=R_MAX, type_names=["A", "B", "C"], l_max=1, num_layers=2,
                num_scalar_features=8, num_tensor_features=4,
                scalar_embed_mlp_hidden_layers_width=8, allegro_mlp_hidden_layers_width=8,
                readout_mlp_hidden_layers_width=8, avg_num_neighbors=6.0,
                per_type_energy_scales=1.0, per_type_energy_shifts=0.0, model_dtype="float64",
                tp_kernel_backend="fused_infer")
    return AllegroModel(**{**base, **kw}).init(0)


def _batch(frame, n_pad, e_pad, zero=False):
    """Single-frame padded data; ``zero``: the padded edges (0, 0), masked."""
    batch = batch_frames([frame], n_atoms=n_pad, n_edges=e_pad, n_frames=1)
    for k in (keys.BATCH, keys.NUM_NODES, keys.FRAME_MASK):
        batch.pop(k)
    if zero:
        ei = batch[keys.EDGE_INDEX].copy()
        ei[:, ~batch[keys.EDGE_MASK]] = 0
        batch[keys.EDGE_INDEX] = ei
    return batch


STATICS_MODELS = {
    "type embeddings": dict(),
    "spline, trainable scales": dict(
        tp_kernel_backend="fused", per_type_energy_scales_trainable=True,
        per_type_energy_shifts_trainable=True,
        radial_chemical_embed={"_target_": "allegro_tpu.nn.TwoBodySplineScalarEmbed"}),
    "pallas": dict(tp_kernel_backend="pallas"),
    "einsum": dict(tp_kernel_backend="einsum"),
}


@pytest.mark.parametrize("zero", [False, True], ids=["sentinel", "zero"])
@pytest.mark.parametrize("name", list(STATICS_MODELS))
def test_graph_statics_equal_precompute_statics(name, zero):
    model = _model(**STATICS_MODELS[name])
    frame = _frame(1, side=3)
    e = frame[keys.EDGE_INDEX].shape[1]
    sentinel = _batch(frame, 40, e + 37)
    sentinel[keys.NODE_MASK][25:] = False  # padded atoms beyond the 27
    want = model.precompute_statics(sentinel)
    given = _batch(frame, 40, e + 37, zero=zero)
    given[keys.NODE_MASK] = sentinel[keys.NODE_MASK]
    got, ok = model.graph_statics(to_torch(given))
    assert bool(ok)
    new = set(want) - set(sentinel) | {keys.EDGE_INDEX}
    assert new == set(got) - set(given) | {keys.EDGE_INDEX}
    assert len(new) == (2 if name == "einsum" else 5 + 3 * len(model.class_lookups))
    for k in new:
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_graph_statics_flag_lists_outside_the_contract():
    model = _model()
    frame = _frame(2)
    e = frame[keys.EDGE_INDEX].shape[1]
    good = to_torch(_batch(frame, 16, e + 8))
    assert bool(model.graph_statics(good)[1])
    ei = good[keys.EDGE_INDEX].clone()
    ei[:, [0, e - 1]] = ei[:, [e - 1, 0]]
    assert not bool(model.graph_statics({**good, keys.EDGE_INDEX: ei})[1])
    far = good[keys.EDGE_INDEX].clone()
    far[1, 3] = 99  # an id beyond the sentinel: clamped, and flagged
    got, ok = model.graph_statics({**good, keys.EDGE_INDEX: far})
    assert not bool(ok) and int(got[keys.EDGE_INDEX].max()) == 16


def _count_wrapper_calls(monkeypatch):
    """Count each kernel wrapper's calls (the launches it would make on the
    card) in ``fused_tp.LAUNCHES``, the weight-gradient kernels' too."""
    for name in fused_tp.LAUNCHES:
        module = pallas_contract if name.startswith("sparse_tp") else fused_tp
        fn = getattr(module, name)

        def counted(*a, _fn=fn, _name=name, **k):
            fused_tp.LAUNCHES[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(module, name, functools.wraps(fn)(counted))


ROUTES = {
    "mega": dict(),
    "use_mega=False": dict(use_mega=False),
    "plain readout": dict(use_mega=False, use_fused_readout=False),
    "einsum": dict(tp_kernel_backend="einsum"),
    "fused": dict(tp_kernel_backend="fused"),
    "pallas": dict(tp_kernel_backend="pallas"),
    "bf16 mega": dict(tensor_dtype="bfloat16"),
    "bf16 use_mega=False": dict(tensor_dtype="bfloat16", use_mega=False),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_program_holds_one_op_per_launch_of_its_route(route, monkeypatch):
    _count_wrapper_calls(monkeypatch)
    model = _model(**ROUTES[route])
    frame = _frame(3)
    batch = _batch(frame, 12, frame[keys.EDGE_INDEX].shape[1] + 5)
    fused_tp.reset_launch_counts()
    eager = model.apply_with_derivatives(to_torch(model.precompute_statics(batch)))
    launches = {k: v for k, v in fused_tp.LAUNCHES.items() if v}
    program, meta = export_program(model, n_atoms=12, n_edges=batch[keys.EDGE_INDEX].shape[1])
    ops = {}
    for node in program.graph.nodes:
        if str(node.target).startswith(custom_ops.NAMESPACE + "."):
            name = str(node.target).split(".")[1]
            ops[name] = ops.get(name, 0) + 1
    assert ops == launches
    assert set(ops) <= set(custom_ops.SCHEMAS) and (route == "einsum") == (not ops)
    assert not {"gather_dw", "sparse_tp_gradw"} & set(launches)
    got = LoadedModel(program.module(), meta)(*(batch[k] for k in EXPORT_INPUTS))
    for k in got:
        torch.testing.assert_close(got[k], eager[k], atol=1e-12, rtol=1e-12)


def _cpp_schemas():
    """``name -> schema`` of each ``m.def`` in ``csrc/torch_ops.cpp``, its
    adjacent string literals joined."""
    src = (REPO / "allegro_tpu_torch/csrc/torch_ops.cpp").read_text()
    out = {}
    for m in re.finditer(r'm\.def\(((?:\s*"[^"]*")+)\s*\)', src):
        text = "".join(re.findall(r'"([^"]*)"', m.group(1)))
        out[text.split("(", 1)[0]] = text
    return out


# the flags each op's kernel launch takes (kernels 1-4, 7-10, 14, 16, 17)
BF16_FLAGS = {
    "env_scatter": ("bf16",), "gather_tp": ("bf16",), "bwd_fused": ("bf16",),
    "unweight_both": ("bf16", "bf16_out"), "latent_env_scatter": ("bf16_wexp",),
    "latent_env_bwd": ("bf16_wexp",), "gather_tp_embed": ("bf16",), "bwd_embed": ("bf16",),
    "tp_scatter": ("bf16",), "unweight_sh": ("bf16",), "unweight_w": ("bf16",),
}


def test_cpp_schemas_are_the_python_ops_schemas():
    src = (REPO / "allegro_tpu_torch/csrc/torch_ops.cpp").read_text()
    cpp = _cpp_schemas()
    assert sorted(cpp) == sorted(custom_ops.SCHEMAS)
    impls = re.findall(r'm\.impl\("(\w+)"', src)
    assert sorted(impls) == sorted(custom_ops.SCHEMAS)
    for name, schema in custom_ops.SCHEMAS.items():
        assert cpp[name] == name + schema
        registered = getattr(torch.ops.atpt, name).default._schema
        assert str(registered) == str(torch._C.parse_schema(f"atpt::{cpp[name]}"))
        flags = tuple(a.name for a in registered.arguments if a.name.startswith("bf16"))
        assert flags == BF16_FLAGS.get(name, ()), name
        assert all(str(a.type) == "bool" for a in registered.arguments if a.name in flags)
    # every launch passes its op's flags: no literal flag before the stream
    assert not re.search(r"\b0,\s*(?:0,\s*)?stream\(\)\)", src)


TINY_CONFIG = {
    "model": {
        "_target_": "allegro_tpu.model.AllegroModel", "seed": 3, "model_dtype": "float64",
        "r_max": R_MAX, "type_names": ["A", "B", "C"], "l_max": 1, "num_layers": 2,
        "num_scalar_features": 8, "num_tensor_features": 4,
        "scalar_embed_mlp_hidden_layers_width": 8, "allegro_mlp_hidden_layers_width": 8,
        "readout_mlp_hidden_layers_width": 8, "avg_num_neighbors": 6.0,
        "per_type_energy_scales": 1.0, "per_type_energy_shifts": 0.0,
        "tp_kernel_backend": "fused_infer",
    },
    "compile": {"target": "pair_allegro_stress", "n_atoms": 12, "n_edges": 64},
}


def test_cli_compile_stage_records_the_program(tmp_path, monkeypatch):
    recorded = {}

    def record(program, path, meta):
        recorded.update(program=program, path=path, meta=meta)
        Path(path).write_bytes(b"recorded")
        return path

    monkeypatch.setattr(export, "_package", record)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(TINY_CONFIG))
    assert cli.main(["compile", "-c", str(cfg), "-w", str(tmp_path / "run"), "-o", "m.pt2",
                     "--device", "cpu"]) == 0
    assert recorded["path"] == str(tmp_path / "run" / "m.pt2")
    assert (tmp_path / "run" / "m.pt2").read_bytes() == b"recorded"
    meta = recorded["meta"]
    assert (meta["target"], meta["n_atoms"], meta["n_edges"], meta["dtype"], meta["device"]) == (
        "pair_allegro_stress", "12", "64", "float64", "cpu")
    loaded = LoadedModel(recorded["program"].module(), meta)
    assert loaded.outputs[-1] == keys.VIRIAL
    frame = _frame(4)
    batch = _batch(frame, 12, 64)
    got = loaded(*(batch[k] for k in EXPORT_INPUTS))
    model = AllegroModel(**{k: v for k, v in TINY_CONFIG["model"].items()
                            if k not in ("_target_", "seed")}).init(3)
    want = model.apply_with_derivatives(to_torch(model.precompute_statics(batch)))
    for k in (keys.PER_ATOM_ENERGY, keys.FORCES, keys.TOTAL_ENERGY):
        torch.testing.assert_close(got[k], want[k], atol=1e-12, rtol=1e-12)
    virial = batch[keys.POSITIONS].T @ want[keys.FORCES].numpy()
    np.testing.assert_allclose(got[keys.VIRIAL][0].numpy(), virial, atol=1e-12)


def test_eager_call_does_not_use_the_ops(monkeypatch):
    """Outside ``tracing()`` the Functions call the wrappers themselves, on
    the inference and both trainable backends."""
    def refuse():
        raise AssertionError("an atpt op ran in an eager call")

    monkeypatch.setattr(custom_ops, "_ops", refuse)
    frame = _frame(5)
    batch = _batch(frame, 12, frame[keys.EDGE_INDEX].shape[1])
    for backend in ("fused_infer", "fused", "pallas"):
        model = _model(tp_kernel_backend=backend)
        out = model.apply_with_derivatives(to_torch(model.precompute_statics(batch)))
        assert torch.isfinite(out[keys.FORCES]).all()
        with custom_ops.tracing(), pytest.raises(AssertionError, match="eager call"):
            model.apply_with_derivatives(to_torch(model.precompute_statics(batch)))
