"""The force call as an AOTInductor package (twin of
``allegro_tpu/compile/export.py``).

JAX lowers its jitted force call to StableHLO at fixed padded shapes and
zips it with the parameters into an ``.atpu``; here the force call becomes
one ``.pt2`` (``torch._inductor.aoti_compile_and_package``), loadable from
Python (:func:`load_exported`) and from C++ (``AOTIModelPackageLoader``, the
MD driver of ``csrc/md_driver.cpp``) without any model-building code.

How the program is made (:func:`export_program`):

- The force call differentiates the energy with ``torch.autograd.grad``
  inside its forward, which ``torch.export.export`` does not take directly.
  So it is first traced with ``make_fx(..., tracing_mode="real")`` on the
  model's device, which records the backward pass's operations too, then
  exported. Tracing runs the call once: host reads of module buffers and the
  route that ``Model.routes`` picks on that device become constants.
- The kernels run through ctypes, which a trace cannot see: inside
  ``custom_ops.tracing()`` each launch is an ``atpt::`` op instead
  (``ops/custom_ops.py``), and the package calls those ops, so it runs the
  hand-written kernels (their plain versions for a CPU package).
- The program's inputs are JAX's artifact's: ``(positions, edge_index,
  atom_types, node_mask, edge_mask)``. The CSR statics are computed inside
  it (``Model.graph_statics``); an edge list that is not sorted by center
  gives NaN energies.
- The parameters are constants of the program, frozen as in the force call.
- ``remat`` and ``checkpoint_energy`` (``torch.utils.checkpoint``) record
  their recompute: the backward's unpack hook runs the checkpointed forward
  again under the trace, so the program launches each of its kernels twice,
  as the eager call does. ``tp_chunk_edges`` traces as its loop of slices.

The package's metadata (``aot_inductor.metadata``: strings, which
``AOTIModelPackageLoader::get_metadata()`` returns) holds what JAX's
``meta.json`` holds: ``format``, ``target``, ``inputs``, ``outputs``,
``n_atoms``, ``n_edges``, ``dtype``, ``config`` (JSON), and ``r_max``,
``device``, ``precision`` (the model's matrix-product policy),
``tensor_dtype``, ``remat`` and ``checkpoint_energy``. The package is built
under that policy, and both runners set TF32 from it for each call.

Exported: every model the builder makes, on all four backends (``fused``
with its parameters frozen, as the force call runs it), the bf16 track on
every route, ``remat``, ``checkpoint_energy`` and ``tp_chunk_edges``, with
``precision`` "highest", "high" or None. The builder itself refuses
``model_dtype="bfloat16"`` (ROADMAP.md queue 1, item 6).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..data import keys
from ..model.builders import PRECISIONS, Model, _not_ported
from ..ops import custom_ops
from .targets import COMPILE_TARGETS, EXPORT_INPUTS

FORMAT = "allegro-tpu-torch-pt2-v1"
EXPORTED_BACKENDS = ("fused_infer", "fused", "pallas", "einsum")
_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def check_exportable(model: Model) -> None:
    """Raise for a model the export has no program for: a bfloat16 model
    (ROADMAP item 14: its kernel forms have no ``atpt::`` ops yet) and what
    the builder itself refuses (a backend it does not know)."""
    kw = model.builder_kwargs
    backend = kw.get("tp_kernel_backend", "einsum")
    if backend not in EXPORTED_BACKENDS:
        raise ValueError(f"tp_kernel_backend={backend!r}: one of {EXPORTED_BACKENDS}")
    if str(kw.get("model_dtype", "float32")) not in _DTYPES:
        raise _not_ported(f"exporting model_dtype={kw['model_dtype']!r}", "queue 1, item 14")


def _force_fn(model: Model, target: str) -> Callable:
    """The target's force call on the export inputs → its outputs, in order."""
    outputs = COMPILE_TARGETS[target].outputs

    def fn(positions, edge_index, atom_types, node_mask, edge_mask):
        data, ok = model.graph_statics(dict(zip(
            EXPORT_INPUTS, (positions, edge_index, atom_types, node_mask, edge_mask))))
        # an edge list outside the contract poisons every output
        nan = torch.full((), float("nan"), dtype=positions.dtype, device=positions.device)
        data[keys.POSITIONS] = positions + torch.where(ok, torch.zeros_like(nan), nan)
        out = model.apply_with_derivatives(data)
        if keys.VIRIAL in outputs and keys.VIRIAL not in out:
            # ghost format (open boundary): E is translation invariant, so
            # VIRIAL = -dE/dε under x' = x (I + ε) is the fdotr sum Σᵢ rᵢ ⊗ fᵢ
            # over real and ghost rows, what LAMMPS' virial_fdotr_compute
            # accumulates from pair_allegro's forces
            f = out[keys.FORCES]
            out[keys.VIRIAL] = (positions.to(f.dtype).T @ f)[None]
        return tuple(out[k] for k in outputs)

    return fn


def example_inputs(n_atoms: int, n_edges: int, dtype: torch.dtype, device) -> Tuple:
    """The export's inputs at the padded shape: no real edge."""
    return (torch.zeros((n_atoms, 3), dtype=dtype, device=device),
            torch.zeros((2, n_edges), dtype=torch.int32, device=device),
            torch.zeros((n_atoms,), dtype=torch.int32, device=device),
            torch.ones((n_atoms,), dtype=torch.bool, device=device),
            torch.zeros((n_edges,), dtype=torch.bool, device=device))


def export_program(model: Model, target: str = "pair_allegro", n_atoms: int = 512,
                   n_edges: int = 8192, dtype: Optional[torch.dtype] = None
                   ) -> Tuple["torch.export.ExportedProgram", Dict[str, str]]:
    """``(ExportedProgram, metadata)`` of the target's force call at one
    padded shape, on the model's device: traced with ``make_fx`` (the kernel
    launches as ``atpt::`` ops), then ``torch.export.export``ed."""
    from torch.fx.experimental.proxy_tensor import make_fx

    check_exportable(model)
    if target not in COMPILE_TARGETS:
        raise ValueError(f"unknown compile target {target!r}; known: {sorted(COMPILE_TARGETS)}")
    device = next(model.module.parameters()).device
    dtype = dtype or model.model_dtype
    args = example_inputs(n_atoms, n_edges, dtype, device)
    fn = _force_fn(model, target)
    # one eager call first: the tables a call uploads to its device once
    # (lru-cached) then exist before the trace and enter it as device
    # constants, where an upload inside the trace would be a host constant
    # that AOTInductor hands to a device product as it is
    fn(*args)
    with custom_ops.tracing():
        graph = make_fx(fn, tracing_mode="real")(*args)
    program = torch.export.export(graph, args)
    meta = {
        "format": FORMAT,
        "target": target,
        "inputs": json.dumps(list(EXPORT_INPUTS)),
        "outputs": json.dumps(list(COMPILE_TARGETS[target].outputs)),
        "n_atoms": str(n_atoms),
        "n_edges": str(n_edges),
        "dtype": str(dtype).removeprefix("torch."),
        "config": json.dumps({k: str(v) for k, v in model.config.items()}),
        "r_max": repr(float(model.config["r_max"])),
        "device": device.type,
        "precision": str(model.precision),
        "tensor_dtype": str(model.builder_kwargs.get("tensor_dtype")),
        "remat": str(bool(model.builder_kwargs.get("remat"))),
        "checkpoint_energy": str(model.checkpoint_energy),
    }
    return program, meta


def _package(program, path: str, meta: Dict[str, str]) -> str:
    """AOTInductor's build of ``program`` into the ``.pt2`` at ``path``, with
    the ``g++`` on the path (the kernels' and the MD driver's compiler;
    AOTInductor would take ``$CXX``) and the eager call's rounding points.
    Inductor's graph patterns fold a round trip through bfloat16
    (``pointless_convert``: float32 → bfloat16 → float32 becomes nothing on
    some torch versions), and its code generator may skip such a rounding
    unless ``emulate_precision_casts``: the bf16 track's path weights,
    rounded so in the eager call, would reach the kernels unrounded (with
    the patterns on, the 100k policy's package on an H100 under torch 2.11
    was 1.5e-4 of sum |E_i| off the eager energy; without, 2.2e-6). Raises
    where the build fails."""
    return torch._inductor.aoti_compile_and_package(
        program, package_path=os.path.abspath(path),
        inductor_configs={"aot_inductor.metadata": meta, "cpp.cxx": ("g++",),
                          "pattern_matcher": False, "emulate_precision_casts": True})


def export_model(model: Model, path: str, target: str = "pair_allegro", n_atoms: int = 512,
                 n_edges: int = 8192, dtype: Optional[torch.dtype] = None) -> str:
    """Write the target's force call at one padded shape as an AOTInductor
    package (``.pt2``) to ``path``, built under the model's matrix-product
    policy; returns the path."""
    program, meta = export_program(model, target, n_atoms, n_edges, dtype)
    with model.matmul_policy():
        return _package(program, path, meta)


class LoadedModel:
    """A compiled force call (``fn``: a loaded package, or an exported
    program's module) with its metadata: called as JAX's ``LoadedModel``,
    ``(positions, edge_index, atom_types, node_mask=None, edge_mask=None)``
    → ``{output name: tensor}``. Inputs are cast and moved to the program's
    dtype and device; the matrix-product policy of the metadata holds for
    the call."""

    def __init__(self, fn: Callable, meta: Dict[str, str]):
        self._fn = fn
        self.meta = meta
        self.n_atoms, self.n_edges = int(meta["n_atoms"]), int(meta["n_edges"])
        self.outputs = json.loads(meta["outputs"])
        self.dtype = _DTYPES[meta["dtype"]]
        self.device = torch.device(meta["device"])
        self.precision = None if meta["precision"] == "None" else meta["precision"]

    def __call__(self, positions, edge_index, atom_types, node_mask=None,
                 edge_mask=None) -> Dict[str, torch.Tensor]:
        n, e = self.n_atoms, self.n_edges
        if tuple(positions.shape) != (n, 3) or tuple(edge_index.shape) != (2, e):
            raise ValueError(f"the program takes positions [{n}, 3] and edge_index [2, {e}], got "
                             f"{tuple(positions.shape)} and {tuple(edge_index.shape)}")
        node_mask = np.ones(n, bool) if node_mask is None else node_mask
        edge_mask = np.ones(e, bool) if edge_mask is None else edge_mask
        args = tuple(torch.as_tensor(v).to(self.device, dt) for v, dt in zip(
            (positions, edge_index, atom_types, node_mask, edge_mask),
            (self.dtype, torch.int32, torch.int32, torch.bool, torch.bool)))
        cuda = torch.backends.cuda.matmul
        before, cuda.allow_tf32 = cuda.allow_tf32, PRECISIONS[self.precision]
        try:
            with torch.no_grad():
                out = self._fn(*args)
        finally:
            cuda.allow_tf32 = before
        return dict(zip(self.outputs, out))


def load_exported(path: str) -> LoadedModel:
    """The ``.pt2`` at ``path``, loaded for inference on its device (the
    kernels' ``atpt::`` ops must be registered: importing this module does
    it)."""
    runner = torch._inductor.aoti_load_package(os.path.abspath(path))
    meta = runner.get_metadata()
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: package format {meta.get('format')!r}, expected {FORMAT!r}")
    return LoadedModel(runner, meta)


def compile_model(config: Dict, workdir: str, ckpt: Optional[str], output: str,
                  device=None) -> str:
    """The CLI's ``compile`` stage: the trained model (EMA parameters of the
    ``best`` checkpoint in ``ckpt`` or ``workdir``, else ``last``, else the
    initial ones) exported with the config's ``compile:`` block (``target``
    default ``pair_allegro``, ``n_atoms`` 512, ``n_edges`` 8192) to
    ``output`` (relative to ``workdir``) on ``device`` (default the card)."""
    from ..device import resolve_device
    from ..train.package import output_path, trained_model

    _, model, _, cfg = trained_model(config, workdir, ckpt)
    ccfg = dict(cfg.get("compile") or {})
    model.to(resolve_device(device))
    path = export_model(model, output_path(workdir, output),
                        target=ccfg.get("target", "pair_allegro"),
                        n_atoms=int(ccfg.get("n_atoms", 512)),
                        n_edges=int(ccfg.get("n_edges", 8192)))
    print(f"wrote AOTInductor package: {path} ({os.path.getsize(path)} bytes)")
    return path
