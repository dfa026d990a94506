"""Deployment: compile targets, ghost-atom conversion, AOTInductor packages
(twin of ``allegro_tpu/compile``).

- a compile-target registry (``pair_allegro``, ``pair_allegro_stress``)
  with fixed input and output keys;
- the ghost-atom data conversion of MD engines (periodic edges → appended
  shifted atom copies, the cell dropped) and the ghost force collapse;
- the force call exported as an AOTInductor package (``.pt2``, in place of
  JAX's ``.atpu``), with the hand-written kernels as ``atpt::`` ops,
  loadable without the model-building code from Python or from the C++ MD
  driver (``allegro_tpu_torch/native/md_driver.py``).
"""

from .export import (
    LoadedModel,
    compile_model,
    export_model,
    export_program,
    load_exported,
)
from .targets import (
    COMPILE_TARGETS,
    CompileTarget,
    collapse_ghost_forces,
    ghost_atom_conversion,
    register_compile_target,
)

__all__ = [
    "CompileTarget",
    "COMPILE_TARGETS",
    "register_compile_target",
    "ghost_atom_conversion",
    "collapse_ghost_forces",
    "compile_model",
    "export_model",
    "export_program",
    "load_exported",
    "LoadedModel",
]
