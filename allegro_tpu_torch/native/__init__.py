"""Native (C++) host code, loaded through ctypes (twin of
``allegro_tpu/native``).

Built at first use with the system's C++ compiler from the port's own
sources (``allegro_tpu_torch/csrc/``) into ``allegro_tpu_torch/_build/``.
The neighbor list has a pure-Python fallback: ``native_available()`` is
False where no toolchain exists, and the callers take the scipy
implementation. The MD driver (``md_driver.py``) has none: its builds raise
where they fail.
"""

from .md_driver import build_md_core, build_md_driver, build_torch_ops
from .neighborlist import native_available, native_neighbor_list

__all__ = ["native_neighbor_list", "native_available", "build_md_core", "build_md_driver",
           "build_torch_ops"]
