"""Native (C++) host code, loaded through ctypes (twin of
``allegro_tpu/native``).

Built at first use with the system's C++ compiler from the port's own
sources (``allegro_tpu_torch/csrc/neighborlist.cpp``) into
``allegro_tpu_torch/_build/``. Everything here has a pure-Python fallback:
``native_available()`` is False where no toolchain exists, and the callers
take the scipy implementation.
"""

from .neighborlist import native_available, native_neighbor_list

__all__ = ["native_neighbor_list", "native_available"]
