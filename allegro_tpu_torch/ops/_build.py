"""Build and load the port's CUDA kernels.

The kernels are CUDA C++ with a plain C interface (``allegro_tpu_torch/csrc``),
compiled with ``nvcc`` for Hopper (``sm_90a``) into one shared library at
first use and loaded with ``ctypes``. The library goes into
``allegro_tpu_torch/_build/``, named by a hash of the sources and flags, so a
changed source is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_i64 = ctypes.c_longlong
# C signatures of csrc/fused_tp.cu; every pointer and the stream are void*
_SIGNATURES = {
    "atpt_env_scatter": [_vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _vp, _vp],
    "atpt_gather_tp": [_vp, _vp, _vp, _vp, _vp, _vp, _i32, _i64, _i32, _i32, _i32, _i32,
                       _i32, _vp, _vp],
    "atpt_bwd_fused": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32, _i64, _i32, _i32, _i32,
                       _i32, _i32, _vp, _vp, _vp],
    "atpt_unweight_both": [_vp, _vp, _vp, _vp, _vp, _i64, _i32, _i32, _i32, _i32, _vp, _vp,
                           _vp],
}


def find_nvcc() -> str | None:
    """``nvcc`` from ``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``."""
    root = os.environ.get("CUDA_HOME")
    if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
        return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.isfile(default) else None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_library(build_dir: Path | str = BUILD_DIR) -> Path:
    """Compile ``csrc/*.cu`` into a shared library (once per source hash) and
    return its path. Raises ``RuntimeError`` when ``nvcc`` is missing or
    fails, with the compiler's output."""
    srcs = _sources()
    digest = hashlib.sha256()
    for src in srcs:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    build_dir = Path(build_dir)
    so_path = build_dir / f"allegro_tpu_torch_kernels_{digest.hexdigest()[:16]}.so"
    if so_path.exists():
        return so_path
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in CUDA_HOME, PATH and /usr/local/cuda/bin): "
            "the CUDA kernels of allegro_tpu_torch cannot be built"
        )
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_name(f"{so_path.name}.tmp{os.getpid()}")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    so_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so_path)
    return so_path


@functools.lru_cache(maxsize=None)
def load_library(build_dir: Path | str = BUILD_DIR) -> ctypes.CDLL:
    """Build if needed, load, and declare the C signatures."""
    lib = ctypes.CDLL(str(build_library(build_dir)))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.atpt_error_string.argtypes = [ctypes.c_int]
    lib.atpt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.atpt_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {msg} (error {rc})")
