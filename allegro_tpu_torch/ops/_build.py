"""Build and load the port's CUDA kernels.

The kernels are CUDA C++ with a plain C interface (``allegro_tpu_torch/csrc``),
compiled with ``nvcc`` for Hopper (``sm_90a``) at first use, one ``nvcc``
process per source, all started together, then linked into one shared
library and loaded with ``ctypes``. The library goes into
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_i64 = ctypes.c_longlong
_vpp = ctypes.POINTER(ctypes.c_void_p)
_i64p = ctypes.POINTER(ctypes.c_longlong)
_i32p = ctypes.POINTER(ctypes.c_int)
# C signatures of csrc/*.cu; every device pointer and the stream are void*,
# the readout's piece tables are host arrays
_SIGNATURES = {
    "atpt_env_scatter": [_vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _vp, _vp],
    "atpt_gather_tp": [_vp, _vp, _vp, _vp, _vp, _vp, _i32, _i64, _i32, _i32, _i32, _i32,
                       _i32, _vp, _vp, _vp],
    "atpt_bwd_fused": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32, _i64, _i32, _i32, _i32,
                       _i32, _i32, _vp, _vp, _vp],
    "atpt_unweight_both": [_vp, _vp, _vp, _vp, _vp, _i64, _i32, _i32, _i32, _i32, _vp, _vp,
                           _vp],
    "atpt_center_gather": [_vp, _vp, _i64, _i32, _i32, _vp, _vp],
    "atpt_center_sum": [_vp, _vp, _vp, _i32, _i32, _vp, _vp],
    "atpt_readout_sum": [_vpp, _i64p, _i32p, _i32, _vp, _vp, _vp, _i32, _i32, _vp, _vp],
    "atpt_readout_bwd": [_vpp, _i64p, _vpp, _i64p, _i32p, _i32, _vp, _vp, _vp, _vp, _i64,
                         _i32, _i32, _vp],
    "atpt_latent_env_scatter": [_vpp, _i64p, _i32p, _i32, _vp, _vp, _vp, _vp, _vp, _i64,
                                _i32, _i32, _i32, _i32, _i32, _i32, _vp, _vp, _vp],
    "atpt_latent_env_bwd": [_vpp, _i64p, _vpp, _i64p, _i32p, _i32, _vp, _vp, _vp, _vp, _vp,
                            _vp, _vp, _i64, _i32, _i32, _i32, _i32, _i32, _i32, _vp, _vp],
    "atpt_gather_tp_embed": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32, _vp, _i64, _i32, _i32,
                             _i32, _i32, _i32, _i32, _i32, _vp, _vp, _vp],
    "atpt_bwd_embed": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32, _vp, _i64, _i32,
                       _i32, _i32, _i32, _i32, _i32, _i32, _vp, _vp, _vp, _vp],
    "atpt_tp_scatter": [_vp, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _i32, _vp,
                        _vp],
    "atpt_gather_dw": [_vp, _vp, _vp, _vp, _vp, _vp, _i32, _i64, _i32, _i32, _i32, _i32, _i32,
                       _i32, _i32, _vp, _vp, _vp],
    "atpt_unweight_sh": [_vp, _vp, _vp, _vp, _i64, _i32, _i32, _i32, _i32, _vp, _vp],
    "atpt_unweight_w": [_vp, _vp, _vp, _vp, _i64, _i32, _i32, _i32, _i32, _vp, _vp],
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
    tag = f"tmp{os.getpid()}"
    objs = [build_dir / f"{src.stem}.{tag}.o" for src in srcs]
    tmp = so_path.with_name(f"{so_path.name}.{tag}")
    try:
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for src, o in zip(srcs, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        results = []
        for cmd, proc in zip(cmds, procs):
            out, err = proc.communicate()
            results.append((cmd, proc.returncode, out, err))
        for cmd, rc, out, err in results:
            if rc != 0:
                raise RuntimeError(f"nvcc failed (exit {rc}): {' '.join(cmd)}\n{err}")
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(link)}\n{proc.stderr}"
            )
        so_path.with_suffix(".log").write_text(
            "".join(out + err for _, _, out, err in results) + proc.stdout + proc.stderr
        )
        os.replace(tmp, so_path)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
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
