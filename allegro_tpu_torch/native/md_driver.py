"""Builds of the native C++ MD driver (``csrc/md_driver.cpp``; twin of
``allegro_tpu/native/md_driver.py``).

The driver is the fully native pair_allegro role: it runs a ``.pt2`` of the
force call (``compile/export.py``) through libtorch's
``AOTIModelPackageLoader`` on the card, with the port's cell list and a
velocity-Verlet integrator in C++. Two builds, each at first use into
``allegro_tpu_torch/_build/`` (gitignored), named by a hash of its sources
and flags; a failed build raises with the compiler's output:

- :func:`build_md_core`: the torch-free core (``csrc/md_core.cpp`` with
  ``csrc/neighborlist.cpp``), a binary that runs ``--selftest``, in seconds
  with plain ``g++``; the CPU tests build it.
- :func:`build_md_driver`: the driver, ``g++`` (nvcc's host compiler) against
  PyTorch's headers and libraries, with the ``atpt`` ops of
  ``csrc/torch_ops.cpp`` linked in and the kernels' library of
  ``ops/_build.py`` (so it needs the card's toolkit: ``nvcc`` and the CUDA
  headers). Its four sources compile in parallel. The same build links
  ``csrc/torch_ops.cpp`` alone into a shared library (:func:`build_torch_ops`),
  which ``torch.ops.load_library`` loads into a Python process that does not
  import ``ops/custom_ops.py`` (both define the ``atpt`` namespace): there
  each op's C++ implementation can be held against its Python wrapper.

Run ``allegro_md --artifact model.pt2 --init system.npz --steps N`` (the
system file and its options: ``csrc/md_driver.cpp``).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Sequence

from ..ops import _build

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
CORE_SOURCES = ("md_core.cpp", "neighborlist.cpp")
CORE_FLAGS = ("-O2", "-std=c++17", "-fopenmp")
DRIVER_SOURCES = ("md_core.cpp", "neighborlist.cpp", "torch_ops.cpp", "md_driver.cpp")


def _digest(paths: Sequence[Path], *extra: str) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    for e in extra:
        h.update(e.encode())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> None:
    """Run the commands together; raise RuntimeError with every failure's
    output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    results = [(c, p.communicate()[1], p.returncode) for c, p in zip(cmds, procs)]
    failed = [f"exit {rc}: {' '.join(cmd)}\n{err[-4000:]}" for cmd, err, rc in results if rc]
    if failed:
        raise RuntimeError("build failed (" + "\n".join(failed) + ")")


def build_md_core(build_dir: Path | str = BUILD_DIR) -> Path:
    """The torch-free core as a binary that runs ``--selftest``; its path."""
    build_dir = Path(build_dir)
    srcs = [CSRC / s for s in CORE_SOURCES]
    out = build_dir / f"allegro_md_core_{_digest([*srcs, CSRC / 'md_core.h'], *CORE_FLAGS)}"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    try:
        _run_all([["g++", *CORE_FLAGS, "-DATPT_MD_CORE_MAIN", *map(str, srcs), "-o", str(tmp)]])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _torch_paths():
    import torch

    root = Path(torch.__file__).resolve().parent
    return root / "include", root / "lib", int(torch._C._GLIBCXX_USE_CXX11_ABI), torch.__version__


def _ops_library(driver: Path) -> Path:
    """The ``torch_ops.cpp`` library built beside the driver ``driver``."""
    return driver.with_name("libatpt_ops_" + driver.name.rsplit("_", 1)[1] + ".so")


def build_md_driver(build_dir: Path | str = BUILD_DIR) -> Path:
    """The driver binary ``allegro_md``, and beside it the ops' library of
    :func:`build_torch_ops`; the driver's path. Builds the kernels' library
    first (``ops/_build.build_library``)."""
    build_dir = Path(build_dir)
    kernels = _build.build_library(build_dir)
    include, lib, abi, version = _torch_paths()
    nvcc = _build.find_nvcc()
    cuda_include = Path(nvcc).resolve().parent.parent / "include"
    flags = ["-O2", "-std=c++17", "-fPIC", "-fopenmp", f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
             f"-I{include}", f"-I{include / 'torch/csrc/api/include'}", f"-I{cuda_include}"]
    srcs = [CSRC / s for s in DRIVER_SOURCES]
    out = build_dir / "allegro_md_{}".format(
        _digest([*srcs, CSRC / "md_core.h"], *flags, kernels.name, version))
    ops = _ops_library(out)
    if out.exists() and ops.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    objs = [build_dir / f"{s.stem}.{tag}.o" for s in srcs]
    tmp, ops_tmp = out.with_name(f"{out.name}.{tag}"), ops.with_name(f"{ops.name}.{tag}")
    libs = [str(kernels), f"-L{lib}", "-Wl,--no-as-needed", "-ltorch", "-ltorch_cpu",
            "-ltorch_cuda", "-lc10", "-lc10_cuda", "-Wl,--as-needed", f"-Wl,-rpath,{lib}",
            f"-Wl,-rpath,{kernels.parent}"]
    try:
        _run_all([["g++", *flags, "-c", str(s), "-o", str(o)] for s, o in zip(srcs, objs)])
        ops_obj = objs[DRIVER_SOURCES.index("torch_ops.cpp")]
        _run_all([["g++", *map(str, objs), *libs, "-o", str(tmp), "-fopenmp", "-lpthread", "-ldl"],
                  ["g++", "-shared", str(ops_obj), *libs, "-o", str(ops_tmp)]])
        os.replace(ops_tmp, ops)
        os.replace(tmp, out)
    finally:
        for path in (*objs, tmp, ops_tmp):
            path.unlink(missing_ok=True)
    return out


def build_torch_ops(build_dir: Path | str = BUILD_DIR) -> Path:
    """``csrc/torch_ops.cpp`` as a shared library for ``torch.ops.load_library``
    (the kernels' library linked in), built with the driver; its path."""
    return _ops_library(build_md_driver(build_dir))


if __name__ == "__main__":
    print(build_md_driver())
