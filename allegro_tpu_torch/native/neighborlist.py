"""ctypes binding of the C++ cell-list neighbor list
(``allegro_tpu_torch/csrc/neighborlist.cpp``; twin of
``allegro_tpu/native/neighborlist.py``).

Compiled at first use with ``g++ -O3 -march=native -fopenmp`` into
``allegro_tpu_torch/_build/``, named by a hash of the source, so a changed
source is rebuilt and an unchanged one is loaded as it is. Where the build
or the load fails (no toolchain), ``native_available()`` is False and
``native_neighbor_list`` returns None: the caller takes the scipy list.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "neighborlist.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-fopenmp")

_dp = ctypes.POINTER(ctypes.c_double)
_ip = ctypes.POINTER(ctypes.c_int)


def _build() -> Optional[Path]:
    """The shared library's path, compiled if needed; None where that fails."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    so_path = BUILD_DIR / f"neighborlist_{digest}.so"
    if so_path.exists():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_name(f"{so_path.name}.tmp{os.getpid()}")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so_path)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return so_path


@functools.lru_cache(maxsize=None)
def _library() -> Optional[ctypes.CDLL]:
    so_path = _build()
    if so_path is None:
        return None
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError:
        return None
    lib.atpt_neighbor_list.restype = ctypes.c_longlong
    lib.atpt_neighbor_list.argtypes = [
        _dp,  # positions [n, 3]
        ctypes.c_longlong,  # n
        _dp,  # cell [3, 3]
        _ip,  # pbc [3]
        ctypes.c_double,  # r_max
        ctypes.c_longlong,  # capacity of the outputs
        _ip,  # centers
        _ip,  # neighbors
        _dp,  # shifts [cap, 3]
    ]
    return lib


def native_available() -> bool:
    """Whether the C++ list builds and loads here."""
    return _library() is not None


def native_neighbor_list(
    positions: np.ndarray,
    r_max: float,
    cell: Optional[np.ndarray],
    pbc,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(centers [E] int32, neighbors [E] int32, shifts [E, 3] float64), or
    None where the library is not available (or a periodic axis has no
    cell). The C++ side wraps the positions into the cell; the shifts
    returned are corrected so that ``r = pos[j] - pos[i] + shift @ cell``
    holds for the positions as given (unwrapped ones too)."""
    lib = _library()
    if lib is None:
        return None
    pos = np.ascontiguousarray(positions, dtype=np.float64)
    n = len(pos)
    pbc_arr = np.ascontiguousarray(np.asarray(pbc, dtype=bool).astype(np.int32))
    periodic = pbc_arr.astype(bool)
    if cell is None:
        if periodic.any():
            return None
        # an open box around the atoms, with an r_max margin
        lo, hi = pos.min(0), pos.max(0)
        cell_arr = np.diag(np.maximum(hi - lo, 1.0) + 2 * r_max)
        pos = pos - lo + r_max
        wrap = None
    else:
        cell_arr = np.ascontiguousarray(np.asarray(cell, dtype=np.float64).reshape(3, 3))
        # per-atom integer wrap vectors, to correct the output shifts
        frac = pos @ np.linalg.inv(cell_arr)
        wrap = np.zeros((n, 3), dtype=np.int64)
        wrap[:, periodic] = -np.floor(frac[:, periodic]).astype(np.int64)
        if not wrap.any():
            wrap = None
    cap = max(64 * n, 1024)
    for _ in range(4):
        out_i = np.empty(cap, dtype=np.int32)
        out_j = np.empty(cap, dtype=np.int32)
        out_s = np.empty((cap, 3), dtype=np.float64)
        ret = lib.atpt_neighbor_list(
            pos.ctypes.data_as(_dp), n, cell_arr.ctypes.data_as(_dp),
            pbc_arr.ctypes.data_as(_ip), float(r_max), cap, out_i.ctypes.data_as(_ip),
            out_j.ctypes.data_as(_ip), out_s.ctypes.data_as(_dp),
        )
        if ret >= 0:
            i, j, s = out_i[:ret], out_j[:ret], out_s[:ret]
            if wrap is not None:
                # pos_wrapped[a] = pos[a] + wrap[a] @ cell, so the shift for
                # the given positions is shift + wrap[j] - wrap[i]
                s = s + (wrap[j] - wrap[i]).astype(np.float64)
            return i, j, s
        if ret == -1:
            return None
        cap = int(-ret) + 16
    return None
