"""The Clebsch-Gordan blocks compiled into the kernels, and their path table.

Each path of a tensor-product layer couples one irrep slice of each input
with one of the output, and its CG entries are a fixed block, ``wigner_3j(l1,
l2, l3) * sqrt(2 l3 + 1)`` (``nn/contract.py:pack_w3j``), a function of the
triple alone. ``csrc/cg_blocks.h`` holds the block of every triple with l1,
l2, l3 <= 3 as literals in straight-line code, in both faces (the path,
``fwd``, and its transpose, ``bwd``), so a kernel walks paths, not CG
entries. This module

- computes the blocks from the port's ``lib/wigner.py`` (:func:`cg_block`),
- writes the header (:func:`render_header`; run ``python -m
  allegro_tpu_torch.ops.gen_cg_blocks`` after a change to the blocks: the
  header is checked in and the build compiles it as it is),
- builds a layer's path descriptors from its entry table
  (:func:`path_table`), checking that every path is a known block times a
  scale.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..lib.wigner import wigner_3j

L_MAX = 3
# every triple the header compiles, in triple-id order
TRIPLES: Tuple[Tuple[int, int, int], ...] = tuple(
    (l1, l2, l3) for l1 in range(L_MAX + 1) for l2 in range(L_MAX + 1)
    for l3 in range(L_MAX + 1) if abs(l1 - l2) <= l3 <= l1 + l2
)
TRIPLE_ID = {t: n for n, t in enumerate(TRIPLES)}
DEFAULT = -1  # the triple id of a path the header does not hold (l > 3)
HEADER = Path(__file__).resolve().parent.parent / "csrc" / "cg_blocks.h"
TOL = 1e-12  # nn/contract.py:sparse_entries' cut for a nonzero coefficient
DESC_COLS = 8  # (p, triple id, i0, j0, k0, first entry, end entry, output width)
SLICE_MAX = 2 * L_MAX + 1  # the widest output slice of a block: kSliceMax of csrc/sparse_tp.cu


def cg_block(l1: int, l2: int, l3: int) -> np.ndarray:
    """The path block ``wigner_3j(l1, l2, l3) * sqrt(2 l3 + 1)`` [2l1+1,
    2l2+1, 2l3+1], float64, with coefficients under ``TOL`` set to 0."""
    block = wigner_3j(l1, l2, l3) * math.sqrt(2 * l3 + 1)
    return np.where(np.abs(block) > TOL, block, 0.0)


def render_header() -> str:
    """The text of ``csrc/cg_blocks.h``."""
    out = [
        "// Generated by allegro_tpu_torch/ops/gen_cg_blocks.py from lib/wigner.py: do not edit.",
        "//",
        "// CgBlock<l1, l2, l3> is one tensor-product path for one channel, with",
        "// C = wigner_3j(l1, l2, l3) * sqrt(2 l3 + 1): its nonzero coefficients are",
        "// literals, in straight-line FMAs. fwd is the path itself: with x and e the",
        "// path's slices of the two inputs (one of them already times the path",
        "// weight), it adds out[c] += sum_ab C[a,b,c] x[a] e[b]. bwd is its transpose",
        "// in the two inputs: with g the output cotangent's slice (already times the",
        "// path weight), it adds dx[a] += sum_bc C[a,b,c] e[b] g[c] and",
        "// de[b] += sum_ac C[a,b,c] x[a] g[c]. cg_dispatch(tid, f) calls",
        "// f.template run<l1, l2, l3>() for the triple of id tid",
        "// (gen_cg_blocks.TRIPLES) and returns false for any other.",
        "",
        "#pragma once",
        "",
        "namespace {",
        "",
        f"constexpr int kCgTriples = {len(TRIPLES)};",
        f"constexpr int kCgCoefficients = {sum(int(np.count_nonzero(cg_block(*t))) for t in TRIPLES)};",
        "",
        "template <int L1, int L2, int L3>",
        "struct CgBlock;",
    ]
    for tid, (l1, l2, l3) in enumerate(TRIPLES):
        block = cg_block(l1, l2, l3)
        d1, d2, d3 = block.shape
        out += [
            "",
            f"// triple {tid}: ({l1}, {l2}, {l3}), {int(np.count_nonzero(block))} coefficients",
            "template <>",
            f"struct CgBlock<{l1}, {l2}, {l3}> {{",
            f"  static __device__ __forceinline__ void fwd(const float (&x)[{d1}], "
            f"const float (&e)[{d2}], float (&out)[{d3}]) {{",
        ]
        for a, b, c in np.argwhere(block != 0.0):
            coef = repr(float(block[a, b, c]))
            out.append(f"    {{ const float t = static_cast<float>({coef}) * x[{a}]; "
                       f"out[{c}] = fmaf(t, e[{b}], out[{c}]); }}")
        out += [
            "  }",
            f"  static __device__ __forceinline__ void bwd(const float (&x)[{d1}], "
            f"const float (&e)[{d2}], const float (&g)[{d3}],",
            f"                                             float (&dx)[{d1}], float (&de)[{d2}]) {{",
        ]
        for a, b, c in np.argwhere(block != 0.0):
            coef = repr(float(block[a, b, c]))
            out.append(f"    {{ const float t = static_cast<float>({coef}) * g[{c}]; "
                       f"dx[{a}] = fmaf(t, e[{b}], dx[{a}]); de[{b}] = fmaf(t, x[{a}], de[{b}]); }}")
        out += ["  }", "};"]
    out += ["", "template <typename F>", "__device__ __forceinline__ bool cg_dispatch(int tid, F& f) {",
            "  switch (tid) {"]
    for tid, (l1, l2, l3) in enumerate(TRIPLES):
        out.append(f"    case {tid}: f.template run<{l1}, {l2}, {l3}>(); return true;")
    out += ["    default: return false;", "  }", "}", "", "}  // namespace", ""]
    return "\n".join(out)


class CgPaths(NamedTuple):
    """A layer's entry table walked by path: ``desc`` [n_rows, 8] int32 =
    (p, triple id, i0, j0, k0, n0, n1, width), where (i0, j0, k0) are the
    path's slice offsets in the two inputs and the output, ``width`` its
    output rows (2 l3 + 1) and ``[n0, n1)`` its entries in ``entry_idx`` /
    ``entry_coef`` (the layer's entries ordered by path); ``scale`` [n_rows]
    the factor of its block. A path whose triple the header does not hold
    (l > 3) has triple id ``DEFAULT`` and is walked entry by entry. One row
    per path, except in the output order of ``path_table(by_output=True)``."""

    desc: torch.Tensor
    scale: torch.Tensor
    entry_idx: torch.Tensor
    entry_coef: torch.Tensor

    def to(self, device) -> "CgPaths":
        return CgPaths(*(t.to(device) for t in self))


def path_table(entry_idx, entry_coef, dtype=torch.float32, by_output=False) -> CgPaths:
    """The path descriptors of an entry table (idx [n, 4] = (i, j, k, p),
    coef [n]), on the CPU. Each path's slices are the ranges its entries
    span, its l's their half-widths; a path with l <= 3 must equal ``scale``
    times the header's block of its triple, entry for entry (raises
    ValueError otherwise). The coefficients must be the float64 ones: a
    float32 table is no block to ``TOL``.

    ``by_output``: the rows in the order an output-stationary kernel walks
    them (``csrc/sparse_tp.cu``), by output slice ``k0``, then ``p``, so
    the rows of one slice are consecutive and the slice can stay in
    registers while they run. A ``DEFAULT`` path wider than ``SLICE_MAX``
    output rows takes one row per ``SLICE_MAX``-row chunk of its output
    (``k0``, ``width``: the chunk), each over all of the path's entries;
    the kernel keeps those whose output row falls in the chunk."""
    idx = np.asarray(torch.as_tensor(entry_idx).cpu(), dtype=np.int64).reshape(-1, 4)
    coef = np.asarray(torch.as_tensor(entry_coef).cpu(), dtype=np.float64).reshape(-1)
    order = np.argsort(idx[:, 3], kind="stable")
    idx, coef = idx[order], coef[order]
    rows: List[List[int]] = []
    scales: List[float] = []
    for p in np.unique(idx[:, 3]):
        n0, n1 = np.searchsorted(idx[:, 3], [p, p + 1])
        ijk, c = idx[n0:n1, :3], coef[n0:n1]
        lo, hi = ijk.min(0), ijk.max(0)
        span = hi - lo
        if (span % 2).any():
            raise ValueError(f"path {p}: entries span {span + 1} rows, not 2l+1 each")
        ls = tuple(int(s) // 2 for s in span)
        tid = TRIPLE_ID.get(ls, DEFAULT)
        scale = 1.0
        if tid != DEFAULT:
            block = cg_block(*ls)
            top = np.unravel_index(np.abs(block).argmax(), block.shape)
            got = np.zeros_like(block)
            got[tuple((ijk - lo).T)] = c
            scale = float(got[top] / block[top])
            if (np.count_nonzero(block) != len(c)
                    or np.abs(got - scale * block).max() > TOL * max(1.0, abs(scale))):
                raise ValueError(f"path {p}: its entries are not a multiple of the CG block "
                                 f"of triple {ls}")
        rows.append([int(p), tid, *map(int, lo), int(n0), int(n1), int(span[2]) + 1])
        scales.append(scale)
    if by_output:
        rows, scales = _by_output(rows, scales)
    return CgPaths(torch.tensor(rows, dtype=torch.int32).reshape(-1, DESC_COLS),
                   torch.tensor(scales, dtype=dtype),
                   torch.as_tensor(idx, dtype=torch.int32).contiguous(),
                   torch.as_tensor(coef, dtype=dtype))


def _by_output(rows, scales):
    """``path_table``'s rows in output order, wide ``DEFAULT`` outputs cut
    into chunks of ``SLICE_MAX`` rows; raises ValueError where two slices
    overlap without being the same."""
    out = []
    for row, scale in zip(rows, scales):
        k0, width = row[4], row[7]
        for c in range(0, width, SLICE_MAX):
            out.append(([*row[:4], k0 + c, *row[5:7], min(SLICE_MAX, width - c)], scale))
    out.sort(key=lambda rs: (rs[0][4], rs[0][0]))
    for (a, _), (b, _) in zip(out, out[1:]):
        if a[4] == b[4] and a[7] != b[7] or a[4] != b[4] and a[4] + a[7] > b[4]:
            raise ValueError(f"output slices [{a[4]}, +{a[7]}) and [{b[4]}, +{b[7]}) overlap")
    return [r for r, _ in out], [s for _, s in out]


if __name__ == "__main__":
    HEADER.write_text(render_header())
    print(f"wrote {HEADER}")
