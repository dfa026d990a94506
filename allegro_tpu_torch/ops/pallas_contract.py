"""The ``pallas`` backend's kernels: wrappers, plain versions, entry tables
(twin of ``allegro_tpu/ops/pallas_contract.py``).

The per-edge sparse Clebsch–Gordan tensor product
``out[e, kU+u] = Σ_{(i,j,k,p,c)} c·w[p,u]·a[e,iU+u]·b[e,jU+u]`` and its weight
transpose, on the port's flat dim-major track ``[E, d*U]`` with weights
``[P, U]``. The TPU kernels' 128-lane packing ``[d, E*U/128, 128]``, lane-tiled
weights and row padding are TPU mechanics and are not carried over.

| wrapper | replaces (allegro_tpu/ops/pallas_contract.py) |
| --- | --- |
| ``sparse_tp`` | ``_run_tp`` / ``_tp_kernel`` |
| ``sparse_tp_gradw`` | ``_run_gradw`` / ``_gradw_kernel`` |

Both are in ``csrc/sparse_tp.cu``. As in ``ops/fused_tp.py``: a CPU tensor
goes to the plain version (``*_reference``), a CUDA tensor to the kernel on
the current stream (the wrapper raises if the launch fails; there is no
fallback), and ``fused_tp.LAUNCHES[name]`` counts the launches.

An entry table may come in any of the six role orders of :data:`ROLES`: the
transposes of the derivative family (``ops/tp_primitives.py``) are the same
kernel on permuted tables. The kernels walk that order's path table
(``gen_cg_blocks.path_table(by_output=True)``, built once per layer by
``nn/contract.py:Contracter``): each path with l <= 3 is one compiled CG
block of ``csrc/cg_blocks.h``, a path beyond it its entries one by one.

A bfloat16 model's operands take bfloat16 forms with JAX's semantics:
``sparse_tp`` rounds each op in the table's entry order
(:func:`sparse_tp_bf16_reference`), ``sparse_tp_gradw`` sums the edges in
the groups of JAX's packed layout and rounds where its kernel and the fold
of its lane-tiled output do (:func:`sparse_tp_gradw_bf16_reference`).
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .fused_tp import (
    _cg_tensor,
    _check_entries,
    _check_kernel_args,
    _kernel_paths,
    _launch,
    _on_cpu,
    _path_tensor,
)
from .gen_cg_blocks import CgPaths

Entry = Tuple[int, int, int, int, float]  # (i, j, k, p, c)

# The role orders of a table: order r maps an entry (i, j, k) to
# (e[r[0]], e[r[1]], e[r[2]]); order 0 is the table itself.
ROLES = tuple(itertools.permutations(range(3)))


def permute_entries(entries: Sequence[Entry], roles: Tuple[int, int, int]) -> Tuple[Entry, ...]:
    """The table with its (i, j, k) roles permuted, sorted by the new (i, j, k)
    as JAX's ``_swap_a_out`` / ``_swap_b_out`` / ``_perm_gradw_a`` sort theirs:
    ``(2, 1, 0)`` is the a-swap, ``(0, 2, 1)`` the b-swap, ``(1, 2, 0)`` the
    a-transpose of the weight gradient."""
    out = [(e[roles[0]], e[roles[1]], e[roles[2]], e[3], e[4]) for e in entries]
    return tuple(sorted(out, key=lambda e: (e[0], e[1], e[2])))


def role_tables(entries: Sequence[Entry], dtype: torch.dtype):
    """The table in every order of :data:`ROLES`: idx ``[6, n, 4]`` int32
    (i, j, k, p) and coef ``[6, n]`` in ``dtype``."""
    tables = [permute_entries(entries, r) for r in ROLES]
    idx = np.array([[e[:4] for e in t] for t in tables], dtype=np.int32).reshape(6, -1, 4)
    coef = np.array([[e[4] for e in t] for t in tables], dtype=np.float64).reshape(6, -1)
    return torch.from_numpy(idx), torch.from_numpy(coef).to(dtype)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def sparse_tp_reference(a, b, w, entry_idx, entry_coef, d3):
    E, U = a.shape[0], w.shape[1]
    d1, d2 = a.shape[1] // U, b.shape[1] // U
    ww = _path_tensor(w, entry_idx, entry_coef, d1, d2, d3)  # [U, d1, d2, d3]
    av, bv = a.view(E, d1, U), b.view(E, d2, U)
    out = a.new_zeros((E, d3, U))
    for i in range(d1):
        out = out + av[:, i : i + 1, :] * torch.einsum("eju,ujk->eku", bv, ww[:, i])
    return out.reshape(E, d3 * U)


def _bf16(v: torch.Tensor) -> torch.Tensor:
    """``v`` (float32) rounded to bfloat16, kept in float32."""
    return v.to(torch.bfloat16).float()


def sparse_tp_bf16_reference(a, b, w, entry_idx, entry_coef, d3):
    """The bfloat16 form's semantics, JAX's ``_tp_kernel`` on bfloat16
    operands, which does not promote: in the table's entry order, ``t =
    a[i] b[j]`` (formed again where (i, j) changes), ``c w[p]`` with c
    rounded to bfloat16, their product, and each output's running sum are
    each rounded to bfloat16 (float32 arithmetic, then rounded, as XLA
    computes a bfloat16 op); out is bfloat16, an output no entry reaches
    zero."""
    E, U = a.shape[0], w.shape[1]
    av, bv = a.float().view(E, -1, U), b.float().view(E, -1, U)
    wf, coef = w.float(), _bf16(entry_coef.float())
    acc = [None] * d3
    cur, t = None, None
    for (i, j, k, p), c in zip(entry_idx.tolist(), coef.unbind(0)):
        if (i, j) != cur:
            t, cur = _bf16(av[:, i] * bv[:, j]), (i, j)
        con = _bf16(_bf16(c * wf[p]) * t)
        acc[k] = con if acc[k] is None else _bf16(acc[k] + con)
    zero = a.new_zeros((E, U), dtype=torch.float32)
    return torch.stack([zero if v is None else v for v in acc], 1).reshape(E, d3 * U).to(a.dtype)


# JAX's packed layout, which its bfloat16 weight gradient sums in: (edge,
# channel) pairs on 128 lanes (lane q*U + u of row r is channel u of edge
# r*Q + q, Q = 128 / U), blocks of 64 rows (``PallasTPBackend.block_rows``)
GRADW_LANES, GRADW_BLOCK_ROWS = 128, 64


def _gradw_layout(E: int, U: int) -> Tuple[int, int]:
    """(Q, the edges on a row of JAX's packed layout; its blocks of 64 rows
    over E edges, at least one); raises unless U divides the 128 lanes
    (JAX's ``tile_weights`` asserts it too)."""
    if U < 1 or GRADW_LANES % U:
        raise ValueError(f"sparse_tp_gradw on bfloat16 operands: U={U} must divide "
                         f"{GRADW_LANES} (JAX's lane tiling of the weights)")
    Q = GRADW_LANES // U
    rows = -(-E // Q)
    return Q, max(1, -(-rows // GRADW_BLOCK_ROWS))


def sparse_tp_gradw_bf16_reference(a, b, g, entry_idx, entry_coef, n_paths, U,
                                   chunk: int = 32):
    """The bfloat16 form's semantics, JAX's ``_gradw_kernel`` on bfloat16
    operands and the fold of its lane-tiled [P, 128] output into [P, U]
    (the transpose of ``tile_weights``' ``jnp.tile``), established on JAX's
    CPU output. The edges are cut as JAX packs them (:data:`GRADW_LANES`,
    :data:`GRADW_BLOCK_ROWS`): lane (q, u) of block b sums the edges
    ``(64 b + r) Q + q``, r = 0..63. Per block, in the table's entry order:
    ``t = a[i] b[j]`` rounded to bfloat16, ``s = Σ_r t g[k]`` in float32 (the
    products exact, summed in row order; ``jnp.sum`` upcasts, and XLA forms
    the product in float32) rounded to bfloat16, ``c s`` with c rounded to
    bfloat16, and the path's running sum, each rounded to bfloat16; then the
    blocks' sums are added in block order and the Q lanes of a channel in
    lane order, each add rounded to bfloat16. gw is bfloat16. ``chunk``:
    entries formed at once (memory only)."""
    E, B = a.shape[0], GRADW_BLOCK_ROWS
    Q, nb = _gradw_layout(E, U)

    def lanes(t):  # [E, d*U] -> [nb, B, Q, d, U] float32, zero past the last edge
        t = torch.cat([t.float(), t.new_zeros((nb * B * Q - E, t.shape[1]), dtype=torch.float32)])
        return t.view(nb, B, Q, -1, U)

    A, Bv, G = lanes(a), lanes(b), lanes(g)
    idx = entry_idx.long().tolist()
    coef = _bf16(entry_coef.float()).tolist()
    acc = [None] * n_paths
    for n0 in range(0, len(idx), chunk):
        part = idx[n0:n0 + chunk]
        i, j, k = (torch.tensor([e[c] for e in part], device=a.device) for c in range(3))
        prod = _bf16(A[:, :, :, i] * Bv[:, :, :, j]) * G[:, :, :, k]  # [nb, B, Q, n, U]
        s = torch.zeros_like(prod[:, 0])
        for r in range(B):
            s = s + prod[:, r]
        s = _bf16(s)
        for m, (_, _, _, p) in enumerate(part):
            con = _bf16(coef[n0 + m] * s[:, :, m])
            acc[p] = con if acc[p] is None else _bf16(acc[p] + con)
    zero = a.new_zeros((nb, Q, U), dtype=torch.float32)
    blocks = torch.stack([zero if v is None else v for v in acc], 1)  # [nb, P, Q, U]
    ow = torch.zeros_like(blocks[0])
    for blk in blocks.unbind(0):
        ow = _bf16(ow + blk)
    gw = torch.zeros_like(ow[:, 0])
    for lane in ow.unbind(1):
        gw = _bf16(gw + lane)
    return gw.to(torch.bfloat16)


def sparse_tp_gradw_reference(a, b, g, entry_idx, entry_coef, n_paths, U):
    E = a.shape[0]
    d1, d2, d3 = a.shape[1] // U, b.shape[1] // U, g.shape[1] // U
    C = _cg_tensor(a, entry_idx, entry_coef, n_paths, d1, d2, d3)
    av, bv, gv = a.view(E, d1, U), b.view(E, d2, U), g.view(E, d3, U)
    gw = a.new_zeros((n_paths, U))
    for i in range(d1):
        t = torch.einsum("eju,eku->jku", av[:, i : i + 1, :] * bv, gv)  # [d2, d3, U]
        gw = gw + torch.einsum("pjk,jku->pu", C[:, i], t)
    return gw


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def sparse_tp(a, b, w, entry_idx, entry_coef, d3: int,
              paths: Optional[CgPaths] = None) -> torch.Tensor:
    """out [E, d3*U]: ``out[e, kU+u] = Σ c w[p,u] a[e,iU+u] b[e,jU+u]``.
    a [E, d1*U], b [E, d2*U], w [P, U], entries (i, j, k, p) / c in any role
    order; on the card also ``paths``, that order's path table in walk
    order; dims up to 32.

    Replaces ``_tp_kernel``. Bound by the reads of a and b and the write of
    out; one thread per (edge, channel), coalesced rows, each output slice
    summed in registers over the compiled CG blocks of its paths and stored
    once.

    bfloat16 a, b and w (a bfloat16 model's) take the bfloat16 form, with
    JAX's semantics (:func:`sparse_tp_bf16_reference`: every product and
    sum rounded to bfloat16, in the table's entry order, which the compiled
    blocks do not keep): a thread per (edge, channel) walks the entry table
    itself, ``entry_idx`` and ``entry_coef`` on the card, out bfloat16."""
    E, U = a.shape[0], w.shape[1]
    _check_entries(entry_idx, entry_coef)
    if a.ndim != 2 or b.ndim != 2 or w.ndim != 2 or b.shape[0] != E or a.shape[1] % U \
            or b.shape[1] % U:
        raise ValueError(
            f"sparse_tp shapes: a {tuple(a.shape)}, b {tuple(b.shape)}, w {tuple(w.shape)}"
        )
    bf16 = torch.bfloat16 in (a.dtype, b.dtype, w.dtype)
    if bf16 and not a.dtype == b.dtype == w.dtype:
        raise TypeError(f"sparse_tp: the bfloat16 form takes a, b and w all bfloat16, got "
                        f"{a.dtype}, {b.dtype}, {w.dtype}")
    if _on_cpu(a, b, w, entry_idx, entry_coef):
        if bf16:
            return sparse_tp_bf16_reference(a, b, w, entry_idx, entry_coef, d3)
        return sparse_tp_reference(a, b, w, entry_idx, entry_coef, d3)
    if bf16:
        _check_kernel_args({"entry_coef": entry_coef}, {"entry_idx": entry_idx},
                           {"a": a, "b": b, "w": w})
        d1, d2 = a.shape[1] // U, b.shape[1] // U
        if max(d1, d2, d3) > 32:
            raise ValueError(f"sparse_tp: dims up to 32, got {(d1, d2, d3)}")
        out = torch.empty((E, d3 * U), dtype=a.dtype, device=a.device)
        if E > 0:
            _launch("sparse_tp", "atpt_sparse_tp_bf16", a.device,
                    a.data_ptr(), b.data_ptr(), w.data_ptr(), entry_idx.data_ptr(),
                    entry_coef.data_ptr(), entry_idx.shape[0], E, d1, d2, d3, U,
                    out.data_ptr(), bf16=True)
        return out
    _check_kernel_args({"a": a, "b": b, "w": w}, {})
    paths = _kernel_paths("sparse_tp", paths, entry_idx.shape[0])
    out = torch.empty((E, d3 * U), dtype=a.dtype, device=a.device)
    if E > 0:
        _launch("sparse_tp", "atpt_sparse_tp", a.device,
                a.data_ptr(), b.data_ptr(), w.data_ptr(), paths.desc.data_ptr(),
                paths.scale.data_ptr(), paths.desc.shape[0], paths.entry_idx.data_ptr(),
                paths.entry_coef.data_ptr(), E, a.shape[1] // U, b.shape[1] // U, d3, U,
                w.shape[0], out.data_ptr())
    return out


_GRADW_MAX_BLOCKS = 1024  # kGradwMaxBlocks of csrc/sparse_tp.cu (partials [blocks, P, U])


def sparse_tp_gradw(a, b, g, entry_idx, entry_coef, n_paths: int, U: int,
                    paths: Optional[CgPaths] = None) -> torch.Tensor:
    """gw [n_paths, U]: ``gw[p, u] = Σ_e Σ_{(i,j,k)∈p} c a[e,iU+u] b[e,jU+u]
    g[e,kU+u]``, the w-transpose of ``sparse_tp``. a [E, d1*U], b [E, d2*U],
    g [E, d3*U]; on the card also ``paths`` (as ``sparse_tp``).

    Replaces ``_gradw_kernel``. Bound by the reads of a, b and g; each
    path's compiled block once per edge and channel, per-block partials
    summed in a second launch in block order (no float atomics).

    bfloat16 a, b and g (a bfloat16 model's training) take the bfloat16
    form, gw bfloat16 (:func:`sparse_tp_gradw_bf16_reference`'s semantics:
    JAX's bits; U must divide 128)."""
    E = a.shape[0]
    _check_entries(entry_idx, entry_coef)
    if (a.ndim != 2 or b.ndim != 2 or g.ndim != 2 or b.shape[0] != E or g.shape[0] != E
            or a.shape[1] % U or b.shape[1] % U or g.shape[1] % U):
        raise ValueError(
            f"sparse_tp_gradw shapes: a {tuple(a.shape)}, b {tuple(b.shape)}, "
            f"g {tuple(g.shape)}, U={U}"
        )
    bf16 = torch.bfloat16 in (a.dtype, b.dtype, g.dtype)
    if bf16 and not a.dtype == b.dtype == g.dtype:
        raise TypeError(f"sparse_tp_gradw: the bfloat16 form takes a, b and g all bfloat16, "
                        f"got {a.dtype}, {b.dtype}, {g.dtype}")
    if _on_cpu(a, b, g, entry_idx, entry_coef):
        if bf16:
            return sparse_tp_gradw_bf16_reference(a, b, g, entry_idx, entry_coef, n_paths, U)
        return sparse_tp_gradw_reference(a, b, g, entry_idx, entry_coef, n_paths, U)
    if bf16:
        return _sparse_tp_gradw_bf16(a, b, g, entry_idx, entry_coef, n_paths, U)
    _check_kernel_args({"a": a, "b": b, "g": g}, {})
    paths = _kernel_paths("sparse_tp_gradw", paths, entry_idx.shape[0])
    n_blocks = max(1, min(_GRADW_MAX_BLOCKS, -(-E // 64)))
    partial = torch.empty((n_blocks, n_paths, U), dtype=a.dtype, device=a.device)
    gw = torch.empty((n_paths, U), dtype=a.dtype, device=a.device)
    _launch("sparse_tp_gradw", "atpt_sparse_tp_gradw", a.device,
            a.data_ptr(), b.data_ptr(), g.data_ptr(), paths.desc.data_ptr(),
            paths.scale.data_ptr(), paths.desc.shape[0], paths.entry_idx.data_ptr(),
            paths.entry_coef.data_ptr(), E, a.shape[1] // U, b.shape[1] // U, g.shape[1] // U, U,
            n_paths, n_blocks, partial.data_ptr(), gw.data_ptr())
    return gw


def _sparse_tp_gradw_bf16(a, b, g, entry_idx, entry_coef, n_paths: int, U: int):
    """The bfloat16 form on the card (:func:`sparse_tp_gradw_bf16_reference`'s
    semantics): a warp per 32 lanes of one of JAX's 64-row blocks walks the
    entry table, each entry's float32 row sums in its shared-memory column,
    then rounds them into the paths' bfloat16 sums (the partials [nb, P,
    128]); a second launch adds the blocks in block order and folds the
    lanes."""
    E = a.shape[0]
    _, nb = _gradw_layout(E, U)
    _check_kernel_args({"entry_coef": entry_coef}, {"entry_idx": entry_idx},
                       {"a": a, "b": b, "g": g})
    partial = torch.empty((nb, n_paths, GRADW_LANES), dtype=torch.float32, device=a.device)
    gw = torch.empty((n_paths, U), dtype=torch.bfloat16, device=a.device)
    _launch("sparse_tp_gradw", "atpt_sparse_tp_gradw_bf16", a.device,
            a.data_ptr(), b.data_ptr(), g.data_ptr(), entry_idx.data_ptr(),
            entry_coef.data_ptr(), entry_idx.shape[0], E, a.shape[1] // U, b.shape[1] // U,
            g.shape[1] // U, U, n_paths, nb, partial.data_ptr(), gw.data_ptr(), bf16=True)
    return gw
