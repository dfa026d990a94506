"""The force call's kernels: wrappers, plain versions, counters.

Each wrapper takes its arguments in the JAX package's layout (edges sorted
by center, sentinel center ``n_atoms`` on padded edges, flat dim-major
tensor track: column ``i*U+u`` is basis dim ``i``, channel ``u``) and returns
per-atom arrays as one ``[n_atoms, ·]`` array, where the TPU kernels returned
two rank-window partials ``(eA, eB)``.

- A tensor on the CPU goes to the kernel's plain PyTorch version
  (``*_reference``), which the CPU tests hold against the Pallas kernels.
- A tensor on a CUDA device goes to the hand-written CUDA kernel
  (``csrc/*.cu``, built by ``ops/_build.py``) on the current stream;
  the wrapper raises if the launch fails. There is no fallback.
- ``LAUNCHES[name]`` counts the kernel launches, and only those;
  ``BF16_LAUNCHES[name]`` counts those of them that ran a bf16 form.

| wrapper | replaces (allegro_tpu/ops/fused_tp.py) |
| --- | --- |
| ``env_scatter`` | ``env_scatter_call`` / ``_env_scatter_kernel`` |
| ``gather_tp`` | ``gather_tp_raw_call`` / ``_gather_tp_raw_kernel`` |
| ``bwd_fused`` | ``bwd_fused_raw_call`` / ``_bwd_fused_raw_kernel``; with ``with_dw``, ``bwd_fused_call`` / ``_bwd_fused_kernel`` |
| ``unweight_both`` | ``unweight_both_raw_call`` / ``_unweight_both_raw_kernel`` |
| ``center_gather`` | ``center_broadcast_call`` / ``_center_broadcast_kernel`` |
| ``center_sum`` | ``center_sum_call`` / ``_center_sum_kernel`` |
| ``readout_sum`` | ``readout_sum_call`` / ``_readout_sum_kernel`` |
| ``readout_bwd`` | ``readout_bwd_call`` / ``_readout_bwd_kernel`` |
| ``latent_env_scatter`` | ``latent_env_scatter_call`` / ``_latent_env_scatter_kernel`` |
| ``latent_env_bwd`` | ``latent_env_bwd_call`` / ``_latent_env_bwd_kernel`` |
| ``gather_tp_embed`` | ``gather_tp_embed_raw_call`` / ``_gather_tp_embed_raw_kernel`` |
| ``bwd_embed`` | ``bwd_embed_raw_call`` / ``_bwd_embed_raw_kernel`` |
| ``tp_scatter`` | ``tp_scatter_call`` / ``_tp_scatter_kernel`` |
| ``gather_dw`` | ``gather_dw_call`` / ``_gather_dw_kernel`` |
| ``unweight_sh`` | ``gather_unweight_sh_call`` / ``_gather_unweight_sh_kernel`` |
| ``unweight_w`` | ``gather_unweight_w_call`` / ``_gather_unweight_w_kernel`` |

``env_scatter`` and ``unweight_both`` are in ``csrc/train_tp.cu`` beside
``unweight_sh`` and ``unweight_w`` (env_scatter's transposes, all four on
staged rows), ``bwd_fused`` with ``with_dw`` in ``csrc/fused_tp.cu``, the
center gathers and the readout in ``csrc/center_readout.cu``, the four
mega-fused layers in ``csrc/mega.cu``; ``gather_tp``, ``gather_dw``,
``tp_scatter`` and ``bwd_fused`` without ``with_dw`` walk the layer's compiled CG
paths in ``csrc/sparse_tp.cu``, the same walkers as the ``pallas``
backend's ``sparse_tp`` / ``sparse_tp_gradw`` with the env row gathered by
center (``tp_scatter``: the per-edge rows summed over each atom's edges;
``bwd_fused``: ``gather_tp``'s walk on the role swap and ``tp_scatter``'s
in one pass), and on the card take the table's path tables (``paths``,
built once per layer by ``nn/contract.py:Contracter``).
``gather_tp`` also serves ``gather_tp_call`` / ``_gather_tp_kernel``: the
port keeps one env array, so that kernel's combined-env form is the same
function, and its x-transpose is ``gather_tp`` on the role-swapped entry
table (:func:`swap_entries`).
``unweight_both`` serves ``unweight_both_call`` / ``_unweight_both_kernel``
the same way: from one denv array, the function of its window pair. What
bounds each kernel on the card and how its design answers it is noted
beside each kernel in the CUDA source.

The bf16 tensor track (the model's ``tensor_dtype="bfloat16"``, on both
fused backends): the features, their cotangents and the env weights are
stored in bfloat16 where JAX stores them so. ``gather_tp`` and ``bwd_fused``
(without dw) take x, g and dx in bfloat16, ``tp_scatter`` and ``gather_dw``
x and g; ``env_scatter``, ``unweight_sh`` and ``unweight_both`` take wexp
in bfloat16 (``unweight_both`` writes dwexp in it too, ``unweight_w`` in its
``out_dtype``); ``gather_tp_embed`` writes its out in ``out_dtype``,
``bwd_embed`` reads its g in bfloat16, and ``latent_env_scatter`` /
``latent_env_bwd`` round the env weights to ``wexp_dtype`` and back before
the env product. Every other array stays in the model dtype. As in JAX
(``compute_dtype``), each kernel and plain version loads the track, computes
in float32 at least (the promotion of float32 with its inputs' dtypes) and
rounds once, on store; each output has the dtype JAX gives it. The CUDA
forms are the same kernels on either storage type (``csrc/*.cu``:
``load_f`` / ``store_f``, the staged rows widened to float); a combination
of dtypes that has no form raises ``TypeError``.

A bfloat16 model (``model_dtype="bfloat16"``): the per-edge operands JAX
stores in bfloat16 are read in bfloat16 by the kernels' bf16-operand forms,
widened as they are staged (their flags: ``BF_SH``, ``BF_W2B``, ``BF_TS``
and the pieces' masks): sh (``env_scatter``, ``unweight_both``, the mega
kernels), w2b (the embeds), the MLP pieces (the mega and readout kernels),
ts and gts (``gather_tp``, ``bwd_fused``, the embeds); ``center_gather``
and ``center_sum`` have bfloat16 forms (a copy; a float32 sum rounded
once). The MLP and path weights come widened to float32, once per call
(``fused_primitives._wide``). Outputs take JAX's dtypes: what JAX stores in
bfloat16 is rounded once from the float32 sum, the rest float32. Its
training (the trainable backend's double backward) reaches 13-16 with the
bf16 track's operands (features, cotangents and env weights bfloat16) and
``unweight_w`` with bfloat16 sh beside its bfloat16 dwexp (``BF_SH``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .gen_cg_blocks import CgPaths, path_table

LAUNCHES: Dict[str, int] = {
    "env_scatter": 0, "gather_tp": 0, "bwd_fused": 0, "unweight_both": 0,
    "center_gather": 0, "center_sum": 0, "readout_sum": 0, "readout_bwd": 0,
    "latent_env_scatter": 0, "latent_env_bwd": 0, "gather_tp_embed": 0, "bwd_embed": 0,
    "tp_scatter": 0, "gather_dw": 0, "unweight_sh": 0, "unweight_w": 0,
    # the `pallas` backend's two, whose wrappers are in ops/pallas_contract.py
    "sparse_tp": 0, "sparse_tp_gradw": 0,
}
# the launches of the bf16 forms (kernels 1-4, 7-10 and 14-17 on the bf16
# track; kernels 1-17, 20 and 21 on a bfloat16 model's bf16 operands), each
# also counted in LAUNCHES under its kernel's name
BF16_LAUNCHES: Dict[str, int] = {name: 0 for name in LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, BF16_LAUNCHES):
        for name in counts:
            counts[name] = 0


def csr_row_ptr(centers: np.ndarray, n_atoms: int) -> np.ndarray:
    """Host CSR statics: ``row_ptr[a]`` is the first edge of atom ``a`` in
    the center-sorted edge list, ``row_ptr[n_atoms]`` the first padded
    (sentinel) edge. Raises ValueError unless the centers lie in
    ``[0, n_atoms]`` and are non-decreasing (padding trailing), the order
    the kernels rely on (as ``make_block_plan_np`` checks on the TPU)."""
    centers = np.asarray(centers).astype(np.int64)
    if centers.size and (centers.min() < 0 or centers.max() > n_atoms):
        raise ValueError(f"edge centers must lie in [0, {n_atoms}] (sentinel {n_atoms})")
    if centers.size and (np.diff(centers) < 0).any():
        raise ValueError(
            "the fused TP kernels require edges sorted by center atom (non-decreasing "
            "edge_index[0], padded edges last); neighbor_list produces this order"
        )
    return np.searchsorted(centers, np.arange(n_atoms + 1), side="left").astype(np.int32)


def neighbor_csr(neighbors: np.ndarray, n_atoms: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host CSR statics of the neighbor side: ``perm`` lists the edges sorted
    by neighbor (stable, so each segment keeps edge order; sentinel
    neighbors ``n_atoms`` last) and ``row_ptr`` is the CSR over that order.
    ``center_sum(v, row_ptr, perm)`` is then the sum over each atom's
    incoming edges, the transpose of gathering by neighbor."""
    neighbors = np.asarray(neighbors).astype(np.int64)
    # sorted in the narrowest type that holds the ids: numpy sorts 8- and
    # 16-bit integers by radix (csr_row_ptr rejects ids out of range)
    narrow = neighbors.astype(np.min_scalar_type(n_atoms))
    perm = np.argsort(narrow, kind="stable").astype(np.int32)
    return perm, csr_row_ptr(neighbors[perm], n_atoms)


# ---------------------------------------------------------------------------
# segment helpers (edges → atoms and back; sentinel edges are dropped / read 0)
# ---------------------------------------------------------------------------


def segment_sum(values: torch.Tensor, centers: torch.Tensor, n_atoms: int) -> torch.Tensor:
    """``out[a] = Σ_{centers[e] = a} values[e]``; ids ``>= n_atoms`` are dropped."""
    idx = centers.long().clamp(0, n_atoms)
    out = values.new_zeros((n_atoms + 1,) + tuple(values.shape[1:]))
    return out.index_add(0, idx, values)[:n_atoms]


def gather_rows(table: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """``out[e] = table[centers[e]]``, zeros for ids ``>= len(table)``."""
    n = table.shape[0]
    padded = torch.cat([table, table.new_zeros((1,) + tuple(table.shape[1:]))])
    return padded.index_select(0, centers.long().clamp(0, n))


def irrep_ranges(dim_to_irr: torch.Tensor) -> torch.Tensor:
    """``[n_irr, 2]`` int32: (first dim, dim count) of each irrep of the SH
    basis, from ``dim_to_irr`` [d2]: ``latent_env_bwd``'s table of each env
    column block's basis dims. Raises ValueError unless each irrep's dims are
    contiguous and the irreps in order."""
    d2i = [int(r) for r in dim_to_irr.tolist()]
    n_irr = max(d2i) + 1 if d2i else 0
    if d2i != sorted(d2i) or set(d2i) != set(range(n_irr)):
        raise ValueError(f"dim_to_irr {d2i}: each irrep's dims must be contiguous and in order")
    counts = [d2i.count(r) for r in range(n_irr)]
    starts = np.cumsum([0] + counts[:-1]).tolist()
    return torch.tensor(list(zip(starts, counts)), dtype=torch.int32).reshape(n_irr, 2)


def swap_entries(entry_idx: torch.Tensor) -> torch.Tensor:
    """The role swap ``(i, j, k, p) -> (k, j, i, p)`` of an entry table (the
    coefficients keep their order): with it, ``gather_tp`` computes the
    transpose of ``gather_tp`` in its first input, mapping ``[E, d3*U]`` to
    ``[E, d1*U]``. Swapping twice gives the table back."""
    return entry_idx[:, [2, 1, 0, 3]].contiguous()


# The columns of an entry table (i, j, k, p) in the role order (0, 2, 1)
# whose path table ``tp_scatter`` walks: (i, k, j, p), so that the walk's
# inputs are x (over i) and g (over k) and its out is j, the env.
SCATTER_ROLES = [0, 2, 1, 3]


def compute_dtype(*tensors) -> torch.dtype:
    """The dtype the kernels compute in: float32 promoted with the inputs'
    (JAX's ``fused_tp.compute_dtype``): bfloat16 storage computes in
    float32, a float64 model in float64."""
    dt = torch.float32
    for t in tensors:
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    return dt


def round_to(v: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``v`` rounded to ``dtype`` and back (None: ``v`` itself): the env
    weights of the bf16 track, ``wexp.astype(bfloat16).astype(cdt)``."""
    return v if dtype is None or dtype == v.dtype else v.to(dtype).to(v.dtype)


def _cg_tensor(like, entry_idx, entry_coef, n_paths, d1, d2, d3):
    """The dense ``C[p, i, j, k]`` of the sparse entries, in ``like``'s dtype."""
    idx = entry_idx.long()
    C = like.new_zeros((n_paths, d1, d2, d3))
    C.index_put_((idx[:, 3], idx[:, 0], idx[:, 1], idx[:, 2]), entry_coef.to(like.dtype),
                 accumulate=True)
    return C


def _path_tensor(w, entry_idx, entry_coef, d1, d2, d3):
    """``ww[u, i, j, k] = Σ_p w[p, u] C[p, i, j, k]`` from the sparse entries."""
    C = _cg_tensor(w, entry_idx, entry_coef, w.shape[0], d1, d2, d3)
    return torch.einsum("pu,pijk->uijk", w, C)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _weighted_sh(sh, wexp, dim_to_irr, U):
    """``[E, d2*U]``: column ``jU+u`` is ``sh[e, j] wexp[e, irr(j)U+u]``."""
    E, d2 = sh.shape
    w = wexp.reshape(E, -1, U).index_select(1, dim_to_irr.long())  # [E, d2, U]
    return (sh[:, :, None] * w).reshape(E, d2 * U)


def env_scatter_reference(sh, wexp, centers, n_atoms, dim_to_irr, U):
    cdt = compute_dtype(sh, wexp)
    return segment_sum(_weighted_sh(sh.to(cdt), wexp.to(cdt), dim_to_irr, U), centers, n_atoms)


def _fold_gts(g, gts):
    """g with the split scalar output's cotangent added to its block 0."""
    if gts is None:
        return g
    U = gts.shape[1]
    return torch.cat([g[:, :U] + gts, g[:, U:]], dim=1)


def _embed_x0(sh, w2b, row_specs, U):
    """Layer 0's features ``x0[e, iU+u] = sh[e, js_i] w2b[e, irs_i U+u]``
    from ``row_specs`` [d1, 2] = (js_i, irs_i)."""
    E = sh.shape[0]
    specs = row_specs.long()
    w = w2b.reshape(E, -1, U).index_select(1, specs[:, 1])  # [E, d1, U]
    return (sh.index_select(1, specs[:, 0])[:, :, None] * w).reshape(E, -1)


def gather_tp_reference(x, env, w, centers, entry_idx, entry_coef, d3, split=False,
                        ts_dtype=None):
    cdt = compute_dtype(x, env)
    out = _gather_tp(x.to(cdt), env.to(cdt), w.to(cdt), centers, entry_idx, entry_coef, d3)
    if not split:
        return out.to(x.dtype)
    return out.to(x.dtype), out[:, :w.shape[1]].to(ts_dtype or env.dtype, copy=True)


def _gather_tp(x, env, w, centers, entry_idx, entry_coef, d3):
    E, U = x.shape[0], w.shape[1]
    d1, d2 = x.shape[1] // U, env.shape[1] // U
    ww = _path_tensor(w, entry_idx, entry_coef, d1, d2, d3)
    env_e = gather_rows(env, centers).view(E, d2, U)
    xv = x.view(E, d1, U)
    out = x.new_zeros((E, d3, U))
    for i in range(d1):
        out = out + xv[:, i : i + 1, :] * torch.einsum("eju,ujk->eku", env_e, ww[:, i])
    return out.reshape(E, d3 * U)


def bwd_fused_reference(x, g, env, w, centers, n_atoms, entry_idx, entry_coef, gts=None,
                        with_dw=False):
    cdt = compute_dtype(x, g, env)
    dx, denv, *dw = _bwd_fused(x.to(cdt), g.to(cdt), env.to(cdt), w.to(cdt), centers, n_atoms,
                               entry_idx, entry_coef, None if gts is None else gts.to(cdt),
                               with_dw)
    # stored as JAX's kernel stores them: dx in x's dtype, denv in the
    # compute dtype of x and g (float32 for a bf16 track in a float64 model)
    return (dx.to(x.dtype), denv.to(compute_dtype(x, g)), *dw)


def _bwd_fused(x, g, env, w, centers, n_atoms, entry_idx, entry_coef, gts, with_dw):
    g = _fold_gts(g, gts)
    E, U = x.shape[0], w.shape[1]
    d1, d2, d3 = x.shape[1] // U, env.shape[1] // U, g.shape[1] // U
    ww = _path_tensor(w, entry_idx, entry_coef, d1, d2, d3)
    env_e = gather_rows(env, centers).view(E, d2, U)
    xv, gv = x.view(E, d1, U), g.view(E, d3, U)
    dx = []
    denv_e = x.new_zeros((E, d2, U))
    for i in range(d1):
        t = torch.einsum("eku,ujk->eju", gv, ww[:, i])  # [E, d2, U]
        dx.append((t * env_e).sum(1))
        denv_e = denv_e + xv[:, i : i + 1, :] * t
    dx = torch.stack(dx, dim=1).reshape(E, d1 * U)
    denv = segment_sum(denv_e.reshape(E, d2 * U), centers, n_atoms)
    if not with_dw:
        return dx, denv
    return dx, denv, gather_dw_reference(x, env, g, centers, entry_idx, entry_coef, w.shape[0], U)


def unweight_both_reference(t, sh, wexp, centers, dim_to_irr, out_dtype=None):
    # JAX's dtypes: computed in the promotion of all three, dsh stored in
    # t's compute dtype, dwexp in out_dtype, default wexp's (the bf16
    # track's bfloat16)
    cdt = compute_dtype(t, wexp, sh)
    n_irr = wexp.shape[1] // (t.shape[1] // sh.shape[1])
    dsh = unweight_sh_reference(t.to(cdt), wexp.to(cdt), centers, dim_to_irr)
    dwexp = unweight_w_reference(t.to(cdt), sh.to(cdt), centers, dim_to_irr, n_irr)
    return dsh.to(compute_dtype(t)), dwexp.to(out_dtype or wexp.dtype)


def center_gather_reference(a, idx):
    return gather_rows(a, idx)


def center_sum_reference(v, row_ptr, perm=None):
    if v.dtype == torch.bfloat16:
        # summed in float32, stored once (a bfloat16 model's sums)
        return center_sum_reference(v.float(), row_ptr, perm).to(v.dtype)
    n_atoms = row_ptr.shape[0] - 1
    E = v.shape[0]
    k = torch.arange(E, device=v.device)
    # atom of CSR position k (n_atoms for the positions after row_ptr[n_atoms])
    seg = torch.searchsorted(row_ptr[1:].long(), k, right=True)
    rows = v if perm is None else v.index_select(0, perm.long())
    out = v.new_zeros((n_atoms + 1,) + tuple(v.shape[1:]))
    return out.index_add(0, seg, rows)[:n_atoms]


def _edge_mlp(pieces, w0, w1):
    """Per-edge ``pre = Σ_i p_i @ W0_i`` and output ``silu(pre) @ w1`` (or
    ``pre`` itself without a hidden layer, ``w1 is None``), in the compute
    dtype: a bfloat16 model's pieces and weights widened, as JAX's kernels
    read them."""
    cdt = compute_dtype(*pieces, w0, w1)
    w0 = w0.to(cdt)
    w1 = None if w1 is None else w1.to(cdt)
    pre = None
    off = 0
    for p in pieces:
        t = p.to(cdt) @ w0[off : off + p.shape[1]]
        pre = t if pre is None else pre + t
        off += p.shape[1]
    return pre, pre if w1 is None else torch.nn.functional.silu(pre) @ w1


def _edge_mlp_bwd(pieces, pre, dout, w0, w1):
    """The piece cotangents of :func:`_edge_mlp` from its output's ``dout``."""
    cdt = pre.dtype
    dh = dout.to(cdt)
    if w1 is not None:
        sig = torch.sigmoid(pre)
        dh = (dh @ w1.to(cdt).T) * (sig * (1.0 + pre * (1.0 - sig)))
    dp = dh @ w0.to(cdt).T
    return tuple(torch.split(dp, [p.shape[1] for p in pieces], dim=1))


def readout_sum_reference(pieces, w0, w1, row_ptr):
    _, energy = _edge_mlp(pieces, w0, w1)
    return center_sum_reference(energy, row_ptr)


def readout_bwd_reference(pieces, w0, w1, y, centers):
    pre, _ = _edge_mlp(pieces, w0, w1)
    return _edge_mlp_bwd(pieces, pre, gather_rows(y, centers), w0, w1)


def latent_env_scatter_reference(pieces, sh, w0, w1, row_ptr, dim_to_irr, U, S,
                                 wexp_dtype=None):
    _, lat = _edge_mlp(pieces, w0, w1)
    wexp = round_to(lat[:, S:], wexp_dtype)
    env = center_sum_reference(_weighted_sh(sh.to(lat.dtype), wexp, dim_to_irr, U), row_ptr)
    return lat[:, :S].contiguous(), env


def latent_env_bwd_reference(pieces, sh, w0, w1, t, g_lat, centers, dim_to_irr, U, S,
                             wexp_dtype=None):
    pre, lat = _edge_mlp(pieces, w0, w1)
    # dsh reads the rounded env weights the forward weighted sh with; dwexp
    # does not read them (the rounding's derivative is taken as 1, as in JAX)
    dsh, dwexp = unweight_both_reference(t, sh.to(lat.dtype), round_to(lat[:, S:], wexp_dtype),
                                         centers, dim_to_irr)
    return dsh, _edge_mlp_bwd(pieces, pre, torch.cat([g_lat, dwexp], dim=1), w0, w1)


def gather_tp_embed_reference(sh, w2b, env, w, centers, entry_idx, entry_coef, row_specs, d3,
                              split=False, out_dtype=None):
    # computed in the promotion of all four (float32 for a bfloat16 model),
    # out stored in out_dtype (default sh's), ts in sh's dtype
    cdt = compute_dtype(sh, w2b, env, w)
    x0 = _embed_x0(sh.to(cdt), w2b.to(cdt), row_specs, w.shape[1])
    out = _gather_tp(x0, env.to(cdt), w.to(cdt), centers, entry_idx, entry_coef, d3)
    stored = out.to(out_dtype or sh.dtype)
    return (stored, out[:, :w.shape[1]].to(sh.dtype, copy=True)) if split else stored


def bwd_embed_reference(sh, w2b, g, env, w, centers, n_atoms, entry_idx, entry_coef, row_specs,
                        gts=None):
    E, U = sh.shape[0], w.shape[1]
    cdt = compute_dtype(sh, w2b, env, w)
    sh, w2b = sh.to(cdt), w2b.to(cdt)
    x0 = _embed_x0(sh, w2b, row_specs, U)
    dx, denv = _bwd_fused(x0, g.to(cdt), env.to(cdt), w.to(cdt), centers, n_atoms, entry_idx,
                          entry_coef, None if gts is None else gts.to(cdt), False)
    specs = row_specs.long()
    dx = dx.view(E, -1, U)  # [E, d1, U]
    w = w2b.reshape(E, -1, U)
    dsh = torch.zeros_like(sh).index_add(
        1, specs[:, 0], (dx * w.index_select(1, specs[:, 1])).sum(-1))
    dw2b = torch.zeros_like(w).index_add(
        1, specs[:, 1], dx * sh.index_select(1, specs[:, 0])[:, :, None])
    return dsh, dw2b.reshape(E, -1), denv


def tp_scatter_reference(x, g, w, centers, n_atoms, entry_idx, entry_coef, d2):
    # computed and stored in the compute dtype of x and g (float32 for the
    # bf16 track, also in a float64 model: JAX's), w read in it
    cdt = compute_dtype(x, g)
    x, g, w = x.to(cdt), g.to(cdt), w.to(cdt)
    E, U = x.shape[0], w.shape[1]
    d1, d3 = x.shape[1] // U, g.shape[1] // U
    ww = _path_tensor(w, entry_idx, entry_coef, d1, d2, d3)
    xv, gv = x.view(E, d1, U), g.view(E, d3, U)
    denv_e = x.new_zeros((E, d2, U))
    for i in range(d1):
        denv_e = denv_e + xv[:, i : i + 1, :] * torch.einsum("eku,ujk->eju", gv, ww[:, i])
    return segment_sum(denv_e.reshape(E, d2 * U), centers, n_atoms)


def gather_dw_reference(x, env, g, centers, entry_idx, entry_coef, n_paths, U):
    # computed in the promotion of all three, stored in the compute dtype of
    # x and g (JAX's)
    out_dtype = compute_dtype(x, g)
    cdt = compute_dtype(x, env, g)
    x, env, g = x.to(cdt), env.to(cdt), g.to(cdt)
    E = x.shape[0]
    d1, d2, d3 = x.shape[1] // U, env.shape[1] // U, g.shape[1] // U
    C = _cg_tensor(x, entry_idx, entry_coef, n_paths, d1, d2, d3)
    env_e = gather_rows(env, centers).view(E, d2, U)
    xv, gv = x.view(E, d1, U), g.view(E, d3, U)
    dw = x.new_zeros((n_paths, U))
    for i in range(d1):
        t = torch.einsum("eju,eku->jku", xv[:, i : i + 1, :] * env_e, gv)  # [d2, d3, U]
        dw = dw + torch.einsum("pjk,jku->pu", C[:, i], t)
    return dw.to(out_dtype)


def unweight_sh_reference(t, wexp, centers, dim_to_irr):
    # computed in the promotion of t and wexp, stored in t's compute dtype
    cdt = compute_dtype(t, wexp)
    E, d2 = wexp.shape[0], dim_to_irr.shape[0]
    U = t.shape[1] // d2
    t_e = gather_rows(t.to(cdt), centers).view(E, d2, U)
    w = wexp.to(cdt).view(E, -1, U).index_select(1, dim_to_irr.long())
    return (t_e * w).sum(-1).to(compute_dtype(t))


def unweight_w_reference(t, sh, centers, dim_to_irr, n_irr, out_dtype=None):
    # computed in the promotion of t and sh, stored in out_dtype (the env
    # weights' storage: JAX's out_dtype) or that promotion
    cdt = compute_dtype(t, sh)
    E, d2 = sh.shape
    U = t.shape[1] // d2
    t_e = gather_rows(t.to(cdt), centers).view(E, d2, U)
    dwexp = t_e.new_zeros((E, n_irr, U)).index_add(1, dim_to_irr.long(),
                                                   t_e * sh.to(cdt)[:, :, None])
    return dwexp.reshape(E, n_irr * U).to(out_dtype or cdt)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*tensors) -> bool:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"all arguments must be on one device, got {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: the kernels run on CUDA or CPU")
    return False


def _check_kernel_args(floats, ints, track=None) -> bool:
    """Checks the arguments of a CUDA kernel: ``floats`` float32, ``ints``
    int32, ``track`` (the tensor track's arrays of a kernel with a bf16
    form) all float32 or all bfloat16, each contiguous. Returns whether the
    track is bfloat16."""
    track = track or {}
    dtypes = {t.dtype for t in track.values()}
    if dtypes - {torch.float32, torch.bfloat16} or len(dtypes) > 1:
        raise TypeError("the CUDA kernels take the tensor track as float32 or bfloat16, one "
                        f"type for all of {sorted(track)}, got {sorted(map(str, dtypes))}")
    for name, t in {**floats, **track}.items():
        if name in floats and t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: index arrays must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dtypes == {torch.bfloat16}


# The bits of a kernel's dtype flags (its ``int bf16`` argument): bit 0 the
# form it had before (the tensor track's bf16), and the per-edge operands a
# bfloat16 model (``model_dtype="bfloat16"``) stores in bfloat16: sh, the
# embed's channel weights w2b, and the split scalars ts (or their cotangent
# gts). The mega kernels' flags carry the pieces from bit BF_PIECES on.
BF_SH, BF_W2B, BF_TS = 2, 4, 8
BF_PIECES = 8


def _bf16_operands(**arrays) -> int:
    """The flag bits (``BF_*``, passed as ``name=(bit, tensor)``) of the
    operands given in bfloat16; each must be float32 or bfloat16 and
    contiguous (None: absent)."""
    flags = 0
    for name, (bit, t) in arrays.items():
        if t is None:
            continue
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: the CUDA kernels take float32 or bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype == torch.bfloat16:
            flags |= bit
    return flags


def _ptr(t: Optional[torch.Tensor]):
    """A device pointer for ctypes; None (a null pointer) for an absent array."""
    return None if t is None else t.data_ptr()


def _launch(name: str, fn: str, device: torch.device, *args, bf16: bool = False) -> None:
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    _build.check(lib, rc, name)
    LAUNCHES[name] += 1
    if bf16:
        BF16_LAUNCHES[name] += 1


def _device_irr_ranges(what, irr_ranges, dim_to_irr, n_irr, device):
    """The per-irrep (start, len) table the mega kernels read: ``irr_ranges``
    as given, or built from ``dim_to_irr`` on the host; raises unless it has
    ``n_irr`` rows."""
    if irr_ranges is None:
        irr_ranges = irrep_ranges(dim_to_irr).to(device)
    if irr_ranges.shape != (n_irr, 2):
        raise ValueError(f"{what}: irr_ranges {tuple(irr_ranges.shape)} for {n_irr} irreps")
    return irr_ranges


def _device_paths(paths, entry_idx, entry_coef, device):
    """The entry table by path that the embed kernels walk: ``paths`` as
    given, or built from the entries on the host."""
    return path_table(entry_idx, entry_coef).to(device) if paths is None else paths


def _kernel_paths(name, paths: Optional[CgPaths], n_entries: int) -> CgPaths:
    """The path table a kernel walks; raises where there is none (it is
    built once per layer, never per call) or it is not in the kernels'
    types."""
    if paths is None:
        raise ValueError(f"{name} on the card walks the table's path table: pass paths "
                         "(built once per layer by nn/contract.py:Contracter)")
    if paths.entry_idx.shape[0] != n_entries:
        raise ValueError(f"{name}: the path table has {paths.entry_idx.shape[0]} entries, "
                         f"the entry table {n_entries}")
    _check_kernel_args({"scale": paths.scale, "paths.entry_coef": paths.entry_coef},
                       {"desc": paths.desc, "paths.entry_idx": paths.entry_idx})
    return paths


def _check_entries(entry_idx, entry_coef):
    if entry_idx.ndim != 2 or entry_idx.shape[1] != 4 or entry_coef.shape != entry_idx.shape[:1]:
        raise ValueError(
            f"entry table must be idx [n, 4] (i, j, k, p) and coef [n], got "
            f"{tuple(entry_idx.shape)} and {tuple(entry_coef.shape)}"
        )


def env_scatter(sh, wexp, centers, row_ptr, dim_to_irr, U: int) -> torch.Tensor:
    """env [n_atoms, d2*U]: ``env[a, jU+u] = Σ_{c(e)=a} sh[e,j] wexp[e, irr(j)U+u]``.

    sh [E, d2], wexp [E, n_irr*U], centers [E], row_ptr [n_atoms+1] (CSR over
    the center-sorted edges), dim_to_irr [d2]. wexp may be the bf16 track
    (the env weights, or a cotangent in their role), and sh that of a
    bfloat16 model: env is in the compute dtype (float32).

    Replaces ``_env_scatter_kernel``. Bound by the one read of wexp; a block
    per group of consecutive atoms stages their edges' wexp and sh rows (one
    contiguous range) in shared memory, and a thread per (atom, dim, 4
    channels) sums its atom's rows in edge order (no atomics)."""
    E, d2 = sh.shape
    n_atoms = row_ptr.shape[0] - 1
    n_irr = wexp.shape[1] // U
    if wexp.shape != (E, n_irr * U) or centers.shape != (E,) or dim_to_irr.shape != (d2,):
        raise ValueError(
            f"env_scatter shapes: sh {tuple(sh.shape)}, wexp {tuple(wexp.shape)}, "
            f"centers {tuple(centers.shape)}, dim_to_irr {tuple(dim_to_irr.shape)}, U={U}"
        )
    if _on_cpu(sh, wexp, centers, row_ptr, dim_to_irr):
        return env_scatter_reference(sh, wexp, centers, n_atoms, dim_to_irr, U)
    flags = _check_kernel_args({}, {"row_ptr": row_ptr, "dim_to_irr": dim_to_irr},
                               {"wexp": wexp}) | _bf16_operands(sh=(BF_SH, sh))
    if flags == BF_SH:
        raise TypeError("env_scatter: a bfloat16 sh takes bfloat16 env weights (a bfloat16 "
                        "model's), got float32")
    env = torch.empty((n_atoms, d2 * U), dtype=compute_dtype(sh, wexp), device=sh.device)
    if n_atoms == 0:
        return env
    _launch("env_scatter", "atpt_env_scatter", sh.device,
            sh.data_ptr(), wexp.data_ptr(), row_ptr.data_ptr(), dim_to_irr.data_ptr(),
            n_atoms, d2, n_irr, U, env.data_ptr(), flags, bf16=bool(flags))
    return env


def gather_tp(x, env, w, centers, entry_idx, entry_coef, d3: int, split: bool = False,
              paths: Optional[CgPaths] = None, ts_dtype: Optional[torch.dtype] = None):
    """out [E, d3*U]: ``out[e,kU+u] = Σ c w[p,u] x[e,iU+u] env[c(e),jU+u]``.

    x [E, d1*U], env [n_atoms, d2*U], w [P, U], entries (i, j, k, p) / c in
    either role order; on the card also ``paths``, that order's path table
    in walk order (``gen_cg_blocks.path_table(by_output=True)``); dims up to
    32. ``split``: also return the leading 0e block ``out[:, :U]`` as its
    own [E, U] array, ``(out, ts)``, ts stored in ``ts_dtype`` (JAX's
    ``scalar_dtype``, the model dtype; default env's). x may be the bf16
    track: out is then bfloat16 too.

    Replaces ``_gather_tp_raw_kernel``. Bound by the read of x and the write
    of out; one thread per (edge, channel), coalesced rows, the edge's env
    row gathered by center, each output slice summed in registers over the
    compiled CG blocks of its paths and stored once."""
    E, U = x.shape[0], w.shape[1]
    n_atoms = env.shape[0]
    _check_entries(entry_idx, entry_coef)
    if x.shape[1] % U or env.shape[1] % U or centers.shape != (E,):
        raise ValueError(
            f"gather_tp shapes: x {tuple(x.shape)}, env {tuple(env.shape)}, "
            f"w {tuple(w.shape)}, centers {tuple(centers.shape)}"
        )
    if _on_cpu(x, env, w, centers, entry_idx, entry_coef):
        return gather_tp_reference(x, env, w, centers, entry_idx, entry_coef, d3, split,
                                   ts_dtype)
    bf16 = _check_kernel_args({"env": env, "w": w}, {"centers": centers}, {"x": x})
    paths = _kernel_paths("gather_tp", paths, entry_idx.shape[0])
    out = torch.empty((E, d3 * U), dtype=x.dtype, device=x.device)
    ts = torch.empty((E, U), dtype=ts_dtype or env.dtype, device=x.device) if split else None
    flags = int(bf16) | _bf16_operands(ts=(BF_TS, ts))
    if E > 0:
        _launch("gather_tp", "atpt_gather_tp", x.device,
                x.data_ptr(), env.data_ptr(), w.data_ptr(), centers.data_ptr(),
                paths.desc.data_ptr(), paths.scale.data_ptr(), paths.desc.shape[0],
                paths.entry_idx.data_ptr(), paths.entry_coef.data_ptr(), E, n_atoms,
                x.shape[1] // U, env.shape[1] // U, d3, U, w.shape[0], out.data_ptr(), _ptr(ts),
                flags, bf16=bool(flags))
    return (out, ts) if split else out


_BWD_DW_MAX_BLOCKS = 1024  # blocks of bwd_fused's with_dw pass (partials [blocks, P, U])


def bwd_fused(x, g, env, w, centers, row_ptr, entry_idx, entry_coef, gts=None,
              with_dw: bool = False, paths: Optional[CgPaths] = None,
              scatter_paths: Optional[CgPaths] = None) -> Tuple[torch.Tensor, ...]:
    """Backward of ``gather_tp`` in x and env: dx [E, d1*U] and denv
    [n_atoms, d2*U]; with ``with_dw`` also its weight gradient dw [P, U],
    ``dw[p, u] = Σ_e Σ_{(i,j,k)∈p} c x[e,iU+u] env[c(e),jU+u] g[e,kU+u]``
    (the sentinel edges add nothing). ``gts`` [E, U]: the cotangent of the
    split scalar output, added to g's block 0. On the card without
    ``with_dw`` also the two path tables it walks (``Contracter``'s, built
    once per layer): ``paths``, that of the role-swapped entry table
    (``gather_paths()[1]``: dx), and ``scatter_paths``, that of the entry
    table with its roles permuted (0, 2, 1) (``scatter_paths()[0]``: denv).
    x and g may be the bf16 track (without dw): dx is then bfloat16 too,
    denv in env's dtype; gts may be bfloat16 (a bfloat16 model's).

    Replaces ``_bwd_fused_raw_kernel`` and, with ``with_dw``,
    ``_bwd_fused_kernel``. Bound by the reads of x and g and the write of
    dx. Without dw (``csrc/sparse_tp.cu``): a block per atom, whose env row
    is staged once, walks each edge's compiled CG paths twice, dx by
    ``gather_tp``'s walk and denv by ``tp_scatter``'s, the chunks' denv
    columns added in chunk order (no atomics). With dw (``csrc/fused_tp.cu``):
    the run-time entry loop, a block per atom segment, denv summed across
    warps in a fixed order, dw as per-lane path sums added across warps,
    then across blocks in block order (a second launch), with no float
    atomics."""
    E, U = x.shape[0], w.shape[1]
    n_atoms = row_ptr.shape[0] - 1
    n_paths = w.shape[0]
    _check_entries(entry_idx, entry_coef)
    if (g.shape[0] != E or g.shape[1] % U or env.shape[0] != n_atoms
            or centers.shape != (E,) or (gts is not None and gts.shape != (E, U))):
        raise ValueError(
            f"bwd_fused shapes: x {tuple(x.shape)}, g {tuple(g.shape)}, "
            f"env {tuple(env.shape)}, row_ptr {tuple(row_ptr.shape)}, "
            f"gts {None if gts is None else tuple(gts.shape)}"
        )
    opt = () if gts is None else (gts,)
    if _on_cpu(x, g, *opt, env, w, centers, row_ptr, entry_idx, entry_coef):
        return bwd_fused_reference(x, g, env, w, centers, n_atoms, entry_idx, entry_coef, gts,
                                   with_dw)
    bf16 = _check_kernel_args(
        {"env": env, "w": w, "entry_coef": entry_coef},
        {"row_ptr": row_ptr, "entry_idx": entry_idx}, {"x": x, "g": g},
    )
    flags = int(bf16) | _bf16_operands(gts=(BF_TS, gts))
    if flags and with_dw:
        raise TypeError("bwd_fused with dw takes float32 x and g, got bfloat16")
    dx = torch.empty_like(x)
    denv = torch.empty_like(env)
    n_blocks = max(1, min(_BWD_DW_MAX_BLOCKS, n_atoms + 1))
    partial = dw = None
    if with_dw:
        partial = torch.empty((n_blocks, n_paths, U), dtype=x.dtype, device=x.device)
        dw = torch.empty((n_paths, U), dtype=x.dtype, device=x.device)
        table = (entry_idx.data_ptr(), entry_coef.data_ptr(), entry_idx.shape[0])
        walks = (None, None, 0, None, None) * 2
    else:
        n = entry_idx.shape[0]
        table = (None, None, 0)
        walks = tuple(v for t in (_kernel_paths("bwd_fused", paths, n),
                                  _kernel_paths("bwd_fused", scatter_paths, n))
                      for v in (t.desc.data_ptr(), t.scale.data_ptr(), t.desc.shape[0],
                                t.entry_idx.data_ptr(), t.entry_coef.data_ptr()))
    if E > 0 or n_atoms > 0:
        _launch("bwd_fused", "atpt_bwd_fused", x.device,
                x.data_ptr(), g.data_ptr(), _ptr(gts), env.data_ptr(), w.data_ptr(),
                row_ptr.data_ptr(), *table, *walks, E, n_atoms,
                x.shape[1] // U, env.shape[1] // U, g.shape[1] // U, U, n_paths, n_blocks,
                dx.data_ptr(), denv.data_ptr(), _ptr(partial), _ptr(dw), flags, bf16=bool(flags))
    elif with_dw:
        dw.zero_()
    return (dx, denv, dw) if with_dw else (dx, denv)


def unweight_both(t, sh, wexp, centers, dim_to_irr, out_dtype: Optional[torch.dtype] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two transposes of ``env_scatter`` from t = denv [n_atoms, d2*U]:
    dsh [E, d2] and dwexp [E, n_irr*U]. wexp may be the bf16 track: dwexp
    is then stored in ``out_dtype``, default wexp's (JAX's non-mega path
    stores it in bfloat16; float32 is the unrounded cotangent of JAX's mega
    path, for a mega model routed here), dsh float32. sh may be bfloat16
    (a bfloat16 model's; dsh float32).

    Replaces ``_unweight_both_raw_kernel`` (and ``_unweight_both_kernel``).
    Bound by the read of wexp and the write of dwexp; the tiles of
    :func:`unweight_sh` and :func:`unweight_w` in one pass: a block per tile
    of 32 consecutive edges stages the tile's wexp and sh rows and up to 4 of
    its centers' t rows once, then computes each (edge, dim) dot of dsh and
    each (edge, irrep, 4 channels) sum of dwexp over the irrep's contiguous
    dims (:func:`irrep_ranges`) from them, each output written as one range.
    Where the rows outgrow the card's shared memory the launcher stages fewer
    t rows, then takes smaller tiles, as theirs do."""
    E, d2 = sh.shape
    U = t.shape[1] // d2
    n_irr = wexp.shape[1] // U
    if (t.shape[1] != d2 * U or wexp.shape != (E, n_irr * U) or centers.shape != (E,)
            or dim_to_irr.shape != (d2,)):
        raise ValueError(
            f"unweight_both shapes: t {tuple(t.shape)}, sh {tuple(sh.shape)}, "
            f"wexp {tuple(wexp.shape)}, centers {tuple(centers.shape)}"
        )
    if _on_cpu(t, sh, wexp, centers, dim_to_irr):
        return unweight_both_reference(t, sh, wexp, centers, dim_to_irr, out_dtype)
    bf16 = _check_kernel_args({"t": t}, {"centers": centers, "dim_to_irr": dim_to_irr},
                              {"wexp": wexp})
    flags = int(bf16) | _bf16_operands(sh=(BF_SH, sh))
    dsh = torch.empty(sh.shape, dtype=compute_dtype(t), device=sh.device)
    dwexp = torch.empty_like(wexp, dtype=out_dtype or wexp.dtype)
    bf16_out = _check_kernel_args({}, {}, {"dwexp": dwexp})
    if bf16_out and not bf16:
        raise TypeError("unweight_both: a bfloat16 dwexp needs bfloat16 env weights")
    if flags & BF_SH and not bf16_out:
        raise TypeError("unweight_both: a bfloat16 sh takes bfloat16 env weights and dwexp "
                        "(a bfloat16 model's)")
    if E == 0:
        return dsh, dwexp
    _launch("unweight_both", "atpt_unweight_both", t.device,
            t.data_ptr(), sh.data_ptr(), wexp.data_ptr(), centers.data_ptr(),
            dim_to_irr.data_ptr(), E, t.shape[0], d2, n_irr, U,
            dsh.data_ptr(), dwexp.data_ptr(), flags, int(bf16_out), bf16=bool(flags))
    return dsh, dwexp


def center_gather(a, idx) -> torch.Tensor:
    """out [E, C]: ``out[e] = a[idx[e]]``, zeros where ``idx[e] >= n_atoms``
    (sentinel edges). a [n_atoms, C], idx [E]. Exact (a copy).

    Replaces ``_center_broadcast_kernel``. Bound by the write of out. Narrow
    rows (C <= 4: positions, energies): a warp per 32 edges reads their
    indices once and stores the warp's outputs as C coalesced rows; wider
    rows: a group of lanes per edge reads its index once and copies the
    row, as float4 where C % 4 == 0. A bfloat16 a (a bfloat16 model's
    positions or env) is copied to a bfloat16 out by its own form, a thread
    per element."""
    if a.ndim != 2 or idx.ndim != 1:
        raise ValueError(f"center_gather shapes: a {tuple(a.shape)}, idx {tuple(idx.shape)}")
    if _on_cpu(a, idx):
        return center_gather_reference(a, idx)
    bf16 = _check_kernel_args({}, {"idx": idx}, {"a": a})
    E, (n_atoms, C) = idx.shape[0], a.shape
    out = torch.empty((E, C), dtype=a.dtype, device=a.device)
    if E == 0 or C == 0:
        return out
    _launch("center_gather", "atpt_center_gather_bf16" if bf16 else "atpt_center_gather",
            a.device, a.data_ptr(), idx.data_ptr(), E, n_atoms, C, out.data_ptr(), bf16=bf16)
    return out


CENTER_SUM_CHUNK = 256  # CSR positions per block of center_sum's chunked first pass


def center_sum(v, row_ptr, perm=None, chunked: bool = False) -> torch.Tensor:
    """s [n_atoms, C]: ``s[a] = Σ_{k ∈ [row_ptr[a], row_ptr[a+1])} v[perm[k]]``
    (``perm`` None = identity, the center side). v [E, C], row_ptr
    [n_atoms+1], perm [E]; CSR positions after ``row_ptr[n_atoms]`` (sentinel
    edges) are dropped. ``chunked``: for a few long segments (a parameter
    table's class CSR).

    Replaces ``_center_sum_kernel``. Bound by the read of v; every sum in a
    fixed order (no atomics). Narrow rows (C <= 4): 16 lanes per atom add
    every 16th row of its segment, then meet in a fixed shuffle tree; wider
    rows: a thread per (atom, 4 columns) adds its segment in edge order, as
    float4. Chunked, two launches and no buffer to clear: a block per chunk
    of ``CENTER_SUM_CHUNK`` positions and slice of columns writes one
    partial per segment piece of the chunk, then a block per row and slice
    adds the row's partials, each in a fixed tree. A bfloat16 v (a bfloat16
    model's) has its own form, chunked or not: a thread per (atom, column)
    adds its segment in edge order in float32 and stores the sum once, in
    bfloat16."""
    n_atoms = row_ptr.shape[0] - 1
    if v.ndim != 2 or row_ptr.ndim != 1 or (perm is not None and perm.shape != v.shape[:1]):
        raise ValueError(
            f"center_sum shapes: v {tuple(v.shape)}, row_ptr {tuple(row_ptr.shape)}, "
            f"perm {None if perm is None else tuple(perm.shape)}"
        )
    ints = {"row_ptr": row_ptr} if perm is None else {"row_ptr": row_ptr, "perm": perm}
    if _on_cpu(v, *ints.values()):
        return center_sum_reference(v, row_ptr, perm)
    bf16 = _check_kernel_args({}, ints, {"v": v})
    C = v.shape[1]
    out = torch.empty((n_atoms, C), dtype=v.dtype, device=v.device)
    if n_atoms == 0 or C == 0:
        return out
    if bf16:
        _launch("center_sum", "atpt_center_sum_bf16", v.device,
                v.data_ptr(), row_ptr.data_ptr(), _ptr(perm), n_atoms, C, out.data_ptr(),
                bf16=True)
        return out
    if chunked:
        # row r's pieces take the entries [first chunk + r, last chunk + r]
        n_chunks = -(-v.shape[0] // CENTER_SUM_CHUNK)
        partial = torch.empty((n_chunks + n_atoms, C), dtype=v.dtype, device=v.device)
        _launch("center_sum", "atpt_center_sum_chunked", v.device,
                v.data_ptr(), row_ptr.data_ptr(), _ptr(perm), n_atoms, C, v.shape[0],
                CENTER_SUM_CHUNK, partial.data_ptr(), out.data_ptr())
        return out
    _launch("center_sum", "atpt_center_sum", v.device,
            v.data_ptr(), row_ptr.data_ptr(), _ptr(perm), n_atoms, C, out.data_ptr())
    return out


_MAX_PIECES = 16  # kMaxPieces of csrc/center_readout.cu


def _check_mlp(what, pieces, w0, w1, E, n_out=None) -> int:
    """Checks the shapes of a per-edge MLP ``Σ_i p_i @ W0_i [→ silu → W1]``
    (pieces [E, S_i], w0 [ΣS_i, H], w1 [H, N] or None); returns its output
    width (``n_out`` if given: the only width allowed)."""
    K = sum(p.shape[1] for p in pieces)
    H = w0.shape[1] if w0.ndim == 2 else -1
    N = H if w1 is None else (w1.shape[1] if w1.ndim == 2 else -1)
    if (not pieces or any(p.ndim != 2 or p.shape[0] != E for p in pieces) or w0.shape != (K, H)
            or (w1 is not None and w1.shape[0] != H) or (n_out is not None and N != n_out)):
        raise ValueError(
            f"{what} shapes: pieces {[tuple(p.shape) for p in pieces]}, w0 {tuple(w0.shape)}, "
            f"w1 {None if w1 is None else tuple(w1.shape)}"
        )
    if len(pieces) > _MAX_PIECES:
        raise ValueError(f"the {what} kernels take at most {_MAX_PIECES} pieces")
    return N


def _check_pieces_dtype(pieces) -> int:
    """The mask of the pieces in bfloat16 (bit i: piece i), a bfloat16
    model's; each piece float32 or bfloat16."""
    mask = 0
    for i, p in enumerate(pieces):
        if p.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"piece {i}: the CUDA kernels take float32 or bfloat16, "
                            f"got {p.dtype}")
        if p.dtype == torch.bfloat16:
            mask |= 1 << i
    return mask


def _check_readout(pieces, w0, w1, E) -> int:
    """Checks the readout's shapes; returns the hidden width (1 without a
    hidden layer)."""
    _check_mlp("readout", pieces, w0, w1, E, n_out=1)
    return w0.shape[1]


def _piece_table(pieces):
    """Host arrays of the pieces' row pointers and row strides (elements);
    each piece must have unit column stride."""
    for i, p in enumerate(pieces):
        if p.shape[1] > 1 and p.stride(1) != 1:
            raise ValueError(f"piece {i} must have unit column stride")
    n = len(pieces)
    return ((ctypes.c_void_p * n)(*(p.data_ptr() for p in pieces)),
            (ctypes.c_longlong * n)(*(p.stride(0) for p in pieces)))


def readout_sum(pieces: Sequence[torch.Tensor], w0, w1: Optional[torch.Tensor],
                row_ptr) -> torch.Tensor:
    """Per-atom readout energy [n_atoms, 1]: ``Σ_{c(e)=a} silu(Σ_i p_i[e] @
    W0_i) @ w1``, or ``Σ_i p_i[e] @ W0_i`` without a hidden layer
    (``w1=None``, w0 [K, 1]). pieces [E, S_i] (column slices are fine: only
    their rows are read), w0 [ΣS_i, H], w1 [H, 1], row_ptr [n_atoms+1] (the
    center CSR; sentinel edges after ``row_ptr[n_atoms]`` add nothing). The
    edgewise factor is expected folded into the last weight. A bfloat16
    model's pieces may be bfloat16 (each widened as it is staged; its
    weights come widened, ``fused_primitives._wide``): the energy is
    float32, the compute dtype.

    Replaces ``_readout_sum_kernel``. Bound by the read of the pieces and
    K·H FMAs per edge; a register-tiled product on tiles of 128 consecutive
    edges (64 or 32 where W0 is too wide for shared memory), their pieces
    streamed in 32-column stages, on a persistent grid whose blocks own
    edge-balanced ranges of whole atoms: the per-edge energies stay in shared
    memory, and each atom's are added in edge order by one thread of one
    block."""
    pieces = tuple(pieces)
    n_atoms = row_ptr.shape[0] - 1
    H = _check_readout(pieces, w0, w1, pieces[0].shape[0] if pieces else 0)
    rest = () if w1 is None else (w1,)
    if _on_cpu(*pieces, w0, *rest, row_ptr):
        return readout_sum_reference(pieces, w0, w1, row_ptr)
    _check_kernel_args({"w0": w0, **{"w1": w for w in rest}}, {"row_ptr": row_ptr})
    mask = _check_pieces_dtype(pieces)
    energy = torch.empty((n_atoms, 1), dtype=w0.dtype, device=w0.device)
    if n_atoms == 0:
        return energy
    ptrs, strides = _piece_table(pieces)
    dims = (ctypes.c_int * len(pieces))(*(p.shape[1] for p in pieces))
    _launch("readout_sum", "atpt_readout_sum_mixed", w0.device,
            ptrs, strides, dims, len(pieces), w0.data_ptr(),
            None if w1 is None else w1.data_ptr(), row_ptr.data_ptr(), n_atoms, H,
            energy.data_ptr(), mask, bf16=bool(mask))
    return energy


def readout_bwd(pieces: Sequence[torch.Tensor], w0, w1: Optional[torch.Tensor], y,
                centers) -> Tuple[torch.Tensor, ...]:
    """Backward of ``readout_sum`` in the pieces, from the per-atom energy
    cotangent y [n_atoms, 1]: ``dp_i[e] = (y[c(e)] w1ᵀ ⊙ silu'(pre_e)) @
    W0_iᵀ`` (``y[c(e)] W0_iᵀ`` without a hidden layer); zero rows on sentinel
    edges. Returns contiguous dpieces [E, S_i] in the compute dtype (JAX's:
    float32 for a bfloat16 piece, whose cotangent autograd then rounds).

    Replaces ``_readout_bwd_kernel``. Bound by the read of the pieces and the
    write of their cotangents, with 2·K·H FMAs per edge close behind; a
    register-tiled GEMM chain on tiles of 64 consecutive edges (32 or 16
    where W0 is too wide for shared memory), a persistent grid: the tile's
    piece rows staged (the next tile's during this one's second product),
    ``pre = p W0`` split over the warps by ranges of K and summed in warp
    order, ``dh = y[c(e)] w1 ⊙ silu'(pre)``, then ``dp = dh W0ᵀ`` from
    registers, stored once per element straight to the dpieces."""
    pieces = tuple(pieces)
    E = centers.shape[0]
    H = _check_readout(pieces, w0, w1, E)
    if y.ndim != 2 or y.shape[1] != 1:
        raise ValueError(f"readout_bwd: y must be [n_atoms, 1], got {tuple(y.shape)}")
    rest = () if w1 is None else (w1,)
    if _on_cpu(*pieces, w0, *rest, y, centers):
        return readout_bwd_reference(pieces, w0, w1, y, centers)
    _check_kernel_args({"w0": w0, "y": y, **{"w1": w for w in rest}}, {"centers": centers})
    mask = _check_pieces_dtype(pieces)
    dpieces = tuple(torch.empty(p.shape, dtype=compute_dtype(p), device=p.device)
                    for p in pieces)
    if E == 0:
        return dpieces
    ptrs, strides = _piece_table(pieces)
    dptrs, dstrides = _piece_table(dpieces)
    dims = (ctypes.c_int * len(pieces))(*(p.shape[1] for p in pieces))
    _launch("readout_bwd", "atpt_readout_bwd_mixed", w0.device,
            ptrs, strides, dptrs, dstrides, dims, len(pieces), w0.data_ptr(),
            None if w1 is None else w1.data_ptr(), y.data_ptr(), centers.data_ptr(), E,
            y.shape[0], H, mask, bf16=bool(mask))
    return dpieces


def _round_flag(what: str, wexp_dtype: Optional[torch.dtype], like: torch.Tensor) -> int:
    """1 where the CUDA form rounds the env weights to bfloat16, 0 where it
    keeps them; raises for a rounding no form takes."""
    if wexp_dtype is None or wexp_dtype == like.dtype:
        return 0
    if wexp_dtype != torch.bfloat16:
        raise TypeError(f"{what}: the CUDA kernels round the env weights to bfloat16 only, "
                        f"got {wexp_dtype}")
    return 1


def latent_env_scatter(pieces: Sequence[torch.Tensor], sh, w0, w1: Optional[torch.Tensor],
                       centers, row_ptr, dim_to_irr, U: int, S: int,
                       irr_ranges: Optional[torch.Tensor] = None,
                       wexp_dtype: Optional[torch.dtype] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A layer's latent MLP fused with the next layer's environment sum:
    ``lat = silu(Σ_i p_i @ W0_i) @ W1`` (or ``Σ_i p_i @ W0_i`` without a
    hidden layer, ``w1=None``) per edge; returns its scalar columns
    ``lat_s = lat[:, :S]`` [E, S] and ``env [n_atoms, d2*U]``, ``env[a, jU+u]
    = Σ_{c(e)=a} sh[e,j] lat[e, S+irr(j)U+u]``. pieces [E, S_i] (column
    slices are fine), sh [E, d2], w0 [ΣS_i, H], w1 [H, S+n_irr*U], centers
    [E] and row_ptr [n_atoms+1] (the center CSR; sentinel edges get lat_s and
    add no env), dim_to_irr [d2]. The scatter factor is expected folded into
    the env columns of the last weight. ``irr_ranges`` is
    :func:`irrep_ranges` of ``dim_to_irr`` on the device (built on the host
    where not given). ``wexp_dtype`` (the bf16 track's bfloat16): the env
    weights ``lat[:, S:]`` are rounded to it and back before they weight
    sh, as JAX's kernel does; lat_s is not rounded. A bfloat16 model's
    pieces and sh may be bfloat16 (widened as they are staged; its weights
    come widened, ``fused_primitives._wide``): lat_s and env are float32,
    the compute dtype, as JAX's.

    Replaces ``_latent_env_scatter_kernel``. Bound by exact-FP32 FMAs; tiles
    of 64 edges through two register-tiled products, weights in shared
    memory, the hidden activation and the env weights never in device
    memory."""
    pieces = tuple(pieces)
    E, d2 = sh.shape
    n_atoms = row_ptr.shape[0] - 1
    N = _check_mlp("latent_env_scatter", pieces, w0, w1, E)
    if N <= S or (N - S) % U or dim_to_irr.shape != (d2,) or centers.shape != (E,):
        raise ValueError(f"latent_env_scatter shapes: MLP output {N}, S={S}, U={U}, "
                         f"sh {tuple(sh.shape)}, dim_to_irr {tuple(dim_to_irr.shape)}, "
                         f"centers {tuple(centers.shape)}")
    rest = () if w1 is None else (w1,)
    if _on_cpu(*pieces, sh, w0, *rest, centers, row_ptr, dim_to_irr):
        return latent_env_scatter_reference(pieces, sh, w0, w1, row_ptr, dim_to_irr, U, S,
                                            wexp_dtype)
    round_wexp = _round_flag("latent_env_scatter", wexp_dtype, sh)
    irr_ranges = _device_irr_ranges("latent_env_scatter", irr_ranges, dim_to_irr, (N - S) // U,
                                    sh.device)
    _check_kernel_args({"w0": w0, **{"w1": w for w in rest}},
                       {"centers": centers, "row_ptr": row_ptr, "irr_ranges": irr_ranges})
    flags = (round_wexp | _bf16_operands(sh=(BF_SH, sh))
             | _check_pieces_dtype(pieces) << BF_PIECES)
    cdt = compute_dtype(sh, *pieces)
    lat_s = torch.empty((E, S), dtype=cdt, device=sh.device)
    env = torch.empty((n_atoms, d2 * U), dtype=cdt, device=sh.device)
    if E == 0 and n_atoms == 0:
        return lat_s, env
    ptrs, strides = _piece_table(pieces)
    dims = (ctypes.c_int * len(pieces))(*(p.shape[1] for p in pieces))
    _launch("latent_env_scatter", "atpt_latent_env_scatter", sh.device,
            ptrs, strides, dims, len(pieces), w0.data_ptr(), _ptr(w1), sh.data_ptr(),
            centers.data_ptr(), row_ptr.data_ptr(), irr_ranges.data_ptr(), E, n_atoms, d2, U, S,
            0 if w1 is None else w0.shape[1], N, lat_s.data_ptr(), env.data_ptr(), flags,
            bf16=bool(flags))
    return lat_s, env


def latent_env_bwd(pieces: Sequence[torch.Tensor], sh, w0, w1: Optional[torch.Tensor], t, g_lat,
                   centers, dim_to_irr, U: int, S: int,
                   irr_ranges: Optional[torch.Tensor] = None,
                   wexp_dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, ...]:
    """Backward of ``latent_env_scatter`` in sh and the pieces, from the env
    cotangent t [n_atoms, d2*U] and the lat_s cotangent g_lat [E, S]:
    ``(dsh [E, d2], dpieces)``, dpieces contiguous [E, S_i]. The MLP is
    recomputed; a sentinel edge reads t = 0. ``irr_ranges`` is
    :func:`irrep_ranges` of ``dim_to_irr`` on the device (built on the host
    where not given). ``wexp_dtype``: as in ``latent_env_scatter``; dsh
    reads the rounded env weights, the env weights' cotangent does not
    depend on them. dsh and dpieces are in the compute dtype (float32 for a
    bfloat16 model's sh and pieces, as JAX's).

    Replaces ``_latent_env_bwd_kernel``. Bound by exact-FP32 FMAs; tiles of
    64 edges through four register-tiled products, weights in shared
    memory."""
    pieces = tuple(pieces)
    E, d2 = sh.shape
    N = _check_mlp("latent_env_bwd", pieces, w0, w1, E)
    if (N <= S or (N - S) % U or t.ndim != 2 or t.shape[1] != d2 * U or g_lat.shape != (E, S)
            or centers.shape != (E,) or dim_to_irr.shape != (d2,)):
        raise ValueError(f"latent_env_bwd shapes: MLP output {N}, S={S}, U={U}, "
                         f"sh {tuple(sh.shape)}, t {tuple(t.shape)}, g_lat {tuple(g_lat.shape)}")
    rest = () if w1 is None else (w1,)
    if _on_cpu(*pieces, sh, w0, *rest, t, g_lat, centers, dim_to_irr):
        return latent_env_bwd_reference(pieces, sh, w0, w1, t, g_lat, centers, dim_to_irr, U, S,
                                        wexp_dtype)
    round_wexp = _round_flag("latent_env_bwd", wexp_dtype, sh)
    irr_ranges = _device_irr_ranges("latent_env_bwd", irr_ranges, dim_to_irr, (N - S) // U,
                                    sh.device)
    _check_kernel_args({"w0": w0, "t": t, "g_lat": g_lat, **{"w1": w for w in rest}},
                       {"centers": centers, "dim_to_irr": dim_to_irr, "irr_ranges": irr_ranges})
    flags = (round_wexp | _bf16_operands(sh=(BF_SH, sh))
             | _check_pieces_dtype(pieces) << BF_PIECES)
    dsh = torch.empty(sh.shape, dtype=compute_dtype(sh), device=sh.device)
    dpieces = tuple(torch.empty(p.shape, dtype=compute_dtype(p), device=p.device)
                    for p in pieces)
    if E == 0:
        return dsh, dpieces
    ptrs, strides = _piece_table(pieces)
    dptrs, dstrides = _piece_table(dpieces)
    dims = (ctypes.c_int * len(pieces))(*(p.shape[1] for p in pieces))
    _launch("latent_env_bwd", "atpt_latent_env_bwd", sh.device,
            ptrs, strides, dptrs, dstrides, dims, len(pieces), w0.data_ptr(), _ptr(w1),
            sh.data_ptr(), t.data_ptr(), g_lat.data_ptr(), centers.data_ptr(),
            irr_ranges.data_ptr(), E, t.shape[0], d2, U, S, 0 if w1 is None else w0.shape[1], N,
            dsh.data_ptr(), flags, bf16=bool(flags))
    return dsh, dpieces


def _check_embed(what, sh, w2b, env, w, centers, entry_idx, entry_coef, row_specs) -> int:
    """Checks the shapes of layer 0's embed-fused TP; returns n_irr."""
    _check_entries(entry_idx, entry_coef)
    E, U = sh.shape[0], w.shape[1]
    if (w2b.ndim != 2 or w2b.shape[0] != E or w2b.shape[1] % U or env.shape[1] % U
            or centers.shape != (E,) or row_specs.ndim != 2 or row_specs.shape[1] != 2):
        raise ValueError(
            f"{what} shapes: sh {tuple(sh.shape)}, w2b {tuple(w2b.shape)}, env {tuple(env.shape)}, "
            f"w {tuple(w.shape)}, centers {tuple(centers.shape)}, "
            f"row_specs {tuple(row_specs.shape)}"
        )
    return w2b.shape[1] // U


def gather_tp_embed(sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs,
                    d3: int, split: bool = False, paths=None,
                    out_dtype: Optional[torch.dtype] = None):
    """``gather_tp`` on layer 0's features ``x0[e, iU+u] = sh[e, js_i]
    w2b[e, irs_i U+u]``, built on the fly: out [E, d3*U] (and ts [E, U]
    with ``split``). sh [E, d_sh], w2b [E, n_irr*U] (the tensor embed's
    channel weights), row_ptr [n_atoms+1] (the center CSR; sentinel edges
    get zero rows), row_specs [d1, 2] int32 = (js_i, irs_i). ``paths``
    (``gen_cg_blocks.CgPaths`` on the device) is the entry table by path,
    which the kernel walks; where it is not given it is built from the
    entries on the host. ``out_dtype``: out's storage (the bf16 track's
    bfloat16; default sh's dtype), rounded once from the sum; ts stays in
    sh's dtype. A bfloat16 model's sh and w2b are bfloat16 (widened as
    they are staged), and so are out and ts.

    Replaces ``_gather_tp_embed_raw_kernel``. Bound by the write of out; a
    warp per atom segment walks the CG paths, each a block compiled into
    ``csrc/cg_blocks.h``, with the atom's env row staged once."""
    E, U = sh.shape[0], w.shape[1]
    n_atoms = row_ptr.shape[0] - 1
    n_irr = _check_embed("gather_tp_embed", sh, w2b, env, w, centers, entry_idx, entry_coef,
                         row_specs)
    if env.shape[0] != n_atoms:
        raise ValueError(f"gather_tp_embed shapes: env {tuple(env.shape)} for {n_atoms} atoms")
    if _on_cpu(sh, w2b, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs):
        return gather_tp_embed_reference(sh, w2b, env, w, centers, entry_idx, entry_coef,
                                         row_specs, d3, split, out_dtype)
    paths = _device_paths(paths, entry_idx, entry_coef, sh.device)
    _check_kernel_args({"env": env, "w": w, "scale": paths.scale, "path_coef": paths.entry_coef},
                       {"row_ptr": row_ptr, "desc": paths.desc, "path_idx": paths.entry_idx,
                        "row_specs": row_specs})
    out = torch.empty((E, d3 * U), dtype=out_dtype or sh.dtype, device=sh.device)
    ts = torch.empty((E, U), dtype=sh.dtype, device=sh.device) if split else None
    flags = _check_kernel_args({}, {}, {"out": out}) | _bf16_operands(
        sh=(BF_SH, sh), w2b=(BF_W2B, w2b), ts=(BF_TS, ts))
    if E > 0:
        _launch("gather_tp_embed", "atpt_gather_tp_embed", sh.device,
                sh.data_ptr(), w2b.data_ptr(), env.data_ptr(), w.data_ptr(), w.shape[0],
                row_ptr.data_ptr(), paths.desc.data_ptr(), paths.scale.data_ptr(),
                paths.desc.shape[0], paths.entry_idx.data_ptr(), paths.entry_coef.data_ptr(),
                row_specs.data_ptr(), E, n_atoms, sh.shape[1], n_irr, row_specs.shape[0],
                env.shape[1] // U, d3, U, out.data_ptr(), _ptr(ts), flags, bf16=bool(flags))
    return (out, ts) if split else out


def bwd_embed(sh, w2b, g, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs,
              gts=None, paths=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of ``gather_tp_embed`` in its factors and env, without dw:
    dsh [E, d_sh], dw2b [E, n_irr*U] and denv [n_atoms, d2*U]; ``gts``
    [E, U] is the cotangent of the split scalar output. Sentinel edges get
    zero rows. ``paths`` (``gen_cg_blocks.CgPaths`` on the device) is the
    entry table by path, which the kernel walks; where it is not given it is
    built from the entries on the host. g may be the bf16 track (the
    cotangent of a bfloat16 out); a bfloat16 model's sh, w2b, g and gts are
    bfloat16. The results are in the compute dtype (the model dtype, or
    float32 for a bfloat16 model, as JAX's).

    Replaces ``_bwd_embed_raw_kernel``. Bound by the read of g and the write
    of dw2b; a warp per atom segment walks the CG paths, each a block
    compiled into ``csrc/cg_blocks.h``, and dx0 is reduced onto the factors
    and never written."""
    E, U = sh.shape[0], w.shape[1]
    n_atoms = row_ptr.shape[0] - 1
    n_irr = _check_embed("bwd_embed", sh, w2b, env, w, centers, entry_idx, entry_coef,
                         row_specs)
    if (g.shape[0] != E or g.shape[1] % U or env.shape[0] != n_atoms
            or (gts is not None and gts.shape != (E, U))):
        raise ValueError(f"bwd_embed shapes: g {tuple(g.shape)}, env {tuple(env.shape)}, "
                         f"gts {None if gts is None else tuple(gts.shape)}")
    opt = () if gts is None else (gts,)
    if _on_cpu(sh, w2b, g, *opt, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs):
        return bwd_embed_reference(sh, w2b, g, env, w, centers, n_atoms, entry_idx, entry_coef,
                                   row_specs, gts)
    paths = _device_paths(paths, entry_idx, entry_coef, sh.device)
    bf16 = _check_kernel_args({"env": env, "w": w,
                               "scale": paths.scale, "path_coef": paths.entry_coef},
                              {"row_ptr": row_ptr, "desc": paths.desc,
                               "path_idx": paths.entry_idx, "row_specs": row_specs}, {"g": g})
    flags = int(bf16) | _bf16_operands(sh=(BF_SH, sh), w2b=(BF_W2B, w2b), gts=(BF_TS, gts))
    cdt = compute_dtype(sh, w2b, env)
    dsh = torch.empty(sh.shape, dtype=cdt, device=sh.device)
    dw2b = torch.empty(w2b.shape, dtype=cdt, device=sh.device)
    denv = torch.empty_like(env)
    if E == 0 and n_atoms == 0:
        return dsh, dw2b, denv
    _launch("bwd_embed", "atpt_bwd_embed", sh.device,
            sh.data_ptr(), w2b.data_ptr(), g.data_ptr(), _ptr(gts), env.data_ptr(), w.data_ptr(),
            w.shape[0], row_ptr.data_ptr(), paths.desc.data_ptr(), paths.scale.data_ptr(),
            paths.desc.shape[0], paths.entry_idx.data_ptr(), paths.entry_coef.data_ptr(),
            row_specs.data_ptr(), E, n_atoms, sh.shape[1], n_irr, row_specs.shape[0],
            env.shape[1] // U, g.shape[1] // U, U, dsh.data_ptr(), dw2b.data_ptr(),
            denv.data_ptr(), flags, bf16=bool(flags))
    return dsh, dw2b, denv


def tp_scatter(x, g, w, centers, row_ptr, entry_idx, entry_coef, d2: int,
               paths: Optional[CgPaths] = None) -> torch.Tensor:
    """denv [n_atoms, d2*U]: ``denv[a, jU+u] = Σ_{c(e)=a} Σ c w[p,u] x[e,iU+u]
    g[e,kU+u]``, the env-transpose of ``gather_tp``. x [E, d1*U], g [E, d3*U],
    w [P, U], row_ptr [n_atoms+1]; the entry table in either role order; on
    the card also ``paths``, the path table of that order with its roles
    permuted (0, 2, 1), so that its out is j (``Contracter.scatter_paths``).
    x and g may be the bf16 track (both): denv is float32 either way.

    Replaces ``_tp_scatter_kernel``. Bound by the reads of x and g; per atom
    segment, threads of (chunk, channel) walk the edges' compiled CG paths
    with each output slice summed in registers, the chunks' partials added
    in chunk order and the row stored once (no atomics)."""
    E, U = x.shape[0], w.shape[1]
    n_atoms = row_ptr.shape[0] - 1
    _check_entries(entry_idx, entry_coef)
    if x.shape[1] % U or g.shape[0] != E or g.shape[1] % U or centers.shape != (E,):
        raise ValueError(
            f"tp_scatter shapes: x {tuple(x.shape)}, g {tuple(g.shape)}, w {tuple(w.shape)}, "
            f"centers {tuple(centers.shape)}"
        )
    if _on_cpu(x, g, w, centers, row_ptr, entry_idx, entry_coef):
        return tp_scatter_reference(x, g, w, centers, n_atoms, entry_idx, entry_coef, d2)
    bf16 = _check_kernel_args({"w": w}, {"row_ptr": row_ptr}, {"x": x, "g": g})
    paths = _kernel_paths("tp_scatter", paths, entry_idx.shape[0])
    denv = torch.empty((n_atoms, d2 * U), dtype=w.dtype, device=x.device)
    if n_atoms == 0:
        return denv
    _launch("tp_scatter", "atpt_tp_scatter", x.device,
            x.data_ptr(), g.data_ptr(), w.data_ptr(), row_ptr.data_ptr(), paths.desc.data_ptr(),
            paths.scale.data_ptr(), paths.desc.shape[0], paths.entry_idx.data_ptr(),
            paths.entry_coef.data_ptr(), n_atoms, x.shape[1] // U, d2, g.shape[1] // U, U,
            w.shape[0], denv.data_ptr(), int(bf16), bf16=bf16)
    return denv


_DW_MAX_BLOCKS = 1024  # kGradwMaxBlocks of csrc/sparse_tp.cu (partials [blocks, P, U])


def gather_dw(x, env, g, centers, entry_idx, entry_coef, n_paths: int, U: int,
              paths: Optional[CgPaths] = None) -> torch.Tensor:
    """dw [n_paths, U]: ``dw[p, u] = Σ_e Σ_{(i,j,k)∈p} c x[e,iU+u]
    env[c(e),jU+u] g[e,kU+u]``, the w-transpose of ``gather_tp``. x [E,
    d1*U], env [n_atoms, d2*U], g [E, d3*U]; sentinel edges add nothing; on
    the card also ``paths`` (as ``gather_tp``). x and g may be the bf16
    track (both): dw is float32 either way.

    Replaces ``_gather_dw_kernel``. Bound by the reads of x and g; each
    path's compiled block once per edge and channel, dotted with g's slice,
    per-block partials summed in a second launch in block order (no float
    atomics)."""
    E = x.shape[0]
    _check_entries(entry_idx, entry_coef)
    if x.shape[1] % U or env.shape[1] % U or g.shape[0] != E or g.shape[1] % U \
            or centers.shape != (E,):
        raise ValueError(
            f"gather_dw shapes: x {tuple(x.shape)}, env {tuple(env.shape)}, g {tuple(g.shape)}, "
            f"centers {tuple(centers.shape)}, U={U}"
        )
    if _on_cpu(x, env, g, centers, entry_idx, entry_coef):
        return gather_dw_reference(x, env, g, centers, entry_idx, entry_coef, n_paths, U)
    bf16 = _check_kernel_args({"env": env}, {"centers": centers}, {"x": x, "g": g})
    paths = _kernel_paths("gather_dw", paths, entry_idx.shape[0])
    n_blocks = max(1, min(_DW_MAX_BLOCKS, -(-E // 64)))
    partial = torch.empty((n_blocks, n_paths, U), dtype=env.dtype, device=x.device)
    dw = torch.empty((n_paths, U), dtype=env.dtype, device=x.device)
    _launch("gather_dw", "atpt_gather_dw", x.device,
            x.data_ptr(), env.data_ptr(), g.data_ptr(), centers.data_ptr(),
            paths.desc.data_ptr(), paths.scale.data_ptr(), paths.desc.shape[0],
            paths.entry_idx.data_ptr(), paths.entry_coef.data_ptr(), E, env.shape[0],
            x.shape[1] // U, env.shape[1] // U, g.shape[1] // U, U, n_paths, n_blocks,
            partial.data_ptr(), dw.data_ptr(), int(bf16), bf16=bf16)
    return dw


def _check_unweight(what, t, e_arr, centers, dim_to_irr):
    E, d2 = e_arr.shape[0], dim_to_irr.shape[0]
    if t.ndim != 2 or t.shape[1] % d2 or centers.shape != (E,) or dim_to_irr.ndim != 1:
        raise ValueError(
            f"{what} shapes: t {tuple(t.shape)}, {tuple(e_arr.shape)}, "
            f"centers {tuple(centers.shape)}, dim_to_irr {tuple(dim_to_irr.shape)}"
        )
    return t.shape[1] // d2


def unweight_sh(t, wexp, centers, dim_to_irr) -> torch.Tensor:
    """dsh [E, d2]: ``dsh[e, j] = Σ_u t[c(e), jU+u] wexp[e, irr(j)U+u]``, the
    sh-transpose of ``env_scatter``. t [n_atoms, d2*U], wexp [E, n_irr*U];
    wexp may be the bf16 track (the env weights, or a cotangent in their
    role): dsh is float32 either way.

    Replaces ``_gather_unweight_sh_kernel``. Bound by the read of wexp; a
    block per tile of 32 consecutive edges, the tile's wexp rows and up to 4
    of its centers' t rows staged in shared memory, each (edge, dim) dot over
    the channels by one thread, the tile's dsh rows written as one range.
    Where those rows outgrow the card's shared memory (wide layers: l_max 4
    at U = 256), the launcher stages fewer t rows, then takes smaller
    tiles."""
    E, d2 = wexp.shape[0], dim_to_irr.shape[0]
    U = _check_unweight("unweight_sh", t, wexp, centers, dim_to_irr)
    if wexp.shape[1] % U:
        raise ValueError(f"unweight_sh: wexp {tuple(wexp.shape)} is not [E, n_irr*{U}]")
    if _on_cpu(t, wexp, centers, dim_to_irr):
        return unweight_sh_reference(t, wexp, centers, dim_to_irr)
    bf16 = _check_kernel_args({"t": t}, {"centers": centers, "dim_to_irr": dim_to_irr},
                              {"wexp": wexp})
    dsh = torch.empty((E, d2), dtype=t.dtype, device=t.device)
    if E > 0:
        _launch("unweight_sh", "atpt_unweight_sh", t.device,
                t.data_ptr(), wexp.data_ptr(), centers.data_ptr(), dim_to_irr.data_ptr(), E,
                t.shape[0], d2, wexp.shape[1] // U, U, dsh.data_ptr(), int(bf16), bf16=bf16)
    return dsh


def unweight_w(t, sh, centers, dim_to_irr, n_irr: int,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """dwexp [E, n_irr*U]: ``dwexp[e, rU+u] = Σ_{irr(j)=r} t[c(e), jU+u]
    sh[e, j]``, the wexp-transpose of ``env_scatter``. t [n_atoms, d2*U],
    sh [E, d2]. ``out_dtype``: dwexp's storage, the env weights' (JAX's
    ``out_dtype``: the bf16 track's bfloat16, rounded once from the float32
    sum); default the compute dtype. sh may be a bfloat16 model's (with a
    bfloat16 dwexp: the env weights' cotangent in training).

    Replaces ``_gather_unweight_w_kernel``. Bound by the write of dwexp; a
    block per tile of 32 consecutive edges, the tile's sh rows and up to 4
    of its centers' t rows staged in shared memory, each output (edge,
    irrep, 4 channels) summed over the irrep's dims (a contiguous range,
    :func:`irrep_ranges`), the tile's dwexp rows written as one range. Where
    the t rows outgrow the card's shared memory, the launcher stages fewer,
    as ``unweight_sh``'s does."""
    E = sh.shape[0]
    U = _check_unweight("unweight_w", t, sh, centers, dim_to_irr)
    if sh.shape[1] != dim_to_irr.shape[0]:
        raise ValueError(f"unweight_w: sh {tuple(sh.shape)} against dim_to_irr "
                         f"{tuple(dim_to_irr.shape)}")
    if _on_cpu(t, sh, centers, dim_to_irr):
        return unweight_w_reference(t, sh, centers, dim_to_irr, n_irr, out_dtype)
    _check_kernel_args({"t": t}, {"centers": centers, "dim_to_irr": dim_to_irr})
    dwexp = torch.empty((E, n_irr * U), dtype=out_dtype or t.dtype, device=t.device)
    flags = int(_check_kernel_args({}, {}, {"dwexp": dwexp})) | _bf16_operands(sh=(BF_SH, sh))
    if flags == BF_SH:
        raise TypeError("unweight_w: a bfloat16 sh takes a bfloat16 dwexp (a bfloat16 "
                        "model's env weights), got float32")
    if E > 0:
        _launch("unweight_w", "atpt_unweight_w", t.device,
                t.data_ptr(), sh.data_ptr(), centers.data_ptr(), dim_to_irr.data_ptr(), E,
                t.shape[0], sh.shape[1], n_irr, U, dwexp.data_ptr(), flags, bf16=bool(flags))
    return dwexp
