"""The force call's kernels: wrappers, plain versions, counters.

Each wrapper takes its arguments in the JAX package's layout (edges sorted
by center, sentinel center ``n_atoms`` on padded edges, flat dim-major
tensor track: column ``i*U+u`` is basis dim ``i``, channel ``u``) and returns
per-atom arrays as one ``[n_atoms, ·]`` array, where the TPU kernels returned
two rank-window partials ``(eA, eB)``.

- A tensor on the CPU goes to the kernel's plain PyTorch version
  (``*_reference``), which the CPU tests hold against the Pallas kernels.
- A tensor on a CUDA device goes to the hand-written CUDA kernel
  (``csrc/fused_tp.cu``, built by ``ops/_build.py``) on the current stream;
  the wrapper raises if the launch fails. There is no fallback.
- ``LAUNCHES[name]`` counts the kernel launches, and only those.

| wrapper | replaces (allegro_tpu/ops/fused_tp.py) |
| --- | --- |
| ``env_scatter`` | ``env_scatter_call`` / ``_env_scatter_kernel`` |
| ``gather_tp`` | ``gather_tp_raw_call`` / ``_gather_tp_raw_kernel`` |
| ``bwd_fused`` | ``bwd_fused_raw_call`` / ``_bwd_fused_raw_kernel`` |
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

The first four are in ``csrc/fused_tp.cu``, the next four in
``csrc/center_readout.cu``, the next four (the mega-fused layers) in
``csrc/mega.cu``, the last four (the trainable backend's transposes) in
``csrc/train_tp.cu``. ``gather_tp`` also serves ``gather_tp_call`` /
``_gather_tp_kernel``: the port keeps one env array, so that kernel's
combined-env form is the same function, and its x-transpose is
``gather_tp`` on the role-swapped entry table (:func:`swap_entries`). What
bounds each kernel on the card and how its design answers it is noted
beside each kernel in the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

LAUNCHES: Dict[str, int] = {
    "env_scatter": 0, "gather_tp": 0, "bwd_fused": 0, "unweight_both": 0,
    "center_gather": 0, "center_sum": 0, "readout_sum": 0, "readout_bwd": 0,
    "latent_env_scatter": 0, "latent_env_bwd": 0, "gather_tp_embed": 0, "bwd_embed": 0,
    "tp_scatter": 0, "gather_dw": 0, "unweight_sh": 0, "unweight_w": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    perm = np.argsort(neighbors, kind="stable").astype(np.int32)
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


def swap_entries(entry_idx: torch.Tensor) -> torch.Tensor:
    """The role swap ``(i, j, k, p) -> (k, j, i, p)`` of an entry table (the
    coefficients keep their order): with it, ``gather_tp`` computes the
    transpose of ``gather_tp`` in its first input, mapping ``[E, d3*U]`` to
    ``[E, d1*U]``. Swapping twice gives the table back."""
    return entry_idx[:, [2, 1, 0, 3]].contiguous()


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
    return segment_sum(_weighted_sh(sh, wexp, dim_to_irr, U), centers, n_atoms)


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


def gather_tp_reference(x, env, w, centers, entry_idx, entry_coef, d3, split=False):
    E, U = x.shape[0], w.shape[1]
    d1, d2 = x.shape[1] // U, env.shape[1] // U
    ww = _path_tensor(w, entry_idx, entry_coef, d1, d2, d3)
    env_e = gather_rows(env, centers).view(E, d2, U)
    xv = x.view(E, d1, U)
    out = x.new_zeros((E, d3, U))
    for i in range(d1):
        out = out + xv[:, i : i + 1, :] * torch.einsum("eju,ujk->eku", env_e, ww[:, i])
    out = out.reshape(E, d3 * U)
    return (out, out[:, :U].clone()) if split else out


def bwd_fused_reference(x, g, env, w, centers, n_atoms, entry_idx, entry_coef, gts=None):
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
    return dx, segment_sum(denv_e.reshape(E, d2 * U), centers, n_atoms)


def unweight_both_reference(t, sh, wexp, centers, dim_to_irr):
    E, d2 = sh.shape
    U = t.shape[1] // d2
    n_irr = wexp.shape[1] // U
    d2i = dim_to_irr.long()
    t_e = gather_rows(t, centers).view(E, d2, U)
    dsh = (t_e * wexp.view(E, n_irr, U).index_select(1, d2i)).sum(-1)
    dwexp = wexp.new_zeros((E, n_irr, U)).index_add(1, d2i, t_e * sh[:, :, None])
    return dsh, dwexp.reshape(E, n_irr * U)


def center_gather_reference(a, idx):
    return gather_rows(a, idx)


def center_sum_reference(v, row_ptr, perm=None):
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
    ``pre`` itself without a hidden layer, ``w1 is None``)."""
    pre = None
    off = 0
    for p in pieces:
        t = p @ w0[off : off + p.shape[1]]
        pre = t if pre is None else pre + t
        off += p.shape[1]
    return pre, pre if w1 is None else torch.nn.functional.silu(pre) @ w1


def _edge_mlp_bwd(pieces, pre, dout, w0, w1):
    """The piece cotangents of :func:`_edge_mlp` from its output's ``dout``."""
    dh = dout
    if w1 is not None:
        sig = torch.sigmoid(pre)
        dh = (dh @ w1.T) * (sig * (1.0 + pre * (1.0 - sig)))
    dp = dh @ w0.T
    return tuple(torch.split(dp, [p.shape[1] for p in pieces], dim=1))


def readout_sum_reference(pieces, w0, w1, row_ptr):
    _, energy = _edge_mlp(pieces, w0, w1)
    return center_sum_reference(energy, row_ptr)


def readout_bwd_reference(pieces, w0, w1, y, centers):
    pre, _ = _edge_mlp(pieces, w0, w1)
    return _edge_mlp_bwd(pieces, pre, gather_rows(y, centers), w0, w1)


def latent_env_scatter_reference(pieces, sh, w0, w1, row_ptr, dim_to_irr, U, S):
    _, lat = _edge_mlp(pieces, w0, w1)
    env = center_sum_reference(_weighted_sh(sh, lat[:, S:], dim_to_irr, U), row_ptr)
    return lat[:, :S].contiguous(), env


def latent_env_bwd_reference(pieces, sh, w0, w1, t, g_lat, centers, dim_to_irr, U, S):
    pre, lat = _edge_mlp(pieces, w0, w1)
    dsh, dwexp = unweight_both_reference(t, sh, lat[:, S:], centers, dim_to_irr)
    return dsh, _edge_mlp_bwd(pieces, pre, torch.cat([g_lat, dwexp], dim=1), w0, w1)


def gather_tp_embed_reference(sh, w2b, env, w, centers, entry_idx, entry_coef, row_specs, d3,
                              split=False):
    x0 = _embed_x0(sh, w2b, row_specs, w.shape[1])
    return gather_tp_reference(x0, env, w, centers, entry_idx, entry_coef, d3, split)


def bwd_embed_reference(sh, w2b, g, env, w, centers, n_atoms, entry_idx, entry_coef, row_specs,
                        gts=None):
    E, U = sh.shape[0], w.shape[1]
    x0 = _embed_x0(sh, w2b, row_specs, U)
    dx, denv = bwd_fused_reference(x0, g, env, w, centers, n_atoms, entry_idx, entry_coef, gts)
    specs = row_specs.long()
    dx = dx.view(E, -1, U)  # [E, d1, U]
    w = w2b.reshape(E, -1, U)
    dsh = torch.zeros_like(sh).index_add(
        1, specs[:, 0], (dx * w.index_select(1, specs[:, 1])).sum(-1))
    dw2b = torch.zeros_like(w).index_add(
        1, specs[:, 1], dx * sh.index_select(1, specs[:, 0])[:, :, None])
    return dsh, dw2b.reshape(E, -1), denv


def tp_scatter_reference(x, g, w, centers, n_atoms, entry_idx, entry_coef, d2):
    E, U = x.shape[0], w.shape[1]
    d1, d3 = x.shape[1] // U, g.shape[1] // U
    ww = _path_tensor(w, entry_idx, entry_coef, d1, d2, d3)
    xv, gv = x.view(E, d1, U), g.view(E, d3, U)
    denv_e = x.new_zeros((E, d2, U))
    for i in range(d1):
        denv_e = denv_e + xv[:, i : i + 1, :] * torch.einsum("eku,ujk->eju", gv, ww[:, i])
    return segment_sum(denv_e.reshape(E, d2 * U), centers, n_atoms)


def gather_dw_reference(x, env, g, centers, entry_idx, entry_coef, n_paths, U):
    E = x.shape[0]
    d1, d2, d3 = x.shape[1] // U, env.shape[1] // U, g.shape[1] // U
    C = _cg_tensor(x, entry_idx, entry_coef, n_paths, d1, d2, d3)
    env_e = gather_rows(env, centers).view(E, d2, U)
    xv, gv = x.view(E, d1, U), g.view(E, d3, U)
    dw = x.new_zeros((n_paths, U))
    for i in range(d1):
        t = torch.einsum("eju,eku->jku", xv[:, i : i + 1, :] * env_e, gv)  # [d2, d3, U]
        dw = dw + torch.einsum("pjk,jku->pu", C[:, i], t)
    return dw


def unweight_sh_reference(t, wexp, centers, dim_to_irr):
    E, d2 = wexp.shape[0], dim_to_irr.shape[0]
    U = t.shape[1] // d2
    t_e = gather_rows(t, centers).view(E, d2, U)
    return (t_e * wexp.view(E, -1, U).index_select(1, dim_to_irr.long())).sum(-1)


def unweight_w_reference(t, sh, centers, dim_to_irr, n_irr):
    E, d2 = sh.shape
    U = t.shape[1] // d2
    t_e = gather_rows(t, centers).view(E, d2, U)
    dwexp = sh.new_zeros((E, n_irr, U)).index_add(1, dim_to_irr.long(), t_e * sh[:, :, None])
    return dwexp.reshape(E, n_irr * U)


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


def _check_kernel_args(floats, ints) -> None:
    for name, t in floats.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: index arrays must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    """A device pointer for ctypes; None (a null pointer) for an absent array."""
    return None if t is None else t.data_ptr()


def _launch(name: str, fn: str, device: torch.device, *args) -> None:
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    _build.check(lib, rc, name)
    LAUNCHES[name] += 1


def _check_entries(entry_idx, entry_coef):
    if entry_idx.ndim != 2 or entry_idx.shape[1] != 4 or entry_coef.shape != entry_idx.shape[:1]:
        raise ValueError(
            f"entry table must be idx [n, 4] (i, j, k, p) and coef [n], got "
            f"{tuple(entry_idx.shape)} and {tuple(entry_coef.shape)}"
        )


def env_scatter(sh, wexp, centers, row_ptr, dim_to_irr, U: int) -> torch.Tensor:
    """env [n_atoms, d2*U]: ``env[a, jU+u] = Σ_{c(e)=a} sh[e,j] wexp[e, irr(j)U+u]``.

    sh [E, d2], wexp [E, n_irr*U], centers [E], row_ptr [n_atoms+1] (CSR over
    the center-sorted edges), dim_to_irr [d2].

    Replaces ``_env_scatter_kernel``. Bound by the one read of wexp; one
    block per atom sums its CSR segment in edge order (no atomics)."""
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
    _check_kernel_args(
        {"sh": sh, "wexp": wexp}, {"row_ptr": row_ptr, "dim_to_irr": dim_to_irr}
    )
    env = torch.empty((n_atoms, d2 * U), dtype=sh.dtype, device=sh.device)
    if n_atoms == 0:
        return env
    _launch("env_scatter", "atpt_env_scatter", sh.device,
            sh.data_ptr(), wexp.data_ptr(), row_ptr.data_ptr(), dim_to_irr.data_ptr(),
            n_atoms, d2, n_irr, U, env.data_ptr())
    return env


def gather_tp(x, env, w, centers, entry_idx, entry_coef, d3: int, split: bool = False):
    """out [E, d3*U]: ``out[e,kU+u] = Σ c w[p,u] x[e,iU+u] env[c(e),jU+u]``.

    x [E, d1*U], env [n_atoms, d2*U], w [P, U], entries (i, j, k, p) / c.
    ``split``: also return the leading 0e block ``out[:, :U]`` as its own
    [E, U] array, ``(out, ts)``.

    Replaces ``_gather_tp_raw_kernel``. Bound by the read of x and the write
    of out; one warp per edge, lane = channel, coalesced rows."""
    E, U = x.shape[0], w.shape[1]
    n_atoms = env.shape[0]
    _check_entries(entry_idx, entry_coef)
    if x.shape[1] % U or env.shape[1] % U or centers.shape != (E,):
        raise ValueError(
            f"gather_tp shapes: x {tuple(x.shape)}, env {tuple(env.shape)}, "
            f"w {tuple(w.shape)}, centers {tuple(centers.shape)}"
        )
    if _on_cpu(x, env, w, centers, entry_idx, entry_coef):
        return gather_tp_reference(x, env, w, centers, entry_idx, entry_coef, d3, split)
    _check_kernel_args(
        {"x": x, "env": env, "w": w, "entry_coef": entry_coef},
        {"centers": centers, "entry_idx": entry_idx},
    )
    out = torch.empty((E, d3 * U), dtype=x.dtype, device=x.device)
    ts = torch.empty((E, U), dtype=x.dtype, device=x.device) if split else None
    if E > 0:
        _launch("gather_tp", "atpt_gather_tp", x.device,
                x.data_ptr(), env.data_ptr(), w.data_ptr(), centers.data_ptr(),
                entry_idx.data_ptr(), entry_coef.data_ptr(), entry_idx.shape[0],
                E, n_atoms, x.shape[1] // U, env.shape[1] // U, d3, U, out.data_ptr(),
                _ptr(ts))
    return (out, ts) if split else out


def bwd_fused(x, g, env, w, centers, row_ptr, entry_idx, entry_coef,
              gts=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of ``gather_tp`` in x and env, without dw:
    dx [E, d1*U] and denv [n_atoms, d2*U]. ``gts`` [E, U]: the cotangent of
    the split scalar output, added to g's block 0.

    Replaces ``_bwd_fused_raw_kernel``. Bound by the reads of x and g and the
    write of dx; one block per atom segment gives dx and denv in one pass,
    denv summed across warps in shared memory in a fixed order."""
    E, U = x.shape[0], w.shape[1]
    n_atoms = row_ptr.shape[0] - 1
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
        return bwd_fused_reference(x, g, env, w, centers, n_atoms, entry_idx, entry_coef, gts)
    _check_kernel_args(
        {"x": x, "g": g, "env": env, "w": w, "entry_coef": entry_coef,
         **{"gts": t for t in opt}},
        {"row_ptr": row_ptr, "entry_idx": entry_idx},
    )
    dx = torch.empty_like(x)
    denv = torch.empty_like(env)
    if E == 0 and n_atoms == 0:
        return dx, denv
    _launch("bwd_fused", "atpt_bwd_fused", x.device,
            x.data_ptr(), g.data_ptr(), _ptr(gts), env.data_ptr(), w.data_ptr(),
            row_ptr.data_ptr(), entry_idx.data_ptr(), entry_coef.data_ptr(),
            entry_idx.shape[0], E, n_atoms,
            x.shape[1] // U, env.shape[1] // U, g.shape[1] // U, U,
            dx.data_ptr(), denv.data_ptr())
    return dx, denv


def unweight_both(t, sh, wexp, centers, dim_to_irr) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two transposes of ``env_scatter`` from t = denv [n_atoms, d2*U]:
    dsh [E, d2] and dwexp [E, n_irr*U].

    Replaces ``_unweight_both_raw_kernel``. Bound by the read of wexp and the
    write of dwexp; one warp per edge, dsh by a warp shuffle reduction."""
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
        return unweight_both_reference(t, sh, wexp, centers, dim_to_irr)
    _check_kernel_args(
        {"t": t, "sh": sh, "wexp": wexp}, {"centers": centers, "dim_to_irr": dim_to_irr}
    )
    dsh = torch.empty_like(sh)
    dwexp = torch.empty_like(wexp)
    if E == 0:
        return dsh, dwexp
    _launch("unweight_both", "atpt_unweight_both", t.device,
            t.data_ptr(), sh.data_ptr(), wexp.data_ptr(), centers.data_ptr(),
            dim_to_irr.data_ptr(), E, t.shape[0], d2, n_irr, U,
            dsh.data_ptr(), dwexp.data_ptr())
    return dsh, dwexp


def center_gather(a, idx) -> torch.Tensor:
    """out [E, C]: ``out[e] = a[idx[e]]``, zeros where ``idx[e] >= n_atoms``
    (sentinel edges). a [n_atoms, C], idx [E]. Exact (a copy).

    Replaces ``_center_broadcast_kernel``. Bound by the write of out; one
    thread per output element, an indexed load."""
    if a.ndim != 2 or idx.ndim != 1:
        raise ValueError(f"center_gather shapes: a {tuple(a.shape)}, idx {tuple(idx.shape)}")
    if _on_cpu(a, idx):
        return center_gather_reference(a, idx)
    _check_kernel_args({"a": a}, {"idx": idx})
    E, (n_atoms, C) = idx.shape[0], a.shape
    out = torch.empty((E, C), dtype=a.dtype, device=a.device)
    if E == 0 or C == 0:
        return out
    _launch("center_gather", "atpt_center_gather", a.device,
            a.data_ptr(), idx.data_ptr(), E, n_atoms, C, out.data_ptr())
    return out


def center_sum(v, row_ptr, perm=None) -> torch.Tensor:
    """s [n_atoms, C]: ``s[a] = Σ_{k ∈ [row_ptr[a], row_ptr[a+1])} v[perm[k]]``
    (``perm`` None = identity, the center side). v [E, C], row_ptr
    [n_atoms+1], perm [E]; CSR positions after ``row_ptr[n_atoms]`` (sentinel
    edges) are dropped.

    Replaces ``_center_sum_kernel``. Bound by the read of v; one thread per
    (atom, column) sums its segment in edge order (no atomics)."""
    n_atoms = row_ptr.shape[0] - 1
    if v.ndim != 2 or row_ptr.ndim != 1 or (perm is not None and perm.shape != v.shape[:1]):
        raise ValueError(
            f"center_sum shapes: v {tuple(v.shape)}, row_ptr {tuple(row_ptr.shape)}, "
            f"perm {None if perm is None else tuple(perm.shape)}"
        )
    ints = {"row_ptr": row_ptr} if perm is None else {"row_ptr": row_ptr, "perm": perm}
    if _on_cpu(v, *ints.values()):
        return center_sum_reference(v, row_ptr, perm)
    _check_kernel_args({"v": v}, ints)
    C = v.shape[1]
    out = torch.empty((n_atoms, C), dtype=v.dtype, device=v.device)
    if n_atoms == 0 or C == 0:
        return out
    _launch("center_sum", "atpt_center_sum", v.device,
            v.data_ptr(), row_ptr.data_ptr(), None if perm is None else perm.data_ptr(),
            n_atoms, C, out.data_ptr())
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


def _check_pieces_dtype(pieces) -> None:
    for i, p in enumerate(pieces):
        if p.dtype != torch.float32:
            raise TypeError(f"piece {i}: the CUDA kernels take float32, got {p.dtype}")


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
    center CSR; sentinel edges after ``row_ptr[n_atoms]`` add nothing). The edgewise factor is expected folded into the last weight.

    Replaces ``_readout_sum_kernel``. Bound by the read of the pieces and
    K·H FMAs per edge; W0 in shared memory, one warp per atom, lane = edge,
    the per-edge energies summed in edge order."""
    pieces = tuple(pieces)
    n_atoms = row_ptr.shape[0] - 1
    H = _check_readout(pieces, w0, w1, pieces[0].shape[0] if pieces else 0)
    rest = () if w1 is None else (w1,)
    if _on_cpu(*pieces, w0, *rest, row_ptr):
        return readout_sum_reference(pieces, w0, w1, row_ptr)
    _check_kernel_args({"w0": w0, **{"w1": w for w in rest}}, {"row_ptr": row_ptr})
    _check_pieces_dtype(pieces)
    energy = torch.empty((n_atoms, 1), dtype=w0.dtype, device=w0.device)
    if n_atoms == 0:
        return energy
    ptrs, strides = _piece_table(pieces)
    dims = (ctypes.c_int * len(pieces))(*(p.shape[1] for p in pieces))
    _launch("readout_sum", "atpt_readout_sum", w0.device,
            ptrs, strides, dims, len(pieces), w0.data_ptr(),
            None if w1 is None else w1.data_ptr(), row_ptr.data_ptr(), n_atoms, H,
            energy.data_ptr())
    return energy


def readout_bwd(pieces: Sequence[torch.Tensor], w0, w1: Optional[torch.Tensor], y,
                centers) -> Tuple[torch.Tensor, ...]:
    """Backward of ``readout_sum`` in the pieces, from the per-atom energy
    cotangent y [n_atoms, 1]: ``dp_i[e] = (y[c(e)] w1ᵀ ⊙ silu'(pre_e)) @
    W0_iᵀ`` (``y[c(e)] W0_iᵀ`` without a hidden layer); zero rows on sentinel
    edges. Returns contiguous dpieces [E, S_i].

    Replaces ``_readout_bwd_kernel``. Bound by the read of the pieces and the
    write of their cotangents; one thread per edge gathers y[c(e)] itself,
    recomputes the pre-activation and writes its dp rows."""
    pieces = tuple(pieces)
    E = centers.shape[0]
    H = _check_readout(pieces, w0, w1, E)
    if y.ndim != 2 or y.shape[1] != 1:
        raise ValueError(f"readout_bwd: y must be [n_atoms, 1], got {tuple(y.shape)}")
    rest = () if w1 is None else (w1,)
    if _on_cpu(*pieces, w0, *rest, y, centers):
        return readout_bwd_reference(pieces, w0, w1, y, centers)
    _check_kernel_args({"w0": w0, "y": y, **{"w1": w for w in rest}}, {"centers": centers})
    _check_pieces_dtype(pieces)
    dpieces = tuple(torch.empty(p.shape, dtype=p.dtype, device=p.device) for p in pieces)
    if E == 0:
        return dpieces
    ptrs, strides = _piece_table(pieces)
    dptrs, dstrides = _piece_table(dpieces)
    dims = (ctypes.c_int * len(pieces))(*(p.shape[1] for p in pieces))
    _launch("readout_bwd", "atpt_readout_bwd", w0.device,
            ptrs, strides, dptrs, dstrides, dims, len(pieces), w0.data_ptr(),
            None if w1 is None else w1.data_ptr(), y.data_ptr(), centers.data_ptr(), E,
            y.shape[0], H)
    return dpieces


def latent_env_scatter(pieces: Sequence[torch.Tensor], sh, w0, w1: Optional[torch.Tensor], row_ptr,
                       dim_to_irr, U: int, S: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A layer's latent MLP fused with the next layer's environment sum:
    ``lat = silu(Σ_i p_i @ W0_i) @ W1`` (or ``Σ_i p_i @ W0_i`` without a
    hidden layer, ``w1=None``) per edge; returns its scalar columns
    ``lat_s = lat[:, :S]`` [E, S] and ``env [n_atoms, d2*U]``, ``env[a, jU+u]
    = Σ_{c(e)=a} sh[e,j] lat[e, S+irr(j)U+u]``. pieces [E, S_i] (column
    slices are fine), sh [E, d2], w0 [ΣS_i, H], w1 [H, S+n_irr*U], row_ptr
    [n_atoms+1] (the center CSR; sentinel edges get lat_s and add no env),
    dim_to_irr [d2]. The scatter factor is expected folded into the env
    columns of the last weight.

    Replaces ``_latent_env_scatter_kernel``. Bound by exact-FP32 FMAs; the
    hidden activation and the env weights never reach device memory."""
    pieces = tuple(pieces)
    E, d2 = sh.shape
    n_atoms = row_ptr.shape[0] - 1
    N = _check_mlp("latent_env_scatter", pieces, w0, w1, E)
    if N <= S or (N - S) % U or dim_to_irr.shape != (d2,):
        raise ValueError(f"latent_env_scatter shapes: MLP output {N}, S={S}, U={U}, "
                         f"sh {tuple(sh.shape)}, dim_to_irr {tuple(dim_to_irr.shape)}")
    rest = () if w1 is None else (w1,)
    if _on_cpu(*pieces, sh, w0, *rest, row_ptr, dim_to_irr):
        return latent_env_scatter_reference(pieces, sh, w0, w1, row_ptr, dim_to_irr, U, S)
    _check_kernel_args({"sh": sh, "w0": w0, **{"w1": w for w in rest}},
                       {"row_ptr": row_ptr, "dim_to_irr": dim_to_irr})
    _check_pieces_dtype(pieces)
    lat_s = torch.empty((E, S), dtype=sh.dtype, device=sh.device)
    env = torch.empty((n_atoms, d2 * U), dtype=sh.dtype, device=sh.device)
    if E == 0 and n_atoms == 0:
        return lat_s, env
    ptrs, strides = _piece_table(pieces)
    dims = (ctypes.c_int * len(pieces))(*(p.shape[1] for p in pieces))
    _launch("latent_env_scatter", "atpt_latent_env_scatter", sh.device,
            ptrs, strides, dims, len(pieces), w0.data_ptr(), _ptr(w1), sh.data_ptr(),
            row_ptr.data_ptr(), dim_to_irr.data_ptr(), E, n_atoms, d2, U, S,
            0 if w1 is None else w0.shape[1], N, lat_s.data_ptr(), env.data_ptr())
    return lat_s, env


def latent_env_bwd(pieces: Sequence[torch.Tensor], sh, w0, w1: Optional[torch.Tensor], t, g_lat,
                   centers, dim_to_irr, U: int, S: int) -> Tuple[torch.Tensor, ...]:
    """Backward of ``latent_env_scatter`` in sh and the pieces, from the env
    cotangent t [n_atoms, d2*U] and the lat_s cotangent g_lat [E, S]:
    ``(dsh [E, d2], dpieces)``, dpieces contiguous [E, S_i]. The MLP is
    recomputed; a sentinel edge reads t = 0.

    Replaces ``_latent_env_bwd_kernel``. Bound by exact-FP32 FMAs; one warp
    per 32 edges, lane = edge, weights in shared memory."""
    pieces = tuple(pieces)
    E, d2 = sh.shape
    N = _check_mlp("latent_env_bwd", pieces, w0, w1, E)
    if (N <= S or (N - S) % U or t.ndim != 2 or t.shape[1] != d2 * U or g_lat.shape != (E, S)
            or centers.shape != (E,) or dim_to_irr.shape != (d2,)):
        raise ValueError(f"latent_env_bwd shapes: MLP output {N}, S={S}, U={U}, "
                         f"sh {tuple(sh.shape)}, t {tuple(t.shape)}, g_lat {tuple(g_lat.shape)}")
    rest = () if w1 is None else (w1,)
    if _on_cpu(*pieces, sh, w0, *rest, t, g_lat, centers, dim_to_irr):
        return latent_env_bwd_reference(pieces, sh, w0, w1, t, g_lat, centers, dim_to_irr, U, S)
    _check_kernel_args({"sh": sh, "w0": w0, "t": t, "g_lat": g_lat, **{"w1": w for w in rest}},
                       {"centers": centers, "dim_to_irr": dim_to_irr})
    _check_pieces_dtype(pieces)
    dsh = torch.empty_like(sh)
    dpieces = tuple(torch.empty(p.shape, dtype=p.dtype, device=p.device) for p in pieces)
    if E == 0:
        return dsh, dpieces
    ptrs, strides = _piece_table(pieces)
    dptrs, dstrides = _piece_table(dpieces)
    dims = (ctypes.c_int * len(pieces))(*(p.shape[1] for p in pieces))
    _launch("latent_env_bwd", "atpt_latent_env_bwd", sh.device,
            ptrs, strides, dptrs, dstrides, dims, len(pieces), w0.data_ptr(), _ptr(w1),
            sh.data_ptr(), t.data_ptr(), g_lat.data_ptr(), centers.data_ptr(),
            dim_to_irr.data_ptr(), E, t.shape[0], d2, U, S, 0 if w1 is None else w0.shape[1], N,
            dsh.data_ptr())
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


def gather_tp_embed(sh, w2b, env, w, centers, entry_idx, entry_coef, row_specs, d3: int,
                    split: bool = False):
    """``gather_tp`` on layer 0's features ``x0[e, iU+u] = sh[e, js_i]
    w2b[e, irs_i U+u]``, built on the fly: out [E, d3*U] (and ts [E, U]
    with ``split``). sh [E, d_sh], w2b [E, n_irr*U] (the tensor embed's
    channel weights), row_specs [d1, 2] int32 = (js_i, irs_i).

    Replaces ``_gather_tp_embed_raw_kernel``. Bound by the write of out;
    one warp per edge, lane = channel, x0 rows built in shared memory."""
    E, U = sh.shape[0], w.shape[1]
    n_irr = _check_embed("gather_tp_embed", sh, w2b, env, w, centers, entry_idx, entry_coef,
                         row_specs)
    if _on_cpu(sh, w2b, env, w, centers, entry_idx, entry_coef, row_specs):
        return gather_tp_embed_reference(sh, w2b, env, w, centers, entry_idx, entry_coef,
                                         row_specs, d3, split)
    _check_kernel_args({"sh": sh, "w2b": w2b, "env": env, "w": w, "entry_coef": entry_coef},
                       {"centers": centers, "entry_idx": entry_idx, "row_specs": row_specs})
    out = torch.empty((E, d3 * U), dtype=sh.dtype, device=sh.device)
    ts = torch.empty((E, U), dtype=sh.dtype, device=sh.device) if split else None
    if E > 0:
        _launch("gather_tp_embed", "atpt_gather_tp_embed", sh.device,
                sh.data_ptr(), w2b.data_ptr(), env.data_ptr(), w.data_ptr(), centers.data_ptr(),
                entry_idx.data_ptr(), entry_coef.data_ptr(), entry_idx.shape[0],
                row_specs.data_ptr(), E, env.shape[0], sh.shape[1], n_irr, row_specs.shape[0],
                env.shape[1] // U, d3, U, out.data_ptr(), _ptr(ts))
    return (out, ts) if split else out


def bwd_embed(sh, w2b, g, env, w, centers, row_ptr, entry_idx, entry_coef, row_specs,
              gts=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of ``gather_tp_embed`` in its factors and env, without dw:
    dsh [E, d_sh], dw2b [E, n_irr*U] and denv [n_atoms, d2*U]; ``gts``
    [E, U] is the cotangent of the split scalar output. Sentinel edges get
    zero rows.

    Replaces ``_bwd_embed_raw_kernel``. Bound by the read of g and the write
    of dw2b; one block per atom segment, dx0 reduced onto the factors in
    registers and never written."""
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
    _check_kernel_args({"sh": sh, "w2b": w2b, "g": g, "env": env, "w": w,
                        "entry_coef": entry_coef, **{"gts": t for t in opt}},
                       {"row_ptr": row_ptr, "entry_idx": entry_idx, "row_specs": row_specs})
    dsh = torch.empty_like(sh)
    dw2b = torch.empty_like(w2b)
    denv = torch.empty_like(env)
    if E == 0 and n_atoms == 0:
        return dsh, dw2b, denv
    _launch("bwd_embed", "atpt_bwd_embed", sh.device,
            sh.data_ptr(), w2b.data_ptr(), g.data_ptr(), _ptr(gts), env.data_ptr(), w.data_ptr(),
            row_ptr.data_ptr(), entry_idx.data_ptr(), entry_coef.data_ptr(), entry_idx.shape[0],
            row_specs.data_ptr(), E, n_atoms, sh.shape[1], n_irr, row_specs.shape[0],
            env.shape[1] // U, g.shape[1] // U, U, dsh.data_ptr(), dw2b.data_ptr(),
            denv.data_ptr())
    return dsh, dw2b, denv


def tp_scatter(x, g, w, centers, row_ptr, entry_idx, entry_coef, d2: int) -> torch.Tensor:
    """denv [n_atoms, d2*U]: ``denv[a, jU+u] = Σ_{c(e)=a} Σ c w[p,u] x[e,iU+u]
    g[e,kU+u]``, the env-transpose of ``gather_tp``. x [E, d1*U], g [E, d3*U],
    w [P, U], row_ptr [n_atoms+1]; the entry table in either role order.

    Replaces ``_tp_scatter_kernel``. Bound by the reads of x and g; one block
    per atom segment, summed across warps in a fixed order (no atomics)."""
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
    _check_kernel_args({"x": x, "g": g, "w": w, "entry_coef": entry_coef},
                       {"row_ptr": row_ptr, "entry_idx": entry_idx})
    denv = torch.empty((n_atoms, d2 * U), dtype=x.dtype, device=x.device)
    if n_atoms == 0:
        return denv
    _launch("tp_scatter", "atpt_tp_scatter", x.device,
            x.data_ptr(), g.data_ptr(), w.data_ptr(), row_ptr.data_ptr(), entry_idx.data_ptr(),
            entry_coef.data_ptr(), entry_idx.shape[0], n_atoms, x.shape[1] // U, d2,
            g.shape[1] // U, U, denv.data_ptr())
    return denv


_DW_MAX_BLOCKS = 1024  # blocks of gather_dw's first pass (partials [blocks, P, U])


def gather_dw(x, env, g, centers, entry_idx, entry_coef, n_paths: int, U: int) -> torch.Tensor:
    """dw [n_paths, U]: ``dw[p, u] = Σ_e Σ_{(i,j,k)∈p} c x[e,iU+u]
    env[c(e),jU+u] g[e,kU+u]``, the w-transpose of ``gather_tp``. x [E,
    d1*U], env [n_atoms, d2*U], g [E, d3*U]; sentinel edges add nothing.

    Replaces ``_gather_dw_kernel``. Bound by the reads of x and g; per-block
    partials summed in a second pass in block order (no float atomics)."""
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
    _check_kernel_args({"x": x, "env": env, "g": g, "entry_coef": entry_coef},
                       {"centers": centers, "entry_idx": entry_idx})
    n_blocks = max(1, min(_DW_MAX_BLOCKS, -(-E // 64)))
    partial = torch.empty((n_blocks, n_paths, U), dtype=x.dtype, device=x.device)
    dw = torch.empty((n_paths, U), dtype=x.dtype, device=x.device)
    _launch("gather_dw", "atpt_gather_dw", x.device,
            x.data_ptr(), env.data_ptr(), g.data_ptr(), centers.data_ptr(),
            entry_idx.data_ptr(), entry_coef.data_ptr(), entry_idx.shape[0], E, env.shape[0],
            x.shape[1] // U, env.shape[1] // U, g.shape[1] // U, U, n_paths, n_blocks,
            partial.data_ptr(), dw.data_ptr())
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
    sh-transpose of ``env_scatter``. t [n_atoms, d2*U], wexp [E, n_irr*U].

    Replaces ``_gather_unweight_sh_kernel``. Bound by the read of wexp; one
    warp per edge, a warp shuffle reduction per basis dim."""
    E, d2 = wexp.shape[0], dim_to_irr.shape[0]
    U = _check_unweight("unweight_sh", t, wexp, centers, dim_to_irr)
    if wexp.shape[1] % U:
        raise ValueError(f"unweight_sh: wexp {tuple(wexp.shape)} is not [E, n_irr*{U}]")
    if _on_cpu(t, wexp, centers, dim_to_irr):
        return unweight_sh_reference(t, wexp, centers, dim_to_irr)
    _check_kernel_args({"t": t, "wexp": wexp}, {"centers": centers, "dim_to_irr": dim_to_irr})
    dsh = torch.empty((E, d2), dtype=t.dtype, device=t.device)
    if E > 0:
        _launch("unweight_sh", "atpt_unweight_sh", t.device,
                t.data_ptr(), wexp.data_ptr(), centers.data_ptr(), dim_to_irr.data_ptr(), E,
                t.shape[0], d2, wexp.shape[1] // U, U, dsh.data_ptr())
    return dsh


def unweight_w(t, sh, centers, dim_to_irr, n_irr: int) -> torch.Tensor:
    """dwexp [E, n_irr*U]: ``dwexp[e, rU+u] = Σ_{irr(j)=r} t[c(e), jU+u]
    sh[e, j]``, the wexp-transpose of ``env_scatter``. t [n_atoms, d2*U],
    sh [E, d2].

    Replaces ``_gather_unweight_w_kernel``. Bound by the write of dwexp; one
    warp per edge, lane = channel."""
    E = sh.shape[0]
    U = _check_unweight("unweight_w", t, sh, centers, dim_to_irr)
    if sh.shape[1] != dim_to_irr.shape[0]:
        raise ValueError(f"unweight_w: sh {tuple(sh.shape)} against dim_to_irr "
                         f"{tuple(dim_to_irr.shape)}")
    if _on_cpu(t, sh, centers, dim_to_irr):
        return unweight_w_reference(t, sh, centers, dim_to_irr, n_irr)
    _check_kernel_args({"t": t, "sh": sh}, {"centers": centers, "dim_to_irr": dim_to_irr})
    dwexp = torch.empty((E, n_irr * U), dtype=t.dtype, device=t.device)
    if E > 0:
        _launch("unweight_w", "atpt_unweight_w", t.device,
                t.data_ptr(), sh.data_ptr(), centers.data_ptr(), dim_to_irr.data_ptr(), E,
                t.shape[0], sh.shape[1], n_irr, U, dwexp.data_ptr())
    return dwexp
