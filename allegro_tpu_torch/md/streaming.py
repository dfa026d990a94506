"""Center-chunked streaming evaluation (twin of ``allegro_tpu/md/streaming.py``).

Strict locality makes the total energy an exact sum over per-center terms.
The center-sorted edges of one frame are split into K contiguous chunks at
center boundaries, so every per-center environment sum lies inside one
chunk; the force call runs as a Python loop over the chunks. Edges are
partitioned, not duplicated: only the position gather reads an atom of a
chunk's boundary (a ghost) more than once.

Each chunk's energy runs under ``torch.utils.checkpoint``: the forward keeps
one chunk's inputs, and the backward recomputes one chunk at a time, so the
peak activation memory is about one chunk's (plus the O(N) global arrays).
The forces come from one autograd pass through the loop; the transpose of
the position gather is the ghost-force sum. On a kernel backend that gather
is ``center_gather`` over the chunk's CSR of its atom ids, so the ghost
forces add in a fixed order (two identical calls give the same bits); the
``einsum`` reference gathers with ``index_select``.

The chunks are padded to uniform (atoms, edges) sizes, as in JAX, with the
per-chunk CSR statics of ``Model.precompute_statics`` attached on the host.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..data import keys, round_up
from ..device import resolve_device
from ..ops.fused_primitives import center_gather
from ..ops.fused_tp import neighbor_csr

LOCAL_IDX = "stream_local_idx"  # [La] int32: the global atom id of each local row
# the CSR of LOCAL_IDX over the global rows (its gather's transpose sums by it)
GATHER_ROW_PTR = "stream_gather_row_ptr"
GATHER_PERM = "stream_gather_perm"


def build_chunks(data: Dict, model, n_chunks: int, atom_multiple: int = 8) -> Dict[str, np.ndarray]:
    """Split a single-frame batch into K chunk batches (on the host).

    ``data``: a padded single-frame batch (NumPy, edges sorted by center: the
    neighbor-list order). Returns a dict of arrays with a leading ``[K, ...]``
    axis, each chunk's statics attached by ``model.precompute_statics``, as
    JAX's ``build_chunks`` does (its arrays, element by element, for every
    key the two share)."""
    eidx = np.asarray(data[keys.EDGE_INDEX])
    types = np.asarray(data[keys.ATOM_TYPES])
    shifts = np.asarray(data[keys.EDGE_CELL_SHIFT]) if keys.EDGE_CELL_SHIFT in data else None
    node_mask = (np.asarray(data[keys.NODE_MASK]) if keys.NODE_MASK in data
                 else np.ones(types.shape[0], bool))
    n_real = int(node_mask.sum())
    if not node_mask[:n_real].all():
        raise ValueError("streaming requires the real atoms first and contiguous")
    E = int(np.asarray(data[keys.EDGE_MASK]).sum()) if keys.EDGE_MASK in data else eidx.shape[1]
    centers, neighbors = eidx[0, :E], eidx[1, :E]
    if not (np.diff(centers) >= 0).all():
        raise ValueError("streaming requires center-sorted edges")
    if shifts is not None:
        shifts = shifts[:E]

    # chunk boundaries on atom ids (atoms without edges are partitioned too):
    # cut where the cumulative edge count crosses k/K of the total
    cum = np.concatenate([[0], np.cumsum(np.bincount(centers, minlength=n_real))])
    cuts = [0]
    for k in range(1, n_chunks):
        c = int(np.searchsorted(cum, k * E / n_chunks))
        cuts.append(min(max(c, cuts[-1] + 1), n_real))
    cuts.append(n_real)

    chunks = []
    for k in range(n_chunks):
        c0, c1 = cuts[k], cuts[k + 1]
        e0, e1 = int(cum[c0]), int(cum[c1])
        nbr = neighbors[e0:e1]
        ghost = np.unique(nbr[(nbr < c0) | (nbr >= c1)])
        n_own = c1 - c0
        lnbr = np.where((nbr >= c0) & (nbr < c1), nbr - c0,
                        n_own + np.searchsorted(ghost, nbr) if ghost.size else 0).astype(np.int32)
        chunks.append(dict(n_own=n_own,
                           gidx=np.concatenate([np.arange(c0, c1), ghost]).astype(np.int32),
                           lcent=(centers[e0:e1] - c0).astype(np.int32), lnbr=lnbr,
                           shifts=None if shifts is None else shifts[e0:e1], ne=e1 - e0))

    La = round_up(max(len(c["gidx"]) for c in chunks) + 1, atom_multiple)
    El = round_up(max(c["ne"] for c in chunks), 128)
    stacked: Dict[str, List[np.ndarray]] = {}
    for c in chunks:
        nl = len(c["gidx"])
        d: Dict[str, np.ndarray] = {}
        d[LOCAL_IDX] = np.concatenate([c["gidx"], np.zeros(La - nl, np.int32)])
        d[keys.ATOM_TYPES] = np.concatenate([types[c["gidx"]], np.zeros(La - nl, np.int32)])
        # owned atoms only: ghost rows add no per-type shift and no per-atom
        # energy (their centers lie in another chunk)
        m = np.zeros(La, bool)
        m[: c["n_own"]] = True
        d[keys.NODE_MASK] = m
        ei = np.full((2, El), La, np.int32)  # sentinel-padded, stays sorted
        ei[0, : c["ne"]] = c["lcent"]
        ei[1, : c["ne"]] = c["lnbr"]
        d[keys.EDGE_INDEX] = ei
        em = np.zeros(El, bool)
        em[: c["ne"]] = True
        d[keys.EDGE_MASK] = em
        if c["shifts"] is not None:
            sh = np.zeros((El, 3), c["shifts"].dtype)
            sh[: c["ne"]] = c["shifts"]
            d[keys.EDGE_CELL_SHIFT] = sh
        d[keys.BATCH] = np.zeros(La, np.int32)
        d[keys.NUM_NODES] = np.asarray([c["n_own"]], np.int32)
        d[keys.FRAME_MASK] = np.ones(1, bool)
        if keys.CELL in data:
            d[keys.CELL] = np.asarray(data[keys.CELL]).reshape(1, 3, 3)
            d[keys.PBC] = np.asarray(data[keys.PBC]).reshape(1, 3)
        # placeholder positions: the evaluator gathers the global ones
        d[keys.POSITIONS] = np.zeros((La, 3), np.float32)
        for k_, v in model.precompute_statics(d).items():
            stacked.setdefault(k_, []).append(np.asarray(v))
    # every chunk has the same keys; drop any whose shape differs between
    # chunks, as JAX does (the port's statics are uniform)
    return {k_: np.stack(v) for k_, v in stacked.items()
            if all(x.shape == v[0].shape for x in v[1:])}


def _chunk_tensors(stacked: Dict[str, np.ndarray], n_rows: int, dtype, device) -> List[Dict]:
    """The chunks as dicts of tensors on ``device``, each with the CSR of its
    atom ids over the ``n_rows`` global rows (the position gather's)."""
    out = []
    for k in range(next(iter(stacked.values())).shape[0]):
        ch = {name: v[k] for name, v in stacked.items()}
        ch[GATHER_PERM], ch[GATHER_ROW_PTR] = neighbor_csr(ch[LOCAL_IDX], n_rows)
        out.append({name: torch.as_tensor(v, device=device).to(dtype)
                    if np.issubdtype(v.dtype, np.floating) else torch.as_tensor(v, device=device)
                    for name, v in ch.items()})
    return out


def make_streamed_energy_forces_fn(model, chunks: List[Dict], with_stress: bool = False):
    """``fn(pos) -> (E, forces)`` (or ``(E, forces, virial)``) for the global
    padded positions ``pos`` [n_rows, 3], which each chunk's ``LOCAL_IDX``
    indexes, over ``chunks`` (``_chunk_tensors``). The parameters are frozen
    for the call, as in the force call; each chunk's energy is recomputed in
    the backward pass."""
    gather_csr = model.on_kernels

    def chunk_energy(pos, ch, cell):
        d = dict(ch)
        idx = ch[LOCAL_IDX]
        d[keys.POSITIONS] = (center_gather(pos, idx, ch[GATHER_ROW_PTR], ch[GATHER_PERM])
                             if gather_csr else pos.index_select(0, idx.long()))
        if cell is not None:
            d[keys.CELL] = cell
        e = model.apply(d)[keys.TOTAL_ENERGY]
        return (e * d[keys.FRAME_MASK].to(e.dtype)[:, None]).sum()

    def fn(pos: torch.Tensor):
        with model.matmul_policy(), model.frozen_parameters(), torch.enable_grad():
            pos = pos.detach().requires_grad_(True)
            strain = torch.zeros((3, 3), dtype=pos.dtype, device=pos.device, requires_grad=True)
            eps = 0.5 * (strain + strain.T)
            p = pos + pos @ eps
            cell0 = chunks[0].get(keys.CELL)
            cell = None if cell0 is None else cell0 + cell0 @ eps
            e = torch.zeros((), dtype=pos.dtype, device=pos.device)
            for ch in chunks:
                e = e + checkpoint(chunk_energy, p, ch, cell, use_reentrant=False)
            inputs = [pos, strain] if with_stress else [pos]
            grads = torch.autograd.grad(e, inputs)
        e = e.detach()
        if with_stress:
            return e, -grads[0], -grads[1]
        return e, -grads[0]

    return fn


class StreamedEvaluator:
    """Energy and forces (and the virial) of one large frame, evaluated in
    K center chunks.

    >>> ev = StreamedEvaluator(model, batch, n_chunks=8)
    >>> e, f = ev(positions)          # on the card

    ``data``: the padded single-frame batch (NumPy); the chunks and their
    statics are built once, on the host, and moved to ``device`` (default
    the CUDA card; ``"cpu"`` to run on the CPU). The parameters are the
    model's, on the same device."""

    def __init__(self, model, data: Dict, n_chunks: int, with_stress: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.n_rows = int(np.asarray(data[keys.POSITIONS]).shape[0])
        self.stacked = build_chunks(data, model, n_chunks)
        self.n_chunks = n_chunks
        model.to(self.device)
        self.chunks = _chunk_tensors(self.stacked, self.n_rows, model.model_dtype, self.device)
        self.fn = make_streamed_energy_forces_fn(model, self.chunks, with_stress=with_stress)
        self.model = model

    def __call__(self, positions):
        pos = torch.as_tensor(np.asarray(positions) if not isinstance(positions, torch.Tensor)
                              else positions, device=self.device).to(self.model.model_dtype)
        return self.fn(pos)
