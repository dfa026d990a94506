"""Whether a fused kernel's shared memory fits on the card: the host-side
twin of the layout choices of the launchers in ``csrc/``.

Four kernels of the default ``fused_infer`` path keep whole weight matrices
in shared memory: ``readout_sum`` and ``readout_bwd`` the readout's W0ᵀ
(``csrc/center_readout.cu``), ``latent_env_scatter`` and ``latent_env_bwd``
the latent MLP's weights (``csrc/mega.cu``); the embed-fused layer-0 kernels
``gather_tp_embed`` and ``bwd_embed`` keep the path weights and a warp's
rows per edge. Each launcher tries its layouts from the widest down and
refuses the launch where even the smallest exceeds the card's opt-in limit
(``shared_memory_per_block_optin``, 227 KB on an H100). A model whose widths
would be refused takes the non-fused kernels instead: the decision is made
here, on the host, when the model meets a device
(``FusedEdgeReadoutSum.route``, ``AllegroLayers.route``), never by catching
a launch error.

Each ``*_bytes`` function returns the bytes its launcher requests for the
given widths in ``limit`` bytes: the layout it chooses, or its smallest
where none fits (then more than ``limit``). The C functions
``atpt_*_smem`` of the same sources return the same numbers from the
launchers' own code; ``chip_smoke.py`` holds the two together over a grid of
widths on both sides of the limit. The bf16 forms of these kernels (the
model's ``tensor_dtype="bfloat16"``) widen the track to float as they stage
it, so their layouts, and these bytes, are the float32 forms'.
"""

from __future__ import annotations

from typing import Optional

import torch

WARP = 32
SMEM_DEFAULT = 48 * 1024  # a block's shared memory without opting in
SEGMENT_WARPS = 8  # kSegmentWarps of csrc/common.cu
RS_THREADS, RS_COLS, RS_STAGE, RS_BUFS = 128, 4, 32, 2  # readout_sum (center_readout.cu)
LEB_ROWS, LEB_COLS, LEB_TILE_ATOMS = 64, 64, 6  # latent_env_bwd (mega.cu)
LES_GROUPS = 2  # latent_env_scatter's walkers per block (mega.cu)
DESC_COLS = 8  # a path table's columns (mega.cu kDescCols)
_F = 4  # bytes per float


def smem_optin(device) -> Optional[int]:
    """The shared memory a block may opt into on ``device`` (bytes); None on
    the CPU, where the kernels' plain versions run and nothing limits them."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).shared_memory_per_block_optin)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _tile_ld(width: int) -> int:
    return _round_up(width, WARP) + 4


def _rs_floats(K: int, H: int, rows: int) -> int:
    Hr = _round_up(H, WARP)
    o = Hr * _tile_ld(K) + Hr + RS_BUFS * rows * (RS_STAGE + 4) + rows + 4
    return _round_up(o, 4)


def readout_sum_bytes(K: int, H: int, limit: int) -> int:
    """``readout_sum`` on input width K, hidden width H (1 without a hidden
    layer): blocks of 128 threads, then 64, then 32 (``rs_threads``)."""
    threads = RS_THREADS
    while threads > RS_THREADS // 4 and _rs_floats(K, H, threads // RS_COLS * 4) * _F > limit:
        threads //= 2
    return _rs_floats(K, H, threads // RS_COLS * 4) * _F


def _rb_floats(K: int, H: int, rows: int, hidden: bool) -> int:
    Hr, ldK = _round_up(H, WARP), _tile_ld(K)
    o = Hr * ldK + Hr + (rows * ldK if hidden else 0) + _round_up(H, 4) * (rows + 4) + rows
    return _round_up(o, 4)


def readout_bwd_bytes(K: int, H: int, hidden: bool, limit: int) -> int:
    """``readout_bwd``: tiles of 64 edges, then 32, then 16 (``rb_rows``)."""
    rows = 64
    while rows > 16 and _rb_floats(K, H, rows, hidden) * _F > limit:
        rows //= 2
    return _rb_floats(K, H, rows, hidden) * _F


def _les_floats(hidden, K, H, N, d2, U, n_irr, stages, groups) -> int:
    ldK, ldN, ldM = _tile_ld(K), _tile_ld(N), LEB_ROWS + 4
    o = _round_up(H if hidden else N, WARP) * ldK
    o += _round_up(H, 4) * ldN if hidden else 0
    o += _round_up(2 * n_irr, 4) + _round_up(3 * d2 + 1, 4)
    a, lat = stages * LEB_ROWS * ldK, LEB_ROWS * ldN
    g = max(a, lat) if hidden else a + lat
    g += _round_up(H, 4) * ldM if hidden else 0
    g += _round_up(LEB_ROWS * d2, 4) + _round_up(2 * LEB_ROWS + 8, 4) + 2 * _round_up(d2 * U, 4)
    return o + groups * g


def latent_env_scatter_bytes(hidden: bool, K: int, H: int, N: int, d2: int, U: int, n_irr: int,
                             limit: int) -> int:
    """``latent_env_scatter`` on a latent MLP of input width K, hidden width
    H (0 without a hidden layer) and output width N: two walkers a block,
    then one; double-buffered piece rows without a hidden layer, then one
    buffer (``les_fit``)."""
    floats = 0
    for groups in range(LES_GROUPS, 0, -1):
        for stages in range(1 if hidden else 2, 0, -1):
            floats = _les_floats(hidden, K, H, N, d2, U, n_irr, stages, groups)
            if floats * _F <= limit:
                return floats * _F
    return floats * _F


def _leb_floats(hidden, K, H, S, NE, d2, U, n_irr, stages, ta) -> int:
    ldK, ldS, ldE, ldM = _tile_ld(K), _tile_ld(S), _tile_ld(NE), LEB_ROWS + 4
    Hr, Kr, NEr = _round_up(H, LEB_COLS), _round_up(K, LEB_COLS), _round_up(NE, LEB_COLS)
    o = (Hr if hidden else NEr) * ldK + (Hr if hidden else Kr) * (ldS + ldE)
    o += stages * LEB_ROWS * ldK + LEB_ROWS * ldS + LEB_ROWS * ldE
    o += 2 * H * ldM if hidden else 0
    o += _round_up(LEB_ROWS * d2, 4) + ta * _round_up(d2 * U, 4) + LEB_ROWS + 2 * n_irr
    return _round_up(o, 4)


def latent_env_bwd_bytes(hidden: bool, K: int, H: int, S: int, N: int, d2: int, U: int,
                         n_irr: int, limit: int) -> int:
    """``latent_env_bwd``: piece rows double-buffered with 6 staged t rows,
    then fewer t rows (down to 2), then one buffer with 6 down to 0
    (``leb_fit``)."""
    floats = 0
    for stages in (2, 1):
        for ta in range(LEB_TILE_ATOMS, (2 if stages == 2 else 0) - 1, -1):
            floats = _leb_floats(hidden, K, H, S, N - S, d2, U, n_irr, stages, ta)
            if floats * _F <= limit:
                return floats * _F
    return floats * _F


def _fit_warps_bytes(fixed: int, per_warp: int, limit: int) -> int:
    """``fit_warps`` (csrc/common.cu): as many warps as fit in 48 KB, at most
    8; where not one fits there, as many as fit in ``limit``."""
    cap = SMEM_DEFAULT if fixed + per_warp <= SMEM_DEFAULT else limit
    if fixed + per_warp > cap:
        return fixed + per_warp
    return fixed + min((cap - fixed) // per_warp, SEGMENT_WARPS) * per_warp


def _embed_fixed(n_paths: int, n_w: int, U: int, d1: int) -> int:
    return _round_up(n_paths * DESC_COLS + 2 * d1 + n_paths + n_w * U, 4) * _F


def gather_tp_embed_bytes(n_paths, n_w, d_sh, n_irr, d1, d2, d3, U, limit) -> int:
    """``gather_tp_embed``: n_paths path-table rows, n_w path weights, d1
    input rows (``row_specs``)."""
    per_warp = (d2 * _round_up(U, WARP) + 2 * _round_up(n_irr * U + d_sh, 4)
                + (d1 + d3) * WARP) * _F
    return _fit_warps_bytes(_embed_fixed(n_paths, n_w, U, d1), per_warp, limit)


def bwd_embed_bytes(n_paths, n_w, d_sh, n_irr, d1, d2, d3, U, limit) -> int:
    """``bwd_embed``, on the same arguments as ``gather_tp_embed``."""
    edge = _round_up((d3 + 1 + n_irr) * U + d_sh, 4)
    per_warp = (2 * d2 * _round_up(U, WARP) + 2 * edge + (2 * d1 + n_irr) * WARP
                + d_sh * (WARP + 1)) * _F
    return _fit_warps_bytes(_embed_fixed(n_paths, n_w, U, d1), per_warp, limit)
