#!/usr/bin/env python3
"""Smoke run of allegro_tpu_torch on one CUDA GPU: build, check, drive.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):

0. device: the card's name and power limit (``nvidia-smi``);
1. build: compile the CUDA kernels (``allegro_tpu_torch/csrc/*.cu``) with
   nvcc, one process per source, all started together;
2. kernels: on the 4,096-atom periodic crystal (r_max 4.0, seed 0), each
   kernel against its plain PyTorch version at the flagship shapes, bound
   max|err| / max|ref| < 1e-5, with median times from CUDA events: the four
   layer kernels at both layers (U = 32; layer 0 dims (9, 9, 9) with 83 CG
   entries, layer 1 (9, 9, 1) with 9); the mega kernels on the mega model's
   weights: ``latent_env_scatter`` and ``latent_env_bwd`` without a hidden
   layer (the first projection, W0 [64, 160]) and with one (layer 0's latent,
   W0 [96, 64], W1 [64, 160]), ``gather_tp_embed`` with its split output and
   ``bwd_embed`` with ``gts``, and ``gather_tp`` with the split output and
   ``bwd_fused`` with ``gts`` at layer-0 dims; then, checks only, all of
   these at U = 16 and 48 (the lane loops for other widths); the center
   gather and sum on positions [4096, 3] at the center and the neighbor side
   (and, checks only, on the [·, 1] energy column of the plain readout
   chain); the fused readout and its backward on three 64-wide pieces (W0
   [192, 32], w1 [32, 1]);
3. force call: the flagship ``AllegroModel`` (l_max 2, 2 layers, 64 scalar
   and 32 tensor features, random weights from seed 0) on ``fused_infer`` in
   three configurations: ``mega`` (the default ``use_mega=None``: the JAX
   bench's default kwargs), and with ``use_mega=False`` the fused readout
   and the plain readout chain (``use_fused_readout=False``). 5 force calls
   each, with the exact launch count of every kernel asserted after each
   call; outputs finite and in agreement with the port's plain ``einsum``
   backend on the same card (force max-abs rel < 1e-5, per-atom energies
   allclose at 5e-5). Prints µs/atom per force call and the run-to-run
   max |Δforces| of two identical calls;
4. MD and calculator, on the ``mega`` model: ``md.Simulation`` runs 100
   steps (10 blocks) of NVE on the crystal with a skin small enough to
   re-neighbor, asserting finite positions, the exact launch counts of every
   block (each of its force calls), no host synchronization inside a block,
   and agreement within 1e-4 Å with the ``einsum`` backend after the first
   block; prints the energy drift, ms/step and µs/atom per step. Then three
   ``AllegroCalculator.calculate`` calls on jittered copies of the crystal,
   each checked against ``apply_with_derivatives`` and its launch counts;
   the padded buckets must not grow after the first call.

5. training on the trainable ``fused`` backend: (a) on the JAX bench's
   4 x 1,000-atom crystal batch (seeds 200-203, 100,928 edges), the four
   transposes ``tp_scatter``, ``gather_dw`` (each layer's entry table in
   both role orders), ``unweight_sh``, ``unweight_w`` and ``gather_tp`` on
   the role-swapped table, each against its plain version (1e-5) with
   median times, then checks only at U = 16 and 48; (b) on that batch (zero
   targets) and on the bench's 16 synthetic 21-atom frames (984 edges):
   the flagship on ``fused`` through ``Trainer.fit``, Adam 1e-3, EMA 0.999,
   10 steps with the exact launch count of every kernel per step, finite
   losses that fall, ms per step, samples/s, peak memory, the run-to-run
   max |dparam| of two identical 3-step runs, and (1k batch) a
   torch.profiler breakdown of 3 steps; (c) on the first step of each
   batch, the parameter gradients against the ``einsum`` backend from the
   same weights (max-abs error over max-abs < 1e-4 per tensor).

The last two lines of stdout are a JSON object with the kernels' records and
the JSON result ``{"ok": true, "device": {...}}``. A kernel's ``ms`` and
``plain_ms`` sum the device times of its launches in one force call of
``ms_config`` (``mega``, except for the four layer kernels of
``use_mega=False``: ``fused readout``, where all their launches are; for
the trainable backend's four, ``train step``: one launch per layer), and
``launches`` counts their launches in the 5 force calls of that
configuration (the 10 training steps on the 1k batch). ``bound_ms`` is the
least time of the same work on the card (the bytes of the inputs read once
and the outputs written once at 3.35 TB/s, or the FLOPs at 67 TFLOP/s f32,
the larger; ``bound_by`` says which), ``library_ms`` the time of one
PyTorch call computing the same function where there is one (the center
gather and sum), else null. Every configuration and entry point has its own
``launches_*`` key; variants (``[split]``, ``[gts]``, ``[swapped]``) have
their own ``ms_*``, ``plain_ms_*`` and ``bound_ms_*``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_ATOMS = 4096
R_MAX = 4.0
SEED = 0
N_CALLS = 5
KERNEL_TOL = 1e-5
SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's clock: longer than queueing 20 calls
FLAGSHIP = dict(
    r_max=R_MAX,
    type_names=["A", "B", "C"],
    l_max=2,
    parity=True,
    num_layers=2,
    num_scalar_features=64,
    num_tensor_features=32,
    per_type_energy_scales=1.0,
    per_type_energy_shifts=0.0,
    model_dtype="float32",
)
SOURCES = {
    "latent_env_scatter": "allegro_tpu_torch/csrc/mega.cu",
    "latent_env_bwd": "allegro_tpu_torch/csrc/mega.cu",
    "gather_tp_embed": "allegro_tpu_torch/csrc/mega.cu",
    "bwd_embed": "allegro_tpu_torch/csrc/mega.cu",
    "env_scatter": "allegro_tpu_torch/csrc/fused_tp.cu",
    "gather_tp": "allegro_tpu_torch/csrc/fused_tp.cu",
    "bwd_fused": "allegro_tpu_torch/csrc/fused_tp.cu",
    "unweight_both": "allegro_tpu_torch/csrc/fused_tp.cu",
    "center_gather": "allegro_tpu_torch/csrc/center_readout.cu",
    "center_sum": "allegro_tpu_torch/csrc/center_readout.cu",
    "readout_sum": "allegro_tpu_torch/csrc/center_readout.cu",
    "readout_bwd": "allegro_tpu_torch/csrc/center_readout.cu",
    "tp_scatter": "allegro_tpu_torch/csrc/train_tp.cu",
    "gather_dw": "allegro_tpu_torch/csrc/train_tp.cu",
    "unweight_sh": "allegro_tpu_torch/csrc/train_tp.cu",
    "unweight_w": "allegro_tpu_torch/csrc/train_tp.cu",
}
REPLACES = {
    "latent_env_scatter": "allegro_tpu/ops/fused_tp.py:1701",
    "latent_env_bwd": "allegro_tpu/ops/fused_tp.py:1966",
    "gather_tp_embed": "allegro_tpu/ops/fused_tp.py:603",
    "bwd_embed": "allegro_tpu/ops/fused_tp.py:683",
    "env_scatter": "allegro_tpu/ops/fused_tp.py:1091",
    # the port keeps one env array: _gather_tp_kernel (kernel 13, combined
    # env, and its x-transpose on the swapped table) is the same function
    "gather_tp": "allegro_tpu/ops/fused_tp.py:500, allegro_tpu/ops/fused_tp.py:451",
    "bwd_fused": "allegro_tpu/ops/fused_tp.py:1340",
    "unweight_both": "allegro_tpu/ops/fused_tp.py:1455",
    "center_gather": "allegro_tpu/ops/fused_tp.py:1043",
    "center_sum": "allegro_tpu/ops/fused_tp.py:991",
    "readout_sum": "allegro_tpu/ops/fused_tp.py:1794",
    "readout_bwd": "allegro_tpu/ops/fused_tp.py:1873",
    "tp_scatter": "allegro_tpu/ops/fused_tp.py:835",
    "gather_dw": "allegro_tpu/ops/fused_tp.py:907",
    "unweight_sh": "allegro_tpu/ops/fused_tp.py:1159",
    "unweight_w": "allegro_tpu/ops/fused_tp.py:1588",
}
# TPU kernels (ROADMAP.md queue 2) that each wrapper serves
SERVES = {"env_scatter": [1], "gather_tp": [2, 13], "bwd_fused": [3], "unweight_both": [4],
          "center_gather": [5], "center_sum": [6], "latent_env_scatter": [7],
          "latent_env_bwd": [8], "gather_tp_embed": [9], "bwd_embed": [10], "readout_sum": [11],
          "readout_bwd": [12], "tp_scatter": [14], "gather_dw": [15], "unweight_sh": [16],
          "unweight_w": [17]}
TRAIN_KERNELS = ("tp_scatter", "gather_dw", "unweight_sh", "unweight_w")
# launches per force call of the 2-layer flagship on fused_infer. All
# configurations: the two position gathers (center and neighbor side) and
# their transposes, the two force scatters. mega: the first projection and
# layer 0's latent are each one latent_env_scatter (and one latent_env_bwd);
# layer 0's TP is gather_tp_embed / bwd_embed, layer 1's gather_tp /
# bwd_fused; the fused readout and its backward once each. use_mega=False:
# each of the four layer kernels once per layer. The plain readout chain sums
# the per-edge energies with center_sum instead, and its backward gathers the
# per-atom cotangent back to the edges with center_gather: one more launch of
# each, none of the readout.
LAYER_KERNELS = ("env_scatter", "gather_tp", "bwd_fused", "unweight_both")
_NO_MEGA = {"latent_env_scatter": 0, "latent_env_bwd": 0, "gather_tp_embed": 0, "bwd_embed": 0}
_NO_TRAIN = {name: 0 for name in TRAIN_KERNELS}
PER_CALL = {
    "mega": {"latent_env_scatter": 2, "latent_env_bwd": 2, "gather_tp_embed": 1, "bwd_embed": 1,
             "env_scatter": 0, "gather_tp": 1, "bwd_fused": 1, "unweight_both": 0,
             "center_gather": 2, "center_sum": 2, "readout_sum": 1, "readout_bwd": 1,
             **_NO_TRAIN},
    "fused readout": {**_NO_MEGA, "env_scatter": 2, "gather_tp": 2, "bwd_fused": 2,
                      "unweight_both": 2, "center_gather": 2, "center_sum": 2, "readout_sum": 1,
                      "readout_bwd": 1, **_NO_TRAIN},
    "plain readout": {**_NO_MEGA, "env_scatter": 2, "gather_tp": 2, "bwd_fused": 2,
                      "unweight_both": 2, "center_gather": 3, "center_sum": 3, "readout_sum": 0,
                      "readout_bwd": 0, **_NO_TRAIN},
}
# launches per training step of the 2-layer flagship on `fused` (energy +
# force loss, its gradient in the parameters). Forward: per layer one
# env_scatter and one gather_tp; the two position gathers (center_gather);
# the edge-energy sum (center_sum). Force backward (create_graph): the
# energy sum's transpose (center_gather); per layer GatherTp's three
# transposes (gather_tp on the swapped table, tp_scatter, gather_dw; the
# forces never read that dw, but needs_input_grad is fixed at forward time)
# and EnvScatter's two (unweight_sh, unweight_w); the position gathers'
# transposes (2 center_sum). Parameter backward, per layer: GatherTp of the
# forward again (gather_tp, tp_scatter, gather_dw), the force backward's
# GatherTp on the swapped table (the same three on swapped tables) and its
# TpScatter (two gather_tp, one gather_dw); EnvScatter again (unweight_sh,
# unweight_w), the force backward's UnweightSh (env_scatter, unweight_w) and
# UnweightW (env_scatter, unweight_sh); the energy sum's transpose and the
# force backward's two center_sum, one center_gather each. Per step: 3 L
# env_scatter, 6 L gather_tp, 3 L tp_scatter, 4 L gather_dw (L of them
# unused), 3 L unweight_sh, 3 L unweight_w (L = 2 layers), 6 center_gather
# and 3 center_sum.
PER_STEP = {**{name: 0 for name in PER_CALL["mega"]},
            "env_scatter": 6, "gather_tp": 12, "tp_scatter": 6, "gather_dw": 8,
            "unweight_sh": 6, "unweight_w": 6, "center_gather": 6, "center_sum": 3}
MD_BLOCKS = 10
MD_STEPS_PER_BLOCK = 10
MD = dict(masses=[1.0, 1.0, 1.0], r_max=R_MAX, dt=0.01, skin=0.2,
          steps_per_block=MD_STEPS_PER_BLOCK, edge_multiple=1024)
MD_KT = 0.01
MD_TOL = 1e-4
CALC_JITTER = 0.01
CALC_SEED = 100
# the card's published peaks (H100 SXM data sheet): what bound_ms divides by
HBM_BYTES_PER_MS = 3.35e9
F32_FLOPS_PER_MS = 67e9
# phase 5: the JAX bench's training batches (allegro_tpu/bench.py:588-680)
TRAIN_SEEDS = (200, 201, 202, 203)
TRAIN_ATOMS = 1000
MOL_FRAMES, MOL_ATOMS, MOL_SPREAD = 16, 21, 3.0
TRAIN_STEPS = 10
TRAIN_REPEAT_STEPS = 3
GRAD_TOL = 1e-4


def crystal_frame(n_atoms, r_max, seed):
    """The JAX bench's crystal (allegro_tpu/bench.py:_crystal_frame): a
    jittered simple-cubic lattice, spacing 2.2, three random types."""
    from allegro_tpu_torch.data import keys, neighbor_list

    rng = np.random.RandomState(seed)
    side = int(round(n_atoms ** (1 / 3)))
    n_atoms = side**3
    spacing = 2.2
    grid = (
        np.stack(np.meshgrid(*(np.arange(side),) * 3, indexing="ij"), axis=-1)
        .reshape(-1, 3)
        .astype(np.float64)
    )
    frame = {
        keys.POSITIONS: grid * spacing + 0.1 * rng.randn(n_atoms, 3),
        keys.ATOM_TYPES: rng.randint(0, 3, n_atoms).astype(np.int32),
        keys.CELL: np.eye(3) * (side * spacing),
        keys.PBC: np.ones(3, dtype=bool),
    }
    return neighbor_list(frame, r_max), n_atoms


def median_ms(fn, reps=20, runs=5, warmup=3):
    """Device time of one call of ``fn``, in ms: ``reps`` calls queued behind
    a sleep kernel (so the device runs them back to back, without waiting
    for the host to launch them) between two CUDA events; the median of
    ``runs`` such batches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def rel_err(got, ref):
    err = (got.double() - ref.double()).abs().max().item()
    scale = max(ref.double().abs().max().item(), 1e-30)
    return err, err / scale


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def check_kernels(tps, data, rng, records=None):
    """Phase 2: each kernel against its plain version at the layers' shapes;
    with ``records``, also the median times, accumulated there."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    dev = data[keys.POSITIONS].device
    centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
    row_ptr = data[keys.CENTER_ROW_PTR]
    n_atoms = row_ptr.shape[0] - 1
    real = data[keys.EDGE_MASK].to(torch.float32)[:, None]
    E = centers.shape[0]
    Er = int(data[keys.EDGE_MASK].sum())  # the edges whose work the bounds count

    def rand(*shape, edge=True):
        t = torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)
        return t * real if edge else t

    for layer, tp in enumerate(tps):
        U, d1, d2, d3 = tp.mul, tp.d1, tp.d2, tp.d3
        n_irr = int(tp.dim_to_irr.max().item()) + 1
        idx, coef, d2i = tp.entry_idx, tp.entry_coef.to(torch.float32), tp.dim_to_irr
        x, sh, wexp, g = rand(E, d1 * U), rand(E, d2), rand(E, n_irr * U), rand(E, d3 * U)
        w = rand(tp.num_paths, U, edge=False)
        env = fused_tp.env_scatter(sh, wexp, centers, row_ptr, d2i, U)
        t = rand(n_atoms, d2 * U, edge=False)
        n = idx.shape[0]
        tables = (idx, coef, d2i)
        # (kernel, plain version, inputs read, FLOPs): a CG entry costs 3 per
        # edge and channel (c*w formed once; x*env, then the multiply-add)
        cases = {
            "env_scatter": (
                lambda: (fused_tp.env_scatter(sh, wexp, centers, row_ptr, d2i, U),),
                lambda: (fused_tp.env_scatter_reference(sh, wexp, centers, n_atoms, d2i, U),),
                (sh, wexp, row_ptr, d2i), 2 * Er * d2 * U,
            ),
            "gather_tp": (
                lambda: (fused_tp.gather_tp(x, env, w, centers, idx, coef, d3),),
                lambda: (fused_tp.gather_tp_reference(x, env, w, centers, idx, coef, d3),),
                (x, env, w, centers, *tables), 3 * Er * n * U,
            ),
            "bwd_fused": (
                lambda: fused_tp.bwd_fused(x, g, env, w, centers, row_ptr, idx, coef),
                lambda: fused_tp.bwd_fused_reference(x, g, env, w, centers, n_atoms, idx, coef),
                (x, g, env, w, row_ptr, *tables), 6 * Er * n * U,
            ),
            "unweight_both": (
                lambda: fused_tp.unweight_both(t, sh, wexp, centers, d2i),
                lambda: fused_tp.unweight_both_reference(t, sh, wexp, centers, d2i),
                (t, sh, wexp, centers, d2i), 4 * Er * d2 * U,
            ),
        }
        for name, (kernel, plain, reads, flops) in cases.items():
            label = f"U {U} layer {layer} dims ({d1},{d2},{d3}) entries {n:3d}"
            check_case(name, kernel, plain, label, records, reads, flops)


def check_case(name, kernel, plain, label, records=None, reads=(), flops=0, library=None):
    """One kernel call against its plain version (max|err| / max|ref| <
    KERNEL_TOL); with ``records``, also their median times, accumulated
    there under ``name`` (a kernel name, or ``kernel[variant]``), with the
    work the bound counts: the bytes of ``reads`` (each input read once) and
    of the outputs (each written once), and ``flops``. ``library``: one
    PyTorch call computing the same function, timed beside them."""
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    errs = [rel_err(a, b) for a, b in zip(got, ref)]
    abs_err = max(e[0] for e in errs)
    rel = max(e[1] for e in errs)
    ok = rel < KERNEL_TOL
    print(f"  {label} {name:18s} max_abs_err {abs_err:.3e} rel {rel:.3e} (< {KERNEL_TOL}) "
          f"{'ok' if ok else 'FAIL'}", end="")
    if not ok:
        print()
        raise AssertionError(f"{name} ({label}) disagrees with its plain version")
    if records is None:
        print()
        return
    ms, plain_ms = median_ms(kernel), median_ms(plain)
    work = nbytes(*reads, *got)
    bound_ms, bound_by = bound(work, flops)
    print(f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})",
          end="")
    rec = records.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                    "bytes": 0, "flops": 0, "library_ms": None})
    rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
    rec["ms"] += ms
    rec["plain_ms"] += plain_ms
    rec["bytes"] += work
    rec["flops"] += flops
    if library is not None:
        lib_ms = median_ms(library)
        rec["library_ms"] = (rec["library_ms"] or 0.0) + lib_ms
        print(f"  library {lib_ms:.4f} ms", end="")
    print()


def bound(n_bytes, flops):
    """The least time (ms) of the work on the card and what binds it: the
    bytes at the memory rate or the FLOPs at the f32 rate, the larger."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_MS, flops / F32_FLOPS_PER_MS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_mega_kernels(allegro, data, rng, records=None):
    """Phase 2: the mega kernels and the split / gts variants of kernels 2
    and 3 against their plain versions, on the mega model's weights at the
    force call's shapes; with ``records``, also the median times, summed
    over the launches of one force call (the variants under their own
    keys). Pieces and g_lat have nonzero rows on the sentinel edges too."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    dev = data[keys.POSITIONS].device
    centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
    row_ptr = data[keys.CENTER_ROW_PTR]
    n_atoms = row_ptr.shape[0] - 1
    E = centers.shape[0]
    Er = int(data[keys.EDGE_MASK].sum())
    S, U = allegro.S, allegro.U
    tp = allegro.tps[0]
    d2i, specs = tp.dim_to_irr, allegro.row_specs
    n_irr = int(max(allegro.env_weighter.dim_to_irr)) + 1

    def rand(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)

    sh, emb, ts = rand(E, tp.d2), rand(E, S), rand(E, U)
    t, g_lat = rand(n_atoms, tp.d2 * U), rand(E, S)
    (w_proj,) = allegro.first_projection.weights()
    w0, w1 = allegro.latents[0].weights()
    label = f"U {U} E {E}"
    for pieces, a, b in (((emb,), w_proj.detach(), None),
                         ((emb, ts), w0.detach(), w1.detach())):
        what = f"{label} W0 {list(a.shape)}" + ("" if b is None else f" W1 {list(b.shape)}")
        # the MLP runs on every edge (sentinels too), the env work on real ones
        mlp = a.shape[0] * a.shape[1] + (0 if b is None else b.shape[0] * b.shape[1])
        env_flops = 2 * Er * tp.d2 * U
        check_case("latent_env_scatter",
                   lambda: fused_tp.latent_env_scatter(pieces, sh, a, b, row_ptr, d2i, U, S),
                   lambda: fused_tp.latent_env_scatter_reference(pieces, sh, a, b, row_ptr, d2i,
                                                                 U, S), what, records,
                   (*pieces, sh, a, b, row_ptr, d2i), 2 * E * mlp + env_flops)
        check_case("latent_env_bwd",
                   lambda: _flat(fused_tp.latent_env_bwd(pieces, sh, a, b, t, g_lat, centers,
                                                         d2i, U, S)),
                   lambda: _flat(fused_tp.latent_env_bwd_reference(pieces, sh, a, b, t, g_lat,
                                                                   centers, d2i, U, S)),
                   what, records, (*pieces, sh, a, b, t, g_lat, centers, d2i),
                   4 * E * mlp + 2 * env_flops)
    wk, idx, coef = (v.detach() for v in tp.fused_infer_parts(torch.float32))
    d1, d2, d3 = tp.d1, tp.d2, tp.d3
    w2b, env = rand(E, n_irr * U), rand(n_atoms, d2 * U)
    x, g, gts = rand(E, d1 * U), rand(E, d3 * U), rand(E, U)
    what = f"{label} dims ({d1},{d2},{d3}) entries {idx.shape[0]}"
    tp_flops = 3 * Er * idx.shape[0] * U
    check_case("gather_tp_embed",
               lambda: fused_tp.gather_tp_embed(sh, w2b, env, wk, centers, idx, coef, specs, d3,
                                                True),
               lambda: fused_tp.gather_tp_embed_reference(sh, w2b, env, wk, centers, idx, coef,
                                                          specs, d3, True), what, records,
               (sh, w2b, env, wk, centers, idx, coef, specs), tp_flops + Er * d1 * U)
    check_case("bwd_embed",
               lambda: fused_tp.bwd_embed(sh, w2b, g, env, wk, centers, row_ptr, idx, coef,
                                          specs, gts),
               lambda: fused_tp.bwd_embed_reference(sh, w2b, g, env, wk, centers, n_atoms, idx,
                                                    coef, specs, gts), what, records,
               (sh, w2b, g, gts, env, wk, row_ptr, idx, coef, specs),
               2 * tp_flops + 4 * Er * d1 * U)
    check_case("gather_tp[split]",
               lambda: fused_tp.gather_tp(x, env, wk, centers, idx, coef, d3, True),
               lambda: fused_tp.gather_tp_reference(x, env, wk, centers, idx, coef, d3, True),
               what, records, (x, env, wk, centers, idx, coef), tp_flops)
    check_case("bwd_fused[gts]",
               lambda: fused_tp.bwd_fused(x, g, env, wk, centers, row_ptr, idx, coef, gts),
               lambda: fused_tp.bwd_fused_reference(x, g, env, wk, centers, n_atoms, idx, coef,
                                                    gts), what, records,
               (x, g, gts, env, wk, row_ptr, idx, coef), 2 * tp_flops + Er * U)


def _flat(res):
    """(dsh, (dp_0, dp_1, ...)) → (dsh, dp_0, dp_1, ...)."""
    return (res[0], *res[1])


def check_center_readout(data, rng, records):
    """Phase 2, second part: the center gather and sum and the fused readout
    at the force call's shapes, summed over the launches of one call. Beside
    the center kernels, the one PyTorch call that computes the same function
    (``index_select`` on the table with a zero row for the sentinel,
    ``index_add_``) is timed; the port never calls it."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    dev = data[keys.POSITIONS].device
    ei = data[keys.EDGE_INDEX].to(torch.int32)
    centers, neighbors = ei[0].contiguous(), ei[1].contiguous()
    row_ptr = data[keys.CENTER_ROW_PTR]
    nbr = (data[keys.NBR_ROW_PTR], data[keys.NBR_PERM])
    n_atoms = row_ptr.shape[0] - 1
    real = data[keys.EDGE_MASK].to(torch.float32)[:, None]
    E = centers.shape[0]
    Er = int(data[keys.EDGE_MASK].sum())

    def rand(*shape, edge=True):
        t = torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)
        return t * real if edge else t

    pos = data[keys.POSITIONS].contiguous()
    for width, timed in ((3, True), (1, False)):
        a = pos if width == 3 else rand(n_atoms, 1, edge=False)
        v = rand(E, width)
        rec = records if timed else None
        a_pad = torch.cat([a, a.new_zeros((1, width))])  # the sentinel's zero row
        for side, idx, (rp, perm) in (("center", centers, (row_ptr, None)),
                                      ("neighbor", neighbors, nbr)):
            label = f"[{n_atoms}, {width}] <-> [{E}, {width}] {side:8s}"
            idx_l = idx.long()
            acc = a.new_zeros((n_atoms + 1, width))
            check_case("center_gather",
                       lambda: (fused_tp.center_gather(a, idx),),
                       lambda: (fused_tp.center_gather_reference(a, idx),), label, rec,
                       (a, idx), 0, lambda: a_pad.index_select(0, idx_l))
            check_case("center_sum",
                       lambda: (fused_tp.center_sum(v, rp, perm),),
                       lambda: (fused_tp.center_sum_reference(v, rp, perm),), label, rec,
                       (v, rp, perm), Er * width, lambda: acc.index_add_(0, idx_l, v))
            if width == 1:  # the plain readout chain sums on the center side only
                break
    S, H = FLAGSHIP["num_scalar_features"], 32
    K = S * (FLAGSHIP["num_layers"] + 1)
    # the scalar track's pieces are column slices of the layers' MLP outputs
    wide = [rand(E, S + 96), rand(E, S + 96), rand(E, S)]
    pieces = [w[:, :S] for w in wide]
    w0 = rand(K, H, edge=False) / K**0.5
    w1 = rand(H, 1, edge=False) / H**0.5
    y = rand(n_atoms, 1, edge=False)
    label = f"pieces 3 x [{E}, {S}] W0 [{K}, {H}]"
    check_case("readout_sum",
               lambda: (fused_tp.readout_sum(pieces, w0, w1, row_ptr),),
               lambda: (fused_tp.readout_sum_reference(pieces, w0, w1, row_ptr),),
               label, records, (*pieces, w0, w1, row_ptr), 2 * Er * (K * H + H))
    check_case("readout_bwd",
               lambda: fused_tp.readout_bwd(pieces, w0, w1, y, centers),
               lambda: fused_tp.readout_bwd_reference(pieces, w0, w1, y, centers),
               label, records, (*pieces, w0, w1, y, centers), 2 * Er * (2 * K * H + H))


def check_train_kernels(tps, data, rng, records=None):
    """Phase 5a: the trainable backend's transposes against their plain
    versions at the training batch's shapes, each layer's table in both role
    orders (the swapped one under ``kernel[swapped]``), and ``gather_tp`` on
    the swapped table; with ``records``, also the median times (one launch per
    layer and order, summed). Per-edge inputs are zero on sentinel edges,
    per-atom ones (env, t) are not."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp
    from allegro_tpu_torch.ops.fused_primitives import FusedStatics

    dev = data[keys.POSITIONS].device
    centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
    row_ptr = data[keys.CENTER_ROW_PTR]
    n_atoms = row_ptr.shape[0] - 1
    real = data[keys.EDGE_MASK].to(torch.float32)[:, None]
    E = centers.shape[0]
    Er = int(data[keys.EDGE_MASK].sum())

    def rand(*shape, edge=True):
        t = torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)
        return t * real if edge else t

    for layer, tp in enumerate(tps):
        U = tp.mul
        _, idx, coef = (v.detach() for v in tp.fused_infer_parts(torch.float32))
        d2i = tp.dim_to_irr
        st = FusedStatics(centers, row_ptr, d2i, tp.n_irr, U, idx, tp.entry_swapped, coef,
                          tp.num_paths, (tp.d1, tp.d2, tp.d3))
        n = idx.shape[0]
        t, sh, wexp = rand(n_atoms, tp.d2 * U, edge=False), rand(E, tp.d2), rand(E, tp.n_irr * U)
        label = f"U {U} layer {layer} dims {st.dims} entries {n:3d}"
        check_case("unweight_sh", lambda: (fused_tp.unweight_sh(t, wexp, centers, d2i),),
                   lambda: (fused_tp.unweight_sh_reference(t, wexp, centers, d2i),), label,
                   records, (t, wexp, centers, d2i), 2 * Er * tp.d2 * U)
        check_case("unweight_w", lambda: (fused_tp.unweight_w(t, sh, centers, d2i, tp.n_irr),),
                   lambda: (fused_tp.unweight_w_reference(t, sh, centers, d2i, tp.n_irr),),
                   label, records, (t, sh, centers, d2i), 2 * Er * tp.d2 * U)
        for tag, s in (("", st), ("[swapped]", st.swap())):
            d1, d2, d3 = s.dims
            x, g = rand(E, d1 * U), rand(E, d3 * U)
            env, w = rand(n_atoms, d2 * U, edge=False), rand(s.n_paths, U, edge=False)
            tab = (s.entry_idx, coef)
            label = f"U {U} layer {layer} dims {s.dims} entries {n:3d}"
            check_case("tp_scatter" + tag,
                       lambda: (fused_tp.tp_scatter(x, g, w, centers, row_ptr, *tab, d2),),
                       lambda: (fused_tp.tp_scatter_reference(x, g, w, centers, n_atoms, *tab,
                                                              d2),),
                       label, records, (x, g, w, row_ptr, *tab), 3 * Er * n * U)
            # a CG entry's dw term: x*env, *g, then the multiply-add with c
            check_case("gather_dw" + tag,
                       lambda: (fused_tp.gather_dw(x, env, g, centers, *tab, s.n_paths, U),),
                       lambda: (fused_tp.gather_dw_reference(x, env, g, centers, *tab,
                                                             s.n_paths, U),),
                       label, records, (x, env, g, centers, *tab), 4 * Er * n * U)
            if tag:
                check_case("gather_tp" + tag,
                           lambda: (fused_tp.gather_tp(x, env, w, centers, *tab, d3),),
                           lambda: (fused_tp.gather_tp_reference(x, env, w, centers, *tab, d3),),
                           label, records, (x, env, w, centers, *tab), 3 * Er * n * U)


def train_loaders():
    """The JAX bench's training batches (``run_train_bench_1k`` and
    ``run_train_bench``, allegro_tpu/bench.py:588-680): four 1,000-atom
    crystals (seeds 200-203) with zero energy and force targets, and 16
    synthetic 21-atom molecular frames (spread 3.0) with their labels, each
    one batch, r_max 4.0."""
    from allegro_tpu_torch.data import (DataLoader, InMemoryDataset, keys,
                                        synthetic_molecular_frames)

    crystals = []
    for seed in TRAIN_SEEDS:
        frame, _ = crystal_frame(TRAIN_ATOMS, R_MAX, seed)
        crystals.append({**frame, keys.TOTAL_ENERGY: np.zeros(1),
                         keys.FORCES: np.zeros_like(frame[keys.POSITIONS])})
    mols = synthetic_molecular_frames(MOL_FRAMES, n_atoms=MOL_ATOMS, spread=MOL_SPREAD)
    return {"1k": DataLoader(InMemoryDataset(crystals, R_MAX), batch_size=len(crystals)),
            "21": DataLoader(InMemoryDataset(mols, R_MAX), batch_size=MOL_FRAMES)}


def train_models(batch_np):
    """The flagship on ``fused`` (random weights from SEED) and its ``einsum``
    twin with the same weights, for one training batch."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.model import AllegroModel

    avg_n = float(batch_np[keys.EDGE_MASK].sum()) / float(batch_np[keys.NODE_MASK].sum())
    fused = AllegroModel(**FLAGSHIP, avg_num_neighbors=avg_n,
                         tp_kernel_backend="fused").init(SEED)
    einsum = AllegroModel(**FLAGSHIP, avg_num_neighbors=avg_n, tp_kernel_backend="einsum")
    einsum.load_state_dict(fused.state_dict())
    return fused, einsum


def make_trainer(model, dev):
    """Adam at 1e-3 and EMA 0.999 with the trainer's default loss: per-atom
    energy and force MSE (the reference tutorial's). The bench's total-energy
    MSE grows with the frame size: on zero targets, Adam's first steps (each
    parameter moves by about the learning rate) overshoot it."""
    from allegro_tpu_torch.train import Trainer

    return Trainer(model, learning_rate=1e-3, ema_decay=0.999, device=dev,
                   logger=lambda s: None)


def peak_mib():
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**20


def run_training(loaders, dev, smi):
    """Phase 5b/5c on each batch: the gradient agreement of ``fused`` with
    ``einsum`` on the first step (5c), then TRAIN_STEPS Adam steps through
    ``Trainer.fit`` with the launch counts of every step (5b), two identical
    runs of TRAIN_REPEAT_STEPS steps, and (1k batch) a torch.profiler trace
    of 3 steps. Returns the launches of each batch's TRAIN_STEPS steps."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    launches = {}
    for name, loader in loaders.items():
        batch_np = next(iter(loader))
        n_atoms, n_edges = int(batch_np[keys.NODE_MASK].sum()), int(batch_np[keys.EDGE_MASK].sum())
        fused, einsum = train_models(batch_np)
        init = {k: v.clone() for k, v in fused.state_dict().items()}
        what = f"{name}: {loader.batch_size} frames, {n_atoms} atoms, {n_edges} edges"
        # 5c: the parameter gradients of the first step, fused against einsum
        grads, peaks = {}, {}
        for backend, model in (("fused", fused), ("einsum", einsum)):
            trainer = make_trainer(model, dev)
            state = trainer.init_state()
            data = trainer.to_device(batch_np)
            torch.cuda.reset_peak_memory_stats()
            _, _, grads[backend] = trainer.loss_and_grads(state, data)
            peaks[backend] = peak_mib()
        ratios = {k: ((g - grads["einsum"][k]).abs().max() / grads["einsum"][k].abs().max()).item()
                  for k, g in grads["fused"].items()}
        worst = max(ratios, key=ratios.get)
        print(f"[5c] {what}: parameter gradients fused vs einsum, worst max-abs err / max-abs "
              f"{ratios[worst]:.3e} ({worst}; < {GRAD_TOL}); peak of one step's gradient: "
              f"fused {peaks['fused']:.1f} MiB, einsum {peaks['einsum']:.1f} MiB")
        if not ratios[worst] < GRAD_TOL:
            raise AssertionError(f"{name}: fused vs einsum gradient of {worst}: "
                                 f"{ratios[worst]:.3e}")
        del grads, einsum
        torch.cuda.empty_cache()
        # 5b: TRAIN_STEPS steps, one per fit call (the loader is one batch)
        trainer = make_trainer(fused, dev)
        state = trainer.init_state()
        totals = {k: 0 for k in PER_STEP}
        times = []
        torch.cuda.reset_peak_memory_stats()
        for step in range(TRAIN_STEPS):
            fused_tp.reset_launch_counts()
            t0 = time.perf_counter()
            trainer.fit(state, loader, max_epochs=1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if fused_tp.LAUNCHES != PER_STEP:
                raise AssertionError(f"{name} step {step}: launches {fused_tp.LAUNCHES}, "
                                     f"expected {PER_STEP}")
            for k, c in fused_tp.LAUNCHES.items():
                totals[k] += c
        peak = peak_mib()
        losses = [h["train_loss"] for h in trainer.history]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"{name}: losses {losses} are not finite or did not fall")
        ms = 1e3 * float(np.median(times[1:]))
        print(f"[5b] {what}: {TRAIN_STEPS} Adam steps on fused, loss {losses[0]:.6e} -> "
              f"{losses[-1]:.6e}; launches per step "
              f"{ {k: c for k, c in PER_STEP.items() if c} }")
        print(f"    {ms:.3f} ms/step (median of steps 2-{TRAIN_STEPS}, host clock, statics and "
              f"upload included), {loader.batch_size / ms * 1e3:.2f} samples/s, peak "
              f"{peak:.1f} MiB; {smi}")
        launches[name] = totals
        # two identical runs from the same weights
        runs = []
        for _ in range(2):
            fused.load_state_dict(init)
            again = make_trainer(fused, dev)
            s = again.fit(again.init_state(), loader, max_epochs=TRAIN_REPEAT_STEPS)
            runs.append({k: v.detach().clone() for k, v in s.params.items()})
        delta = max((runs[0][k] - runs[1][k]).abs().max().item() for k in runs[0])
        print(f"    max |dparam| of two identical runs of {TRAIN_REPEAT_STEPS} steps: {delta:.3e}")
        if name == "1k":
            profile_steps(again, s, loader)
    return launches


def profile_steps(trainer, state, loader, steps=3):
    """Where a training step's time goes: torch.profiler over ``steps`` steps,
    device time by kernel name and the device's idle share of the span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.fit(state, loader, max_epochs=steps)
        torch.cuda.synchronize()
        span_ms = 1e3 * (time.perf_counter() - t0)
    # device events only; a user annotation (Optimizer.step) spans kernels
    # that are counted on their own
    rows = [(e.self_device_time_total / 1e3 / steps, e.count / steps, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    busy = sum(r[0] for r in rows)
    if not rows:
        print("    profile: torch.profiler recorded no device time")
        return
    print(f"    profile of {steps} steps (1k batch): {sum(r[1] for r in rows):.0f} device ops "
          f"and {busy:.4f} ms device time per step, span {span_ms / steps:.4f} ms per step "
          f"(profiled), idle {100 * (1 - busy * steps / span_ms):.1f}%; per step by name:")
    for ms, count, key in sorted(rows, reverse=True)[:16]:
        print(f"      {ms:9.4f} ms {count:6.1f}x  {key[:90]}")


def time_force_call(model, data, n_atoms, reps=10):
    for _ in range(2):
        model.apply_with_derivatives(data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        model.apply_with_derivatives(data)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps / n_atoms * 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from allegro_tpu_torch.data import batch_frames, keys, to_torch
    from allegro_tpu_torch.model import AllegroModel
    from allegro_tpu_torch.ops import _build, fused_tp

    # phase 0: device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[0] device {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)

    # phase 1: build
    t0 = time.perf_counter()
    so = _build.build_library()
    _build.load_library()
    print(f"[1] built {so.name} in {time.perf_counter() - t0:.1f} s")
    log = so.with_suffix(".log")
    if log.exists():
        print(log.read_text().strip(), file=sys.stderr)

    # phase 2: kernels at the slice's shapes
    frame, n_atoms = crystal_frame(N_ATOMS, R_MAX, SEED)
    n_edges = frame[keys.EDGE_INDEX].shape[1]
    print(f"[2] crystal: {n_atoms} atoms, {n_edges} edges ({n_edges / n_atoms:.2f}/atom)")
    batch_np = batch_frames([frame], n_frames=1)
    fused = AllegroModel(
        **FLAGSHIP, avg_num_neighbors=n_edges / n_atoms, tp_kernel_backend="fused_infer",
        use_mega=False, use_fused_readout=False,
    ).init(SEED).to(dev)
    data = to_torch(fused.precompute_statics(batch_np), dtype=torch.float32, device=dev)
    mega = AllegroModel(
        **FLAGSHIP, avg_num_neighbors=n_edges / n_atoms, tp_kernel_backend="fused_infer",
    ).to(dev)
    mega.load_state_dict(fused.state_dict())
    if not mega.module.allegro.mega:
        raise AssertionError("the default fused_infer model does not take the mega path")
    records = {}
    rng = np.random.RandomState(SEED)
    check_kernels(fused.module.allegro.tps, data, rng, records)
    check_mega_kernels(mega.module.allegro, data, rng, records)
    for U in (16, 48):
        other = AllegroModel(
            **{**FLAGSHIP, "num_tensor_features": U}, avg_num_neighbors=n_edges / n_atoms,
            tp_kernel_backend="fused_infer",
        ).init(SEED).to(dev)
        check_kernels(other.module.allegro.tps, data, rng)
        check_mega_kernels(other.module.allegro, data, rng)

    check_center_readout(data, rng, records)

    # phase 3: the force call — 5 calls per configuration through the kernels
    fused_ro = AllegroModel(
        **FLAGSHIP, avg_num_neighbors=n_edges / n_atoms, tp_kernel_backend="fused_infer",
        use_mega=False,
    ).to(dev)
    fused_ro.load_state_dict(fused.state_dict())
    einsum = AllegroModel(
        **FLAGSHIP, avg_num_neighbors=n_edges / n_atoms, tp_kernel_backend="einsum"
    ).to(dev)
    einsum.load_state_dict(fused.state_dict())
    einsum_data = to_torch(einsum.precompute_statics(batch_np), dtype=torch.float32, device=dev)
    ref = einsum.apply_with_derivatives(einsum_data)
    us = {}
    launches = {}
    for config, model in (("mega", mega), ("fused readout", fused_ro), ("plain readout", fused)):
        model.apply_with_derivatives(data)
        torch.cuda.synchronize()
        fused_tp.reset_launch_counts()
        for call in range(1, N_CALLS + 1):
            out = model.apply_with_derivatives(data)
            want = {k: n * call for k, n in PER_CALL[config].items()}
            if fused_tp.LAUNCHES != want:
                raise AssertionError(f"{config}, force call {call}: launches "
                                     f"{fused_tp.LAUNCHES}, expected {want}")
        torch.cuda.synchronize()
        launches[config] = dict(fused_tp.LAUNCHES)
        print(f"[3] {N_CALLS} force calls on fused_infer, {config}; launches {launches[config]}")
        check_force_call(out, ref, n_atoms, batch_np[keys.POSITIONS].shape[0])
        again = model.apply_with_derivatives(data)
        drift = (again[keys.FORCES] - out[keys.FORCES]).abs().max().item()
        print(f"    run-to-run max |dforces| of two identical calls {drift:.3e}")
        us[config] = time_force_call(model, data, n_atoms)
    us["einsum"] = time_force_call(einsum, einsum_data, n_atoms)
    print("    force call: " + ", ".join(f"{k} {v:.3f} us/atom" for k, v in us.items())
          + f" ({n_atoms} atoms, f32; {smi})")

    # phase 4: the MD and calculator entry points, on the mega model
    md_launches = run_md(mega, einsum, frame, n_atoms, dev, smi)
    calc_launches = run_calculator(mega, frame, n_atoms, dev)

    # phase 5: training on the trainable `fused` backend
    loaders = train_loaders()
    batch_1k = next(iter(loaders["1k"]))
    train, _ = train_models(batch_1k)
    train_data = to_torch(train.to(dev).precompute_statics(batch_1k), dtype=torch.float32,
                          device=dev)
    print(f"[5] training batch: {int(batch_1k[keys.NODE_MASK].sum())} atoms, "
          f"{int(batch_1k[keys.EDGE_MASK].sum())} edges (padded "
          f"{batch_1k[keys.EDGE_INDEX].shape[1]})")
    check_train_kernels(train.module.allegro.tps, train_data, rng, records)
    for U in (16, 48):
        other = AllegroModel(**{**FLAGSHIP, "num_tensor_features": U}, avg_num_neighbors=25.0,
                             tp_kernel_backend="fused").init(SEED).to(dev)
        check_train_kernels(other.module.allegro.tps, train_data, rng)
    del train_data
    train_launches = run_training(loaders, dev, smi)

    print(smi)
    print(json.dumps({"kernels": [kernel_record(name, records, launches, md_launches,
                                                calc_launches, train_launches)
                                  for name in SOURCES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def kernel_record(name, records, launches, md_launches, calc_launches, train_launches):
    """One entry of the ``kernels`` JSON line (see the module docstring)."""
    rec = records[name]
    # the four layer kernels are timed on the use_mega=False path, where all
    # their launches are; the trainable backend's on the training step; the
    # rest on the mega path
    if name in TRAIN_KERNELS:
        config, count = "train step", train_launches["1k"][name]
    else:
        config = "fused readout" if name in LAYER_KERNELS else "mega"
        count = launches[config][name]
    bound_ms, bound_by = bound(rec["bytes"], rec["flops"])
    out = {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
           "serves": SERVES[name], "launches": count, "max_abs_err": rec["max_abs_err"],
           "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": rec["library_ms"], "ms_config": config}
    for config in PER_CALL:
        out["launches_" + config.replace(" ", "_")] = launches[config][name]
    out["launches_md"] = md_launches[name]
    out["launches_calculator"] = calc_launches[name]
    for batch, counts in train_launches.items():
        out[f"launches_train_{batch}"] = counts[name]
    for key, variant in records.items():
        if key.startswith(name + "["):
            tag = key[len(name) + 1:-1]
            v_bound, v_by = bound(variant["bytes"], variant["flops"])
            out[f"max_abs_err_{tag}"] = variant["max_abs_err"]
            out[f"ms_{tag}"], out[f"plain_ms_{tag}"] = variant["ms"], variant["plain_ms"]
            out[f"bound_ms_{tag}"], out[f"bound_by_{tag}"] = v_bound, v_by
    return out


def check_force_call(out, ref, n_atoms, n_rows):
    """Finite outputs of the right shape that agree with the einsum backend."""
    from allegro_tpu_torch.data import keys

    for k in (keys.TOTAL_ENERGY, keys.PER_ATOM_ENERGY, keys.FORCES, keys.VIRIAL):
        if not torch.isfinite(out[k]).all():
            raise AssertionError(f"non-finite {k}")
    if out[keys.FORCES].shape != (n_rows, 3):
        raise AssertionError(f"forces shape {tuple(out[keys.FORCES].shape)}")
    f_f = out[keys.FORCES][:n_atoms].double()
    f_o = ref[keys.FORCES][:n_atoms].double()
    force_rel = ((f_f - f_o).abs().max() / f_o.abs().max().clamp_min(1e-6)).item()
    ea_f = out[keys.PER_ATOM_ENERGY][:n_atoms].double().cpu().numpy().ravel()
    ea_o = ref[keys.PER_ATOM_ENERGY][:n_atoms].double().cpu().numpy().ravel()
    ea_err = float(np.abs(ea_f - ea_o).max())
    print(f"    vs einsum on the card: force max-abs rel {force_rel:.3e} (< 1e-5), "
          f"per-atom energy max-abs {ea_err:.3e} (allclose 5e-5)")
    if not force_rel < 1e-5:
        raise AssertionError(f"fused_infer vs einsum forces: rel {force_rel:.3e}")
    np.testing.assert_allclose(ea_f, ea_o, rtol=5e-5, atol=5e-5)


def run_md(model, einsum, frame, n_atoms, dev, smi):
    """Phase 4a: MD_BLOCKS blocks of NVE through ``md.Simulation``."""
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.md import MDState, Simulation, kinetic_energy
    from allegro_tpu_torch.md import maxwell_boltzmann_velocities
    from allegro_tpu_torch.ops import fused_tp

    types = frame[keys.ATOM_TYPES]
    kw = dict(atom_types=types, cell=frame[keys.CELL], pbc=frame[keys.PBC], device=dev, **MD)
    sim = Simulation(model, **kw)
    pos0 = frame[keys.POSITIONS]
    vel0 = maxwell_boltzmann_velocities(sim.masses_per_atom, MD_KT, seed=SEED)
    block = sim._block

    def no_sync_block(*args):
        # a host synchronization inside the block raises
        torch.cuda.set_sync_debug_mode("error")
        try:
            return block(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    sim._block = no_sync_block
    per_block = {k: n * (MD_STEPS_PER_BLOCK + 1) for k, n in PER_CALL["mega"].items()}
    state = MDState(pos0, vel0)
    totals, times, rebuilt = [], [], []
    total_launches = {k: 0 for k in per_block}
    for b in range(MD_BLOCKS):
        rebuilds = sim.rebuilds
        fused_tp.reset_launch_counts()
        t0 = time.perf_counter()
        energies = []
        state = sim.run(state, MD_STEPS_PER_BLOCK, callback=lambda s, e: energies.append(e))
        times.append(time.perf_counter() - t0)
        rebuilt.append(sim.rebuilds > rebuilds)
        if fused_tp.LAUNCHES != per_block:
            raise AssertionError(f"MD block {b}: launches {fused_tp.LAUNCHES}, "
                                 f"expected {per_block} ({MD_STEPS_PER_BLOCK + 1} force calls)")
        for k, n in fused_tp.LAUNCHES.items():
            total_launches[k] += n
        if not np.isfinite(state.positions).all() or not np.isfinite(state.velocities).all():
            raise AssertionError(f"MD block {b}: non-finite positions or velocities")
        totals.append(energies[-1] + kinetic_energy(state.velocities, sim.masses_per_atom))
        if b == 0:
            first = state.positions.copy()
    steps = MD_BLOCKS * MD_STEPS_PER_BLOCK
    print(f"[4] MD: {steps} steps on fused_infer (mega), {sim.rebuilds} neighbor lists "
          f"(edge bucket {sim._edge_bucket}, grown {sim.bucket_grows}x), "
          f"launches per block {per_block}")
    if sim.rebuilds < 2:
        raise AssertionError("MD: no re-neighboring happened")
    ref_sim = Simulation(einsum, **kw)
    ref = ref_sim.run(MDState(pos0, vel0), MD_STEPS_PER_BLOCK)
    dpos = float(np.abs(first - ref.positions).max())
    print(f"    after block 1: max |dpos| vs einsum {dpos:.3e} A (< {MD_TOL})")
    if not dpos < MD_TOL:
        raise AssertionError(f"MD positions vs einsum: {dpos:.3e}")
    e = np.asarray(totals)
    drift = float(np.abs(e - e[0]).max())
    steady = [t for t, r in zip(times, rebuilt) if not r] or times
    ms_step = 1e3 * float(np.median(steady)) / MD_STEPS_PER_BLOCK
    print(f"    NVE total energy {e[0]:.6f} -> {e[-1]:.6f}, max |drift| {drift:.3e} "
          f"({drift / abs(e[0]):.3e} rel) over {steps} steps")
    print(f"    {ms_step:.3f} ms/step, {ms_step * 1e3 / n_atoms:.3f} us/atom per step "
          f"(median of {len(steady)} blocks without a rebuild; all {steps} steps with "
          f"rebuilds {1e3 * sum(times) / steps:.3f} ms/step; {smi})")
    return total_launches


def run_calculator(model, frame, n_atoms, dev):
    """Phase 4b: three single-point calls on jittered copies of the crystal."""
    from allegro_tpu_torch.calculator import AllegroCalculator
    from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
    from allegro_tpu_torch.ops import fused_tp

    calc = AllegroCalculator(model, device=dev)
    rng = np.random.RandomState(CALC_SEED)
    total_launches = {k: 0 for k in fused_tp.LAUNCHES}
    for call in range(3):
        pos = frame[keys.POSITIONS] + CALC_JITTER * rng.randn(n_atoms, 3)
        fused_tp.reset_launch_counts()
        res = calc.calculate(pos, atom_types=frame[keys.ATOM_TYPES], cell=frame[keys.CELL],
                             pbc=frame[keys.PBC])
        if fused_tp.LAUNCHES != PER_CALL["mega"]:
            raise AssertionError(f"calculator call {call}: launches {fused_tp.LAUNCHES}")
        for k, n in fused_tp.LAUNCHES.items():
            total_launches[k] += n
        if call == 0:
            buckets = (calc.n_atoms_pad, calc.n_edges_pad)
        elif (calc.n_atoms_pad, calc.n_edges_pad) != buckets:
            raise AssertionError(f"calculator buckets grew: {buckets} -> "
                                 f"{(calc.n_atoms_pad, calc.n_edges_pad)}")
        fr = neighbor_list({**frame, keys.POSITIONS: pos}, R_MAX)
        data = to_torch(model.precompute_statics(batch_frames([fr], n_frames=1)),
                        dtype=torch.float32, device=dev)
        want = model.apply_with_derivatives(data)
        f_w = want[keys.FORCES][:n_atoms].double().cpu().numpy()
        rel = float(np.abs(res["forces"] - f_w).max() / np.abs(f_w).max())
        e_w = want[keys.PER_ATOM_ENERGY][:n_atoms, 0].double().cpu().numpy()
        if not (np.isfinite(res["forces"]).all() and rel < 1e-5):
            raise AssertionError(f"calculator call {call}: forces rel {rel:.3e}")
        np.testing.assert_allclose(res["energies"], e_w, rtol=5e-5, atol=5e-5)
        np.testing.assert_allclose(res["energy"], want[keys.TOTAL_ENERGY].sum().item(),
                                   rtol=5e-5, atol=5e-5)
        print(f"    calculator call {call}: energy {res['energy']:.6f}, forces rel "
              f"{rel:.3e} vs apply_with_derivatives, buckets (atoms {calc.n_atoms_pad}, "
              f"edges {calc.n_edges_pad})")
    return total_launches


if __name__ == "__main__":
    sys.exit(main())
