#!/usr/bin/env python3
"""Time two checkouts of allegro_tpu_torch on one CUDA card, interleaved.

    python3 scripts/torch_compare_trees.py BEFORE AFTER [--out FILE] [--center]

BEFORE and AFTER are directories that each hold a checkout (``git
archive``) of the repository. Each tree is measured in a subprocess of its
own, in the order BEFORE, AFTER, AFTER, BEFORE, so a drift of the host's
clocks over the call shows as a difference between the two runs of a tree.
Each run times, with that tree's package:

- ``force_us_per_atom``: the flagship on ``pallas`` on the 4,096-atom
  crystal (f32, random weights from seed 0): the mean of 20 force calls
  after 3 warm-up calls, host clock, in µs per atom; ``launches_per_call``
  its kernel launches; ``pallas_busy_ms`` and ``pallas_idle_pct`` its
  device time per call and idle share under torch.profiler (3 calls);
  ``pallas_lmax3_*`` the same for its l_max-3 twin (``chip_smoke.LMAX3``);
- ``sparse_tp_ms`` and ``sparse_tp_gradw_ms``: device times from CUDA
  events of the two ``pallas`` kernels on the force call's edges, summed
  over the table and its a- and b-swaps (the orders of the force call's
  launches and of the training step's weight gradients) at both flagship
  layers, and (``*_lmax3_ms``) at the l_max-3 model's layer 0, with the
  path tables the tree's layers cache where it has them;
- ``train_ms_per_step``: one ``Trainer.fit`` step of the flagship on
  ``pallas`` on the 4 x 1,000-atom batch: the median of 10 steps after 2,
  host clock; ``pallas_train_busy_ms`` and ``pallas_train_idle_pct`` its
  device time per step and idle share under torch.profiler (3 steps);
- ``md_ms_per_step``: ``python -m allegro_tpu_torch md -c configs/md.yaml``
  run from the tree, its own "MD done" ms/step;
- ``mega_us_per_atom`` and ``mega_lmax3_us_per_atom``: the same force call
  on ``fused_infer``'s default mega path, for the flagship and its l_max-3
  twin (``chip_smoke.LMAX3``); ``mega*_busy_ms`` and ``mega*_idle_pct``
  their device time per call and idle share under torch.profiler (3 calls);
- ``latent_env_scatter_ms`` and ``latent_env_bwd_ms`` (both launches of one
  mega force call: the first projection and layer 0's latent),
  ``gather_tp_embed_ms`` and ``bwd_embed_ms``, flagship and l_max 3
  (``*_lmax3_ms``): device times from CUDA events (``chip_smoke.median_ms``)
  of the tree's wrappers on the force call's shapes and the model's
  weights, with the tables the tree's layers cache where it has them; and
  ``readout_sum_ms`` and ``readout_bwd_ms``: the fused readout and its
  backward on ``chip_smoke``'s phase-2 readout shapes (three 64-wide column
  slices of 160-wide rows, W0 [192, 32], w1 [32, 1]; the same at l_max 3,
  whose readout is the same);
- ``nomega_us_per_atom``, ``nomega_busy_ms`` and ``nomega_idle_pct``: the
  flagship's force call on ``fused_infer`` with ``use_mega=False`` (host
  clock; torch.profiler, 3 calls);
- ``gather_tp_ms``, ``gather_tp_swapped_ms`` and ``gather_dw_ms``: device
  times from CUDA events of kernels 2, 13 and 15 on the crystal's edges at
  both flagship layers (``gather_tp`` in the layer's entry order, the
  force call's; ``gather_tp`` on the role-swapped table and ``gather_dw`` in
  the layer's order, a training step's), and (``*_lmax3_ms``) at the
  l_max-3 model's layer 0, each through the tree's wrapper with the path
  tables the tree's layers cache where it has them;
- ``tp_scatter_ms``, ``tp_scatter_swapped_ms`` and ``unweight_sh_ms``:
  device times from CUDA events of kernels 14 (in the layer's entry order
  and on the role-swapped table) and 16 on the same edges and layers, with
  the path table the tree's ``tp_scatter`` walks where it takes one
  (``chip_smoke.scatter_paths``), and (``*_rmax7_ms``) at the flagship's
  layer 0 on the crystal at r_max 7.0 (``chip_smoke.LONG_R_MAX``: ~137
  edges per atom);
- ``bwd_fused_ms``, ``bwd_fused_gts_ms``, ``unweight_w_ms``,
  ``unweight_both_ms`` and ``env_scatter_ms``: the same for kernels 3
  (without and with the split output's cotangent ``gts``; with the path
  tables of the layer's ``infer_paths`` where the tree's ``bwd_fused`` takes
  them), 17, 4 and 1, on the same edges and layers (the flagship's two,
  l_max 3's layer 0, r_max 7.0's layer 0), and ``unweight_pair_ms``:
  ``unweight_sh`` and ``unweight_w`` one after the other on
  ``unweight_both``'s inputs; ``env_scatter_u256_ms``: kernel 1 on the
  crystal's edges at the flagship's layer-0 dims with U = 256;
- ``center_gather_<case>_ms`` and ``center_sum_<case>_ms``: device times
  from CUDA events of kernels 5 and 6 at every width and side a user path
  runs them (``chip_smoke.center_cases``: C = 3 on the center and the
  neighbor side, C = 1, the ``pallas`` env sums at 288 and 256, the
  chunked class-CSR sums at 1,024 and 32 and the 32-wide class gather),
  with each case's ``_bound_ms`` and ``_library_ms``; ``--center`` times
  these alone;
- ``fused_train_ms_per_step``: one ``Trainer.fit`` step of the flagship on
  ``fused`` on the 4 x 1,000-atom batch (median of 10 steps after 2, host
  clock), ``fused_train_busy_ms`` and ``fused_train_idle_pct`` its device
  time per step and idle share under torch.profiler (3 steps).

The crystal, the batch and the flagship's settings come from this checkout's
``chip_smoke.py``, so both trees see the same inputs. Prints one JSON line
per run and the card's name and power limit; ``--out`` also writes them to
a file. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FORCE_CALLS, WARMUP_CALLS = 20, 3
TRAIN_STEPS, WARMUP_STEPS = 10, 2
TIMEOUT = 900


def _smoke():
    """This checkout's chip_smoke.py as a module (its helpers import the
    package only inside their bodies, so they use the tree on sys.path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_times(smoke, allegro, data) -> dict:
    """Device ms, from CUDA events, of the mega kernels at the model's shapes:
    latent_env_scatter and latent_env_bwd (the two launches of one force
    call each: the first projection and layer 0's latent), gather_tp_embed
    (split) and bwd_embed (with gts), each through the tree's wrapper with
    the tables the tree's layers cache where it has them; and readout_bwd
    on chip_smoke's phase-2 readout shapes."""
    import inspect

    import numpy as np
    import torch

    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    rng = np.random.RandomState(smoke.SEED)
    dev = data[keys.POSITIONS].device
    centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
    row_ptr = data[keys.CENTER_ROW_PTR]
    n_atoms, E = row_ptr.shape[0] - 1, centers.shape[0]
    S, U, tp = allegro.S, allegro.U, allegro.tps[0]
    d2i = tp.dim_to_irr

    def rand(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)

    def takes(fn, name):
        return name in inspect.signature(fn).parameters

    ranges = (tp.irr_ranges,) if hasattr(tp, "irr_ranges") else ()
    paths = (tp.cg_paths(),) if hasattr(tp, "cg_paths") else ()
    sh, emb, ts = rand(E, tp.d2), rand(E, S), rand(E, U)
    t, g_lat = rand(n_atoms, tp.d2 * U), rand(E, S)
    (w_proj,) = allegro.first_projection.weights()
    w0, w1 = allegro.latents[0].weights()
    # older trees' scatter takes (row_ptr, ...), newer ones (centers, row_ptr, ...)
    new_scatter = takes(fused_tp.latent_env_scatter, "centers")
    scatter_csr = (centers, row_ptr) if new_scatter else (row_ptr,)
    scatter_ranges = ranges if takes(fused_tp.latent_env_scatter, "irr_ranges") else ()
    ms = {"latent_env_scatter_ms": 0.0, "latent_env_bwd_ms": 0.0}
    for pieces, a, b in (((emb,), w_proj.detach(), None), ((emb, ts), w0.detach(), w1.detach())):
        ms["latent_env_scatter_ms"] += smoke.median_ms(lambda: fused_tp.latent_env_scatter(
            pieces, sh, a, b, *scatter_csr, d2i, U, S, *scatter_ranges))
        ms["latent_env_bwd_ms"] += smoke.median_ms(lambda: fused_tp.latent_env_bwd(
            pieces, sh, a, b, t, g_lat, centers, d2i, U, S, *ranges))
    wk, idx, coef = (v.detach() for v in tp.fused_infer_parts(torch.float32))
    w2b, env = rand(E, tp.n_irr * U), rand(n_atoms, tp.d2 * U)
    g, gts = rand(E, tp.d3 * U), rand(E, U)
    if takes(fused_tp.gather_tp_embed, "row_ptr"):
        embed = lambda: fused_tp.gather_tp_embed(  # noqa: E731
            sh, w2b, env, wk, centers, row_ptr, idx, coef, allegro.row_specs, tp.d3, True, *paths)
    else:
        embed = lambda: fused_tp.gather_tp_embed(  # noqa: E731
            sh, w2b, env, wk, centers, idx, coef, allegro.row_specs, tp.d3, True)
    ms["gather_tp_embed_ms"] = smoke.median_ms(embed)
    ms["bwd_embed_ms"] = smoke.median_ms(lambda: fused_tp.bwd_embed(
        sh, w2b, g, env, wk, centers, row_ptr, idx, coef, allegro.row_specs, gts, *paths))
    K, H = 3 * S, 32
    pieces = [rand(E, S + 96)[:, :S] for _ in range(3)]
    w0, w1, y = rand(K, H) / K**0.5, rand(H, 1) / H**0.5, rand(n_atoms, 1)
    ms["readout_sum_ms"] = smoke.median_ms(lambda: fused_tp.readout_sum(
        pieces, w0, w1, row_ptr))
    ms["readout_bwd_ms"] = smoke.median_ms(lambda: fused_tp.readout_bwd(
        pieces, w0, w1, y, centers))
    return ms


def center_kernel_times(smoke, data) -> dict:
    """Device ms, from CUDA events, of the center gather and sum at every
    width and side a user path runs them (``chip_smoke.center_cases``, on
    ``data``'s edges), each through the tree's wrapper, keyed
    ``<kernel>_<case>_ms``; beside each, ``_bound_ms`` and ``_library_ms``
    (the same for both trees)."""
    import numpy as np

    ms = {}
    cases = smoke.center_cases(data, np.random.RandomState(smoke.SEED))
    for key, case, _, kernel, _, reads, flops, library, _ in cases:
        name = f"{key.split('[')[0]}_{case}"
        ms[f"{name}_ms"] = smoke.median_ms(kernel)
        ms[f"{name}_bound_ms"] = smoke.bound(smoke.nbytes(*reads, *kernel()), flops)[0]
        ms[f"{name}_library_ms"] = smoke.median_ms(library)
    return ms


def pallas_kernel_times(smoke, tps, n_edges, dev) -> dict:
    """Device ms, from CUDA events, of sparse_tp and sparse_tp_gradw on
    ``n_edges`` rows, summed over the layers ``tps`` and the three role
    orders of the force call (the table, its a- and b-swap), each through
    the tree's wrapper, with the order's path table where the tree's layers
    cache one."""
    import numpy as np
    import torch

    from allegro_tpu_torch.ops import pallas_contract as pc
    from allegro_tpu_torch.ops.tp_primitives import SWAP_A, SWAP_B, compose

    rng = np.random.RandomState(smoke.SEED)

    def rand(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)

    ms = {"sparse_tp_ms": 0.0, "sparse_tp_gradw_ms": 0.0}
    for tp in tps:
        U, P = tp.mul, tp.num_paths
        st = tp.tp_statics() if hasattr(tp, "tp_statics") else None
        for r in (0, compose(0, SWAP_A), compose(0, SWAP_B)):
            d1, d2, d3 = ((tp.d1, tp.d2, tp.d3)[s] for s in pc.ROLES[r])
            idx, coef = tp.tp_idx[r], tp.tp_coef[r]
            paths = (st.walk(r),) if st is not None else ()
            a, b, g = rand(n_edges, d1 * U), rand(n_edges, d2 * U), rand(n_edges, d3 * U)
            w = rand(P, U)
            ms["sparse_tp_ms"] += smoke.median_ms(
                lambda: pc.sparse_tp(a, b, w, idx, coef, d3, *paths))
            ms["sparse_tp_gradw_ms"] += smoke.median_ms(
                lambda: pc.sparse_tp_gradw(a, b, g, idx, coef, P, U, *paths))
            del a, b, g
    return ms


def gather_kernel_times(smoke, tps, data) -> dict:
    """Device ms, from CUDA events, of gather_tp (the layer's entry order),
    gather_tp on the role-swapped table and gather_dw (the layer's order) on
    ``data``'s edges, summed over the layers ``tps``, each through the tree's
    wrapper with the path tables the tree's layers cache where it has them."""
    import numpy as np
    import torch

    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    rng = np.random.RandomState(smoke.SEED)
    dev = data[keys.POSITIONS].device
    centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
    n_atoms, E = data[keys.CENTER_ROW_PTR].shape[0] - 1, centers.shape[0]
    real = data[keys.EDGE_MASK].to(torch.float32)[:, None]

    def rand(*shape, edge=True):
        t = torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)
        return t * real if edge else t

    ms = {"gather_tp_ms": 0.0, "gather_tp_swapped_ms": 0.0, "gather_dw_ms": 0.0}
    for tp in tps:
        U, P = tp.mul, tp.num_paths
        coef = tp.entry_coef.to(torch.float32)
        walks = tp.gather_paths() if hasattr(tp, "gather_paths") else None
        own, swapped = ((walks[0],), (walks[1],)) if walks else ((), ())
        x, g = rand(E, tp.d1 * U), rand(E, tp.d3 * U)
        env, w = rand(n_atoms, tp.d2 * U, edge=False), rand(P, U, edge=False)
        ms["gather_tp_ms"] += smoke.median_ms(lambda: fused_tp.gather_tp(
            x, env, w, centers, tp.entry_idx, coef, tp.d3, False, *own))
        ms["gather_tp_swapped_ms"] += smoke.median_ms(lambda: fused_tp.gather_tp(
            g, env, w, centers, tp.entry_swapped, coef, tp.d1, False, *swapped))
        ms["gather_dw_ms"] += smoke.median_ms(lambda: fused_tp.gather_dw(
            x, env, g, centers, tp.entry_idx, coef, P, U, *own))
        del x, g, env
    return ms


def scatter_kernel_times(smoke, tps, data) -> dict:
    """Device ms, from CUDA events, of tp_scatter (the layer's entry order
    and the role swap, the two orders a training step runs), unweight_sh,
    bwd_fused (without and with gts), unweight_w, unweight_both, the pair
    unweight_sh + unweight_w and env_scatter on ``data``'s edges,
    summed over the layers ``tps``, each through the tree's wrapper, with the
    path table of this checkout's ``chip_smoke.scatter_paths`` where the
    tree's ``tp_scatter`` takes one, and the layer's ``infer_paths`` where
    the tree's ``bwd_fused`` takes them."""
    import inspect

    import numpy as np
    import torch

    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    rng = np.random.RandomState(smoke.SEED)
    dev = data[keys.POSITIONS].device
    centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
    row_ptr = data[keys.CENTER_ROW_PTR]
    n_atoms, E = row_ptr.shape[0] - 1, centers.shape[0]
    real = data[keys.EDGE_MASK].to(torch.float32)[:, None]
    walks = "paths" in inspect.signature(fused_tp.tp_scatter).parameters
    bwd_walks = "scatter_paths" in inspect.signature(fused_tp.bwd_fused).parameters

    def rand(*shape, edge=True):
        t = torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)
        return t * real if edge else t

    ms = {"tp_scatter_ms": 0.0, "tp_scatter_swapped_ms": 0.0, "unweight_sh_ms": 0.0,
          "bwd_fused_ms": 0.0, "bwd_fused_gts_ms": 0.0, "unweight_w_ms": 0.0,
          "unweight_both_ms": 0.0, "unweight_pair_ms": 0.0, "env_scatter_ms": 0.0}
    for tp in tps:
        U, P = tp.mul, tp.num_paths
        coef = tp.entry_coef.to(torch.float32)
        own, swapped = ((p,) for p in smoke.scatter_paths(tp)) if walks else ((), ())
        x, g, w = rand(E, tp.d1 * U), rand(E, tp.d3 * U), rand(P, U, edge=False)
        t, wexp = rand(n_atoms, tp.d2 * U, edge=False), rand(E, tp.n_irr * U)
        ms["tp_scatter_ms"] += smoke.median_ms(lambda: fused_tp.tp_scatter(
            x, g, w, centers, row_ptr, tp.entry_idx, coef, tp.d2, *own))
        ms["tp_scatter_swapped_ms"] += smoke.median_ms(lambda: fused_tp.tp_scatter(
            g, x, w, centers, row_ptr, tp.entry_swapped, coef, tp.d2, *swapped))
        ms["unweight_sh_ms"] += smoke.median_ms(lambda: fused_tp.unweight_sh(
            t, wexp, centers, tp.dim_to_irr))
        env, sh, gts = rand(n_atoms, tp.d2 * U, edge=False), rand(E, tp.d2), rand(E, U)
        bwd = dict(zip(("paths", "scatter_paths"), tp.infer_paths()[1:])) if bwd_walks else {}
        ms["bwd_fused_ms"] += smoke.median_ms(lambda: fused_tp.bwd_fused(
            x, g, env, w, centers, row_ptr, tp.entry_idx, coef, **bwd))
        ms["bwd_fused_gts_ms"] += smoke.median_ms(lambda: fused_tp.bwd_fused(
            x, g, env, w, centers, row_ptr, tp.entry_idx, coef, gts, **bwd))
        ms["unweight_w_ms"] += smoke.median_ms(lambda: fused_tp.unweight_w(
            t, sh, centers, tp.dim_to_irr, tp.n_irr))
        ms["unweight_both_ms"] += smoke.median_ms(lambda: fused_tp.unweight_both(
            t, sh, wexp, centers, tp.dim_to_irr))
        ms["unweight_pair_ms"] += smoke.median_ms(lambda: (
            fused_tp.unweight_sh(t, wexp, centers, tp.dim_to_irr),
            fused_tp.unweight_w(t, sh, centers, tp.dim_to_irr, tp.n_irr)))
        ms["env_scatter_ms"] += smoke.median_ms(lambda: fused_tp.env_scatter(
            sh, wexp, centers, row_ptr, tp.dim_to_irr, U))
        del x, g, t, wexp, env, sh, gts
    return ms


def env_scatter_wide_ms(smoke, tp, data, U) -> float:
    """Device ms, from CUDA events, of env_scatter on ``data``'s edges at
    layer ``tp``'s dims with ``U`` channels (random sh and wexp)."""
    import numpy as np
    import torch

    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.ops import fused_tp

    rng = np.random.RandomState(smoke.SEED)
    dev = data[keys.POSITIONS].device
    centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
    E = centers.shape[0]
    sh = torch.as_tensor(rng.randn(E, tp.d2).astype(np.float32), device=dev)
    wexp = torch.as_tensor(rng.randn(E, tp.n_irr * U).astype(np.float32), device=dev)
    return smoke.median_ms(lambda: fused_tp.env_scatter(
        sh, wexp, centers, data[keys.CENTER_ROW_PTR], tp.dim_to_irr, U))


def measure(tree: Path, center_only: bool = False) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import allegro_tpu_torch
    from allegro_tpu_torch.data import batch_frames, keys, to_torch
    from allegro_tpu_torch.model import AllegroModel
    from allegro_tpu_torch.ops import fused_tp

    if Path(allegro_tpu_torch.__file__).resolve().parents[1] != tree.resolve():
        raise RuntimeError(f"imported {allegro_tpu_torch.__file__}, not the tree {tree}")
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    out = {"tree": str(tree)}

    frame, n_atoms = smoke.crystal_frame(smoke.N_ATOMS, smoke.R_MAX, smoke.SEED)
    n_edges = frame[keys.EDGE_INDEX].shape[1]
    model = AllegroModel(**smoke.FLAGSHIP, avg_num_neighbors=n_edges / n_atoms,
                         tp_kernel_backend="pallas").init(smoke.SEED).to(dev)
    data = to_torch(model.precompute_statics(batch_frames([frame], n_frames=1)),
                    dtype=torch.float32, device=dev)
    out.update(center_kernel_times(smoke, data))
    if center_only:
        return out
    for _ in range(WARMUP_CALLS):
        model.apply_with_derivatives(data)
    torch.cuda.synchronize()
    fused_tp.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(FORCE_CALLS):
        model.apply_with_derivatives(data)
    torch.cuda.synchronize()
    out["force_us_per_atom"] = (time.perf_counter() - t0) / FORCE_CALLS / n_atoms * 1e6
    out["launches_per_call"] = {k: c // FORCE_CALLS for k, c in fused_tp.LAUNCHES.items() if c}
    prof = smoke.profile_calls(lambda: model.apply_with_derivatives(data), 3, "pallas")
    if prof is not None:
        out["pallas_busy_ms"], out["pallas_idle_pct"] = prof[0], prof[1]
    out.update(pallas_kernel_times(smoke, model.module.allegro.tps, n_edges, dev))
    del model, data
    torch.cuda.empty_cache()

    model = AllegroModel(**smoke.LMAX3, avg_num_neighbors=n_edges / n_atoms,
                         tp_kernel_backend="pallas").init(smoke.SEED).to(dev)
    data = to_torch(model.precompute_statics(batch_frames([frame], n_frames=1)),
                    dtype=torch.float32, device=dev)
    out["pallas_lmax3_us_per_atom"] = smoke.time_force_call(model, data, n_atoms, FORCE_CALLS)
    prof = smoke.profile_calls(lambda: model.apply_with_derivatives(data), 3, "pallas_lmax3")
    if prof is not None:
        out["pallas_lmax3_busy_ms"], out["pallas_lmax3_idle_pct"] = prof[0], prof[1]
    for key, ms in pallas_kernel_times(smoke, model.module.allegro.tps[:1], n_edges,
                                       dev).items():
        out[key.replace("_ms", "_lmax3_ms")] = ms
    del model, data
    torch.cuda.empty_cache()

    for tag, cfg in (("mega", smoke.FLAGSHIP), ("mega_lmax3", smoke.LMAX3)):
        model = AllegroModel(**cfg, avg_num_neighbors=n_edges / n_atoms,
                             tp_kernel_backend="fused_infer").init(smoke.SEED).to(dev)
        data = to_torch(model.precompute_statics(batch_frames([frame], n_frames=1)),
                        dtype=torch.float32, device=dev)
        out[f"{tag}_us_per_atom"] = smoke.time_force_call(model, data, n_atoms, FORCE_CALLS)
        prof = smoke.profile_calls(lambda: model.apply_with_derivatives(data), 3, tag)
        if prof is not None:
            out[f"{tag}_busy_ms"], out[f"{tag}_idle_pct"] = prof[0], prof[1]
        suffix = "" if tag == "mega" else "_lmax3"
        for key, ms in kernel_times(smoke, model.module.allegro, data).items():
            out[key.replace("_ms", suffix + "_ms")] = ms
        del model, data
        torch.cuda.empty_cache()

    for tag, cfg in (("nomega", smoke.FLAGSHIP), ("nomega_lmax3", smoke.LMAX3)):
        model = AllegroModel(**cfg, avg_num_neighbors=n_edges / n_atoms,
                             tp_kernel_backend="fused_infer", use_mega=False).init(smoke.SEED).to(dev)
        data = to_torch(model.precompute_statics(batch_frames([frame], n_frames=1)),
                        dtype=torch.float32, device=dev)
        tps = model.module.allegro.tps
        if tag == "nomega":
            out["nomega_us_per_atom"] = smoke.time_force_call(model, data, n_atoms, FORCE_CALLS)
            prof = smoke.profile_calls(lambda: model.apply_with_derivatives(data), 3, tag)
            if prof is not None:
                out["nomega_busy_ms"], out["nomega_idle_pct"] = prof[0], prof[1]
        suffix = "" if tag == "nomega" else "_lmax3"
        for times in (gather_kernel_times, scatter_kernel_times):
            for key, ms in times(smoke, tps if tag == "nomega" else tps[:1], data).items():
                out[key.replace("_ms", suffix + "_ms")] = ms
        if tag == "nomega":
            out["env_scatter_u256_ms"] = env_scatter_wide_ms(smoke, tps[0], data, 256)
        del model, data
        torch.cuda.empty_cache()

    frame, n_atoms = smoke.crystal_frame(smoke.N_ATOMS, smoke.LONG_R_MAX, smoke.SEED)
    n_edges = frame[keys.EDGE_INDEX].shape[1]
    model = AllegroModel(**{**smoke.FLAGSHIP, "r_max": smoke.LONG_R_MAX},
                         avg_num_neighbors=n_edges / n_atoms, tp_kernel_backend="fused_infer",
                         use_mega=False).init(smoke.SEED).to(dev)
    data = to_torch(model.precompute_statics(batch_frames([frame], n_frames=1)),
                    dtype=torch.float32, device=dev)
    for key, ms in scatter_kernel_times(smoke, model.module.allegro.tps[:1], data).items():
        out[key.replace("_ms", "_rmax7_ms")] = ms
    del model, data
    torch.cuda.empty_cache()

    loader = smoke.train_loaders()["1k"]
    train, _ = smoke.train_models(next(iter(loader)), "fused")
    trainer = smoke.make_trainer(train, dev)
    state = trainer.init_state()
    times = []
    for _ in range(WARMUP_STEPS + TRAIN_STEPS):
        t0 = time.perf_counter()
        trainer.fit(state, loader, max_epochs=1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["fused_train_ms_per_step"] = 1e3 * float(np.median(times[WARMUP_STEPS:]))
    prof = smoke.profile_steps(trainer, state, loader)
    if prof is not None:
        out["fused_train_busy_ms"], out["fused_train_idle_pct"] = prof
    del train, trainer, state
    torch.cuda.empty_cache()

    train, _ = smoke.train_models(next(iter(loader)), "pallas")
    trainer = smoke.make_trainer(train, dev)
    state = trainer.init_state()
    times = []
    for _ in range(WARMUP_STEPS + TRAIN_STEPS):
        t0 = time.perf_counter()
        trainer.fit(state, loader, max_epochs=1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["train_ms_per_step"] = 1e3 * float(np.median(times[WARMUP_STEPS:]))
    prof = smoke.profile_steps(trainer, state, loader)
    if prof is not None:
        out["pallas_train_busy_ms"], out["pallas_train_idle_pct"] = prof

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "allegro_tpu_torch", "md", "-c", "configs/md.yaml", "-w", tmp],
            cwd=tree, capture_output=True, text=True, timeout=TIMEOUT)
    if proc.returncode != 0:
        raise RuntimeError(f"md.yaml exited {proc.returncode}: {proc.stderr[-2000:]}")
    done = next(ln for ln in proc.stdout.splitlines() if ln.startswith("MD done"))
    out["md_ms_per_step"] = float(done.split(" ms/step")[0].rsplit("(", 1)[1])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("before", type=Path)
    ap.add_argument("after", type=Path, nargs="?")
    ap.add_argument("--one", action="store_true", help="measure BEFORE alone, in this process")
    ap.add_argument("--center", action="store_true",
                    help="time the center gather and sum cases alone")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(measure(args.before, args.center)))
        return 0
    if args.after is None:
        ap.error("give two trees, or one with --one")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    lines = [smi]
    for label, tree in (("before", args.before), ("after", args.after),
                        ("after", args.after), ("before", args.before)):
        proc = subprocess.run([sys.executable, __file__, str(tree), "--one"]
                              + ["--center"] * args.center, capture_output=True,
                              text=True, timeout=TIMEOUT)
        if proc.returncode != 0:
            print(proc.stdout[-3000:])
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        result = {"run": label, **json.loads(proc.stdout.splitlines()[-1])}
        print(json.dumps(result), flush=True)
        lines.append(json.dumps(result))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
