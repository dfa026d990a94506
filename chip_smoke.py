#!/usr/bin/env python3
"""Smoke run of allegro_tpu_torch on one CUDA GPU: build, check, drive.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):

0. device: the card's name and power limit (``nvidia-smi``);
1. build: compile the CUDA kernels (``allegro_tpu_torch/csrc``) with nvcc;
2. kernels: on the 4,096-atom periodic crystal (r_max 4.0, seed 0), each of
   the four kernels against its plain PyTorch version at the flagship shapes
   of both layers (U = 32; layer 0 dims (9, 9, 9) with 83 CG entries, layer 1
   (9, 9, 1) with 9), bound max|err| / max|ref| < 1e-5, with median times
   from CUDA events; then, checks only, at U = 16 and 48 (the kernels' lane
   loop for other widths);
3. slice: the flagship ``AllegroModel`` (l_max 2, 2 layers, 64 scalar and 32
   tensor features, random weights from seed 0) on ``fused_infer`` makes 5
   force calls; every kernel must launch exactly twice per call, outputs must
   be finite, and forces / per-atom energies must agree with the port's
   plain ``einsum`` backend on the same card (force max-abs rel < 1e-5,
   per-atom energies allclose at 5e-5). Prints µs/atom per force call.

The last two lines of stdout are a JSON object with the kernels' records and
the JSON result ``{"ok": true, "device": {...}}``.
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
SOURCE = "allegro_tpu_torch/csrc/fused_tp.cu"
REPLACES = {
    "env_scatter": "allegro_tpu/ops/fused_tp.py:1091",
    "gather_tp": "allegro_tpu/ops/fused_tp.py:500",
    "bwd_fused": "allegro_tpu/ops/fused_tp.py:1340",
    "unweight_both": "allegro_tpu/ops/fused_tp.py:1455",
}


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


def median_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rel_err(got, ref):
    err = (got.double() - ref.double()).abs().max().item()
    scale = max(ref.double().abs().max().item(), 1e-30)
    return err, err / scale


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
        cases = {
            "env_scatter": (
                lambda: (fused_tp.env_scatter(sh, wexp, centers, row_ptr, d2i, U),),
                lambda: (fused_tp.env_scatter_reference(sh, wexp, centers, n_atoms, d2i, U),),
            ),
            "gather_tp": (
                lambda: (fused_tp.gather_tp(x, env, w, centers, idx, coef, d3),),
                lambda: (fused_tp.gather_tp_reference(x, env, w, centers, idx, coef, d3),),
            ),
            "bwd_fused": (
                lambda: fused_tp.bwd_fused(x, g, env, w, centers, row_ptr, idx, coef),
                lambda: fused_tp.bwd_fused_reference(x, g, env, w, centers, n_atoms, idx, coef),
            ),
            "unweight_both": (
                lambda: fused_tp.unweight_both(t, sh, wexp, centers, d2i),
                lambda: fused_tp.unweight_both_reference(t, sh, wexp, centers, d2i),
            ),
        }
        for name, (kernel, plain) in cases.items():
            got, ref = kernel(), plain()
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(got, ref)]
            abs_err = max(e[0] for e in errs)
            rel = max(e[1] for e in errs)
            ok = rel < KERNEL_TOL
            print(f"  U {U} layer {layer} dims ({d1},{d2},{d3}) entries {idx.shape[0]:3d} "
                  f"{name:14s} max_abs_err {abs_err:.3e} rel {rel:.3e} (< {KERNEL_TOL}) "
                  f"{'ok' if ok else 'FAIL'}", end="")
            if not ok:
                print()
                raise AssertionError(f"{name} (U {U}, layer {layer}) disagrees with its plain version")
            if records is None:
                print()
                continue
            ms, plain_ms = median_ms(kernel), median_ms(plain)
            print(f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
            rec = records.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
            rec["ms"] += ms
            rec["plain_ms"] += plain_ms


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
    records = {}
    rng = np.random.RandomState(SEED)
    check_kernels(fused.module.allegro.tps, data, rng, records)
    for U in (16, 48):
        other = AllegroModel(
            **{**FLAGSHIP, "num_tensor_features": U}, tp_kernel_backend="fused_infer",
            use_mega=False,
        ).to(dev)
        check_kernels(other.module.allegro.tps, data, rng)

    # phase 3: the slice — 5 force calls through the kernels
    fused.apply_with_derivatives(data)
    torch.cuda.synchronize()
    fused_tp.reset_launch_counts()
    for call in range(1, N_CALLS + 1):
        out = fused.apply_with_derivatives(data)
        bad = {k: v for k, v in fused_tp.LAUNCHES.items() if v != 2 * call}
        if bad:
            raise AssertionError(f"force call {call}: expected 2 launches per call, got {bad}")
    torch.cuda.synchronize()
    launches = dict(fused_tp.LAUNCHES)
    print(f"[3] {N_CALLS} force calls on fused_infer; kernel launches {launches}")
    for k in (keys.TOTAL_ENERGY, keys.PER_ATOM_ENERGY, keys.FORCES, keys.VIRIAL):
        if not torch.isfinite(out[k]).all():
            raise AssertionError(f"non-finite {k}")
    if out[keys.FORCES].shape != (batch_np[keys.POSITIONS].shape[0], 3):
        raise AssertionError(f"forces shape {tuple(out[keys.FORCES].shape)}")

    einsum = AllegroModel(
        **FLAGSHIP, avg_num_neighbors=n_edges / n_atoms, tp_kernel_backend="einsum"
    ).to(dev)
    einsum.load_state_dict(fused.state_dict())
    ref = einsum.apply_with_derivatives(data)
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

    us_fused = time_force_call(fused, data, n_atoms)
    us_einsum = time_force_call(einsum, data, n_atoms)
    print(f"    force call: fused_infer {us_fused:.3f} us/atom, einsum {us_einsum:.3f} us/atom "
          f"({n_atoms} atoms, f32; {smi})")

    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": rec["max_abs_err"],
         "ms": rec["ms"], "plain_ms": rec["plain_ms"]}
        for name, rec in records.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
