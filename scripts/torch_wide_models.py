#!/usr/bin/env python3
"""Run the wide models of ``chip_smoke.WIDE_MODELS`` on one CUDA card with
the package of a given checkout: one force call each on the default
``fused_infer`` path, on the 4,096-atom crystal (r_max 4.0, f32, random
weights from seed 0).

    python3 scripts/torch_wide_models.py TREE [--out FILE]

TREE is a directory that holds a checkout (``git archive``) of the
repository; its ``allegro_tpu_torch`` is imported, this checkout's
``chip_smoke.py`` supplies the models and the crystal. For each model one
JSON line (stdout, and appended to FILE): ``result`` is ``"runs"`` or
``"raises"`` (with the error's first line), ``routes`` the model's
``Model.routes()`` where the tree has it, and for a model that runs the
force max-abs error over max-abs and the per-atom energies' max-abs error
against the tree's ``einsum`` on the same card, and µs/atom (host clock,
10 calls after 2); with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("tree")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_wide_models: no CUDA device", file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import allegro_tpu_torch

    if not Path(allegro_tpu_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"allegro_tpu_torch came from {allegro_tpu_torch.__file__}, not {tree}")
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from allegro_tpu_torch.data import batch_frames, keys, to_torch
    from allegro_tpu_torch.model import AllegroModel
    from allegro_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    _build.load_library()
    dev = torch.device("cuda", 0)
    frame, n_atoms = smoke.crystal_frame(smoke.N_ATOMS, smoke.R_MAX, smoke.SEED)
    n_edges = frame[keys.EDGE_INDEX].shape[1]
    batch = batch_frames([frame], n_frames=1)
    for name, kw in smoke.WIDE_MODELS.items():
        rec = {"tree": str(tree), "model": name, "card": smi, "edges": int(n_edges)}
        model = AllegroModel(**kw, avg_num_neighbors=n_edges / n_atoms,
                             tp_kernel_backend="fused_infer").init(smoke.SEED).to(dev)
        if hasattr(model, "routes"):
            rec["routes"] = model.routes()
        data = to_torch(model.precompute_statics(batch), dtype=torch.float32, device=dev)
        try:
            out = model.apply_with_derivatives(data)
            torch.cuda.synchronize()
        except RuntimeError as e:
            rec.update(result="raises", error=str(e).splitlines()[0])
        else:
            einsum = AllegroModel(**kw, avg_num_neighbors=n_edges / n_atoms,
                                  tp_kernel_backend="einsum").to(dev)
            einsum.load_state_dict(model.state_dict())
            ref = einsum.apply_with_derivatives(
                to_torch(einsum.precompute_statics(batch), dtype=torch.float32, device=dev))
            f, fr = out[keys.FORCES][:n_atoms].double(), ref[keys.FORCES][:n_atoms].double()
            ea = out[keys.PER_ATOM_ENERGY][:n_atoms].double()
            ea_ref = ref[keys.PER_ATOM_ENERGY][:n_atoms].double()
            rec.update(result="runs",
                       force_rel=((f - fr).abs().max() / fr.abs().max()).item(),
                       per_atom_energy_abs=(ea - ea_ref).abs().max().item(),
                       us_per_atom=smoke.time_force_call(model, data, n_atoms))
            del einsum, ref, out
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
        del model, data
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
