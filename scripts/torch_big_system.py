#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s big-system phases alone on one CUDA card
(``chip_smoke.big_system_phase``, the function its ``main`` calls): the
97,336-atom crystal in f32, under the JAX bench's 100k policy, with remat
and checkpoint_energy in f32 and streamed (phase 8), then the bf16 forms of
kernels 2, 3 and 7-10 against their plain versions at the flagship's
4,096-atom shapes (phase 8e).

    python3 scripts/torch_big_system.py

Prints what those phases print, the card's name and power limit, each bf16
entry point's ptxas registers and spills, and the bf16 rows of the kernels
line as one JSON line; exits non-zero where a check fails or there is no
card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_big_system: no CUDA device", file=sys.stderr)
        return 1
    from allegro_tpu_torch.data import batch_frames, keys, to_torch
    from allegro_tpu_torch.model import AllegroModel
    from allegro_tpu_torch.ops import _build

    t0 = time.perf_counter()
    so = _build.build_library()
    _build.load_library()
    print(f"built {so.name} in {time.perf_counter() - t0:.1f} s")
    usage = cs.ptxas_usage(so.with_suffix(".log").read_text())
    for _, name in cs.BF16_KERNELS:
        print(name, cs.kernel_ptxas(name, usage))
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    frame, n_atoms = cs.crystal_frame(cs.N_ATOMS, cs.R_MAX, cs.SEED)
    n_edges = frame[keys.EDGE_INDEX].shape[1]
    mega = AllegroModel(**cs.FLAGSHIP, avg_num_neighbors=n_edges / n_atoms,
                        tp_kernel_backend="fused_infer").init(cs.SEED).to(dev)
    data = to_torch(mega.precompute_statics(batch_frames([frame], n_frames=1)),
                    dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    rows = cs.big_system_phase(mega, data, np.random.RandomState(cs.SEED), dev, smi)
    print(f"phases 8 and 8e in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
