#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s multi-device phase alone on one CUDA card
(``chip_smoke.parallel_phase``, the function its ``main`` calls as phase
10), every mesh ``[cuda:0] * D`` on that card: the slab and brick force
calls on the 4,096-atom crystal against the undecomposed call (10a),
``edge_shard`` over two (10b), 20 MD steps on slab and brick against
one-device ``edge_shard`` (10c), and the data-parallel ``fused`` step over
two 1k-atom rows (10d).

    python3 scripts/torch_parallel.py

Prints what phase 10 prints and the card's name and power limit; exits
non-zero where a check fails or there is no card.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_parallel: no CUDA device", file=sys.stderr)
        return 1
    from allegro_tpu_torch.data import keys
    from allegro_tpu_torch.model import AllegroModel
    from allegro_tpu_torch.ops import _build

    t_start = time.perf_counter()

    def stamp(phase):
        print(f"[t] phase {phase} starts at {time.perf_counter() - t_start:.1f} s")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    so = _build.build_library()
    _build.load_library()
    print(f"built {so.name} in {time.perf_counter() - t_start:.1f} s")
    dev = torch.device("cuda", 0)
    frame, n_atoms = cs.crystal_frame(cs.N_ATOMS, cs.R_MAX, cs.SEED)
    n_edges = frame[keys.EDGE_INDEX].shape[1]
    mega = AllegroModel(**cs.FLAGSHIP, avg_num_neighbors=n_edges / n_atoms,
                        tp_kernel_backend="fused_infer").init(cs.SEED).to(dev)
    runs = cs.parallel_phase(mega, dev, smi, stamp)
    for run, counts in runs.items():
        print(f"launches {run}: {sum(counts.values())} ({counts})")
    print(f"[done] phase 10 in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
