#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s deployment phase alone on one CUDA card
(``chip_smoke.deploy_phase``, the function its ``main`` calls as phase 9):
the flagship's force call on the ghost-format 4,096-atom crystal exported
(9a), built into an AOTInductor ``.pt2`` and run from Python (9b) and from
the C++ MD driver (9c), and ``python -m allegro_tpu_torch compile`` on a
tutorial workdir (9d), which this script trains first with ``python -m
allegro_tpu_torch run -c configs/tutorial.yaml`` while the kernels build.

    python3 scripts/torch_deploy.py

Prints what phase 9 prints and the card's name and power limit; exits
non-zero where a check fails or there is no card.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_deploy: no CUDA device", file=sys.stderr)
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
    with tempfile.TemporaryDirectory(prefix="torch_deploy_") as tmp:
        tutorial = Path(tmp) / "tutorial"
        train = subprocess.Popen([sys.executable, "-m", "allegro_tpu_torch", "run", "-c",
                                  "configs/tutorial.yaml", "-w", str(tutorial)], cwd=cs.REPO,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        so = _build.build_library()
        _build.load_library()
        print(f"built {so.name} in {time.perf_counter() - t_start:.1f} s")
        out, err = train.communicate(timeout=cs.CLI_TIMEOUT)
        if train.returncode != 0:
            print(out[-2000:], err[-3000:], file=sys.stderr)
            return 1
        print(f"trained the tutorial in {time.perf_counter() - t_start:.1f} s")
        dev = torch.device("cuda", 0)
        frame, n_atoms = cs.crystal_frame(cs.N_ATOMS, cs.R_MAX, cs.SEED)
        n_edges = frame[keys.EDGE_INDEX].shape[1]
        mega = AllegroModel(**cs.FLAGSHIP, avg_num_neighbors=n_edges / n_atoms,
                            tp_kernel_backend="fused_infer").init(cs.SEED).to(dev)
        cs.deploy_phase(mega, dev, smi, str(tutorial), stamp)
    print(f"[done] phase 9 in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
