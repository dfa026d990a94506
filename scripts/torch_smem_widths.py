#!/usr/bin/env python3
"""The widest shapes each shared-memory-bound launcher of the port takes,
from the launchers' own layout rules, for a card whose blocks may opt into
LIMIT bytes (default an H100's 232,448). Arithmetic only: runs anywhere.

    python3 scripts/torch_smem_widths.py [--limit BYTES]

- the fused readout (``readout_sum`` and ``readout_bwd``,
  ``csrc/center_readout.cu``): the widest input K = S (L + 1) at each
  hidden width H;
- the mega layers (``latent_env_scatter`` / ``latent_env_bwd`` and the
  embed-fused layer 0, ``csrc/mega.cu``), by ``AllegroLayers.mega_fits``:
  the widest S at the default latent width 64, the widest latent width at
  S = 64, and the widest U, for l_max 2 and 3 (2 layers);
- the launchers with no other route (``fused_call``'s kernels):
  ``bwd_fused`` without dw (``csrc/sparse_tp.cu:launch_bwd_fused_walk``:
  both path tables, the env row and one chunk of rows must fit), and the
  row kernels of ``csrc/train_tp.cu`` (``unweight_sh`` / ``unweight_both``
  at one edge per tile and no staged row; ``env_scatter`` at one edge per
  chunk): the widest U at layer 0, l_max 2 and 3.

Copies of the formulas of ``launch_bwd_fused_walk`` and ``fit_tile`` are
here; the route rules are ``ops/smem_fit.py``'s, which ``chip_smoke.py``
holds to the launchers' own code on the card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from allegro_tpu_torch.ops import smem_fit  # noqa: E402

DESC_COLS = 8


def widest(fits, lo, hi):
    """The largest w in [lo, hi] with fits(w) (fits falls once), or None."""
    if not fits(lo):
        return None
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


def layers(l_max, S=64, H=64, U=32):
    from allegro_tpu_torch.model import AllegroModel

    m = AllegroModel(r_max=4.0, type_names=["A", "B", "C"], l_max=l_max, num_layers=2,
                     num_scalar_features=S, num_tensor_features=U,
                     allegro_mlp_hidden_layers_width=H, tp_kernel_backend="fused_infer")
    return m.module.allegro


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--limit", type=int, default=232448)
    limit = p.parse_args().limit
    print(f"opt-in limit {limit} B")
    for H in (1, 32, 64, 128, 256):
        K = widest(lambda k: smem_fit.readout_sum_bytes(k, H, limit) <= limit
                   and smem_fit.readout_bwd_bytes(k, H, H > 1, limit) <= limit, 1, 8192)
        print(f"fused readout, hidden width {H}: K <= {K}")
    for l_max in (2, 3):
        # widths in steps of 8 (S must be even: the product type embedding)
        S = 8 * widest(lambda s: layers(l_max, S=8 * s).mega_fits(limit), 1, 128)
        H = 8 * widest(lambda h: layers(l_max, H=8 * h).mega_fits(limit), 1, 256)
        U = 8 * widest(lambda u: layers(l_max, U=8 * u).mega_fits(limit), 1, 128)
        print(f"mega layers, l_max {l_max}: S <= {S} (latent width 64), latent width <= {H} "
              f"(S = 64), U <= {U} (S = 64), in steps of 8")
        tp = layers(l_max).tps[0]
        _, swapped, scatter = tp.infer_paths()
        rows = swapped.desc.shape[0] + scatter.desc.shape[0]
        d1, d2, d3 = tp.d1, tp.d2, tp.d3
        n_irr = tp.irr_ranges.shape[0]

        def walk(u):
            return 4 * (rows * (DESC_COLS + u) + d2 * u + (d2 + d1 + d3) * u) <= limit

        print(f"bwd_fused walk, l_max {l_max} layer 0 ({rows} path rows): "
              f"U <= {widest(walk, 1, 1024)} (its own check: U <= 1024)")
        row_u = widest(lambda u: 4 * (n_irr * u + d2 + 2 * n_irr) <= limit, 1, 1 << 20)
        print(f"unweight_sh / unweight_both / env_scatter, l_max {l_max} layer 0: U <= {row_u}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
