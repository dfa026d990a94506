"""The Allegro two-track layer stack (twin of ``allegro_tpu/nn/allegro.py``).

Scalar latents plus the flat dim-major tensor track ``[E, d*U]``. Per layer:
weight the SH basis into channels with the current env weights, contract
against the tensor features with the environment sum fused in
(``scatter_factor = 1/sqrt(avg_num_neighbors)``), take the leading ``0e``
block as the layer's tensor scalars, and run the latent MLP on the densenet
concat of all scalar blocks so far, sliced into the next scalar block and
the next env weights.

The scatter factor is applied exactly once: in ``env_sum`` on the einsum
backend, folded into the last weight columns of the MLPs that produce env
weights on the kernel backends (``fused_infer``, and ``fused``, the
trainable one).

On ``fused_infer`` the default is JAX's mega-fused stack (``_mega_forward``):
each latent MLP runs in one kernel with the next layer's env scatter, and
layer 0 builds its features from the tensor embed's factors in the kernel.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..data import keys
from ..lib.irreps import Irrep, Irreps, tp_path_exists
from ..ops.fused_primitives import gather_tp_embed_infer, gather_tp_infer, mega_latent_env
from .channels import MakeWeightedChannels, device_index
from .contract import Contracter
from .mlp import ScalarMLP, silu

BACKENDS = ("einsum", "fused", "fused_infer")


def compute_irreps_ladder(irreps_sh: Irreps, allowed: Irreps, num_layers: int) -> List[Irreps]:
    """Per-layer tensor-track irreps: [input, out_0, ..., out_{L-1}]."""
    irreps_sh = Irreps(irreps_sh)
    allowed = Irreps(allowed).sorted().merged()
    ladder = [irreps_sh]
    for layer in range(num_layers):
        targets = Irreps("1x0e") if layer == num_layers - 1 else allowed
        out = Irreps(
            [(1, mi.ir) for mi in targets if tp_path_exists(ladder[-1], irreps_sh, mi.ir)]
        )
        if len(out) == 0 or out[0].ir != Irrep("0e"):
            raise ValueError(f"layer {layer}: ladder must start with 0e, got {out}")
        ladder.append(out)
    # backward prune: keep only irreps that can still produce a wanted output
    for layer in reversed(range(num_layers)):
        wanted = [w.ir for w in ladder[layer + 1]]
        kept = [
            (1, mi.ir)
            for mi in ladder[layer]
            if any(any(ir in wanted for ir in mi.ir * sh.ir) for sh in irreps_sh)
        ]
        ladder[layer] = Irreps(kept)
    return ladder


def _subset_dims(full: Irreps, subset: Irreps) -> List[int]:
    """Basis-dim indices of ``subset``'s irreps inside ``full`` (ordered)."""
    dims: List[int] = []
    used = set()
    full_slices = full.slices()
    for mi in subset:
        for k, fmi in enumerate(full):
            if fmi.ir == mi.ir and k not in used:
                used.add(k)
                dims.extend(range(full_slices[k].start, full_slices[k].stop))
                break
        else:
            raise ValueError(f"{mi} not found in {full}")
    return dims


class AllegroLayers(nn.Module):
    """Consumes EDGE_EMBEDDING/EDGE_ATTRS and EDGE_FEATURES (on the mega
    path EDGE_FEATURE_WEIGHTS instead), writes EDGE_SCALARS (a tuple of
    ``num_layers + 1`` blocks ``[E, S]``).

    ``use_mega`` (None, True or False) selects the mega-fused stack on
    ``fused_infer``, as in JAX (``allegro_tpu/nn/allegro.py:341-357``): it
    runs when the backend is ``fused_infer``, the latent MLPs have exactly
    one hidden layer, their activation is SiLU (the mega kernels' own), and
    ``use_mega`` is not False. Outside that condition ``use_mega=True``
    takes the non-mega kernels (``fused_layer_infer``), as JAX does. JAX's
    environment switches (``ALLEGRO_NO_MEGA``, ``ALLEGRO_TP_BYPASS``) are
    not read: the model kwarg decides."""

    def __init__(
        self,
        irreps_sh: str,
        tensor_track_allowed_irreps: str,
        embed_dim: int,
        num_layers: int = 2,
        num_scalar_features: int = 64,
        num_tensor_features: int = 16,
        avg_num_neighbors: float = 1.0,
        mlp_hidden_dims: Sequence[int] = (64,),
        mlp_nonlinearity=silu,
        tp_path_channel_coupling: bool = True,
        dtype=torch.float32,
        tp_kernel_backend: str = "einsum",
        use_mega: Optional[bool] = None,
    ):
        super().__init__()
        if tp_kernel_backend not in BACKENDS:
            raise NotImplementedError(
                f"tp_kernel_backend={tp_kernel_backend!r} is not ported yet; the port has "
                f"{BACKENDS} (ROADMAP.md queue 1, item 7)"
            )
        irreps_sh = Irreps(irreps_sh)
        ladder = compute_irreps_ladder(irreps_sh, Irreps(tensor_track_allowed_irreps), num_layers)
        self.num_layers = int(num_layers)
        self.S = S = int(num_scalar_features)
        self.U = U = int(num_tensor_features)
        self.backend = tp_kernel_backend
        self.dtype = dtype
        self.env_weighter = MakeWeightedChannels(irreps_sh, U)
        env_numel = self.env_weighter.weight_numel
        scatter_factor = 1.0 / math.sqrt(avg_num_neighbors)
        fold = tp_kernel_backend in ("fused", "fused_infer")
        env_scale = (S, scatter_factor) if fold else None
        self.first_projection = ScalarMLP(
            embed_dim, S + env_numel, hidden_dims=(), dtype=dtype, out_col_scale=env_scale
        )
        self.tps = nn.ModuleList()
        self.latents = nn.ModuleList()
        for layer in range(self.num_layers):
            self.tps.append(
                Contracter(
                    str(ladder[layer]), str(irreps_sh), str(ladder[layer + 1]), U,
                    path_channel_coupling=tp_path_channel_coupling,
                    scatter_factor=None if fold else scatter_factor,
                    dtype=dtype,
                    kernel_backend=tp_kernel_backend,
                )
            )
            last = layer == self.num_layers - 1
            self.latents.append(
                ScalarMLP(
                    S * (layer + 1) + U, S + (0 if last else env_numel),
                    hidden_dims=tuple(mlp_hidden_dims), nonlinearity=mlp_nonlinearity,
                    dtype=dtype, out_col_scale=None if last else env_scale,
                )
            )
        # layer-0 column blocks if the backward prune shrank the input irreps
        self.input_dims = None if ladder[0] == irreps_sh else tuple(_subset_dims(irreps_sh, ladder[0]))
        self.mega = (
            tp_kernel_backend == "fused_infer" and len(mlp_hidden_dims) == 1
            and mlp_nonlinearity is silu and use_mega is not False
        )
        # layer 0's input rows as (SH dim, irrep), for the embed-fused kernel
        dim_to_irr = self.env_weighter.dim_to_irr
        in_dims = self.input_dims or range(irreps_sh.dim)
        self.register_buffer(
            "row_specs", torch.tensor([(j, dim_to_irr[j]) for j in in_dims], dtype=torch.int32),
            persistent=False,
        )

    def forward(self, data: Dict) -> Dict:
        S, U = self.S, self.U
        n_atoms = data[keys.POSITIONS].shape[0]
        centers = data[keys.EDGE_INDEX][0]
        sh = data[keys.EDGE_ATTRS].to(self.dtype)
        fused = self.backend != "einsum"
        if fused:
            if keys.CENTER_ROW_PTR not in data:
                raise ValueError(
                    f"tp_kernel_backend={self.backend!r} needs the CSR statics: "
                    "call Model.precompute_statics(data) once per neighbor list"
                )
            centers = centers.to(torch.int32).contiguous()
            row_ptr = data[keys.CENTER_ROW_PTR]
            sh = sh.contiguous()
        out = dict(data)
        if self.mega:
            out[keys.EDGE_SCALARS] = self._mega_forward(data, sh, centers, row_ptr)
            return out
        features = data[keys.EDGE_FEATURES]
        if self.input_dims is not None:
            cols = device_index(
                tuple(d * U + u for d in self.input_dims for u in range(U)), features.device
            )
            features = features.index_select(1, cols)
        proj = self.first_projection(data[keys.EDGE_EMBEDDING])
        scalar_blocks = [proj[:, :S]]
        env_w = proj[:, S:]
        for layer in range(self.num_layers):
            tp = self.tps[layer]
            if fused:
                feats = tp.fused_call(
                    features.contiguous(), sh, env_w.contiguous(), centers, row_ptr
                )
            else:
                weighted_sh = self.env_weighter.flat_dim_major(sh, env_w)
                feats = tp(features, weighted_sh, centers, n_atoms)
            # densenet latent input: the pieces, not a materialized concat
            lat = self.latents[layer](scalar_blocks + [feats[:, :U]])
            scalar_blocks.append(lat[:, :S])
            env_w = lat[:, S:]
            features = feats
        out[keys.EDGE_SCALARS] = tuple(scalar_blocks)
        return out

    def _mega_forward(self, data: Dict, sh, centers, row_ptr) -> tuple:
        """Twin of JAX's ``_mega_forward`` / ``_mega_layer_body``: the first
        projection is a mega call with no hidden layer (scalar block 0 and
        layer 0's env); layer 0 runs the embed-fused TP on the tensor embed's
        factors (``EDGE_FEATURE_WEIGHTS``, which the port's embed always
        emits), later layers the plain TP, each with its leading 0e block as
        a second output wherever the layer has more than one output dim;
        every latent but the last is a mega call that also scatters the next
        layer's env, the last is the plain ScalarMLP."""
        S, U = self.S, self.U
        d2i = self.tps[0].dim_to_irr
        (w_proj,) = self.first_projection.weights()
        emb = data[keys.EDGE_EMBEDDING].to(self.dtype)
        lat_s, env = mega_latent_env((emb,), sh, w_proj, None, centers, row_ptr, d2i, U, S)
        blocks = [lat_s]
        w2b = data[keys.EDGE_FEATURE_WEIGHTS].to(self.dtype).contiguous()
        for layer, tp in enumerate(self.tps):
            wk, entry_idx, entry_coef = tp.fused_infer_parts(self.dtype)
            split = tp.d3 > 1
            if layer == 0:
                res = gather_tp_embed_infer(sh, w2b, env, wk, centers, row_ptr, entry_idx,
                                            entry_coef, self.row_specs, tp.d3, split)
            else:
                res = gather_tp_infer(x, env, wk, centers, row_ptr, entry_idx, entry_coef, tp.d3,
                                      split)
            x, tp_scalars = res if split else (res, res[:, :U])
            latent = self.latents[layer]
            if layer == self.num_layers - 1:
                lat_s = latent(blocks + [tp_scalars])
            else:
                w0, w1 = latent.weights()
                lat_s, env = mega_latent_env(tuple(blocks) + (tp_scalars,), sh, w0, w1, centers,
                                             row_ptr, d2i, U, S)
            blocks.append(lat_s)
        return tuple(blocks)
