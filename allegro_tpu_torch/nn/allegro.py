"""The Allegro two-track layer stack (twin of ``allegro_tpu/nn/allegro.py``).

Scalar latents plus the flat dim-major tensor track ``[E, d*U]``. Per layer:
weight the SH basis into channels with the current env weights, contract
against the tensor features with the environment sum fused in
(``scatter_factor = 1/sqrt(avg_num_neighbors)``), take the leading ``0e``
block as the layer's tensor scalars, and run the latent MLP on the densenet
concat of all scalar blocks so far, sliced into the next scalar block and
the next env weights.

The scatter factor is applied exactly once: in ``env_sum`` on the einsum
and pallas backends, folded into the last weight columns of the MLPs that produce env
weights on the kernel backends (``fused_infer``, and ``fused``, the
trainable one).

On ``fused_infer`` the default is JAX's mega-fused stack (``_mega_forward``):
each latent MLP runs in one kernel with the next layer's env scatter, and
layer 0 builds its features from the tensor embed's factors in the kernel.

The big-system policies (JAX's ``tensor_dtype``, ``remat``,
``tp_chunk_edges``): ``tensor_dtype="bfloat16"`` stores the tensor track in
bfloat16 on both fused backends, on every route (JAX's ``if fused``): between
the mega layers, with the env weights rounded to it inside the latent
kernels, and off mega (``_layer_body``), with the env and path weights cast
to it each layer; ``einsum`` and ``pallas`` ignore it; ``remat``
recomputes each layer in the backward pass (``torch.utils.checkpoint``), on
every backend; ``tp_chunk_edges`` chunks the ``einsum`` contraction over
edges (``Contracter``).

A bfloat16 model (``dtype`` bfloat16, JAX's ``param_dtype``) keeps JAX's
dtypes: on the mega path the latent kernels' scalars and env are float32
(their compute dtype), layer 0's features and every layer's split scalars
bfloat16; off it every array the layer stores is bfloat16 but env
(float32); the kernels widen what they read.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data import keys
from ..lib.irreps import Irrep, Irreps, tp_path_exists
from ..ops import smem_fit
from ..ops.fused_primitives import gather_tp_embed_infer, gather_tp_infer, mega_latent_env
from ..ops.fused_tp import round_to
from .channels import MakeWeightedChannels, device_index
from .contract import Contracter
from .mlp import ScalarMLP, silu

BACKENDS = ("einsum", "fused", "fused_infer", "pallas")


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
    one hidden layer, their activation is SiLU (the mega kernels' own), the
    env weights are per irrep (``weight_individual_irreps``), and
    ``use_mega`` is not False. Outside that condition ``use_mega=True``
    takes the non-mega kernels (``fused_layer_infer``), as JAX does. JAX's
    environment switches (``ALLEGRO_NO_MEGA``, ``ALLEGRO_TP_BYPASS``) are
    not read: the model kwarg decides.

    ``weight_individual_irreps=False``: one env weight per channel, shared
    by the irreps; the kernel backends read it tiled over the irreps.

    Within that condition the mega kernels keep the latent MLPs' weights in
    shared memory, and the embed-fused layer 0 the path weights. Where the
    widths would not fit on the card (``mega_fits``, the launchers' own
    layout rule, ``ops/smem_fit.py``), the stack takes the non-mega kernels
    (``fused_call``), as it does outside the condition. ``route(device)``
    says which, decided once per device when the model first runs there.

    ``tensor_dtype`` (a torch dtype; None: the model dtype) is the storage of
    the tensor track on the fused backends, as in JAX: on the mega route
    layer 0's features out of the embed-fused TP, each later layer's out of
    ``gather_tp``, and their cotangents (``allegro_tpu/nn/allegro.py:480-518``),
    with the env weights rounded to it inside the latent kernels; off it
    (``fused_call``, on ``fused_infer`` and the trainable ``fused``) the
    features, cast once at entry, each layer's env weights, cast after the
    shared-weight tile, and their cotangents (``:240-270``, ``:521-534``),
    with the path weights cast to it (``Contracter.fused_call``); a mega
    model routed off the mega kernels keeps the mega path's rounding points
    (JAX runs mega for it). The scalars, sh, env and the parameters stay in
    the model dtype. JAX casts only where the backend is fused: on
    ``einsum`` and ``pallas`` the port ignores it (``self.tensor_dtype`` is
    None there, and the result is that of ``tensor_dtype=None`` bit for bit;
    JAX's tensor embed would still round layer 0's features there,
    ROADMAP.md queue 3). ``remat`` recomputes each layer's body in the backward
    pass instead of keeping its activations (JAX's ``nn.remat`` of
    ``_layer_body`` / ``_mega_layer_body``); every kernel sums in a fixed
    order, so the result is the same bits. ``tp_chunk_edges`` (> 0) chunks
    the ``einsum`` contraction over edges."""

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
        weight_individual_irreps: bool = True,
        tensor_dtype: Optional[torch.dtype] = None,
        remat: bool = False,
        tp_chunk_edges: int = 0,
    ):
        super().__init__()
        if tp_kernel_backend not in BACKENDS:
            raise NotImplementedError(
                f"tp_kernel_backend={tp_kernel_backend!r} is not ported; the port has "
                f"{BACKENDS} (ROADMAP.md queue 1, item 12: not to be ported)"
            )
        irreps_sh = Irreps(irreps_sh)
        ladder = compute_irreps_ladder(irreps_sh, Irreps(tensor_track_allowed_irreps), num_layers)
        self.num_layers = int(num_layers)
        self.S = S = int(num_scalar_features)
        self.U = U = int(num_tensor_features)
        self.backend = tp_kernel_backend
        self.dtype = dtype
        self.env_weighter = MakeWeightedChannels(irreps_sh, U, weight_individual_irreps)
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
                    chunk_edges=tp_chunk_edges,
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
            and mlp_nonlinearity is silu and weight_individual_irreps and use_mega is not False
        )
        self.embed_dim = int(embed_dim)
        self.tensor_dtype = None if tensor_dtype in (None, dtype) or not fold else tensor_dtype
        self.remat = bool(remat)
        self._routes: Dict[torch.device, str] = {}
        # layer 0's input rows as (SH dim, irrep), for the embed-fused kernel
        dim_to_irr = self.env_weighter.dim_to_irr
        in_dims = self.input_dims or range(irreps_sh.dim)
        self.register_buffer(
            "row_specs", torch.tensor([(j, dim_to_irr[j]) for j in in_dims], dtype=torch.int32),
            persistent=False,
        )

    def mega_fits(self, limit: Optional[int]) -> bool:
        """Whether every mega kernel's shared memory fits in ``limit`` bytes
        (None: no limit): ``latent_env_scatter`` and ``latent_env_bwd`` on
        the first projection (no hidden layer) and on every latent but the
        last, ``gather_tp_embed`` and ``bwd_embed`` on layer 0."""
        if limit is None:
            return True
        S, U = self.S, self.U
        d2, n_irr = self.env_weighter.irreps_in.dim, self.env_weighter.n_irr
        N = S + n_irr * U
        mlps = [(False, self.embed_dim, 0)]
        for layer in range(self.num_layers - 1):
            mlps.append((True, S * (layer + 1) + U, self.latents[layer].w0.shape[1]))
        for hidden, K, H in mlps:
            if (smem_fit.latent_env_scatter_bytes(hidden, K, H, N, d2, U, n_irr, limit) > limit
                    or smem_fit.latent_env_bwd_bytes(hidden, K, H, S, N, d2, U, n_irr, limit)
                    > limit):
                return False
        tp = self.tps[0]
        embed = (tp.cg_desc.shape[0], tp.w3j.shape[0], d2, n_irr, self.row_specs.shape[0], d2,
                 tp.d3, U, limit)
        return (smem_fit.gather_tp_embed_bytes(*embed) <= limit
                and smem_fit.bwd_embed_bytes(*embed) <= limit)

    def route(self, device) -> str:
        """The layer kernels this stack runs on ``device``: ``"mega"``, or
        the backend's own (``"fused_call"`` on ``fused`` / ``fused_infer``,
        ``"pallas"``, ``"einsum"``)."""
        device = torch.device(device)
        if device not in self._routes:
            mega = self.mega and self.mega_fits(smem_fit.smem_optin(device))
            own = "fused_call" if self.backend in ("fused", "fused_infer") else self.backend
            self._routes[device] = "mega" if mega else own
        return self._routes[device]

    def _body(self, fn, *args):
        """``fn(*args)``, with ``remat`` recomputed in the backward pass
        (only the arguments are kept)."""
        if self.remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def forward(self, data: Dict) -> Dict:
        S, U = self.S, self.U
        n_atoms = data[keys.POSITIONS].shape[0]
        centers = data[keys.EDGE_INDEX][0]
        sh = data[keys.EDGE_ATTRS].to(self.dtype)
        # the backend decides: einsum, the reference, ignores the CSR statics;
        # every kernel backend needs them (pallas is the einsum layer with its
        # env sum on the center kernels and its contraction on sparse_tp)
        row_ptr = None
        if self.backend != "einsum":
            row_ptr = data.get(keys.CENTER_ROW_PTR)
            if row_ptr is None:
                raise ValueError(
                    f"tp_kernel_backend={self.backend!r} needs the CSR statics: "
                    "call Model.precompute_statics(data) once per neighbor list"
                )
            centers = centers.to(torch.int32).contiguous()
            sh = sh.contiguous()
        out = dict(data)
        if self.route(sh.device) == "mega":
            out[keys.EDGE_SCALARS] = self._mega_forward(data, sh, centers, row_ptr)
            return out
        features = data.get(keys.EDGE_FEATURES)
        if features is None:
            # a mega model routed off the mega kernels: the tensor embed left
            # its features to layer 0 (build_features=False), so build them
            # here from its factors, as that embed would have
            features = self.env_weighter.flat_dim_major(sh, data[keys.EDGE_FEATURE_WEIGHTS])
        if self.input_dims is not None:
            cols = device_index(
                tuple(d * U + u for d in self.input_dims for u in range(U)), features.device
            )
            features = features.index_select(1, cols)
        if self.tensor_dtype is not None and not self.mega:
            # JAX's non-mega path: the track's storage from here on, cast
            # once at entry. A mega model routed off the mega kernels keeps
            # the mega path's rounding points instead (JAX runs mega there):
            # layer 0 reads its features unrounded (x0, built in the kernel
            # on mega) and stores its output in the track
            features = features.to(self.tensor_dtype)
        proj = self.first_projection(data[keys.EDGE_EMBEDDING])
        scalar_blocks = [proj[:, :S]]
        env_w = proj[:, S:]
        for layer in range(self.num_layers):
            # the blocks so far as a tuple: remat's recompute reads the
            # arguments as they were, and the list grows after the call
            features, lat = self._body(self._layer_body, layer, features, env_w,
                                       tuple(scalar_blocks), sh, centers, n_atoms, row_ptr)
            scalar_blocks.append(lat[:, :S])
            env_w = lat[:, S:]
        out[keys.EDGE_SCALARS] = tuple(scalar_blocks)
        return out

    def _layer_body(self, layer: int, features, env_w, scalar_blocks, sh, centers, n_atoms,
                    row_ptr):
        """One layer off the mega route: the TP (with its env sum) and the
        latent MLP on the densenet pieces → (features, latent output)."""
        tp = self.tps[layer]
        tp_scalars = None
        if self.backend in ("fused", "fused_infer"):
            # the shared weights tiled over the irreps, then (the bf16
            # track) cast to its storage, in JAX's order
            wexp = self.env_weighter.per_irrep(env_w)
            track = self.tensor_dtype
            # a mega model routed off the mega kernels on the track keeps
            # JAX's mega rounding points: the env weights rounded for the
            # product only (their cotangent unrounded), each layer's scalars
            # unrounded where the mega layer splits them out (more than one
            # output dim)
            routed = track is not None and self.mega
            split = routed and tp.d3 > 1
            if track is not None and not routed:
                wexp = wexp.to(track)
            feats = tp.fused_call(features.contiguous(), sh, wexp.contiguous(), centers, row_ptr,
                                  split, track if routed else None)
            if split:
                feats, tp_scalars = feats
            if track is not None:
                feats = feats.to(track)
        else:
            weighted_sh = self.env_weighter.flat_dim_major(sh, env_w)
            feats = tp(features, weighted_sh, centers, n_atoms, row_ptr)
        if tp_scalars is None:
            # the track's scalars back in the model dtype
            tp_scalars = feats[:, :self.U].to(self.dtype)
        # densenet latent input: the pieces, not a materialized concat
        return feats, self.latents[layer](list(scalar_blocks) + [tp_scalars])

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
        d2i, ranges = self.tps[0].dim_to_irr, self.tps[0].irr_ranges
        (w_proj,) = self.first_projection.weights()
        emb = data[keys.EDGE_EMBEDDING].to(self.dtype)
        lat_s, env = mega_latent_env((emb,), sh, w_proj, None, centers, row_ptr, d2i, U, S,
                                     ranges, self.tensor_dtype)
        blocks = [lat_s]
        # layer 0's input: the embed's channel weights, x0 built in the kernel
        x = data[keys.EDGE_FEATURE_WEIGHTS].to(self.dtype).contiguous()
        for layer in range(self.num_layers):
            x, lat_s, env = self._body(self._mega_layer_body, layer, x, env, tuple(blocks), sh,
                                       centers, row_ptr)
            blocks.append(lat_s)
        return tuple(blocks)

    def _mega_layer_body(self, layer: int, x, env, blocks, sh, centers, row_ptr):
        """One mega layer (JAX's ``_mega_layer_body``): the TP of x (layer
        0: the embed's channel weights) with env, then the latent MLP, as a
        mega call that also sums the next layer's env (plain on the last
        layer) → (features, lat_s, next env). On the bf16 track the features
        are stored in ``tensor_dtype``; the scalars stay in the model dtype."""
        S, U = self.S, self.U
        tp = self.tps[layer]
        wk, entry_idx, entry_coef = tp.fused_infer_parts(self.dtype)
        if layer > 0:
            # JAX reads the path weights in the features' dtype
            # (fused_infer_parts(x.dtype)): on the bf16 track, rounded
            wk = round_to(wk, self.tensor_dtype)
        split = tp.d3 > 1
        if layer == 0:
            res = gather_tp_embed_infer(sh, x, env, wk, centers, row_ptr, entry_idx, entry_coef,
                                        self.row_specs, tp.d3, split, tp.cg_paths(),
                                        self.tensor_dtype)
        else:
            res = gather_tp_infer(x, env, wk, centers, row_ptr, entry_idx, entry_coef, tp.d3,
                                  split, *tp.infer_paths(), ts_dtype=self.dtype)
        feats, tp_scalars = res if split else (res, res[:, :U].to(self.dtype))
        latent = self.latents[layer]
        if layer == self.num_layers - 1:
            return feats, latent(list(blocks) + [tp_scalars]), env
        w0, w1 = latent.weights()
        lat_s, env = mega_latent_env(tuple(blocks) + (tp_scalars,), sh, w0, w1, centers, row_ptr,
                                     tp.dim_to_irr, U, S, tp.irr_ranges, self.tensor_dtype)
        return feats, lat_s, env

