"""Model builders (twin of ``allegro_tpu/model/builders.py``).

The same config-facing builders and keyword names, so a JAX builder config
builds the same model here: edge normalization → radial-chemical embed →
scalar-embed MLP → SH tensor embed → Allegro layers → edge readout → edge
sum (× 1/sqrt(2·avg_num_neighbors)) → per-type scale/shift → atomwise sum.
The stage names are the JAX package's, and ``model/convert.py`` carries JAX
parameters over.

Options the port does not run yet raise ``NotImplementedError`` naming the
ROADMAP item; none of them runs silently on something else.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..data import keys
from ..lib.irreps import Irreps
from ..nn import (
    AllegroLayers,
    AtomwiseReduce,
    EdgeLengthNormalizer,
    EdgewiseReduce,
    PerTypeScaleShift,
    ScalarMLP,
    SequentialGraphNet,
    TwoBodyBesselScalarEmbed,
    TwoBodySphericalHarmonicTensorEmbed,
    force_stress_wrapper,
)
from ..nn.mlp import silu
from ..ops.fused_primitives import readout_sum_infer
from ..ops.fused_tp import csr_row_ptr, neighbor_csr

NONLINEARITIES = {
    "silu": silu,
    "mish": lambda x: x * torch.tanh(torch.nn.functional.softplus(x)),
    # flax's nn.gelu is the tanh approximation
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    None: None,
    "none": None,
}

DTYPES = {"float64": torch.float64, "float32": torch.float32}

MODEL_BUILDERS: Dict[str, Callable] = {}


def model_builder(fn: Callable) -> Callable:
    MODEL_BUILDERS[fn.__name__] = fn
    return fn


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to allegro_tpu_torch yet (ROADMAP.md {item})")


class FieldMLP(torch.nn.Module):
    """Apply a ScalarMLP (``mlp``) to one field of the data dict."""

    def __init__(self, field: str, out_field: str, in_dim: int, output_dim: int,
                 hidden_dims: Sequence[int] = (), nonlinearity=silu, dtype=torch.float32):
        super().__init__()
        self.field = field
        self.out_field = out_field
        self.mlp = ScalarMLP(in_dim, output_dim, tuple(hidden_dims), nonlinearity, dtype)

    def forward(self, data: Dict) -> Dict:
        out = dict(data)
        out[self.out_field] = self.mlp(data[self.field])
        return out


class FusedEdgeReadoutSum(torch.nn.Module):
    """``edge_readout`` + ``edge_sum`` as one stage for the inference backend,
    with the edgewise ``factor`` folded into the MLP's last weight matrix.

    As in JAX, the fused readout kernel (``readout_sum_infer``: the per-edge
    MLP and the per-atom energy sum in one pass) runs when the CSR statics
    are present, the MLP has at most one hidden layer, its activation is
    SiLU, and ``use_fused`` is not False; otherwise the plain chain runs
    (readout MLP, then the edge sum, which takes the ``center_sum`` kernel
    when the statics are present). The parameters are ``mlp.w*`` either way,
    as in the JAX stage."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int] = (), nonlinearity=silu,
                 dtype=torch.float32, factor: Optional[float] = None,
                 use_fused: Optional[bool] = None):
        super().__init__()
        self.mlp = ScalarMLP(
            in_dim, 1, tuple(hidden_dims), nonlinearity, dtype,
            out_col_scale=None if factor is None else (0, factor),
        )
        self.fusable = len(hidden_dims) <= 1 and nonlinearity is silu and use_fused is not False
        self.reduce = EdgewiseReduce(field=keys.EDGE_ENERGY, out_field=keys.PER_ATOM_ENERGY)

    def forward(self, data: Dict) -> Dict:
        blocks = data[keys.EDGE_SCALARS]
        pieces = tuple(blocks) if isinstance(blocks, (tuple, list)) else (blocks,)
        out = dict(data)
        if self.fusable and keys.CENTER_ROW_PTR in data:
            ws = self.mlp.weights()
            centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
            out[keys.PER_ATOM_ENERGY] = readout_sum_infer(
                pieces, ws[0], ws[1] if len(ws) > 1 else None, centers,
                data[keys.CENTER_ROW_PTR],
            )
            return out
        out[keys.EDGE_ENERGY] = self.mlp(pieces)
        return self.reduce(out)


def _as_numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class Model:
    """A built model: the module chain, its dtype and config, and the
    ``apply`` / ``apply_with_derivatives`` entry points."""

    def __init__(self, module: SequentialGraphNet, model_dtype: torch.dtype,
                 config: Dict[str, Any], has_derivatives: bool = True,
                 builder_kwargs: Optional[Dict[str, Any]] = None):
        self.module = module
        self.model_dtype = model_dtype
        self.config = config
        self.has_derivatives = has_derivatives
        self.builder_kwargs = builder_kwargs or {}

    def init(self, seed: int) -> "Model":
        """(Re)initialize every parameter from ``torch.Generator(seed)``.
        Values are drawn on the CPU, so they do not depend on the device."""
        gen = torch.Generator().manual_seed(int(seed))
        for m in self.module.modules():
            if m is not self.module and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
        return self

    def to(self, device) -> "Model":
        self.module.to(device)
        return self

    def state_dict(self):
        return self.module.state_dict()

    def parameters(self) -> Dict[str, torch.nn.Parameter]:
        """The trainable parameters by name: the ``state_dict`` names, which
        are ``params_from_jax``'s (fixed per-type scales/shifts are buffers
        and not among them)."""
        return dict(self.module.named_parameters())

    def load_state_dict(self, state_dict, strict: bool = True):
        return self.module.load_state_dict(state_dict, strict=strict)

    def precompute_statics(self, data: Dict) -> Dict:
        """Attach the position-independent per-neighbor-list arrays, on the
        host: ``EDGE_TYPE``, and for the kernel backends (``fused``,
        ``fused_infer``) the CSR statics of the TP layers and the center
        gathers: ``CENTER_ROW_PTR`` over the center-sorted edges, and
        ``NBR_PERM`` / ``NBR_ROW_PTR`` over the neighbor-sorted order. Call it
        once per neighbor list. Raises ValueError on edges that are not
        sorted by center. Torch inputs get tensors on the device of
        ``EDGE_INDEX``."""
        ei = _as_numpy(data[keys.EDGE_INDEX])
        types = _as_numpy(data[keys.ATOM_TYPES])
        n_atoms = types.shape[0]
        num_types = len(self.config["type_names"])
        ct = types[np.clip(ei[0], 0, n_atoms - 1)]
        nt = types[np.clip(ei[1], 0, n_atoms - 1)]
        new = {keys.EDGE_TYPE: (ct * num_types + nt).astype(np.int32)}
        if self.builder_kwargs.get("tp_kernel_backend") in ("fused", "fused_infer"):
            new[keys.CENTER_ROW_PTR] = csr_row_ptr(ei[0], n_atoms)
            new[keys.NBR_PERM], new[keys.NBR_ROW_PTR] = neighbor_csr(ei[1], n_atoms)
        out = dict(data)
        like = data[keys.EDGE_INDEX]
        for k, v in new.items():
            out[k] = torch.as_tensor(v, device=like.device) if isinstance(like, torch.Tensor) else v
        return out

    def apply(self, data: Dict) -> Dict:
        """Energy-only forward pass."""
        _pin_fp32_matmuls()
        return self.module(data)

    def apply_with_derivatives(self, data: Dict, create_graph: bool = False) -> Dict:
        """Forward + forces (and virial/stress when a cell is present).
        ``create_graph``: keep the graph of the derivatives, so a loss on the
        forces can be differentiated in the parameters (training); otherwise
        the outputs are plain values (the force call)."""
        _pin_fp32_matmuls()
        return force_stress_wrapper(self.module, create_graph=create_graph)(data)

    def __call__(self, data: Dict) -> Dict:
        if self.has_derivatives:
            return self.apply_with_derivatives(data)
        return self.apply(data)


def _pin_fp32_matmuls() -> None:
    # precision "highest" is the reference's allow_tf32: false — full float32
    # matrix products on the card, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _bessel_embed(cfg, num_types: int, output_dim: int, dtype) -> TwoBodyBesselScalarEmbed:
    cfg = dict(cfg or {})
    target = cfg.pop("_target_", "allegro_tpu.nn.TwoBodyBesselScalarEmbed")
    if target.rsplit(".", 1)[-1] != "TwoBodyBesselScalarEmbed":
        raise _not_ported(f"radial_chemical_embed {target}", "queue 1, item 7")
    return TwoBodyBesselScalarEmbed(
        num_types=num_types,
        output_dim=output_dim,
        num_bessels=int(cfg.pop("num_bessels", 8)),
        polynomial_cutoff_p=int(cfg.pop("polynomial_cutoff_p", 6)),
        dtype=dtype,
    )


@model_builder
def FullAllegroEnergyModel(
    r_max: float,
    type_names: Sequence[str],
    irreps_edge_sh: Union[int, str],
    tensor_track_allowed_irreps: str,
    radial_chemical_embed: Optional[Dict] = None,
    radial_chemical_embed_dim: Optional[int] = None,
    per_edge_type_cutoff: Optional[Dict] = None,
    scalar_embed_mlp_hidden_layers_depth: int = 1,
    scalar_embed_mlp_hidden_layers_width: int = 64,
    scalar_embed_mlp_nonlinearity: Optional[str] = "silu",
    num_layers: int = 2,
    num_scalar_features: int = 64,
    num_tensor_features: int = 16,
    allegro_mlp_hidden_layers_depth: int = 1,
    allegro_mlp_hidden_layers_width: int = 64,
    allegro_mlp_nonlinearity: Optional[str] = "silu",
    tp_path_channel_coupling: bool = True,
    readout_mlp_hidden_layers_depth: int = 1,
    readout_mlp_hidden_layers_width: int = 32,
    readout_mlp_nonlinearity: Optional[str] = "silu",
    avg_num_neighbors: Optional[float] = None,
    weight_individual_irreps: bool = True,
    per_type_energy_scales: Optional[Union[float, Sequence[float]]] = None,
    per_type_energy_shifts: Optional[Union[float, Sequence[float]]] = None,
    per_type_energy_scales_trainable: bool = False,
    per_type_energy_shifts_trainable: bool = False,
    pair_potential: Optional[Dict] = None,
    model_dtype: str = "float32",
    tp_kernel_backend: str = "einsum",
    tp_chunk_edges: int = 0,
    remat: bool = False,
    tensor_dtype: Optional[str] = None,
    checkpoint_energy: bool = False,
    # layout of the JAX tensor embed's output; the port's track is always
    # flat dim-major, so both values build the same model
    features_layout: Optional[str] = None,
    # TPU block-plan mechanics that the CSR layout replaces: accepted so
    # builder kwargs round-trip, and ignored
    fused_block_edges: Optional[int] = None,
    window_rows: Optional[int] = None,
    onehot_passes: Optional[int] = None,
    allow_tf32: bool = False,
    precision: Optional[str] = None,
    use_mega: Optional[bool] = None,
    use_fused_readout: Optional[bool] = None,
    **_unused,
) -> Model:
    _kwargs = {k: v for k, v in locals().items() if k != "_unused"}
    if tensor_dtype is not None:
        raise _not_ported(f"tensor_dtype={tensor_dtype!r}", "queue 1, item 6")
    if remat or checkpoint_energy:
        raise _not_ported("remat/checkpoint_energy", "queue 1, item 6")
    if tp_chunk_edges:
        raise _not_ported("tp_chunk_edges", "queue 1, item 6")
    if per_edge_type_cutoff is not None:
        raise _not_ported("per_edge_type_cutoff", "queue 1, item 7")
    if pair_potential is not None:
        raise _not_ported("pair_potential (ZBL)", "queue 1, item 7")
    if not weight_individual_irreps:
        raise _not_ported("weight_individual_irreps=False", "queue 1, item 7")
    if allow_tf32 or precision not in (None, "highest"):
        raise _not_ported(f"precision={precision!r}/allow_tf32={allow_tf32}", "queue 1, item 6")
    if str(model_dtype) not in DTYPES:
        raise _not_ported(f"model_dtype={model_dtype!r}", "queue 1, item 6")
    dtype = DTYPES[str(model_dtype)]
    num_types = len(type_names)
    if isinstance(irreps_edge_sh, int):
        irreps_sh = Irreps.spherical_harmonics(irreps_edge_sh, p=-1)
    else:
        irreps_sh = Irreps(str(irreps_edge_sh))
    if irreps_sh.lmax > 2:
        raise _not_ported(f"l_max={irreps_sh.lmax} (> 2)", "queue 1, item 7")
    avg_n = float(avg_num_neighbors) if avg_num_neighbors is not None else 1.0
    embed_dim = (
        int(radial_chemical_embed_dim) if radial_chemical_embed_dim is not None
        else num_scalar_features
    )
    S = num_scalar_features
    readout_in = S * (num_layers + 1)
    readout_hidden = (readout_mlp_hidden_layers_width,) * readout_mlp_hidden_layers_depth
    readout_act = NONLINEARITIES[readout_mlp_nonlinearity]
    factor = 1.0 / math.sqrt(2.0 * avg_n)
    allegro = AllegroLayers(
        irreps_sh=str(irreps_sh),
        tensor_track_allowed_irreps=str(tensor_track_allowed_irreps),
        embed_dim=S,
        num_layers=num_layers,
        num_scalar_features=S,
        num_tensor_features=num_tensor_features,
        avg_num_neighbors=avg_n,
        mlp_hidden_dims=(allegro_mlp_hidden_layers_width,) * allegro_mlp_hidden_layers_depth,
        mlp_nonlinearity=NONLINEARITIES[allegro_mlp_nonlinearity],
        tp_path_channel_coupling=tp_path_channel_coupling,
        dtype=dtype,
        tp_kernel_backend=tp_kernel_backend,
        use_mega=use_mega,
    )

    layers = [
        ("edge_norm", EdgeLengthNormalizer(r_max=r_max, num_types=num_types)),
        ("radial_chemical_embed", _bessel_embed(radial_chemical_embed, num_types, embed_dim, dtype)),
        (
            "scalar_embed_mlp",
            FieldMLP(
                keys.EDGE_EMBEDDING, keys.EDGE_EMBEDDING, embed_dim, S,
                (scalar_embed_mlp_hidden_layers_width,) * scalar_embed_mlp_hidden_layers_depth,
                NONLINEARITIES[scalar_embed_mlp_nonlinearity], dtype,
            ),
        ),
        (
            "tensor_embed",
            # the mega-fused layer 0 reads the embed's factors, not its features
            TwoBodySphericalHarmonicTensorEmbed(str(irreps_sh), num_tensor_features, S, dtype,
                                                build_features=not allegro.mega),
        ),
        ("allegro", allegro),
    ]
    if tp_kernel_backend == "fused_infer":
        layers.append((
            "edge_readout",
            FusedEdgeReadoutSum(readout_in, readout_hidden, readout_act, dtype, factor=factor,
                                use_fused=use_fused_readout),
        ))
    else:
        layers += [
            (
                "edge_readout",
                FieldMLP(keys.EDGE_SCALARS, keys.EDGE_ENERGY, readout_in, 1, readout_hidden,
                         readout_act, dtype),
            ),
            ("edge_sum", EdgewiseReduce(keys.EDGE_ENERGY, keys.PER_ATOM_ENERGY, factor=factor)),
        ]
    layers += [
        (
            "per_type_scale_shift",
            PerTypeScaleShift(
                num_types,
                scales=per_type_energy_scales,
                shifts=per_type_energy_shifts,
                scales_trainable=per_type_energy_scales_trainable,
                shifts_trainable=per_type_energy_shifts_trainable,
                dtype=dtype,
            ),
        ),
        ("total_energy_sum", AtomwiseReduce()),
    ]
    config = dict(
        r_max=r_max,
        type_names=tuple(type_names),
        irreps_edge_sh=str(irreps_sh),
        tensor_track_allowed_irreps=str(tensor_track_allowed_irreps),
        num_layers=num_layers,
        num_scalar_features=num_scalar_features,
        num_tensor_features=num_tensor_features,
        avg_num_neighbors=avg_n,
        model_dtype=str(model_dtype),
    )
    return Model(SequentialGraphNet(layers), dtype, config, has_derivatives=False,
                 builder_kwargs=_kwargs)


@model_builder
def AllegroEnergyModel(l_max: int, parity: bool = True, **kwargs) -> Model:
    """Derive irreps from ``l_max``/``parity``."""
    if not parity:
        raise _not_ported("parity=False", "queue 1, item 7")
    if l_max > 2:
        raise _not_ported(f"l_max={l_max} (> 2)", "queue 1, item 7")
    irreps_sh = Irreps.spherical_harmonics(l_max, p=-1)
    allowed = Irreps([(1, (l, p)) for l in range(l_max + 1) for p in (1, -1)])
    return FullAllegroEnergyModel(
        irreps_edge_sh=str(irreps_sh), tensor_track_allowed_irreps=str(allowed), **kwargs
    )


@model_builder
def FullAllegroModel(**kwargs) -> Model:
    m = FullAllegroEnergyModel(**kwargs)
    m.has_derivatives = True
    return m


@model_builder
def AllegroModel(**kwargs) -> Model:
    m = AllegroEnergyModel(**kwargs)
    m.has_derivatives = True
    return m
