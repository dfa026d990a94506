"""Model builders (twin of ``allegro_tpu/model/builders.py``).

The same config-facing builders and keyword names, so a JAX builder config
builds the same model here: edge normalization → radial-chemical embed →
scalar-embed MLP → SH tensor embed → Allegro layers → edge readout → edge
sum (× 1/sqrt(2·avg_num_neighbors)) → per-type scale/shift → optional ZBL
pair potential → atomwise sum. The stage names are the JAX package's, and
``model/convert.py`` carries JAX parameters over. The model modifiers
(``MODEL_MODIFIERS``, ``modify``) rebuild a model on another TP backend with
the same parameters.

Options the port does not run yet raise ``NotImplementedError`` naming the
ROADMAP item; none of them runs silently on something else.

The big-system and precision policies are JAX's builder kwargs:
``tensor_dtype="bfloat16"`` (the bf16 tensor track, on both fused backends;
``einsum`` and ``pallas`` ignore it),
``remat`` (each layer recomputed in the backward pass), ``checkpoint_energy``
(the whole energy recomputed inside the force call's backward pass),
``tp_chunk_edges`` (the ``einsum`` contraction over edge slices), and the
matrix-product policy ``precision`` / ``allow_tf32``, resolved as JAX does
(``precision`` if given, else None with ``allow_tf32``, else "highest") and
set for each model call, then restored: "highest" and "high" are exact
float32 products on the card ("high", JAX's 3-pass bf16 split at ~1e-7,
has no such split here: exact is its closest form, ROADMAP.md queue 3);
None lets the products outside the kernels use TF32 (the reference's
``allow_tf32: true``). The kernels compute in exact float32 under every
policy. ``features_layout`` is accepted and ignored: the port's track is
always flat dim-major.

``model_dtype="bfloat16"`` (JAX's: every parameter in bfloat16) serves on
``fused_infer`` (on and off the mega path), ``pallas``, ``einsum`` and the
trainable ``fused`` with JAX's rounding points and output dtypes, and
trains on ``fused``, ``pallas`` and ``einsum``; its export raises (ROADMAP
item 14).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data import keys
from ..data.datasets import ATOMIC_NUMBERS
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
    TwoBodySplineScalarEmbed,
    ZBLPairPotential,
    force_stress_wrapper,
)
from ..nn.mlp import silu
from ..ops import smem_fit
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

# the model dtypes, and the tensor track's storages (tensor_dtype)
DTYPES = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}
# the matrix-product policies (the resolved precision): whether the products
# outside the kernels may use TF32
PRECISIONS = {"highest": False, "high": False, None: True}

# the backends whose stages run on the kernels, and the CSR statics they read
KERNEL_BACKENDS = ("fused", "fused_infer", "pallas")
CSR_STATICS = (keys.CENTER_ROW_PTR, keys.NBR_PERM, keys.NBR_ROW_PTR)

MODEL_BUILDERS: Dict[str, Callable] = {}


def model_builder(fn: Callable) -> Callable:
    MODEL_BUILDERS[fn.__name__] = fn
    return fn


MODEL_MODIFIERS: Dict[str, Callable] = {}


def model_modifier(fn: Callable) -> Callable:
    MODEL_MODIFIERS[fn.__name__] = fn
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
    when the statics are present). The fused kernels keep W0ᵀ in shared
    memory: where the readout is too wide for the card (``fits``, the
    launchers' own layout rule, ``ops/smem_fit.py``), the plain chain runs
    there too. ``route(device)`` says which, decided once per device when
    the stage first runs there. The parameters are ``mlp.w*`` either way, as
    in the JAX stage."""

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
        self._routes: Dict[torch.device, str] = {}

    def fits(self, limit: Optional[int]) -> bool:
        """Whether ``readout_sum`` and ``readout_bwd`` fit in ``limit`` bytes
        of shared memory (None: no limit)."""
        if limit is None:
            return True
        K, H = self.mlp.w0.shape
        hidden = self.mlp.n_layers > 1
        return (smem_fit.readout_sum_bytes(K, H, limit) <= limit
                and smem_fit.readout_bwd_bytes(K, H, hidden, limit) <= limit)

    def route(self, device) -> str:
        """``"fused"`` (``readout_sum`` / ``readout_bwd``) or ``"plain"`` (the
        readout MLP, then the edge sum) on ``device``."""
        device = torch.device(device)
        if device not in self._routes:
            fused = self.fusable and self.fits(smem_fit.smem_optin(device))
            self._routes[device] = "fused" if fused else "plain"
        return self._routes[device]

    def forward(self, data: Dict) -> Dict:
        blocks = data[keys.EDGE_SCALARS]
        pieces = tuple(blocks) if isinstance(blocks, (tuple, list)) else (blocks,)
        out = dict(data)
        if keys.CENTER_ROW_PTR in data and self.route(pieces[0].device) == "fused":
            ws = self.mlp.weights()
            centers = data[keys.EDGE_INDEX][0].to(torch.int32).contiguous()
            # summed in the compute dtype and stored, as JAX stores it, in the
            # model dtype (its fused readout's per_atom.astype(param_dtype));
            # JAX runs that readout only where its rank plan is the identity
            # (keys.CENTER_RANK_IDENTITY), else the plain chain, whose sum
            # keeps the pieces' dtype. The two differ in a bfloat16 model
            # only: float32 pieces on the mega route
            dtype = ws[0].dtype if keys.CENTER_RANK_IDENTITY in data else \
                functools.reduce(torch.promote_types, (p.dtype for p in pieces))
            out[keys.PER_ATOM_ENERGY] = readout_sum_infer(
                pieces, ws[0], ws[1] if len(ws) > 1 else None, centers,
                data[keys.CENTER_ROW_PTR],
            ).to(dtype)
            return out
        out[keys.EDGE_ENERGY] = self.mlp(pieces)
        return self.reduce(out)


def _row_ptr(sorted_ids: torch.Tensor, n: int) -> torch.Tensor:
    """``csr_row_ptr`` in torch: the first position of each id in ``[0, n]``
    (int32 [n+1]). Non-decreasing in the id on any input, so a kernel's
    segments stay within the array even where the ids are not sorted."""
    ids = torch.arange(n + 1, dtype=sorted_ids.dtype, device=sorted_ids.device)
    return torch.searchsorted(sorted_ids.contiguous(), ids, out_int32=True)


def _class_lookups(ct, nt, types, num_types: int, real_edge, real_atom) -> Dict:
    """Each class lookup's (class per edge or atom, table rows, real mask),
    from the center and neighbor types per edge and the types per atom
    (numpy arrays or tensors alike)."""
    return {
        keys.CENTER_TYPE_LOOKUP: (ct, num_types, real_edge),
        keys.NEIGHBOR_TYPE_LOOKUP: (nt, num_types, real_edge),
        keys.EDGE_CLASS_LOOKUP: (ct * num_types + nt, num_types**2, real_edge),
        keys.ATOM_TYPE_LOOKUP: (types, num_types, real_atom),
    }


def _as_numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class Model:
    """A built model: the module chain, its dtype and config, and the
    ``apply`` / ``apply_with_derivatives`` entry points."""

    def __init__(self, module: SequentialGraphNet, model_dtype: torch.dtype,
                 config: Dict[str, Any], has_derivatives: bool = True,
                 builder_kwargs: Optional[Dict[str, Any]] = None,
                 checkpoint_energy: bool = False, precision: Optional[str] = "highest"):
        self.module = module
        self.model_dtype = model_dtype
        self.config = config
        self.has_derivatives = has_derivatives
        self.builder_kwargs = builder_kwargs or {}
        # recompute the whole energy inside the force call's backward pass
        self.checkpoint_energy = bool(checkpoint_energy)
        # the resolved matrix-product policy: "highest", "high" or None
        self.precision = precision

    @contextlib.contextmanager
    def matmul_policy(self):
        """The model's matrix-product policy for the duration of a call:
        TF32 for the products outside the kernels only where the resolved
        precision is None (``allow_tf32``), exact float32 otherwise; the
        process's flags are restored after it."""
        cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
        before = (cuda.allow_tf32, cudnn.allow_tf32)
        cuda.allow_tf32 = cudnn.allow_tf32 = PRECISIONS[self.precision]
        try:
            yield
        finally:
            cuda.allow_tf32, cudnn.allow_tf32 = before

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

    def routes(self, device=None) -> Dict[str, str]:
        """The kernel route of each stage that has a choice, on ``device``
        (default: where the parameters are): ``{"allegro": "mega" |
        "fused_call" | "pallas" | "einsum", "edge_readout": "fused" |
        "plain"}`` (the readout only on ``fused_infer``). A fused route whose
        shared memory would not fit on the card is not taken there."""
        if device is None:
            device = next(self.module.parameters()).device
        return {name: m.route(device) for name, m in self.module.named_children()
                if hasattr(m, "route")}

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
        ``fused_infer``, ``pallas``) the CSR statics of the TP layers, the
        env sums and the center gathers: ``CENTER_ROW_PTR`` over the
        center-sorted edges, ``NBR_PERM`` / ``NBR_ROW_PTR`` over the
        neighbor-sorted order, and the class CSR of each trainable parameter
        table read by class (``keys.class_csr_keys``; padded edges and atoms
        read the sentinel row). Call it once per neighbor list. Raises
        ValueError on edges that are not sorted by center. Torch inputs get tensors on the device of
        ``EDGE_INDEX``."""
        ei = _as_numpy(data[keys.EDGE_INDEX])
        types = _as_numpy(data[keys.ATOM_TYPES])
        n_atoms = types.shape[0]
        num_types = len(self.config["type_names"])
        ct = types[np.clip(ei[0], 0, n_atoms - 1)]
        nt = types[np.clip(ei[1], 0, n_atoms - 1)]
        new = {keys.EDGE_TYPE: (ct * num_types + nt).astype(np.int32)}
        if self.on_kernels:
            new[keys.CENTER_ROW_PTR] = csr_row_ptr(ei[0], n_atoms)
            real = ei[0][ei[0] < n_atoms]
            if (self.model_dtype == torch.bfloat16 and real.size
                    and np.array_equal(np.unique(real), np.arange(int(real.max()) + 1))):
                # the marker of the readout's dtype in a bfloat16 model
                new[keys.CENTER_RANK_IDENTITY] = np.ones((), np.bool_)
            new[keys.NBR_PERM], new[keys.NBR_ROW_PTR] = neighbor_csr(ei[1], n_atoms)
            real_edge = ei[0] < n_atoms
            if keys.EDGE_MASK in data:
                real_edge &= _as_numpy(data[keys.EDGE_MASK]).astype(bool)
            real_atom = (_as_numpy(data[keys.NODE_MASK]).astype(bool) if keys.NODE_MASK in data
                         else np.ones(n_atoms, dtype=bool))
            classes = _class_lookups(ct, nt, types, num_types, real_edge, real_atom)
            for lookup in self.class_lookups:
                cls, rows, real = classes[lookup]
                idx = np.where(real, cls, rows).astype(np.int32)
                perm, row_ptr = neighbor_csr(idx, rows)
                new.update(zip(keys.class_csr_keys(lookup), (idx, row_ptr, perm)))
        out = dict(data)
        like = data[keys.EDGE_INDEX]
        for k, v in new.items():
            out[k] = torch.as_tensor(v, device=like.device) if isinstance(like, torch.Tensor) else v
        return out

    def graph_statics(self, data: Dict) -> Tuple[Dict, torch.Tensor]:
        """``precompute_statics`` in torch ops on the data's device, for a
        force call traced into one program (``compile/export.py``), and
        ``ok``, a 0-d bool tensor. JAX's rule for the in-jit statics
        (``allegro_tpu/nn/allegro.py:286-305``): edges that ``EDGE_MASK``
        masks are padding and get the sentinel atom ``n_atoms`` in both
        rows of ``EDGE_INDEX`` (and so the sentinel class row); the real
        edges must have ids within ``[0, n_atoms]`` and, on a kernel
        backend, be sorted by center with the padding trailing. Where they
        are not, ``ok`` is False (the caller poisons the energies with NaN)
        and the ids are clamped so that every kernel reads within its
        arrays. On a list within the rule the arrays equal
        ``precompute_statics`` of the list with the sentinel rows, bit for
        bit."""
        ei = data[keys.EDGE_INDEX].long()
        types = data[keys.ATOM_TYPES].long()
        n_atoms = types.shape[0]
        num_types = len(self.config["type_names"])
        mask = data[keys.EDGE_MASK].bool() if keys.EDGE_MASK in data else \
            torch.ones(ei.shape[1], dtype=torch.bool, device=ei.device)
        ei = torch.where(mask[None], ei, n_atoms)
        ok = ((ei >= 0) & (ei <= n_atoms)).all()
        if self.on_kernels:
            ok = ok & (ei[0, 1:] >= ei[0, :-1]).all()
        ei = ei.clamp(0, n_atoms)
        ct = types.index_select(0, ei[0].clamp(max=n_atoms - 1))
        nt = types.index_select(0, ei[1].clamp(max=n_atoms - 1))
        out = dict(data)
        out[keys.EDGE_INDEX] = ei.to(torch.int32)
        out[keys.EDGE_TYPE] = (ct * num_types + nt).to(torch.int32)
        if not self.on_kernels:
            return out, ok

        def csr(ids, rows):
            """(perm, row_ptr) of ``ids`` in ``[0, rows]``: ``neighbor_csr``."""
            perm = torch.sort(ids, stable=True).indices
            return perm.to(torch.int32), _row_ptr(ids.index_select(0, perm), rows)

        out[keys.CENTER_ROW_PTR] = _row_ptr(ei[0], n_atoms)
        out[keys.NBR_PERM], out[keys.NBR_ROW_PTR] = csr(ei[1], n_atoms)
        real_edge = (ei[0] < n_atoms) & mask
        real_atom = data[keys.NODE_MASK].bool() if keys.NODE_MASK in data else \
            torch.ones(n_atoms, dtype=torch.bool, device=ei.device)
        classes = _class_lookups(ct, nt, types, num_types, real_edge, real_atom)
        for lookup in self.class_lookups:
            cls, rows, real = classes[lookup]
            idx = torch.where(real, cls, rows)
            perm, row_ptr = csr(idx, rows)
            out.update(zip(keys.class_csr_keys(lookup), (idx.to(torch.int32), row_ptr, perm)))
        return out, ok

    @property
    def on_kernels(self) -> bool:
        return self.builder_kwargs.get("tp_kernel_backend") in KERNEL_BACKENDS

    @property
    def class_lookups(self) -> Tuple[str, ...]:
        """The class lookups of the model's trainable parameter tables
        (``keys.CENTER_TYPE_LOOKUP`` etc.), each stage's ``class_lookups``."""
        return tuple(dict.fromkeys(
            lookup for m in self.module.modules() for lookup in getattr(m, "class_lookups", ())))

    @property
    def statics_keys(self) -> Tuple[str, ...]:
        """The keys ``precompute_statics`` attaches for the kernels."""
        return CSR_STATICS + tuple(k for lookup in self.class_lookups
                                   for k in keys.class_csr_keys(lookup))

    def apply(self, data: Dict, frozen: bool = False) -> Dict:
        """Energy-only forward pass. ``frozen``: with the parameters'
        ``requires_grad`` off (``frozen_parameters``), so no autograd pass
        through the result reaches them; a caller that differentiates a
        model with ``remat`` runs its backward inside ``frozen_parameters``
        itself (the force call and MD, whose derivatives are in the
        positions only, do).

        The backend decides where the gathers and sums run: a kernel backend
        raises without the CSR statics, so none of its stages falls back to
        a plain sum; ``einsum``, the reference, drops them, so none of its
        stages runs a kernel."""
        with self.matmul_policy():
            return self._apply(data, frozen)

    def _apply(self, data: Dict, frozen: bool) -> Dict:
        statics = self.statics_keys
        if self.on_kernels:
            missing = [k for k in statics if k not in data]
            if missing:
                raise ValueError(
                    f"tp_kernel_backend={self.builder_kwargs['tp_kernel_backend']!r} needs the "
                    f"CSR statics {missing}: call Model.precompute_statics(data) once per "
                    "neighbor list"
                )
        else:
            data = {k: v for k, v in data.items() if k not in statics}
        with self.frozen_parameters() if frozen else contextlib.nullcontext():
            return self.module(data)

    @contextlib.contextmanager
    def frozen_parameters(self):
        """The parameters with ``requires_grad`` off for the duration: no
        autograd pass through what runs inside reaches them. A backward pass
        that recomputes (``remat``, ``checkpoint_energy``) must run inside
        too, or its recompute would see live parameters."""
        live = [p for p in self.module.parameters() if p.requires_grad]
        for p in live:
            p.requires_grad_(False)
        try:
            yield
        finally:
            for p in live:
                p.requires_grad_(True)

    def apply_with_derivatives(self, data: Dict, create_graph: bool = False) -> Dict:
        """Forward + forces (and virial/stress when a cell is present).
        ``create_graph``: keep the graph of the derivatives, so a loss on the
        forces can be differentiated in the parameters (training); otherwise
        the outputs are plain values (the force call), evaluated with the
        parameters frozen: ``ctx.needs_input_grad`` is fixed when a kernel's
        Function runs forward, so with live parameters the force call would
        also launch the weight-gradient kernels whose result nobody reads
        (JAX's transposes skip them). With ``checkpoint_energy`` the energy
        is recomputed inside the backward pass (only its inputs are kept)."""
        frozen = contextlib.nullcontext() if create_graph else self.frozen_parameters()
        with self.matmul_policy(), frozen:
            return force_stress_wrapper(lambda d: self._apply(d, frozen=False),
                                        create_graph=create_graph,
                                        checkpoint_energy=self.checkpoint_energy)(data)

    def energy_forces(self, data: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """MD's force call: the total energy (0-d) and ``-∂E/∂positions``,
        both detached, with the parameters frozen for the forward and the
        backward pass (a model with ``remat`` recomputes there), so no
        weight-gradient kernel runs; no virial."""
        with torch.enable_grad(), self.frozen_parameters(), self.matmul_policy():
            pos = data[keys.POSITIONS].detach().requires_grad_(True)
            energy = self.apply({**data, keys.POSITIONS: pos})[keys.TOTAL_ENERGY].sum()
            (grad,) = torch.autograd.grad(energy, pos)
        return energy.detach(), -grad

    def __call__(self, data: Dict) -> Dict:
        if self.has_derivatives:
            return self.apply_with_derivatives(data)
        return self.apply(data)


def _per_edge_type_cutoff_matrix(per_edge_type_cutoff, type_names: Sequence[str],
                                 r_max: float) -> Optional[np.ndarray]:
    """The config's per-edge-type cutoffs as a dense [T, T] matrix (center
    type by neighbor type), twin of JAX's: a dict of center type → a float
    (every neighbor) or a dict of neighbor type → float, pairs not named at
    r_max; an ndarray passes through."""
    if per_edge_type_cutoff is None:
        return None
    if isinstance(per_edge_type_cutoff, np.ndarray):
        return per_edge_type_cutoff
    names = list(type_names)
    mat = np.full((len(names), len(names)), r_max, dtype=np.float64)
    for center, v in per_edge_type_cutoff.items():
        ci = names.index(center)
        if isinstance(v, dict):
            for neigh, c in v.items():
                mat[ci, names.index(neigh)] = float(c)
        else:
            mat[ci, :] = float(v)
    return mat


def _scalar_embed(cfg, num_types: int, output_dim: int, dtype) -> torch.nn.Module:
    """The ``radial_chemical_embed`` stage from its config block (JAX's
    ``_instantiate_scalar_embed``): the Bessel embed (the default) or the
    spline embed, with JAX's kwargs and defaults."""
    cfg = dict(cfg or {})
    target = cfg.pop("_target_", "allegro_tpu.nn.TwoBodyBesselScalarEmbed")
    short = target.rsplit(".", 1)[-1]
    if short == "TwoBodyBesselScalarEmbed":
        return TwoBodyBesselScalarEmbed(
            num_types=num_types,
            output_dim=output_dim,
            num_bessels=int(cfg.pop("num_bessels", 8)),
            polynomial_cutoff_p=int(cfg.pop("polynomial_cutoff_p", 6)),
            dtype=dtype,
        )
    if short == "TwoBodySplineScalarEmbed":
        return TwoBodySplineScalarEmbed(
            num_types=num_types,
            output_dim=output_dim,
            num_splines=int(cfg.pop("num_splines", cfg.pop("spline_grid_size", 16))),
            spline_span=int(cfg.pop("spline_span", 12)),
            polynomial_cutoff_p=int(cfg.pop("polynomial_cutoff_p", 6)),
            dtype=dtype,
        )
    raise ValueError(f"unknown radial_chemical_embed target {target}")


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
    if str(model_dtype) not in DTYPES:
        raise ValueError(f"model_dtype={model_dtype!r}: one of {sorted(DTYPES)}")
    dtype = DTYPES[str(model_dtype)]
    if tensor_dtype is not None and str(tensor_dtype) not in DTYPES:
        raise ValueError(f"tensor_dtype={tensor_dtype!r}: one of {sorted(DTYPES)} or None")
    track = None if tensor_dtype is None else DTYPES[str(tensor_dtype)]
    prec = precision if precision is not None else (None if allow_tf32 else "highest")
    if prec not in PRECISIONS:
        raise _not_ported(f"precision={precision!r}", "queue 1, item 6")
    num_types = len(type_names)
    if isinstance(irreps_edge_sh, int):
        irreps_sh = Irreps.spherical_harmonics(irreps_edge_sh, p=-1)
    else:
        irreps_sh = Irreps(str(irreps_edge_sh))
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
        weight_individual_irreps=weight_individual_irreps,
        tensor_dtype=track,
        remat=remat,
        tp_chunk_edges=tp_chunk_edges,
    )

    layers = [
        ("edge_norm", EdgeLengthNormalizer(
            r_max=r_max, num_types=num_types,
            per_edge_type_cutoff=_per_edge_type_cutoff_matrix(per_edge_type_cutoff, type_names,
                                                              r_max))),
        ("radial_chemical_embed", _scalar_embed(radial_chemical_embed, num_types, embed_dim, dtype)),
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
                                                build_features=not allegro.mega,
                                                tensor_dtype=allegro.tensor_dtype),
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
    ]
    if pair_potential is not None:
        layers.append(("pair_potential", _zbl(pair_potential, r_max)))
    layers.append(("total_energy_sum", AtomwiseReduce()))
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
                 builder_kwargs=_kwargs, checkpoint_energy=checkpoint_energy, precision=prec)


def _zbl(cfg, r_max: float) -> ZBLPairPotential:
    """The ``pair_potential`` stage from its config block: ``_target_`` ZBL,
    the atomic numbers as ``type_to_Z`` or as ``chemical_species`` names."""
    cfg = dict(cfg)
    target = cfg.pop("_target_", "allegro_tpu.nn.ZBLPairPotential")
    if target.rsplit(".", 1)[-1] not in ("ZBL", "ZBLPairPotential"):
        raise ValueError(f"unknown pair_potential {target}")
    type_to_Z = cfg.pop("type_to_Z", None) or cfg.pop("chemical_species", None)
    if type_to_Z is None:
        raise ValueError("pair_potential needs type_to_Z or chemical_species")
    if isinstance(type_to_Z[0], str):
        type_to_Z = [ATOMIC_NUMBERS[s] for s in type_to_Z]
    return ZBLPairPotential(type_to_Z=type_to_Z, r_max=r_max)


def _rebuild(model: Model, **overrides) -> Model:
    """The model built again from its builder kwargs with ``overrides``,
    carrying its parameters (``state_dict``), its device and whether it
    computes derivatives."""
    kwargs = {**model.builder_kwargs, **overrides}
    new = FullAllegroEnergyModel(**kwargs)
    new.has_derivatives = model.has_derivatives
    state = model.state_dict()
    new.load_state_dict(state)
    device = next((v.device for v in state.values()), None)
    return new if device is None else new.to(device)


@model_modifier
def enable_PallasContracter(model: Model) -> Model:
    """The TP on the per-edge sparse kernel (``pallas``), the parameters kept."""
    return _rebuild(model, tp_kernel_backend="pallas")


@model_modifier
def enable_EinsumContracter(model: Model) -> Model:
    return _rebuild(model, tp_kernel_backend="einsum")


@model_modifier
def enable_FusedContracter(model: Model) -> Model:
    """The TP on the trainable fused kernels (``fused``), the parameters kept."""
    return _rebuild(model, tp_kernel_backend="fused")


# the reference configs' names for its Triton and cuEquivariance backends
MODEL_MODIFIERS["enable_TritonContracter"] = enable_FusedContracter
MODEL_MODIFIERS["enable_CuEquivarianceContracter"] = enable_FusedContracter


def modify(model: Model, modifiers) -> Model:
    """Apply named modifiers (names or ``{"modifier": name}`` dicts) in order."""
    for m in modifiers:
        if isinstance(m, dict):
            m = m.get("modifier")
        if m not in MODEL_MODIFIERS:
            raise ValueError(f"unknown model modifier {m}; known: {sorted(MODEL_MODIFIERS)}")
        model = MODEL_MODIFIERS[m](model)
    return model


@model_builder
def AllegroEnergyModel(l_max: int, parity: bool = True, **kwargs) -> Model:
    """Derive irreps from ``l_max``/``parity``: with parity, the tensor track
    may carry both parities of every l; without, only the SH irreps."""
    irreps_sh = Irreps.spherical_harmonics(l_max, p=-1)
    if parity:
        allowed = Irreps([(1, (l, p)) for l in range(l_max + 1) for p in (1, -1)])
    else:
        allowed = irreps_sh
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
