"""Equivariant NN modules (torch.nn) operating on atomic data dicts — the
twin of ``allegro_tpu.nn`` for the flagship force call."""

from .mlp import ScalarMLP
from .cutoffs import PolynomialCutoff, bessel_basis
from .channels import MakeWeightedChannels
from .contract import Contracter
from .sequential import SequentialGraphNet
from .edge_geometry import EdgeLengthNormalizer, with_edge_vectors
from .scalar_embed import OneHotEmbed, ProductTypeEmbedding, TwoBodyBesselScalarEmbed
from .tensor_embed import TwoBodySphericalHarmonicTensorEmbed
from .allegro import AllegroLayers, compute_irreps_ladder
from .edgewise import EdgewiseReduce
from .atomwise import AtomwiseReduce, PerTypeScaleShift
from .grad import force_stress_wrapper

__all__ = [
    "ScalarMLP",
    "PolynomialCutoff",
    "bessel_basis",
    "MakeWeightedChannels",
    "Contracter",
    "SequentialGraphNet",
    "EdgeLengthNormalizer",
    "with_edge_vectors",
    "OneHotEmbed",
    "ProductTypeEmbedding",
    "TwoBodyBesselScalarEmbed",
    "TwoBodySphericalHarmonicTensorEmbed",
    "AllegroLayers",
    "compute_irreps_ladder",
    "EdgewiseReduce",
    "AtomwiseReduce",
    "PerTypeScaleShift",
    "force_stress_wrapper",
]
