"""Math substrate: O(3) irreps algebra, real spherical harmonics, Wigner 3j.

Twin of ``allegro_tpu.lib``: the tables are NumPy (float64, host), the
spherical-harmonic evaluation is torch.
"""

from .irreps import Irrep, MulIrrep, Irreps, tp_path_exists
from .spherical_harmonics import spherical_harmonics, sh_coefficients
from .wigner import wigner_3j, wigner_D, rand_rotation, rand_o3_matrix
from .testing import rep_matrix, transform_flat_dim_major, transform_strided

__all__ = [
    "Irrep",
    "MulIrrep",
    "Irreps",
    "tp_path_exists",
    "spherical_harmonics",
    "sh_coefficients",
    "wigner_3j",
    "wigner_D",
    "rand_rotation",
    "rand_o3_matrix",
    "rep_matrix",
    "transform_strided",
    "transform_flat_dim_major",
]
