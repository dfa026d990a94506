"""Data model: atomic data dicts, neighbor lists, padding (twin of
``allegro_tpu.data``)."""

from . import keys
from .atomic_data import AtomsData, batch_frames, pad_data, round_up, to_torch
from .neighborlist import neighbor_list, primitive_neighbor_list

__all__ = [
    "keys",
    "AtomsData",
    "batch_frames",
    "pad_data",
    "round_up",
    "to_torch",
    "neighbor_list",
    "primitive_neighbor_list",
]
