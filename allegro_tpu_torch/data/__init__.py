"""Data model: atomic data dicts, neighbor lists, padding (twin of
``allegro_tpu.data``)."""

from . import keys
from .atomic_data import AtomsData, batch_frames, pad_data, round_up, to_torch
from .dataloader import DataLoader
from .datasets import InMemoryDataset, compute_statistics, synthetic_molecular_frames
from .neighborlist import neighbor_list, primitive_neighbor_list

__all__ = [
    "keys",
    "AtomsData",
    "batch_frames",
    "pad_data",
    "round_up",
    "to_torch",
    "DataLoader",
    "InMemoryDataset",
    "compute_statistics",
    "synthetic_molecular_frames",
    "neighbor_list",
    "primitive_neighbor_list",
]
