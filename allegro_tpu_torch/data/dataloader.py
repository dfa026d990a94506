"""Batches of one fixed padded signature (twin of
``allegro_tpu/data/dataloader.py``).

Every batch is padded to the same ``(n_frames, n_atoms, n_edges)``, chosen
up front from the dataset's largest frames, so the model sees one shape
throughout training. Batches are NumPy dicts, array for array the JAX
loader's; the trainer attaches the model's statics and moves them to the
device.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from . import keys
from .atomic_data import AtomsData, batch_frames, round_up
from .datasets import InMemoryDataset


class DataLoader:
    def __init__(
        self,
        dataset: InMemoryDataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        n_atoms: Optional[int] = None,
        n_edges: Optional[int] = None,
        atom_multiple: int = 8,
        edge_multiple: int = 128,
        drop_last: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self.drop_last = drop_last
        if n_atoms is None or n_edges is None:
            # the worst-case batch: the largest frames, with one spare atom
            # row for the sentinel
            atoms_sorted = sorted(f[keys.POSITIONS].shape[0] for f in dataset.frames)
            edges_sorted = sorted(f[keys.EDGE_INDEX].shape[1] for f in dataset.frames)
            worst_atoms = sum(atoms_sorted[-self.batch_size:])
            worst_edges = sum(edges_sorted[-self.batch_size:])
            n_atoms = n_atoms or round_up(worst_atoms + 1, atom_multiple)
            n_edges = n_edges or round_up(max(worst_edges, 1), edge_multiple)
        self.n_atoms = int(n_atoms)
        self.n_edges = int(n_edges)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[AtomsData]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for s in range(0, len(order), self.batch_size):
            idx = order[s : s + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield batch_frames([self.dataset[int(i)] for i in idx], n_atoms=self.n_atoms,
                               n_edges=self.n_edges, n_frames=self.batch_size)
