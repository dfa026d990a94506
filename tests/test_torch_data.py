"""allegro_tpu_torch.data against allegro_tpu.data: neighbor lists edge for
edge, batching array for array, and the CSR statics of the port."""

import numpy as np
import pytest
import torch

from allegro_tpu.data import atomic_data as jax_atomic_data
from allegro_tpu.data import neighborlist as jax_nl

from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, pad_data, to_torch
from allegro_tpu_torch.ops.fused_tp import csr_row_ptr
from torch_threads import one_thread  # noqa: F401

R_MAX = 4.0


def _crystal(side, seed, spacing=2.2):
    rng = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(*(np.arange(s) for s in side), indexing="ij"), -1).reshape(-1, 3)
    n = grid.shape[0]
    return {
        keys.POSITIONS: grid * spacing + 0.1 * rng.randn(n, 3),
        keys.ATOM_TYPES: rng.randint(0, 3, n).astype(np.int32),
        keys.CELL: np.diag(np.asarray(side, dtype=np.float64) * spacing),
        keys.PBC: np.ones(3, dtype=bool),
    }


def _molecule(n, seed):
    rng = np.random.RandomState(seed)
    return {
        keys.POSITIONS: rng.rand(n, 3) * 5.0,
        keys.ATOM_TYPES: rng.randint(0, 3, n).astype(np.int32),
    }


FRAMES = {
    "crystal_3x3x3": lambda: _crystal((3, 3, 3), 0),
    "crystal_2x2x3": lambda: _crystal((2, 2, 3), 1),
    "molecule_20": lambda: _molecule(20, 2),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_neighbor_list_matches_jax_edge_for_edge(name, monkeypatch):
    frame = FRAMES[name]()
    # the JAX package's scipy branch (its native C++ list orders each
    # center's neighbors differently, compared as a set below)
    monkeypatch.setenv("ALLEGRO_TPU_NATIVE", "0")
    want = jax_nl.neighbor_list(frame, R_MAX)
    got = neighbor_list(frame, R_MAX)
    assert got[keys.EDGE_INDEX].dtype == np.int32
    np.testing.assert_array_equal(got[keys.EDGE_INDEX], want[keys.EDGE_INDEX])
    np.testing.assert_array_equal(got[keys.EDGE_CELL_SHIFT], want[keys.EDGE_CELL_SHIFT])
    assert (np.diff(got[keys.EDGE_INDEX][0]) >= 0).all()


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_neighbor_list_matches_jax_native_as_set(name, monkeypatch):
    frame = FRAMES[name]()
    monkeypatch.setenv("ALLEGRO_TPU_NATIVE", "1")
    want = jax_nl.neighbor_list(frame, R_MAX)
    got = neighbor_list(frame, R_MAX)

    def rows(d):
        return sorted(
            zip(*d[keys.EDGE_INDEX].tolist(), *d[keys.EDGE_CELL_SHIFT].T.round().astype(int).tolist())
        )

    assert rows(got) == rows(want)


def test_batch_frames_matches_jax():
    frames = [neighbor_list(FRAMES[n](), R_MAX) for n in ("crystal_3x3x3", "crystal_2x2x3")]
    got = batch_frames(frames, n_frames=3)
    want = jax_atomic_data.batch_frames(frames, n_frames=3)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # sentinel padding: padded edges point at atom n_atoms, sorted last
    n_atoms = got[keys.POSITIONS].shape[0]
    ei = got[keys.EDGE_INDEX]
    assert (ei[:, ~got[keys.EDGE_MASK]] == n_atoms).all()
    assert (np.diff(ei[0]) >= 0).all()


def test_pad_data_matches_jax():
    frame = neighbor_list(FRAMES["molecule_20"](), R_MAX)
    got = pad_data(frame, 24, 512)
    want = jax_atomic_data.pad_data(frame, 24, 512)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_to_torch_types():
    frame = neighbor_list(FRAMES["crystal_2x2x3"](), R_MAX)
    data = to_torch(batch_frames([frame]), dtype=torch.float32)
    assert data[keys.POSITIONS].dtype == torch.float32
    assert data[keys.EDGE_INDEX].dtype == torch.int32
    assert data[keys.EDGE_MASK].dtype == torch.bool
    assert data[keys.CELL].dtype == torch.float32


def test_csr_row_ptr():
    # atoms 1 and 4 have no edges; two sentinel (padded) edges at the end
    centers = np.array([0, 0, 2, 2, 2, 3, 5, 6, 6], dtype=np.int32)
    row_ptr = csr_row_ptr(centers, 6)
    np.testing.assert_array_equal(row_ptr, [0, 2, 2, 5, 6, 6, 7])
    assert row_ptr.dtype == np.int32
    with pytest.raises(ValueError, match="sorted by center"):
        csr_row_ptr(np.array([0, 2, 1, 6], dtype=np.int32), 6)
    with pytest.raises(ValueError, match="sorted by center"):
        csr_row_ptr(np.array([0, 6, 1], dtype=np.int32), 6)  # padding not trailing
    with pytest.raises(ValueError, match="must lie in"):
        csr_row_ptr(np.array([0, 7], dtype=np.int32), 6)
