"""allegro_tpu_torch.lib against allegro_tpu.lib: Wigner 3j tables, SH
coefficient tables and spherical-harmonic values up to l = 3 (float64,
1e-12), plus the irreps ladder and the sparse CG entry tables."""

import importlib
import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from threadpoolctl import threadpool_limits

from allegro_tpu.lib.irreps import Irreps as JaxIrreps
from allegro_tpu.nn.allegro import compute_irreps_ladder as jax_ladder
from allegro_tpu.nn.contract import enumerate_instructions as jax_instructions
from allegro_tpu.nn.contract import pack_w3j as jax_pack_w3j
from allegro_tpu.ops.pallas_contract import sparse_entries as jax_sparse_entries

from allegro_tpu_torch.lib import Irreps, sh_coefficients, spherical_harmonics, wigner_3j
from allegro_tpu_torch.nn.allegro import compute_irreps_ladder
from allegro_tpu_torch.nn.contract import enumerate_instructions, pack_w3j, sparse_entries
from torch_threads import one_thread  # noqa: F401

# the package re-exports a function under the module's name: import the modules
jax_sh = importlib.import_module("allegro_tpu.lib.spherical_harmonics")
jax_wigner = importlib.import_module("allegro_tpu.lib.wigner")

TOL = 1e-12


@pytest.fixture
def one_blas_thread():
    # the table fits are small SVD/lstsq solves: one BLAS thread is faster,
    # and keeps parallel test workers from oversubscribing the cores
    with threadpool_limits(1):
        yield


@pytest.mark.parametrize("l1", [0, 1, 2, 3])
def test_wigner_3j_matches_jax(l1, one_blas_thread):
    for l2, l3 in itertools.product(range(4), range(4)):
        np.testing.assert_allclose(
            wigner_3j(l1, l2, l3), jax_wigner.wigner_3j(l1, l2, l3), rtol=0, atol=TOL
        )


@pytest.mark.parametrize("l", [0, 1, 2, 3])
def test_sh_coefficients_match_jax(l, one_blas_thread):
    np.testing.assert_allclose(sh_coefficients(l), jax_sh.sh_coefficients(l), rtol=0, atol=TOL)


@pytest.mark.parametrize("normalize", [True, False])
def test_spherical_harmonics_match_jax(normalize):
    rng = np.random.RandomState(0)
    v = rng.randn(64, 3) * 1.7
    v[5] = 0.0  # a padded (zero) edge vector
    got = spherical_harmonics(3, torch.as_tensor(v, dtype=torch.float64), normalize=normalize)
    want = np.asarray(jax_sh.spherical_harmonics(3, jnp.asarray(v), normalize=normalize))
    assert got.dtype == torch.float64 and got.shape == (64, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("num_layers", [1, 2, 3])
def test_ladder_and_entries_match_jax(num_layers):
    sh = "1x0e+1x1o+1x2e"
    allowed = "1x0e+1x0o+1x1e+1x1o+1x2e+1x2o"
    ladder = compute_irreps_ladder(Irreps(sh), Irreps(allowed), num_layers)
    want = jax_ladder(JaxIrreps(sh), JaxIrreps(allowed), num_layers)
    assert [str(x) for x in ladder] == [str(x) for x in want]
    for a, b in zip(ladder[:-1], ladder[1:]):
        ins = enumerate_instructions(a, Irreps(sh), b)
        ja, jb, jsh = JaxIrreps(str(a)), JaxIrreps(str(b)), JaxIrreps(sh)
        assert ins == jax_instructions(ja, jsh, jb)
        w3j = pack_w3j(a, Irreps(sh), b, ins)
        np.testing.assert_allclose(w3j, jax_pack_w3j(ja, jsh, jb, ins), rtol=0, atol=TOL)
        got, exp = sparse_entries(w3j), jax_sparse_entries(w3j)
        assert [e[:4] for e in got] == [e[:4] for e in exp]
        np.testing.assert_allclose([e[4] for e in got], [e[4] for e in exp], rtol=0, atol=0)


def test_flagship_entry_counts():
    """The flagship ladder (l_max 2, 2 layers): 83 CG entries at layer 0
    (dims 9, 9, 9) and 9 at layer 1 (dims 9, 9, 1)."""
    sh = Irreps("1x0e+1x1o+1x2e")
    ladder = compute_irreps_ladder(sh, Irreps("1x0e+1x0o+1x1e+1x1o+1x2e+1x2o"), 2)
    counts = []
    for a, b in zip(ladder[:-1], ladder[1:]):
        w3j = pack_w3j(a, sh, b, enumerate_instructions(a, sh, b))
        counts.append((w3j.shape[1:], len(sparse_entries(w3j))))
    assert counts == [((9, 9, 9), 83), ((9, 9, 1), 9)]
