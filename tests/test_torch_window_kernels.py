"""TPU kernels 18 and 19 through the port's plain versions (the CPU path).

- Kernel 18, ``_bwd_fused_kernel`` (``bwd_fused_call``: dx, denv and, with
  ``with_dw``, the weight gradient dw in one pass), against the port's
  ``bwd_fused(..., with_dw=True/False)``.
- Kernel 19, ``_unweight_both_kernel`` (``unweight_both_call``: dsh and
  dwexp from one per-atom denv), against the port's ``unweight_both``
  (kernel 4's wrapper, which takes that one array).

The JAX kernels run in interpret mode on the same inputs, with the env and
denv windows combined by ``combine_scatter_outputs`` as
``tests/model/test_window_rows.py`` does, then mapped from rank space
(atoms that have edges) to atoms. Tables: both layers of the flagship
(l_max 2: (9, 9, 9) with 83 entries, (9, 9, 1) with 9) and layer 1 of the
l_max-3 model ((16, 16, 1), 16 entries). float64 at 1e-10, float32 at 1e-5.
The CPU wrappers launch nothing.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from allegro_tpu.ops import fused_tp as jax_ftp

from allegro_tpu_torch.lib import Irreps
from allegro_tpu_torch.nn.allegro import compute_irreps_ladder
from allegro_tpu_torch.nn.contract import enumerate_instructions, pack_w3j, sparse_entries
from allegro_tpu_torch.ops import fused_tp
from torch_threads import one_thread  # noqa: F401

EB = 128
U = 4
N_ATOMS = 24
E_REAL = 150
TOL = {"float64": 1e-10, "float32": 1e-5}


def _tables(l_max, layer):
    sh = Irreps.spherical_harmonics(l_max, p=-1)
    allowed = Irreps([(1, (l, p)) for l in range(l_max + 1) for p in (1, -1)])
    ladder = compute_irreps_ladder(sh, allowed, 2)
    a, b = ladder[layer], ladder[layer + 1]
    w3j = pack_w3j(a, sh, b, enumerate_instructions(a, sh, b))
    dim_to_irr = tuple(k for k, s in enumerate(sh.slices()) for _ in range(s.stop - s.start))
    return w3j, sparse_entries(w3j), dim_to_irr


def _rank_to_atoms(rank_arr, atoms):
    out = np.zeros((N_ATOMS, rank_arr.shape[1]), rank_arr.dtype)
    out[atoms] = rank_arr[: len(atoms)]
    return out


@pytest.fixture(scope="module")
def interpret():
    old = jax_ftp.INTERPRET
    jax_ftp.INTERPRET = True
    yield
    jax_ftp.INTERPRET = old


CASES = [(2, 0, "float64"), (2, 1, "float64"), (3, 1, "float64"), (2, 0, "float32")]


def _inputs(l_max, layer, dtype_name):
    """Inputs of both sides: numpy arrays, the block plan, the port's tensors."""
    rng = np.random.RandomState(11 + 3 * layer + l_max)
    w3j, entries, dim_to_irr = _tables(l_max, layer)
    P, d1, d2, d3 = w3j.shape
    n_irr = max(dim_to_irr) + 1
    # atom 5 and atoms >= 20 have no edges; sentinel padding to a multiple of EB
    atoms = np.array([a for a in range(20) if a != 5])
    real = np.sort(np.concatenate([atoms, rng.choice(atoms, size=E_REAL - len(atoms))]))
    Ep = -(-E_REAL // EB) * EB
    centers = np.concatenate([real, np.full(Ep - E_REAL, N_ATOMS)]).astype(np.int32)
    dt = np.dtype(dtype_name)

    def arr(*shape, edge=True):
        a = rng.randn(*shape).astype(dt)
        if edge:
            a[E_REAL:] = 0.0
        return a

    s = dict(x=arr(Ep, d1 * U), g=arr(Ep, d3 * U), gts=arr(Ep, U), sh=arr(Ep, d2),
             wexp=arr(Ep, n_irr * U), w=arr(P, U, edge=False))
    win, offs = jax_ftp.make_block_plan(jnp.asarray(centers), EB)
    t = {k: torch.as_tensor(v) for k, v in s.items()}
    t.update(centers=torch.as_tensor(centers),
             row_ptr=torch.as_tensor(fused_tp.csr_row_ptr(centers, N_ATOMS)),
             idx=torch.tensor([e[:4] for e in entries], dtype=torch.int32),
             coef=torch.tensor([e[4] for e in entries], dtype=t["x"].dtype),
             d2i=torch.tensor(dim_to_irr, dtype=torch.int32))
    plan = dict(entries=entries, dims=(d1, d2, d3), P=P, dim_to_irr=dim_to_irr, offs=offs,
                win=win, nr=jax_ftp.num_rank_rows(N_ATOMS, EB), atoms=atoms, dtype=dtype_name,
                J={k: jnp.asarray(v) for k, v in s.items()})
    return plan, t


def _jax_bwd_fused(p, with_dw):
    """JAX's env (kernel 1, windows combined) and kernel 18 on it."""
    J = p["J"]
    eA, eB = jax_ftp.env_scatter_call(J["sh"], J["wexp"], p["offs"], p["win"],
                                      dim_to_irr=p["dim_to_irr"], U=U, eb=EB,
                                      n_rank_rows=p["nr"])
    env = jax_ftp.combine_scatter_outputs(eA, eB, p["win"], EB)
    dx, dA, dB, dw = jax_ftp.bwd_fused_call(J["x"], J["g"], env, env, J["w"], p["offs"],
                                            p["win"], entries=p["entries"], dims=p["dims"], U=U,
                                            eb=EB, n_rank_rows=p["nr"], with_dw=with_dw)
    return env, dx, jax_ftp.combine_scatter_outputs(dA, dB, p["win"], EB), dw


@pytest.fixture(scope="module", params=CASES,
                ids=[f"lmax{l}-layer{k}-{d}" for l, k, d in CASES])
def window_run(request, interpret):
    """The inputs, the port's tensors and JAX's kernels 18 and 19 on them."""
    p, t = _inputs(*request.param)
    env, dx, denv, dw = _jax_bwd_fused(p, with_dw=True)
    J = p["J"]
    dsh, dwexp = jax_ftp.unweight_both_call(denv, denv, J["sh"], J["wexp"], p["offs"], p["win"],
                                            dim_to_irr=p["dim_to_irr"], U=U, eb=EB)
    atoms = p["atoms"]
    jax_out = dict(env=_rank_to_atoms(np.asarray(env), atoms), dx=np.asarray(dx),
                   denv=_rank_to_atoms(np.asarray(denv), atoms), dw=np.asarray(dw),
                   dsh=np.asarray(dsh), dwexp=np.asarray(dwexp))
    t.update(env=torch.as_tensor(jax_out["env"]), denv=torch.as_tensor(jax_out["denv"]))
    return p, t, jax_out


def _close(got, want, dtype_name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL[dtype_name] * scale, f"max abs err {err:.3e} (scale {scale:.3e})"


@pytest.mark.parametrize("with_dw", [True, False])
def test_bwd_fused_with_and_without_dw_matches_kernel_18(window_run, with_dw):
    s, t, j = window_run
    out = fused_tp.bwd_fused(t["x"], t["g"], t["env"], t["w"], t["centers"], t["row_ptr"],
                             t["idx"], t["coef"], with_dw=with_dw)
    assert len(out) == (3 if with_dw else 2)
    _close(out[0], j["dx"], s["dtype"])
    _close(out[1], j["denv"], s["dtype"])
    if with_dw:
        assert out[2].shape == (s["P"], U) and out[2].dtype == t["x"].dtype
        _close(out[2], j["dw"], s["dtype"])


def test_unweight_both_matches_kernel_19(window_run):
    s, t, j = window_run
    dsh, dwexp = fused_tp.unweight_both(t["denv"], t["sh"], t["wexp"], t["centers"], t["d2i"])
    _close(dsh, j["dsh"], s["dtype"])
    _close(dwexp, j["dwexp"], s["dtype"])


def test_kernel_18_without_dw_matches_the_port_without_dw(interpret):
    """JAX's with_dw=False form (the force path, dw None) on the flagship's
    layer 1, against the port's bwd_fused without dw."""
    p, t = _inputs(2, 1, "float64")
    env, dx, denv, dw = _jax_bwd_fused(p, with_dw=False)
    assert dw is None
    env = torch.as_tensor(_rank_to_atoms(np.asarray(env), p["atoms"]))
    got_dx, got_denv = fused_tp.bwd_fused(t["x"], t["g"], env, t["w"], t["centers"],
                                          t["row_ptr"], t["idx"], t["coef"])
    _close(got_dx, np.asarray(dx), "float64")
    _close(got_denv, _rank_to_atoms(np.asarray(denv), p["atoms"]), "float64")


def test_bwd_fused_dw_with_split_cotangent_folds_it_into_g(window_run):
    """``gts`` (the split scalar output's cotangent) adds to g's block 0 for
    dw as for dx and denv."""
    s, t, _ = window_run
    U_ = t["w"].shape[1]
    g = t["g"].clone()
    g[:, :U_] += t["gts"]
    args = (t["env"], t["w"], t["centers"], t["row_ptr"], t["idx"], t["coef"])
    got = fused_tp.bwd_fused(t["x"], t["g"], *args, gts=t["gts"], with_dw=True)
    want = fused_tp.bwd_fused(t["x"], g, *args, with_dw=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=TOL[s["dtype"]])


def test_cpu_wrappers_launch_nothing(window_run):
    s, t, _ = window_run
    fused_tp.reset_launch_counts()
    fused_tp.bwd_fused(t["x"], t["g"], t["env"], t["w"], t["centers"], t["row_ptr"], t["idx"],
                       t["coef"], with_dw=True)
    fused_tp.unweight_both(t["denv"], t["sh"], t["wexp"], t["centers"], t["d2i"])
    assert fused_tp.LAUNCHES == {k: 0 for k in fused_tp.LAUNCHES}
