"""The port's four layer kernels, through their plain versions (the CPU path).

- Each plain version against the JAX Pallas kernel it replaces, run in
  interpret mode on the same inputs (float64 at 1e-10, float32 at 1e-5). The
  Pallas kernels return per-rank window partials (eA, eB): they are combined
  and mapped from rank space (atoms that have edges, in order) to atoms. One
  atom in the middle and the last ones have no edges, and the edge list ends
  in sentinel padding.
- The two backward plain versions against torch.autograd of the plain
  forward, and ``fused_layer_infer``'s gradients (NaN for the weights).
- The wrappers' CPU dispatch: launch counters stay at zero; building the
  CUDA library without nvcc raises.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from allegro_tpu.ops import fused_tp as jax_ftp

from allegro_tpu_torch.lib import Irreps
from allegro_tpu_torch.nn.allegro import compute_irreps_ladder
from allegro_tpu_torch.nn.contract import enumerate_instructions, pack_w3j, sparse_entries
from allegro_tpu_torch.ops import _build, fused_tp
from allegro_tpu_torch.ops.fused_primitives import fused_layer_infer

EB = 128
U = 4
N_ATOMS = 24
E_REAL = 150
TOL = {"float64": 1e-10, "float32": 1e-5}


def _layer_tables(layer):
    sh = Irreps("1x0e+1x1o+1x2e")
    ladder = compute_irreps_ladder(sh, Irreps("1x0e+1x0o+1x1e+1x1o+1x2e+1x2o"), 2)
    a, b = ladder[layer], ladder[layer + 1]
    w3j = pack_w3j(a, sh, b, enumerate_instructions(a, sh, b))
    dim_to_irr = tuple(k for k, s in enumerate(sh.slices()) for _ in range(s.stop - s.start))
    return w3j, sparse_entries(w3j), dim_to_irr


def _setup(layer, dtype_name):
    rng = np.random.RandomState(7 + layer)
    w3j, entries, dim_to_irr = _layer_tables(layer)
    P, d1, d2, d3 = w3j.shape
    n_irr = max(dim_to_irr) + 1
    # atom 5 and atoms >= 20 have no edges; sentinel padding to a multiple of EB
    atoms = np.array([a for a in range(20) if a != 5])
    real = np.sort(rng.choice(atoms, size=E_REAL))
    real[:len(atoms)] = atoms  # every listed atom has at least one edge
    real = np.sort(real)
    Ep = -(-E_REAL // EB) * EB
    centers = np.concatenate([real, np.full(Ep - E_REAL, N_ATOMS)]).astype(np.int32)
    dt = np.dtype(dtype_name)

    def arr(*shape, edge=True):
        a = rng.randn(*shape).astype(dt)
        if edge:
            a[E_REAL:] = 0.0
        return a

    return dict(
        entries=entries, dims=(d1, d2, d3), dim_to_irr=dim_to_irr, P=P, n_irr=n_irr,
        centers=centers, Ep=Ep, atoms=atoms, dt=dt,
        x=arr(Ep, d1 * U), g=arr(Ep, d3 * U), sh=arr(Ep, d2), wexp=arr(Ep, n_irr * U),
        w=arr(P, U, edge=False),
    )


def _torch_args(s):
    t = {k: torch.as_tensor(s[k]) for k in ("x", "g", "sh", "wexp", "w")}
    t["centers"] = torch.as_tensor(s["centers"])
    t["row_ptr"] = torch.as_tensor(fused_tp.csr_row_ptr(s["centers"], N_ATOMS))
    t["idx"] = torch.tensor([e[:4] for e in s["entries"]], dtype=torch.int32)
    t["coef"] = torch.tensor([e[4] for e in s["entries"]], dtype=t["x"].dtype)
    t["d2i"] = torch.tensor(s["dim_to_irr"], dtype=torch.int32)
    return t


def _rank_to_atoms(rank_arr, atoms):
    """[Nr, C] rank-space rows → [N_ATOMS, C] atom rows (zeros for atoms
    without edges); rank r is the r-th atom that has edges."""
    out = np.zeros((N_ATOMS, rank_arr.shape[1]), rank_arr.dtype)
    out[atoms] = rank_arr[: len(atoms)]
    return out


@pytest.fixture(scope="module")
def interpret():
    old = jax_ftp.INTERPRET
    jax_ftp.INTERPRET = True
    yield
    jax_ftp.INTERPRET = old


@pytest.fixture(scope="module", params=[(0, "float64"), (1, "float64"), (0, "float32")],
                ids=["layer0-f64", "layer1-f64", "layer0-f32"])
def pallas_run(request, interpret):
    """Plain versions and interpret-mode Pallas kernels on the same inputs."""
    layer, dtype_name = request.param
    s = _setup(layer, dtype_name)
    t = _torch_args(s)
    win, offs = jax_ftp.make_block_plan(jnp.asarray(s["centers"]), EB)
    nr = jax_ftp.num_rank_rows(N_ATOMS, EB)
    kw = dict(entries=s["entries"], dims=s["dims"], U=U, eb=EB)
    J = {k: jnp.asarray(s[k]) for k in ("x", "g", "sh", "wexp", "w")}
    eA, eB = jax_ftp.env_scatter_call(J["sh"], J["wexp"], offs, win, dim_to_irr=s["dim_to_irr"],
                                      U=U, eb=EB, n_rank_rows=nr)
    out = jax_ftp.gather_tp_raw_call(J["x"], eA, eB, J["w"], offs, win, **kw)
    dx, dA, dB = jax_ftp.bwd_fused_raw_call(J["x"], J["g"], eA, eB, J["w"], offs, win,
                                            n_rank_rows=nr, **kw)
    dsh, dwexp = jax_ftp.unweight_both_raw_call(dA, dB, J["sh"], J["wexp"], offs, win,
                                                dim_to_irr=s["dim_to_irr"], U=U, eb=EB)

    def atoms_of(a, b):
        return _rank_to_atoms(np.asarray(jax_ftp.combine_scatter_outputs(a, b, win, EB)),
                              s["atoms"])

    jax_out = dict(env=atoms_of(eA, eB), out=np.asarray(out), dx=np.asarray(dx),
                   denv=atoms_of(dA, dB), dsh=np.asarray(dsh), dwexp=np.asarray(dwexp))
    return s, t, jax_out


def _close(got, want, dtype_name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL[dtype_name] * scale, f"max abs err {err:.3e} (scale {scale:.3e})"


def test_env_scatter_matches_pallas(pallas_run):
    s, t, j = pallas_run
    env = fused_tp.env_scatter(t["sh"], t["wexp"], t["centers"], t["row_ptr"], t["d2i"], U)
    assert env.shape == (N_ATOMS, len(s["dim_to_irr"]) * U) and env.dtype == t["x"].dtype
    _close(env, j["env"], s["dt"].name)


def test_gather_tp_matches_pallas(pallas_run):
    s, t, j = pallas_run
    env = torch.as_tensor(j["env"])
    out = fused_tp.gather_tp(t["x"], env, t["w"], t["centers"], t["idx"], t["coef"], s["dims"][2])
    _close(out, j["out"], s["dt"].name)


def test_bwd_fused_matches_pallas(pallas_run):
    s, t, j = pallas_run
    env = torch.as_tensor(j["env"])
    dx, denv = fused_tp.bwd_fused(t["x"], t["g"], env, t["w"], t["centers"], t["row_ptr"],
                                  t["idx"], t["coef"])
    _close(dx, j["dx"], s["dt"].name)
    _close(denv, j["denv"], s["dt"].name)


def test_unweight_both_matches_pallas(pallas_run):
    s, t, j = pallas_run
    denv = torch.as_tensor(j["denv"])
    dsh, dwexp = fused_tp.unweight_both(denv, t["sh"], t["wexp"], t["centers"], t["d2i"])
    _close(dsh, j["dsh"], s["dt"].name)
    _close(dwexp, j["dwexp"], s["dt"].name)


@pytest.mark.parametrize("layer", [0, 1])
def test_backward_plain_versions_match_autograd(layer):
    s = _setup(layer, "float64")
    t = _torch_args(s)
    sh = t["sh"].clone().requires_grad_(True)
    wexp = t["wexp"].clone().requires_grad_(True)
    x = t["x"].clone().requires_grad_(True)
    env = fused_tp.env_scatter_reference(sh, wexp, t["centers"], N_ATOMS, t["d2i"], U)
    env_leaf = env.detach().requires_grad_(True)
    out = fused_tp.gather_tp_reference(x, env_leaf, t["w"], t["centers"], t["idx"], t["coef"],
                                       s["dims"][2])
    ad_dx, ad_denv = torch.autograd.grad(out, [x, env_leaf], t["g"])
    dx, denv = fused_tp.bwd_fused_reference(x.detach(), t["g"], env.detach(), t["w"],
                                            t["centers"], N_ATOMS, t["idx"], t["coef"])
    torch.testing.assert_close(dx, ad_dx, rtol=0, atol=1e-10)
    torch.testing.assert_close(denv, ad_denv, rtol=0, atol=1e-10)
    ad_dsh, ad_dwexp = torch.autograd.grad(env, [sh, wexp], denv)
    dsh, dwexp = fused_tp.unweight_both_reference(denv, sh.detach(), wexp.detach(),
                                                  t["centers"], t["d2i"])
    torch.testing.assert_close(dsh, ad_dsh, rtol=0, atol=1e-10)
    torch.testing.assert_close(dwexp, ad_dwexp, rtol=0, atol=1e-10)


def test_fused_layer_infer_gradients_and_nan_weight_grad():
    s = _setup(0, "float64")
    t = _torch_args(s)
    leaves = {k: t[k].clone().requires_grad_(True) for k in ("x", "sh", "wexp", "w")}
    out = fused_layer_infer(leaves["x"], leaves["sh"], leaves["wexp"], leaves["w"], t["centers"],
                            t["row_ptr"], t["idx"], t["coef"], t["d2i"], s["dims"][2])
    (out * t["g"]).sum().backward()
    assert torch.isnan(leaves["w"].grad).all()
    # the other cotangents equal autograd through the plain composition
    ref = {k: t[k].clone().requires_grad_(True) for k in ("x", "sh", "wexp")}
    env = fused_tp.env_scatter_reference(ref["sh"], ref["wexp"], t["centers"], N_ATOMS,
                                         t["d2i"], U)
    out_ref = fused_tp.gather_tp_reference(ref["x"], env, t["w"], t["centers"], t["idx"],
                                           t["coef"], s["dims"][2])
    torch.testing.assert_close(out.detach(), out_ref.detach(), rtol=0, atol=1e-12)
    (out_ref * t["g"]).sum().backward()
    for k in ("x", "sh", "wexp"):
        torch.testing.assert_close(leaves[k].grad, ref[k].grad, rtol=0, atol=1e-10)


def test_cpu_tensors_take_the_plain_path():
    s = _setup(1, "float32")
    t = _torch_args(s)
    fused_tp.reset_launch_counts()
    env = fused_tp.env_scatter(t["sh"], t["wexp"], t["centers"], t["row_ptr"], t["d2i"], U)
    fused_tp.gather_tp(t["x"], env, t["w"], t["centers"], t["idx"], t["coef"], s["dims"][2])
    _, denv = fused_tp.bwd_fused(t["x"], t["g"], env, t["w"], t["centers"], t["row_ptr"],
                                 t["idx"], t["coef"])
    fused_tp.unweight_both(denv, t["sh"], t["wexp"], t["centers"], t["d2i"])
    assert fused_tp.LAUNCHES == {k: 0 for k in fused_tp.LAUNCHES}


def test_wrappers_reject_mixed_and_unsupported_devices():
    s = _setup(1, "float32")
    t = _torch_args(s)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_tp.env_scatter(t["sh"].to("meta"), t["wexp"].to("meta"), t["centers"].to("meta"),
                             t["row_ptr"].to("meta"), t["d2i"].to("meta"), U)
    with pytest.raises(ValueError, match="one device"):
        fused_tp.env_scatter(t["sh"], t["wexp"].to("meta"), t["centers"], t["row_ptr"],
                             t["d2i"], U)
    with pytest.raises(ValueError, match="shapes"):
        fused_tp.env_scatter(t["sh"], t["wexp"][:, :-1], t["centers"], t["row_ptr"], t["d2i"], U)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library(tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_build_reports_nvcc_errors(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fused_tp.cu(1): error: broken' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match=r"nvcc failed \(exit 2\)[\s\S]*error: broken"):
        _build.build_library(tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))
