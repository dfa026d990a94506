"""The trainable backend's kernels and autograd Functions, on the CPU.

- The plain versions of ``tp_scatter``, ``gather_dw``, ``unweight_sh``,
  ``unweight_w`` and ``gather_tp`` on the role-swapped entry table against
  the Pallas kernels they replace (``tp_scatter_call``, ``gather_dw_call``,
  ``gather_unweight_sh_call``, ``gather_unweight_w_call``,
  ``gather_tp_call``), run in interpret mode on the same inputs, float64 at
  1e-10. The Pallas kernels work in rank space (atoms that have edges, in
  order): their per-atom inputs are mapped there and their per-atom outputs
  back. Atom 5 and the last atoms have no edges; the edge list ends in
  sentinel padding.
- Sentinel edges: garbage on their rows changes no per-atom or per-path
  output, and their per-edge outputs are zero.
- ``gradcheck`` and ``gradgradcheck`` (float64) of each Function of the
  family, and first- and second-order gradients of ``fused_layer`` against
  JAX's ``fused_primitives.fused_layer`` in interpret mode.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from allegro_tpu.ops import fused_primitives as jax_fp
from allegro_tpu.ops import fused_tp as jax_ftp

from allegro_tpu_torch.lib import Irreps
from allegro_tpu_torch.nn.allegro import compute_irreps_ladder
from allegro_tpu_torch.nn.contract import enumerate_instructions, pack_w3j, sparse_entries
from allegro_tpu_torch.ops import fused_tp
from allegro_tpu_torch.ops.fused_primitives import (
    EnvScatter,
    FusedStatics,
    GatherDw,
    GatherTp,
    TpScatter,
    UnweightSh,
    UnweightW,
    fused_layer,
)

EB = 128
U = 4
N_ATOMS = 24
E_REAL = 150
TOL = 1e-10


def _layer_tables(layer):
    sh = Irreps("1x0e+1x1o+1x2e")
    ladder = compute_irreps_ladder(sh, Irreps("1x0e+1x0o+1x1e+1x1o+1x2e+1x2o"), 2)
    a, b = ladder[layer], ladder[layer + 1]
    w3j = pack_w3j(a, sh, b, enumerate_instructions(a, sh, b))
    dim_to_irr = tuple(k for k, s in enumerate(sh.slices()) for _ in range(s.stop - s.start))
    return w3j, sparse_entries(w3j), dim_to_irr


def _setup(layer, n_atoms=N_ATOMS, e_real=E_REAL, u=U, seed=3):
    rng = np.random.RandomState(seed + layer)
    w3j, entries, dim_to_irr = _layer_tables(layer)
    P, d1, d2, d3 = w3j.shape
    n_irr = max(dim_to_irr) + 1
    # atom 5 and the last atoms have no edges; sentinel padding to a multiple of EB
    atoms = np.array([a for a in range(n_atoms - 4) if a != 5])
    real = np.sort(rng.choice(atoms, size=e_real))
    real[: len(atoms)] = atoms  # every listed atom has at least one edge
    real = np.sort(real)
    Ep = -(-e_real // EB) * EB
    centers = np.concatenate([real, np.full(Ep - e_real, n_atoms)]).astype(np.int32)

    def arr(*shape, edge=True):
        a = rng.randn(*shape)
        if edge:
            a[e_real:] = 0.0
        return a

    s = dict(entries=entries, dims=(d1, d2, d3), dim_to_irr=dim_to_irr, P=P, n_irr=n_irr,
             centers=centers, Ep=Ep, atoms=atoms, n_atoms=n_atoms, e_real=e_real, U=u,
             x=arr(Ep, d1 * u), g=arr(Ep, d3 * u), sh=arr(Ep, d2), wexp=arr(Ep, n_irr * u),
             w=arr(P, u, edge=False), env=arr(n_atoms, d2 * u, edge=False),
             t=arr(n_atoms, d2 * u, edge=False), v=arr(P, u, edge=False))
    idx = torch.tensor([e[:4] for e in entries], dtype=torch.int32)
    s["st"] = FusedStatics(
        torch.as_tensor(centers), torch.as_tensor(fused_tp.csr_row_ptr(centers, n_atoms)),
        torch.tensor(dim_to_irr, dtype=torch.int32), n_irr, u, idx, fused_tp.swap_entries(idx),
        torch.tensor([e[4] for e in entries], dtype=torch.float64), P, (d1, d2, d3))
    return s


def _t(s, *names):
    return [torch.as_tensor(s[n]) for n in names]


@pytest.fixture(scope="module")
def interpret():
    old = jax_ftp.INTERPRET
    jax_ftp.INTERPRET = True
    yield
    jax_ftp.INTERPRET = old


@pytest.fixture(scope="module", params=[0, 1], ids=["layer0", "layer1"])
def pallas_run(request, interpret):
    """The five Pallas kernels on one layer's inputs, outputs in atom space."""
    s = _setup(request.param)
    win, offs, _ = jax_ftp.make_block_plan_np(s["centers"], EB, s["n_atoms"])
    nr = jax_ftp.num_rank_rows(s["n_atoms"], EB)
    kw = dict(entries=s["entries"], dims=s["dims"], U=U, eb=EB)
    ukw = dict(dim_to_irr=s["dim_to_irr"], U=U, eb=EB)

    def to_rank(a):  # atom rows -> rank rows (zero rows past the last rank)
        r = np.zeros((nr, a.shape[1]))
        r[: len(s["atoms"])] = a[s["atoms"]]
        return jnp.asarray(r)

    def to_atoms(dA, dB):
        comb = np.asarray(jax_ftp.combine_scatter_outputs(dA, dB, win, EB))
        out = np.zeros((s["n_atoms"], comb.shape[1]))
        out[s["atoms"]] = comb[: len(s["atoms"])]
        return out

    J = {k: jnp.asarray(s[k]) for k in ("x", "g", "sh", "wexp", "w")}
    env_r, t_r = to_rank(s["env"]), to_rank(s["t"])
    swapped = tuple((k, j, i, p, c) for (i, j, k, p, c) in s["entries"])
    d1, d2, d3 = s["dims"]
    out = dict(
        tp_scatter=to_atoms(*jax_ftp.tp_scatter_call(J["x"], J["g"], J["w"], offs, win,
                                                     n_rank_rows=nr, **kw)),
        gather_dw=jax_ftp.gather_dw_call(J["x"], env_r, env_r, J["g"], offs, win, **kw),
        unweight_sh=jax_ftp.gather_unweight_sh_call(t_r, t_r, J["wexp"], offs, win, **ukw),
        unweight_w=jax_ftp.gather_unweight_w_call(t_r, t_r, J["sh"], offs, win, **ukw),
        gather_tp_swapped=jax_ftp.gather_tp_call(J["g"], env_r, env_r, J["w"], offs, win,
                                                 entries=swapped, dims=(d3, d2, d1), U=U, eb=EB),
    )
    return s, {k: np.asarray(v) for k, v in out.items()}


def _port_outputs(s):
    x, g, sh, wexp, w, env, t = _t(s, "x", "g", "sh", "wexp", "w", "env", "t")
    st = s["st"]
    sw = st.swap()
    return dict(
        tp_scatter=fused_tp.tp_scatter(x, g, w, st.centers, st.row_ptr, st.entry_idx,
                                       st.entry_coef, st.dims[1]),
        gather_dw=fused_tp.gather_dw(x, env, g, st.centers, st.entry_idx, st.entry_coef,
                                     st.n_paths, U),
        unweight_sh=fused_tp.unweight_sh(t, wexp, st.centers, st.dim_to_irr),
        unweight_w=fused_tp.unweight_w(t, sh, st.centers, st.dim_to_irr, st.n_irr),
        gather_tp_swapped=fused_tp.gather_tp(g, env, w, st.centers, sw.entry_idx, sw.entry_coef,
                                             sw.dims[2]),
    )


KERNELS = ["tp_scatter", "gather_dw", "unweight_sh", "unweight_w", "gather_tp_swapped"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_versions_match_pallas(pallas_run, kernel):
    s, want = pallas_run
    got = _port_outputs(s)[kernel].numpy()
    assert got.shape == want[kernel].shape
    scale = max(1.0, float(np.abs(want[kernel]).max()))
    err = float(np.abs(got - want[kernel]).max())
    assert err <= TOL * scale, f"{kernel}: max abs err {err:.3e} (scale {scale:.3e})"


@pytest.mark.parametrize("layer", [0, 1])
def test_sentinel_edges_add_nothing(layer):
    """Garbage on the sentinel rows of every per-edge input leaves the
    per-atom and per-path outputs unchanged; per-edge outputs are zero
    there (a sentinel reads zero per-atom rows)."""
    s = _setup(layer)
    clean = _port_outputs(s)
    noisy = dict(s)
    rng = np.random.RandomState(11)
    for k in ("x", "g", "sh", "wexp"):
        a = s[k].copy()
        a[s["e_real"]:] = 1e3 * rng.randn(*a[s["e_real"]:].shape)
        noisy[k] = a
    dirty = _port_outputs(noisy)
    for k in ("tp_scatter", "gather_dw"):
        torch.testing.assert_close(dirty[k], clean[k], rtol=0, atol=1e-12)
    for k in ("unweight_sh", "unweight_w", "gather_tp_swapped"):
        assert (dirty[k][s["e_real"]:] == 0).all()
        torch.testing.assert_close(dirty[k][: s["e_real"]], clean[k][: s["e_real"]], rtol=0,
                                   atol=1e-12)


def _small(layer):
    """A tiny layer for gradcheck: 10 atoms (5 with edges), 10 real edges,
    U = 1, 2 sentinel edges."""
    s = _setup(layer, n_atoms=10, e_real=10, u=1, seed=5)
    keep = 12
    s = dict(s, Ep=keep, centers=s["centers"][:keep])
    for k in ("x", "g", "sh", "wexp"):
        s[k] = s[k][:keep]
    s["st"] = s["st"]._replace(centers=torch.as_tensor(s["centers"]),
                               row_ptr=torch.as_tensor(fused_tp.csr_row_ptr(s["centers"], 10)))
    return s


FUNCTIONS = {
    "EnvScatter": (EnvScatter, ("sh", "wexp")),
    "GatherTp": (GatherTp, ("x", "env", "w")),
    "TpScatter": (TpScatter, ("x", "g", "w")),
    "GatherDw": (GatherDw, ("x", "env", "g")),
    "UnweightSh": (UnweightSh, ("t", "wexp")),
    "UnweightW": (UnweightW, ("t", "sh")),
}


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_functions_pass_gradcheck_and_gradgradcheck(name, layer):
    s = _small(layer)
    fn, names = FUNCTIONS[name]
    inputs = tuple(t.clone().requires_grad_(True) for t in _t(s, *names))

    def f(*args):
        return fn.apply(*args, s["st"])

    assert torch.autograd.gradcheck(f, inputs)
    assert torch.autograd.gradgradcheck(f, inputs)


@pytest.fixture(scope="module")
def layer_grads(interpret):
    """JAX fused_layer's first-order gradients and force-style second-order
    weight gradient (the twin of tests/nn/test_fused_primitives.py:119-156)."""
    s = _setup(0)
    win, offs, _ = jax_ftp.make_block_plan_np(s["centers"], EB, s["n_atoms"])
    nr = jax_ftp.num_rank_rows(s["n_atoms"], EB)
    args = tuple(jnp.asarray(s[k]) for k in ("x", "sh", "wexp", "w"))

    def layer(x, sh, wexp, w):
        return jax_fp.fused_layer(x, sh, wexp, w, offs, win, entries=s["entries"], dims=s["dims"],
                                  U=U, eb=EB, dim_to_irr=s["dim_to_irr"], n_rank_rows=nr)

    def loss(*a):
        out = layer(*a)
        return jnp.sum(out * out) + jnp.sum(out[:, :U] ** 3)

    def force_loss(w):
        frc = jax.grad(lambda sh_: jnp.sum(layer(args[0], sh_, args[2], w) ** 2))(args[1])
        return jnp.sum(frc * frc)

    first = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
    second = jax.grad(force_loss)(args[3])
    return s, [np.asarray(g) for g in first], np.asarray(second)


def test_fused_layer_first_order_grads_match_jax(layer_grads):
    s, want, _ = layer_grads
    leaves = [t.clone().requires_grad_(True) for t in _t(s, "x", "sh", "wexp", "w")]
    out = fused_layer(*leaves, s["st"])
    loss = (out * out).sum() + (out[:, :U] ** 3).sum()
    got = torch.autograd.grad(loss, leaves)
    for g, w_, name in zip(got, want, ("x", "sh", "wexp", "w")):
        np.testing.assert_allclose(g.numpy(), w_, rtol=0, atol=1e-9, err_msg=f"grad wrt {name}")


def test_fused_layer_second_order_force_style_matches_jax(layer_grads):
    s, _, want = layer_grads
    x, sh, wexp, w = _t(s, "x", "sh", "wexp", "w")
    sh, w = sh.requires_grad_(True), w.requires_grad_(True)
    out = fused_layer(x, sh, wexp, w, s["st"])
    (frc,) = torch.autograd.grad((out * out).sum(), sh, create_graph=True)
    (got,) = torch.autograd.grad((frc * frc).sum(), w)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)
