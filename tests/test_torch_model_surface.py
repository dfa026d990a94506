"""The rest of the model surface against the JAX package, on the CPU.

Configurations: JAX's ``MODEL_GRID`` (``tests/model/test_allegro_model.py``:
the defaults, ``parity=False``, no path-channel coupling, the spline embed;
its per-edge-type-cutoff row is ``tests/test_torch_cutoffs.py``'s), plus l_max 3, three layers
with ``parity=False`` (the only depth at which it changes the ladder) and
shared env weights (``weight_individual_irreps=False``). Tiny widths
(``num_tensor_features=4``, as that file has), float64.

- Each configuration on every port backend (``einsum``, ``fused``,
  ``fused_infer`` with and without the mega layers, ``pallas``; the kernels'
  plain versions on the CPU) against the JAX model on ``einsum`` from the
  same weights (``params_from_jax``): energy and forces at 1e-10. JAX runs
  ``einsum`` here, not its own kernel backends: their Pallas kernels in
  interpret mode would take minutes for this grid (``test_torch_pallas.py``
  and ``test_torch_model_interpret.py`` hold the port to those).
- Shared env weights take the non-mega kernels on ``fused_infer``, as in JAX.
- O(3) equivariance through ``allegro_tpu_torch.lib.testing``: each
  configuration's Contracters (tensor track features transformed by their
  Wigner D blocks, parity included) and the model's energy and forces under a
  random O(3) element; ``rep_matrix`` and the l = 3 spherical harmonics
  against JAX's.
- Force-loss parameter gradients on ``fused`` and ``pallas`` at l_max 3
  against JAX ``einsum``; the spline embed's parameters carried over.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from allegro_tpu.data import to_jax
from allegro_tpu.lib.spherical_harmonics import spherical_harmonics as jax_sh
from allegro_tpu.lib.testing import rep_matrix as jax_rep_matrix
from allegro_tpu.model import AllegroModel as JaxAllegroModel

from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
from allegro_tpu_torch.lib import Irreps, rand_o3_matrix, rep_matrix, spherical_harmonics
from allegro_tpu_torch.lib import transform_flat_dim_major
from allegro_tpu_torch.model import AllegroModel, params_from_jax
from allegro_tpu_torch.nn.allegro import compute_irreps_ladder
from allegro_tpu_torch.nn.contract import Contracter
from allegro_tpu_torch.ops import fused_tp
from allegro_tpu_torch.ops.fused_tp import csr_row_ptr
from torch_threads import one_thread  # noqa: F401

R_MAX = 4.0
SPLINE = {"_target_": "allegro_tpu.nn.TwoBodySplineScalarEmbed", "num_splines": 8,
          "spline_span": 6}
CONFIGS = {
    "default": dict(),
    "parity_false": dict(parity=False),
    "uncoupled": dict(tp_path_channel_coupling=False),
    "spline": dict(radial_chemical_embed=SPLINE),
    "lmax3": dict(l_max=3),
    "parity_false_3layers": dict(parity=False, num_layers=3),
    "shared_env_weights": dict(weight_individual_irreps=False),
}
BACKENDS = ("einsum", "fused", "mega", "fused_infer", "pallas")


def _crystal(side, seed, spacing=2.2):
    rng = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(*(np.arange(s) for s in side), indexing="ij"), -1).reshape(-1, 3)
    n = grid.shape[0]
    return neighbor_list({
        keys.POSITIONS: grid * spacing + 0.1 * rng.randn(n, 3),
        keys.ATOM_TYPES: rng.randint(0, 3, n).astype(np.int32),
        keys.CELL: np.diag(np.asarray(side, dtype=np.float64) * spacing),
        keys.PBC: np.ones(3, dtype=bool),
    }, R_MAX)


FRAMES = [_crystal((2, 2, 2), 0), _crystal((2, 2, 3), 1)]
BATCH = batch_frames(FRAMES, n_frames=2)
AVG_N = sum(f[keys.EDGE_INDEX].shape[1] for f in FRAMES) / sum(
    f[keys.POSITIONS].shape[0] for f in FRAMES)


def _kwargs(**over):
    kw = dict(r_max=R_MAX, type_names=["A", "B", "C"], l_max=2, parity=True, num_layers=2,
              num_scalar_features=8, num_tensor_features=4,
              scalar_embed_mlp_hidden_layers_width=8, allegro_mlp_hidden_layers_width=8,
              readout_mlp_hidden_layers_width=8, avg_num_neighbors=AVG_N,
              per_type_energy_scales=1.3, per_type_energy_shifts=[0.1, -0.2, 0.3],
              model_dtype="float64")
    kw.update(over)
    return kw


def _port(backend, **over):
    """``"mega"`` is ``fused_infer`` with its default ``use_mega``."""
    if backend == "mega":
        return AllegroModel(**_kwargs(**over), tp_kernel_backend="fused_infer")
    extra = {"use_mega": False} if backend == "fused_infer" else {}
    return AllegroModel(**_kwargs(**over), tp_kernel_backend=backend, **extra)


def _outputs(model, batch=BATCH, create_graph=False):
    data = to_torch(model.precompute_statics(batch), torch.float64)
    return model.apply_with_derivatives(data, create_graph=create_graph)


def _jax_loss(out):
    return jnp.sum(out[keys.FORCES] ** 2) + out[keys.TOTAL_ENERGY].sum() ** 2


@functools.lru_cache(maxsize=None)
def _jax(name):
    """JAX einsum on the batch: its parameters under the port's names and its
    energy and forces; for l_max 3 also the force-loss parameter gradients
    (one compiled call for both)."""
    jm = JaxAllegroModel(**_kwargs(**CONFIGS[name]))
    jb = to_jax(BATCH, dtype=np.float64)
    params = jm.init(0, jb)

    def run(p):
        out = jm.apply_with_derivatives(p, jb)
        out = {k: out[k] for k in (keys.TOTAL_ENERGY, keys.FORCES)}
        if name != "lmax3":
            return out, None
        return out, jax.grad(lambda q: _jax_loss(jm.apply_with_derivatives(q, jb)))(p)

    out, grads = jax.jit(run)(params)
    by_name = lambda tree: params_from_jax(jax.tree_util.tree_map(np.asarray, tree))  # noqa: E731
    return (by_name(params), {k: np.asarray(v) for k, v in out.items()},
            None if grads is None else {k: v.numpy() for k, v in by_name(grads).items()})


@pytest.fixture(scope="module", params=list(CONFIGS))
def jax_run(request):
    return (request.param, *_jax(request.param)[:2])


@pytest.mark.parametrize("backend", BACKENDS)
def test_configuration_matches_jax_einsum(jax_run, backend):
    name, state, want = jax_run
    m = _port(backend, **CONFIGS[name])
    m.load_state_dict(state)
    out = _outputs(m)
    for k in (keys.TOTAL_ENERGY, keys.FORCES):
        np.testing.assert_allclose(out[k].numpy(), want[k], rtol=0, atol=1e-10, err_msg=k)


def test_mega_path_follows_jax_condition():
    """Shared env weights: fused_infer takes the non-mega kernels, even
    with use_mega=True (JAX's condition); the other configurations take the
    mega layers by default."""
    for name, over in CONFIGS.items():
        m = AllegroModel(**_kwargs(**over), tp_kernel_backend="fused_infer", use_mega=True)
        assert m.module.allegro.mega == (name != "shared_env_weights"), name
        assert m.module.tensor_embed.build_features == (name == "shared_env_weights"), name


def test_shared_env_weights_narrow_the_projection():
    wide, narrow = _port("einsum"), _port("einsum", weight_individual_irreps=False)
    S, U, n_irr = 8, 4, 3
    assert wide.module.allegro.first_projection.w0.shape == (8, S + n_irr * U)
    assert narrow.module.allegro.first_projection.w0.shape == (8, S + U)
    assert narrow.module.allegro.latents[0].w1.shape[1] == S + U


@pytest.mark.parametrize("name", list(CONFIGS))
def test_contracters_are_o3_equivariant(name):
    """Each layer's Contracter (``einsum`` and ``pallas``): transforming both
    inputs by an O(3) element (Wigner D blocks, parity included) transforms
    the output the same way."""
    over = CONFIGS[name]
    l_max, L = over.get("l_max", 2), over.get("num_layers", 2)
    sh = Irreps.spherical_harmonics(l_max, p=-1)
    allowed = (Irreps([(1, (l, p)) for l in range(l_max + 1) for p in (1, -1)])
               if over.get("parity", True) else sh)
    ladder = compute_irreps_ladder(sh, allowed, L)
    rng = np.random.RandomState(3)
    U, E, n_atoms = 2, 6, 3
    centers_np = np.sort(rng.randint(0, n_atoms, E)).astype(np.int32)
    centers = torch.as_tensor(centers_np)
    row_ptr = torch.as_tensor(csr_row_ptr(centers_np, n_atoms))  # pallas reads it, einsum not
    gen = torch.Generator().manual_seed(0)
    for layer in range(L):
        irr = (ladder[layer], sh, ladder[layer + 1])
        x1, x2 = rng.randn(E, irr[0].dim * U), rng.randn(E, irr[1].dim * U)
        R = rand_o3_matrix(rng)
        parity = int(np.sign(np.linalg.det(R)))
        Rp = R * parity  # the proper rotation; the parity acts through the irreps
        for backend in ("einsum", "pallas"):
            c = Contracter(*map(str, irr), U, path_channel_coupling=over.get(
                "tp_path_channel_coupling", True), scatter_factor=0.5, dtype=torch.float64,
                kernel_backend=backend)
            c.reset_parameters(gen)
            f = lambda a, b: c(torch.as_tensor(a), torch.as_tensor(b), centers,  # noqa: E731
                               n_atoms, row_ptr).detach().numpy()
            got = f(transform_flat_dim_major(x1, irr[0], U, Rp, parity),
                    transform_flat_dim_major(x2, irr[1], U, Rp, parity))
            want = transform_flat_dim_major(f(x1, x2), irr[2], U, Rp, parity)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-10,
                                       err_msg=f"{name} layer {layer} {backend}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_model_is_o3_invariant_and_forces_covariant(name):
    """Energy invariant and forces rotated under a random O(3) element of a
    single frame (on the default ``fused_infer`` path)."""
    m = _port("mega", **CONFIGS[name]).init(0)
    fr = FRAMES[1]
    R = rand_o3_matrix(np.random.RandomState(5))
    rot = neighbor_list({keys.POSITIONS: fr[keys.POSITIONS] @ R.T,
                         keys.ATOM_TYPES: fr[keys.ATOM_TYPES],
                         keys.CELL: fr[keys.CELL] @ R.T, keys.PBC: fr[keys.PBC]}, R_MAX)
    out = _outputs(m, batch_frames([fr]))
    out_r = _outputs(m, batch_frames([rot]))
    np.testing.assert_allclose(out_r[keys.TOTAL_ENERGY].numpy(), out[keys.TOTAL_ENERGY].numpy(),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(out_r[keys.FORCES].numpy(), out[keys.FORCES].numpy() @ R.T,
                               rtol=0, atol=1e-9)


def test_rep_matrix_and_l3_harmonics_match_jax():
    rng = np.random.RandomState(2)
    irreps = "1x0e+1x0o+1x1e+1x1o+1x2e+1x2o+1x3e+1x3o"
    for parity in (1, -1):
        R = rand_o3_matrix(rng)
        np.testing.assert_allclose(rep_matrix(irreps, R, parity),
                                   jax_rep_matrix(irreps, R, parity), rtol=0, atol=1e-12)
    v = rng.randn(50, 3)
    got = spherical_harmonics(3, torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_sh(3, jnp.asarray(v))), rtol=0, atol=1e-12)
    assert got.shape == (50, 16)


@pytest.mark.parametrize("backend", ["fused", "pallas"])
def test_lmax3_force_loss_gradients_match_jax_einsum(backend):
    state, _, want = _jax("lmax3")
    m = _port(backend, l_max=3)
    m.load_state_dict(state)
    out = _outputs(m, create_graph=True)
    loss = (out[keys.FORCES] ** 2).sum() + out[keys.TOTAL_ENERGY].sum() ** 2
    ps = m.parameters()
    assert sorted(ps) == sorted(want)
    for name, grad in zip(ps, torch.autograd.grad(loss, list(ps.values()))):
        np.testing.assert_allclose(grad.numpy(), want[name], atol=1e-9, rtol=1e-7, err_msg=name)


def test_spline_embed_parameters_carry_over():
    state = _jax("spline")[0]
    w = state["radial_chemical_embed.spline.spline_weights"]
    assert w.shape == (9, 8, 8)  # [types², channels, num_splines]
    m = _port("einsum", radial_chemical_embed=SPLINE)
    m.load_state_dict(state)
    assert sorted(m.state_dict()) == sorted(state)
    np.testing.assert_array_equal(m.state_dict()["radial_chemical_embed.spline.spline_weights"]
                                  .numpy(), w.numpy())
    # JAX's alias of num_splines
    alias = _port("einsum", radial_chemical_embed={"_target_": SPLINE["_target_"],
                                                   "spline_grid_size": 5})
    assert alias.module.radial_chemical_embed.spline.spline_weights.shape == (9, 8, 5)


def test_per_edge_type_cutoff_still_raises():
    """Per-edge-type cutoffs run (``tests/test_torch_cutoffs.py``); one above
    r_max raises, as JAX's assertion does."""
    _port("einsum", per_edge_type_cutoff={"A": 3.0})
    with pytest.raises(ValueError, match="<= r_max"):
        _port("einsum", per_edge_type_cutoff={"A": 5.0})


def test_cpu_force_calls_launch_nothing():
    for backend in ("mega", "pallas"):
        m = _port(backend, l_max=3).init(0)
        fused_tp.reset_launch_counts()
        out = _outputs(m)
        assert torch.isfinite(out[keys.FORCES]).all()
        assert fused_tp.LAUNCHES == {k: 0 for k in fused_tp.LAUNCHES}


NEW_KEYS = dict(l_max=3, parity=False, weight_individual_irreps=False,
                radial_chemical_embed=SPLINE)


@pytest.mark.parametrize("backend", ["fused_infer", "pallas"])
def test_cli_md_runs_the_new_model_keys(tmp_path, backend):
    """``python -m allegro_tpu_torch md`` with the new ``model:`` keys."""
    import contextlib
    import io
    from pathlib import Path

    import yaml

    from allegro_tpu_torch.cli import main

    with open(Path(__file__).resolve().parent.parent / "configs/md.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["model"].update(NEW_KEYS, num_scalar_features=8, num_tensor_features=4,
                        tp_kernel_backend=backend)
    cfg["md"].update(n_atoms=27, n_steps=4, steps_per_block=2)
    path = tmp_path / "md.yaml"
    path.write_text(yaml.safe_dump(cfg))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["md", "-c", str(path), "-w", str(tmp_path / "md"), "--device", "cpu"]) == 0
    assert "MD done: 4 steps of 27 atoms" in buf.getvalue()


def test_trainer_and_calculator_run_the_new_model_keys():
    from allegro_tpu_torch.calculator import AllegroCalculator
    from allegro_tpu_torch.data import DataLoader, InMemoryDataset
    from allegro_tpu_torch.train import Trainer

    frames = [dict(f, **{keys.TOTAL_ENERGY: np.zeros(1),
                         keys.FORCES: np.zeros_like(f[keys.POSITIONS])}) for f in FRAMES]
    trainer = Trainer(_port("fused", **NEW_KEYS), device="cpu", logger=lambda s: None)
    trainer.fit(trainer.init_state(0), DataLoader(InMemoryDataset(frames, R_MAX), batch_size=2))
    assert np.isfinite(trainer.history[-1]["train_loss"])
    fr = FRAMES[0]
    res = AllegroCalculator(_port("pallas", **NEW_KEYS).init(0), device="cpu").calculate(
        fr[keys.POSITIONS], atom_types=fr[keys.ATOM_TYPES], cell=fr[keys.CELL], pbc=fr[keys.PBC])
    assert np.isfinite(res["forces"]).all() and np.isfinite(res["energy"])
