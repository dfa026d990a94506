"""The shared-memory fit rule that routes wide models off the fused kernels
(``ops/smem_fit.py``), on the CPU.

- The rule's bytes on both sides of an H100's 227 KB opt-in (passed as an
  argument): the readout kernels by K and H, the latent-MLP kernels by S
  and hidden width, the embed kernels by U; each family's bytes never fall
  as a width grows.
- On a card with that limit (the rule's device query replaced), the
  flagship keeps the mega layers and the fused readout, and the three wide
  models of ``chip_smoke.WIDE_MODELS`` take the non-fused ones: S = 128 with
  3 layers and readout width 128 (neither), S = 128 with latent width 128
  and S = 256 with latent width 256 (no mega layers, the fused readout);
  on the CPU, where the plain versions run, nothing is routed off.
- The wide models' force call, on that route, against JAX's ``einsum`` at
  1e-10 (float64) on a small crystal.
"""

import numpy as np
import jax
import pytest
import torch

from allegro_tpu.data import to_jax
from allegro_tpu.model import AllegroModel as JaxAllegroModel

from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
from allegro_tpu_torch.model import AllegroModel, params_from_jax
from allegro_tpu_torch.ops import smem_fit
from torch_threads import one_thread  # noqa: F401

OPTIN = 232448  # an H100 block's opt-in shared memory (227 KB)
FLAGSHIP = dict(r_max=4.0, type_names=["A", "B", "C"], l_max=2, parity=True, num_layers=2,
                num_scalar_features=64, num_tensor_features=32, avg_num_neighbors=20.0,
                per_type_energy_scales=1.3, per_type_energy_shifts=[0.1, -0.2, 0.3])
WIDE = {
    "S128_3layers_readout128": ({"num_scalar_features": 128, "num_layers": 3,
                                 "readout_mlp_hidden_layers_width": 128},
                                {"allegro": "fused_call", "edge_readout": "plain"}),
    "S128_latent128": ({"num_scalar_features": 128, "allegro_mlp_hidden_layers_width": 128},
                       {"allegro": "fused_call", "edge_readout": "fused"}),
    "S256_latent256": ({"num_scalar_features": 256, "allegro_mlp_hidden_layers_width": 256},
                       {"allegro": "fused_call", "edge_readout": "fused"}),
}


@pytest.fixture
def h100(monkeypatch):
    """The rule's device query answers an H100's opt-in, on any device."""
    monkeypatch.setattr(smem_fit, "smem_optin", lambda device: OPTIN)


@pytest.mark.parametrize("rule, fits", [
    (lambda L: smem_fit.readout_sum_bytes(192, 32, L), True),
    (lambda L: smem_fit.readout_sum_bytes(512, 128, L), False),
    (lambda L: smem_fit.readout_bwd_bytes(192, 32, True, L), True),
    (lambda L: smem_fit.readout_bwd_bytes(512, 128, True, L), False),
    (lambda L: smem_fit.readout_bwd_bytes(1184, 32, True, L), True),
    (lambda L: smem_fit.readout_bwd_bytes(1216, 32, True, L), False),
    (lambda L: smem_fit.latent_env_scatter_bytes(True, 160, 64, 160, 9, 32, 3, L), True),
    (lambda L: smem_fit.latent_env_scatter_bytes(True, 288, 128, 224, 9, 32, 3, L), False),
    (lambda L: smem_fit.latent_env_bwd_bytes(False, 64, 0, 64, 160, 9, 32, 3, L), True),
    (lambda L: smem_fit.latent_env_bwd_bytes(False, 128, 0, 128, 224, 9, 32, 3, L), False),
    (lambda L: smem_fit.gather_tp_embed_bytes(18, 18, 9, 3, 9, 9, 9, 32, L), True),
    (lambda L: smem_fit.bwd_embed_bytes(18, 18, 9, 3, 9, 9, 9, 32, L), True),
    (lambda L: smem_fit.bwd_embed_bytes(18, 18, 9, 3, 9, 9, 9, 1024, L), False),
], ids=["rs_flagship", "rs_K512_H128", "rb_flagship", "rb_K512_H128", "rb_K1184_H32",
        "rb_K1216_H32", "les_flagship", "les_S128_H128", "leb_proj_S64", "leb_proj_S128",
        "gte_U32", "be_U32", "be_U1024"])
def test_fit_rule_on_both_sides_of_the_limit(rule, fits):
    assert (rule(OPTIN) <= OPTIN) == fits
    # the smallest layout the launcher tries: no limit below it changes it
    small = rule(0)
    assert small <= rule(OPTIN) and rule(small) == small


@pytest.mark.parametrize("family", ["readout_sum", "readout_bwd", "latent_env", "embed"])
def test_fit_rule_grows_with_width(family):
    widths = range(16, 2049, 16)
    by = {
        "readout_sum": lambda w: smem_fit.readout_sum_bytes(w, 64, OPTIN),
        "readout_bwd": lambda w: smem_fit.readout_bwd_bytes(w, 64, True, OPTIN),
        "latent_env": lambda w: smem_fit.latent_env_bwd_bytes(True, 2 * w + 32, w, w, w + 96, 9,
                                                              32, 3, OPTIN),
        "embed": lambda w: smem_fit.bwd_embed_bytes(18, 18, 9, 3, 9, 9, 9, w, OPTIN),
    }[family]
    sizes = [by(w) for w in widths]
    fit = [s <= OPTIN for s in sizes]
    assert fit[0] and not fit[-1]
    # past the limit the smallest layouts, which only grow
    first_out = fit.index(False)
    assert not any(fit[first_out:])
    assert all(a <= b for a, b in zip(sizes[first_out:], sizes[first_out + 1:]))


def test_flagship_keeps_the_fused_kernels_on_an_h100(h100):
    m = AllegroModel(**FLAGSHIP, tp_kernel_backend="fused_infer")
    assert m.routes("cpu") == {"allegro": "mega", "edge_readout": "fused"}
    assert m.module.allegro.mega_fits(OPTIN) and m.module.edge_readout.fits(OPTIN)


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_models_route_off_the_fused_kernels(name, h100):
    over, want = WIDE[name]
    m = AllegroModel(**{**FLAGSHIP, **over}, tp_kernel_backend="fused_infer")
    assert m.module.allegro.mega and m.module.edge_readout.fusable  # JAX's conditions hold
    assert m.routes("cpu") == want


@pytest.mark.parametrize("name", list(WIDE))
def test_nothing_is_routed_off_on_the_cpu(name):
    m = AllegroModel(**{**FLAGSHIP, **WIDE[name][0]}, tp_kernel_backend="fused_infer")
    assert smem_fit.smem_optin("cpu") is None
    assert m.routes("cpu") == {"allegro": "mega", "edge_readout": "fused"}


def _crystal():
    rng = np.random.RandomState(0)
    grid = np.stack(np.meshgrid(*(np.arange(2),) * 3, indexing="ij"), -1).reshape(-1, 3)
    return neighbor_list({keys.POSITIONS: grid * 2.2 + 0.1 * rng.randn(8, 3),
                          keys.ATOM_TYPES: rng.randint(0, 3, 8).astype(np.int32),
                          keys.CELL: np.eye(3) * 4.4, keys.PBC: np.ones(3, dtype=bool)}, 4.0)


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_model_force_call_matches_jax(name, h100):
    over, want = WIDE[name]
    kw = {**FLAGSHIP, **over, "model_dtype": "float64"}
    batch = batch_frames([_crystal()], n_frames=1)
    jm = JaxAllegroModel(**kw)
    jb = to_jax(batch, dtype=np.float64)
    params = jm.init(0, jb)
    ref = jax.jit(jm.apply_with_derivatives)(params, jb)
    m = AllegroModel(**kw, tp_kernel_backend="fused_infer")
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    got = m.apply_with_derivatives(to_torch(m.precompute_statics(batch), torch.float64))
    assert m.routes("cpu") == want
    for k in (keys.TOTAL_ENERGY, keys.PER_ATOM_ENERGY, keys.FORCES):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-10,
                                   err_msg=k)
