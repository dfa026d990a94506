"""The precision policies and the bf16 tensor track of the port (ROADMAP
item 6), on the CPU.

- The bf16 track (``tensor_dtype="bfloat16"``) on the default mega path
  against JAX's, its Pallas kernels in interpret mode, at the toy widths of
  JAX's ``tests/model/test_bf16_storage.py:_model`` on 12 atoms padded to 14:
  in float64, where both round the same float64 values to bfloat16, at
  1e-10; in float32 at ``F32_TRACK_TOL``, measured (the two sum in other
  orders, and a float32 sum within its noise of a bf16 rounding midpoint
  rounds the other way: 1.1e-6 relative on the forces here), no looser than
  JAX's own ``BF16_REL_FORCE_TOL`` = 6e-4.
- The JAX bench's 100k policy (bf16 track, "high", remat, checkpoint_energy)
  at the flagship's full widths on 12 atoms, the port alone against the
  port's float64 ``einsum``: the reference allclose, max(|Δf| - 5e-5 |f|)
  <= 5e-5 (the counterpart of JAX's slow-marked pin,
  ``test_bf16_storage.py:60-64``).
- The matrix-product policy: TF32 on for the products of a call only with
  ``allow_tf32`` (precision None), off with "highest" and "high", the
  process's flags restored after each call; the options that still raise.
- ``tp_chunk_edges`` on ``einsum``: against JAX's model with the same kwarg
  (which its ``einsum`` contraction ignores) at 1e-10 and against the
  unchunked port, on an edge count that is no multiple of the chunk.
- JAX's parameters of a model built with the 100k policy load into the
  port's (the policies add none).
"""

import numpy as np
import jax
import pytest
import torch

from allegro_tpu.data import to_jax
from allegro_tpu.model import AllegroModel as JaxAllegroModel
from allegro_tpu.ops import fused_tp as jax_ftp

from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
from allegro_tpu_torch.model import AllegroModel, params_from_jax

R_MAX = 2.5
TOL = 1e-10
# the bf16 track in float32, port against JAX: max |Δ| over max |ref| of each
# output (measured 1.1e-6 on the forces, ~1e-7 on the energies)
F32_TRACK_TOL = 1e-5
REF_ATOL = REF_RTOL = 5e-5
OUTPUTS = (keys.TOTAL_ENERGY, keys.PER_ATOM_ENERGY, keys.FORCES, keys.VIRIAL)


def _toy(model_dtype, **kw):
    """JAX's ``test_bf16_storage.py:_model`` kwargs."""
    return dict(
        r_max=R_MAX, type_names=["A", "B", "C"], l_max=2, parity=True, num_layers=2,
        num_scalar_features=16, num_tensor_features=4, scalar_embed_mlp_hidden_layers_width=16,
        allegro_mlp_hidden_layers_width=16, readout_mlp_hidden_layers_width=16,
        avg_num_neighbors=6.0, per_type_energy_scales=1.3,
        per_type_energy_shifts=[0.1, -0.2, 0.3], model_dtype=model_dtype, **kw,
    )


def _toy_batch(seed=9):
    """JAX's ``test_bf16_storage.py:_data``: 12 atoms (padded to 14), free."""
    rng = np.random.RandomState(seed)
    frame = {keys.POSITIONS: rng.randn(12, 3) * 1.4,
             keys.ATOM_TYPES: rng.randint(0, 3, 12).astype(np.int32)}
    return batch_frames([neighbor_list(frame, R_MAX)], n_atoms=14, n_frames=1, edge_multiple=16)


def _crystal_batch():
    """12 atoms: a jittered 2x2x3 periodic lattice, three types (r_max 4)."""
    rng = np.random.RandomState(1)
    grid = np.stack(np.meshgrid(*(np.arange(s) for s in (2, 2, 3)), indexing="ij"), -1)
    frame = {keys.POSITIONS: grid.reshape(-1, 3) * 2.2 + 0.1 * rng.randn(12, 3),
             keys.ATOM_TYPES: rng.randint(0, 3, 12).astype(np.int32),
             keys.CELL: np.diag([4.4, 4.4, 6.6]), keys.PBC: np.ones(3, dtype=bool)}
    return batch_frames([neighbor_list(frame, 4.0)], n_frames=1)


def _jax_and_port(kw, batch, dtype, seed=0):
    """JAX's force call (interpret mode) and the port's with JAX's parameters."""
    jm = JaxAllegroModel(**kw)
    jb = to_jax(batch, dtype=dtype)
    params = jm.init(seed, jb)
    old = jax_ftp.INTERPRET
    jax_ftp.INTERPRET = True
    try:
        want = jax.jit(jm.apply_with_derivatives)(params, jb)
    finally:
        jax_ftp.INTERPRET = old
    m = AllegroModel(**kw)
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    got = m.apply_with_derivatives(to_torch(m.precompute_statics(batch), dtype=torch.float64
                                            if dtype == np.float64 else torch.float32))
    return m, got, want


def _max_rel(got, want):
    w = np.asarray(want, dtype=np.float64)
    err = float(np.abs(got.double().numpy() - w).max())
    return err, err / max(float(np.abs(w).max()), 1e-30)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_bf16_track_matches_jax_on_the_mega_path(dtype):
    kw = _toy(dtype, tp_kernel_backend="fused_infer", tensor_dtype="bfloat16")
    m, got, want = _jax_and_port(kw, _toy_batch(), np.float64 if dtype == "float64"
                                 else np.float32)
    assert m.module.allegro.mega and m.routes()["allegro"] == "mega"
    for k in (k for k in OUTPUTS if k in want):
        err, rel = _max_rel(got[k], want[k])
        if dtype == "float64":
            assert err <= TOL * max(1.0, float(np.abs(np.asarray(want[k])).max())), (k, err)
        else:
            assert rel <= F32_TRACK_TOL, (k, rel)
    # the track changes the result: the same model without it differs
    exact = AllegroModel(**{**kw, "tensor_dtype": None})
    exact.load_state_dict(m.state_dict())
    out = exact.apply_with_derivatives(to_torch(exact.precompute_statics(_toy_batch()),
                                                dtype=got[keys.FORCES].dtype))
    assert not torch.equal(out[keys.FORCES], got[keys.FORCES])


def test_the_100k_policy_meets_the_reference_allclose_at_flagship_widths():
    batch = _crystal_batch()
    kw = dict(r_max=4.0, type_names=["A", "B", "C"], l_max=2, parity=True, num_layers=2,
              num_scalar_features=64, num_tensor_features=32, avg_num_neighbors=24.0,
              per_type_energy_scales=1.0, per_type_energy_shifts=0.0)
    oracle = AllegroModel(**kw, model_dtype="float64", tp_kernel_backend="einsum").init(0)
    ref = oracle.apply_with_derivatives(to_torch(oracle.precompute_statics(batch),
                                                 dtype=torch.float64))
    policy = AllegroModel(**kw, model_dtype="float32", tp_kernel_backend="fused_infer",
                          tensor_dtype="bfloat16", remat=True, checkpoint_energy=True,
                          precision="high", features_layout="flat_dim_major")
    policy.load_state_dict({k: v.float() for k, v in oracle.state_dict().items()})
    assert policy.routes()["allegro"] == "mega" and policy.checkpoint_energy
    out = policy.apply_with_derivatives(to_torch(policy.precompute_statics(batch),
                                                 dtype=torch.float32))
    f, f_ref = out[keys.FORCES].double(), ref[keys.FORCES]
    margin = float(((f - f_ref).abs() - REF_RTOL * f_ref.abs()).max())
    assert margin <= REF_ATOL, f"margin {margin:.3e}"
    e, e_ref = float(out[keys.TOTAL_ENERGY].sum()), float(ref[keys.TOTAL_ENERGY].sum())
    assert abs(e - e_ref) / max(abs(e_ref), 1e-3) < 6e-4


@pytest.mark.parametrize("policy,tf32", [
    ({"allow_tf32": True}, True),
    ({"precision": "high"}, False),
    ({"precision": "highest", "allow_tf32": True}, False),
    ({}, False),
], ids=["allow_tf32", "high", "highest", "default"])
def test_precision_flags_hold_for_the_call_only(policy, tf32):
    batch = _toy_batch()
    m = AllegroModel(**_toy("float32", tp_kernel_backend="fused_infer", **policy))
    seen = []

    def record(module, args):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))

    m.module.register_forward_pre_hook(record)
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (cuda.allow_tf32, cudnn.allow_tf32)
    try:
        for flags in ((True, True), (False, False)):
            cuda.allow_tf32, cudnn.allow_tf32 = flags
            data = to_torch(m.precompute_statics(batch), dtype=torch.float32)
            m.apply_with_derivatives(data)
            m.apply(data)
            assert (cuda.allow_tf32, cudnn.allow_tf32) == flags
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = before
    assert seen and all(s == (tf32, tf32) for s in seen), seen


@pytest.mark.parametrize("kw", [{"precision": "default"}, {"precision": "bfloat16"}],
                         ids=["default", "bfloat16"])
def test_other_precisions_raise_naming_item_6(kw):
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        AllegroModel(**_toy("float32", tp_kernel_backend="fused_infer", **kw))


def test_tp_chunk_edges_matches_jax_and_the_unchunked_einsum():
    batch = _toy_batch(3)
    E = int(batch[keys.EDGE_MASK].sum())
    chunk = 7
    assert E % chunk and batch[keys.EDGE_INDEX].shape[1] % chunk
    kw = _toy("float64", tp_kernel_backend="einsum", tp_chunk_edges=chunk)
    m, got, want = _jax_and_port(kw, batch, np.float64, seed=4)
    assert all(tp.chunk_edges == chunk for tp in m.module.allegro.tps)
    for k in (k for k in OUTPUTS if k in want):
        err, _ = _max_rel(got[k], want[k])
        assert err <= TOL * max(1.0, float(np.abs(np.asarray(want[k])).max())), (k, err)
    whole = AllegroModel(**{**kw, "tp_chunk_edges": 0})
    whole.load_state_dict(m.state_dict())
    out = whole.apply_with_derivatives(to_torch(whole.precompute_statics(batch),
                                                dtype=torch.float64))
    for k in (k for k in OUTPUTS if k in want):
        torch.testing.assert_close(got[k], out[k], rtol=0, atol=1e-12)


def test_jax_parameters_load_into_the_100k_policy():
    """The policies add no parameters: JAX's tree of a model built with the
    100k policy loads strictly into the port's, whose names are those of
    the model without it."""
    kw = _toy("float32", tp_kernel_backend="fused_infer", tensor_dtype="bfloat16", remat=True,
              checkpoint_energy=True, precision="high", features_layout="flat_dim_major")
    params = JaxAllegroModel(**kw).init(0, to_jax(_toy_batch(), dtype=np.float32))
    m = AllegroModel(**kw)
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    plain = AllegroModel(**_toy("float32", tp_kernel_backend="fused_infer"))
    assert sorted(m.state_dict()) == sorted(plain.state_dict())


def test_calculator_and_md_run_the_100k_policy():
    """``AllegroCalculator`` and ``md.Simulation`` run a model built with the
    100k policy as they run any other: the calculator's forces are the force
    call's, and MD steps stay finite."""
    from allegro_tpu_torch.calculator import AllegroCalculator
    from allegro_tpu_torch.md import MDState, Simulation

    rng = np.random.RandomState(0)
    grid = np.stack(np.meshgrid(*(np.arange(2),) * 3, indexing="ij"), -1).reshape(-1, 3)
    frame = {keys.POSITIONS: grid * 2.2 + 0.1 * rng.randn(8, 3),
             keys.ATOM_TYPES: rng.randint(0, 3, 8).astype(np.int32),
             keys.CELL: np.eye(3) * 4.4, keys.PBC: np.ones(3, dtype=bool)}
    m = AllegroModel(**{**_toy("float32", tp_kernel_backend="fused_infer", tensor_dtype="bfloat16",
                               remat=True, checkpoint_energy=True, precision="high"),
                        "r_max": 4.0}).init(0)
    want = m.apply_with_derivatives(to_torch(m.precompute_statics(
        batch_frames([neighbor_list(frame, 4.0)])), dtype=torch.float32))
    res = AllegroCalculator(m, device="cpu").calculate(
        frame[keys.POSITIONS], atom_types=frame[keys.ATOM_TYPES], cell=frame[keys.CELL],
        pbc=frame[keys.PBC])
    np.testing.assert_allclose(res["forces"], want[keys.FORCES][:8].numpy(), rtol=0, atol=1e-5)
    sim = Simulation(m, frame[keys.ATOM_TYPES], np.ones(3), 4.0, cell=frame[keys.CELL],
                     pbc=(True,) * 3, steps_per_block=2, device="cpu")
    st = sim.run(MDState(frame[keys.POSITIONS], np.zeros((8, 3))), 2)
    assert np.isfinite(st.positions).all()


@pytest.mark.parametrize("gopt,policy", [
    ({"allow_tf32": False}, {"precision": "highest"}),
    ({"allow_tf32": False, "matmul_precision": "high"}, {"precision": "highest"}),
    # TF32 on: JAX's CLI ignores allow_tf32: true (ROADMAP queue 3, a departure)
    ({"allow_tf32": True}, {"allow_tf32": True}),
    ({"matmul_precision": "high"}, {"precision": "high"}),
    ({"allow_tf32": True, "matmul_precision": "highest"},
     {"allow_tf32": True, "precision": "highest"}),
    ({}, {}),
], ids=["no_tf32", "no_tf32_high", "tf32", "high", "tf32_highest", "none"])
def test_cli_global_options_become_the_model_policy(gopt, policy):
    from allegro_tpu_torch.cli import _global_options

    assert _global_options(gopt) == policy
    AllegroModel(**_toy("float32", tp_kernel_backend="fused_infer", **policy))
