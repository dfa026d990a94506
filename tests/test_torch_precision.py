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
- The bf16 track off the mega path against JAX's, the same toy: on
  ``fused_infer`` with ``use_mega=False`` and with shared env weights (JAX's
  non-mega semantics: the features cast to bfloat16 at entry, the env and
  path weights each layer), and on the trainable ``fused`` backend. float64
  at 1e-10, except the ``fused`` forces (``F64_SCATTER_TOL``: JAX's
  ``tp_scatter`` computes in float32, the compute dtype of its two bf16
  inputs, also in a float64 model; measured 6.8e-10 relative); float32 at
  ``F32_TRACK_TOL`` (measured 4.6e-6 and 4.7e-6), with shared env weights
  at ``F32_SHARED_TRACK_TOL`` (measured 3.2e-5: one env weight's rounding
  flip moves every irrep of its channel).
- The JAX bench's 100k policy (bf16 track, "high", remat, checkpoint_energy)
  at the flagship's full widths on 12 atoms, the port alone against the
  port's float64 ``einsum``: the reference allclose, max(|Δf| - 5e-5 |f|)
  <= 5e-5 (the counterpart of JAX's slow-marked pin,
  ``test_bf16_storage.py:60-64``), on the mega path, on ``use_mega=False``
  and on ``fused``. On the JAX bench's crystal at 216 atoms with the card
  check's weights, JAX's own non-mega call misses that allclose, and the
  port's ``use_mega=False`` call is as far from the oracle as JAX's, in
  forces and energy.
- The matrix-product policy: TF32 on for the products of a call only with
  ``allow_tf32`` (precision None), off with "highest" and "high", the
  process's flags restored after each call; the options that still raise.
- ``tp_chunk_edges`` on ``einsum``: against JAX's model with the same kwarg
  (which its ``einsum`` contraction ignores) at 1e-10 and against the
  unchunked port, on an edge count that is no multiple of the chunk.
- JAX's parameters of a model built with the 100k policy load into the
  port's (the policies add none).
"""

import os

import numpy as np
import jax
import pytest
import torch

from allegro_tpu.data import to_jax
from allegro_tpu.model import AllegroModel as JaxAllegroModel
from allegro_tpu.ops import fused_tp as jax_ftp

from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
from allegro_tpu_torch.model import AllegroModel, params_from_jax
from torch_threads import one_thread  # noqa: F401

R_MAX = 2.5
TOL = 1e-10
# the bf16 track in float32, port against JAX: max |Δ| over max |ref| of each
# output (measured 1.1e-6 on the forces, ~1e-7 on the energies)
F32_TRACK_TOL = 1e-5
F32_SHARED_TRACK_TOL = 1e-4
F64_SCATTER_TOL = 1e-8
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


OFF_MEGA = {
    "use_mega_false": dict(tp_kernel_backend="fused_infer", use_mega=False),
    "shared_env_weights": dict(tp_kernel_backend="fused_infer", weight_individual_irreps=False),
    "fused": dict(tp_kernel_backend="fused"),
}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("route", list(OFF_MEGA))
def test_bf16_track_matches_jax_off_the_mega_path(route, dtype):
    kw = _toy(dtype, tensor_dtype="bfloat16", **OFF_MEGA[route])
    m, got, want = _jax_and_port(kw, _toy_batch(), np.float64 if dtype == "float64"
                                 else np.float32)
    assert not m.module.allegro.mega and m.routes()["allegro"] == "fused_call"
    for k in (k for k in OUTPUTS if k in want):
        err, rel = _max_rel(got[k], want[k])
        if dtype == "float32":
            tol = F32_SHARED_TRACK_TOL if route == "shared_env_weights" else F32_TRACK_TOL
            assert rel <= tol, (k, rel)
        elif route == "fused" and k == keys.FORCES:
            assert rel <= F64_SCATTER_TOL, (k, rel)
        else:
            assert err <= TOL * max(1.0, float(np.abs(np.asarray(want[k])).max())), (k, err)


def _policy_call(backend_kw):
    """The 100k policy at the flagship's widths on the 12-atom crystal and
    the port's float64 einsum oracle with the same weights."""
    batch = _crystal_batch()
    kw = dict(r_max=4.0, type_names=["A", "B", "C"], l_max=2, parity=True, num_layers=2,
              num_scalar_features=64, num_tensor_features=32, avg_num_neighbors=24.0,
              per_type_energy_scales=1.0, per_type_energy_shifts=0.0)
    oracle = AllegroModel(**kw, model_dtype="float64", tp_kernel_backend="einsum").init(0)
    ref = oracle.apply_with_derivatives(to_torch(oracle.precompute_statics(batch),
                                                 dtype=torch.float64))
    policy = AllegroModel(**kw, model_dtype="float32", tensor_dtype="bfloat16", remat=True,
                          checkpoint_energy=True, precision="high",
                          features_layout="flat_dim_major", **backend_kw)
    policy.load_state_dict({k: v.float() for k, v in oracle.state_dict().items()})
    out = policy.apply_with_derivatives(to_torch(policy.precompute_statics(batch),
                                                 dtype=torch.float32))
    return policy, out, ref


def _meets_the_reference_allclose(out, ref):
    f, f_ref = out[keys.FORCES].double(), ref[keys.FORCES]
    margin = float(((f - f_ref).abs() - REF_RTOL * f_ref.abs()).max())
    assert margin <= REF_ATOL, f"margin {margin:.3e}"
    e, e_ref = float(out[keys.TOTAL_ENERGY].sum()), float(ref[keys.TOTAL_ENERGY].sum())
    assert abs(e - e_ref) / max(abs(e_ref), 1e-3) < 6e-4


@pytest.mark.parametrize("route", ["use_mega_false", "fused"])
def test_the_100k_policy_meets_the_reference_allclose_off_the_mega_path(route):
    """JAX's non-mega semantics round layer 0's input features too: on these
    12 atoms the margin is 4.2e-5 (the mega path's 9e-6); on the card's
    4,096-atom crystal it misses (chip_smoke.py phase 11b)."""
    policy, out, ref = _policy_call(OFF_MEGA[route])
    assert policy.routes()["allegro"] == "fused_call" and policy.checkpoint_energy
    _meets_the_reference_allclose(out, ref)


def test_the_100k_policy_meets_the_reference_allclose_at_flagship_widths():
    policy, out, ref = _policy_call(dict(tp_kernel_backend="fused_infer"))
    assert policy.routes()["allegro"] == "mega" and policy.checkpoint_energy
    _meets_the_reference_allclose(out, ref)


POLICY_100K = dict(tensor_dtype="bfloat16", remat=True, checkpoint_energy=True,
                   precision="high", features_layout="flat_dim_major")
FLAGSHIP = dict(r_max=4.0, type_names=["A", "B", "C"], l_max=2, parity=True, num_layers=2,
                num_scalar_features=64, num_tensor_features=32, per_type_energy_scales=1.0,
                per_type_energy_shifts=0.0)
# the port's margin against JAX's own on the same inputs (the two sum in
# other orders, so a few features round the other way)
MARGIN_SLACK = 0.05
# the crystal's side in the comparison below: 6 (216 atoms); 16 is the card's
# 4,096 atoms (~7 min on one CPU worker)
OFF_MEGA_SIDE = int(os.environ.get("ATPT_OFF_MEGA_SIDE", "6"))


def _bench_crystal(side):
    """The JAX bench's crystal (``chip_smoke.crystal_frame``): a jittered
    simple-cubic lattice, spacing 2.2, three types, seed 0, r_max 4."""
    rng = np.random.RandomState(0)
    n = side**3
    grid = np.stack(np.meshgrid(*(np.arange(side),) * 3, indexing="ij"), -1).reshape(-1, 3)
    frame = {keys.POSITIONS: grid * 2.2 + 0.1 * rng.randn(n, 3),
             keys.ATOM_TYPES: rng.randint(0, 3, n).astype(np.int32),
             keys.CELL: np.eye(3) * side * 2.2, keys.PBC: np.ones(3, dtype=bool)}
    return batch_frames([neighbor_list(frame, 4.0)], n_frames=1), n


def _with_values(params, state):
    """JAX's parameter tree ``params`` holding the port's ``state`` (each
    leaf renamed as ``params_from_jax`` renames it)."""
    def value(path, leaf):
        single = np.zeros(())
        for k in reversed(path):
            single = {k.key: single}
        (name,) = params_from_jax(single)
        return np.asarray(state[name].detach().double().numpy(), dtype=leaf.dtype)

    return jax.tree_util.tree_map_with_path(value, params)


def test_the_100k_policy_off_the_mega_path_is_as_close_as_jaxs_own():
    """On the card's crystal cut to 216 atoms, with the weights the card's
    check uses (the flagship's ``init(0)``), the ``use_mega=False`` call of
    the 100k policy misses the reference allclose, and so does JAX's own
    non-mega call on the same inputs (Pallas in interpret mode): the miss is
    JAX's semantics (layer 0's input features rounded to bfloat16), not the
    port's. Margins against the float64 ``einsum`` oracle (printed): port
    8.36e-5, JAX 8.33e-5; energy |dE| over sum |E_i|: 2.46e-5 and 2.63e-5.
    With ``ATPT_OFF_MEGA_SIDE=16`` (the card's 4,096 atoms) it compares the
    two on ``chip_smoke.py`` phase 11b's inputs."""
    batch, n = _bench_crystal(OFF_MEGA_SIDE)
    avg = float(batch[keys.EDGE_MASK].sum()) / n
    oracle = AllegroModel(**FLAGSHIP, avg_num_neighbors=avg, model_dtype="float64",
                          tp_kernel_backend="einsum").init(0)
    ref = oracle.apply_with_derivatives(to_torch(oracle.precompute_statics(batch),
                                                 dtype=torch.float64))
    kw = dict(FLAGSHIP, avg_num_neighbors=avg, model_dtype="float32",
              tp_kernel_backend="fused_infer", use_mega=False, **POLICY_100K)
    port = AllegroModel(**kw)
    port.load_state_dict({k: v.float() for k, v in oracle.state_dict().items()})
    assert port.routes()["allegro"] == "fused_call" and port.checkpoint_energy
    out = port.apply_with_derivatives(to_torch(port.precompute_statics(batch),
                                               dtype=torch.float32))
    jm = JaxAllegroModel(**kw)
    jb = to_jax(batch, dtype=np.float32)
    params = _with_values(jm.init(0, jb), oracle.state_dict())
    old = jax_ftp.INTERPRET
    jax_ftp.INTERPRET = True
    try:
        want = jax.jit(jm.apply_with_derivatives)(params, jb)
    finally:
        jax_ftp.INTERPRET = old
    f_ref = ref[keys.FORCES][:n].numpy()
    e_ref = ref[keys.PER_ATOM_ENERGY][:n].numpy()
    scale = float(np.abs(e_ref).sum())
    seen = {}
    for who, f, e in (
            ("port", out[keys.FORCES][:n].double().numpy(), float(out[keys.TOTAL_ENERGY].sum())),
            ("JAX", np.asarray(want[keys.FORCES], dtype=np.float64)[:n],
             float(np.asarray(want[keys.TOTAL_ENERGY], dtype=np.float64).sum()))):
        margin = float((np.abs(f - f_ref) - REF_RTOL * np.abs(f_ref)).max())
        seen[who] = margin, abs(e - float(e_ref.sum())) / scale
    print(f"reference allclose margins (atol {REF_ATOL}): port {seen['port'][0]:.3e}, JAX "
          f"{seen['JAX'][0]:.3e}; energy |dE| / sum |E_i|: port {seen['port'][1]:.3e}, JAX "
          f"{seen['JAX'][1]:.3e}")
    assert seen["JAX"][0] > REF_ATOL, seen  # the crystal shows the miss
    assert seen["port"][0] <= (1 + MARGIN_SLACK) * seen["JAX"][0], seen
    assert seen["port"][1] <= (1 + MARGIN_SLACK) * seen["JAX"][1], seen


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
