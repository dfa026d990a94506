"""The port's domain decompositions (``allegro_tpu_torch/parallel``) against
the JAX package's, on the CPU, float64.

The small model and systems of ``tests/parallel/test_domain.py`` and
``test_brick.py`` (l_max 1, widths 8/4; 16x3x3 and 5³/12x5x5 jittered
lattices). The port runs its default ``fused_infer`` route (the kernels'
plain versions) on meshes of ``["cpu"] * D``:

- slab at D = 2, 4, 8 and brick at the JAX test's mesh shapes, periodic
  and open (brick also mixed): energy and forces against JAX's
  single-device force call at 1e-10, and against the port's undecomposed
  call; one slab against JAX's own decomposed call (``shard_map`` over 4
  host devices); one slab on ``einsum``;
- the host build equals JAX's: owned atoms, send lists, ghost slots and
  shifts array for array, each domain's local edges as a set;
- the width assertions; the open narrow box without duplicate edges;
- ``decomposition_accounting`` equals JAX's, and ``project_step`` with JAX's
  v5p figures passed as arguments equals JAX's projection;
- two identical decomposed calls give the same bits.
"""

import numpy as np
import jax
import pytest
import torch

from allegro_tpu.data import batch_frames as jax_batch_frames
from allegro_tpu.data import to_jax
from allegro_tpu.data.neighborlist import neighbor_list as jax_neighbor_list
from allegro_tpu.model import AllegroEnergyModel as JaxAllegroEnergyModel
from allegro_tpu.parallel import BrickDecomposition as JaxBrick
from allegro_tpu.parallel import SlabDecomposition as JaxSlab
from allegro_tpu.parallel.accounting import CHIP_SPECS
from allegro_tpu.parallel.accounting import decomposition_accounting as jax_accounting
from allegro_tpu.parallel.accounting import project_step as jax_project_step

from allegro_tpu_torch.data import batch_frames, keys, neighbor_list, to_torch
from allegro_tpu_torch.model import AllegroEnergyModel, params_from_jax
from allegro_tpu_torch.parallel import BrickDecomposition, SlabDecomposition
from allegro_tpu_torch.parallel.accounting import decomposition_accounting, project_step
from torch_threads import one_thread  # noqa: F401

R_MAX = 1.6
MODEL_KW = dict(
    r_max=R_MAX, type_names=["A", "B"], l_max=1, num_layers=2, num_scalar_features=8,
    num_tensor_features=4, scalar_embed_mlp_hidden_layers_width=8,
    allegro_mlp_hidden_layers_width=8, readout_mlp_hidden_layers_width=8,
    avg_num_neighbors=8.0, per_type_energy_scales=0.7, per_type_energy_shifts=[0.4, -0.1],
    model_dtype="float64",
)
PBC = {"all": (True, True, True), "none": (False, False, False), "mixed": (True, False, True)}
BRICK_SHAPES = [(2, 2, 2), (4, 2), (8,), (1, 2, 2)]


def _system(seed, nx, ny, nz, a=1.4, jitter=0.05):
    rng = np.random.RandomState(seed)
    grid = np.stack(
        np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"), -1
    ).reshape(-1, 3).astype(np.float64)
    pos = grid * a + jitter * rng.randn(len(grid), 3)
    cell = np.diag([nx * a, ny * a, nz * a])
    types = rng.randint(0, 2, len(grid)).astype(np.int32)
    return pos, types, cell


SYSTEMS = {"slab": (0, 16, 3, 3), "brick5": (1, 5, 5, 5), "brick12": (2, 12, 5, 5)}


@pytest.fixture(scope="module")
def jax_model():
    jm = JaxAllegroEnergyModel(**MODEL_KW)
    pos, types, _ = _system(0, 2, 2, 2)
    params = jm.init(0, {
        keys.POSITIONS: pos, keys.ATOM_TYPES: types,
        keys.EDGE_INDEX: np.zeros((2, 4), np.int32), keys.EDGE_CELL_SHIFT: np.zeros((4, 3)),
        keys.EDGE_MASK: np.zeros(4, bool),
    })
    # JAX's force call jitted: eager, each system takes ~15 s of op dispatch
    return jm, params, jax.jit(jm.apply_with_derivatives)


@pytest.fixture(scope="module")
def port_models(jax_model):
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_model[1]))
    out = {}
    for backend in ("fused_infer", "einsum"):
        m = AllegroEnergyModel(**MODEL_KW, tp_kernel_backend=backend)
        m.load_state_dict(state)
        out[backend] = m
    return out


def _frame(pos, types, cell, pbc):
    fr = {keys.POSITIONS: pos, keys.ATOM_TYPES: types}
    if any(pbc):
        fr[keys.CELL] = cell
        fr[keys.PBC] = np.asarray(pbc)
    return fr


@pytest.fixture(scope="module")
def references(jax_model, port_models):
    """Per (system, pbc): JAX's single-device (energy, forces) and the
    port's undecomposed ones, computed once."""
    jm, params, force_call = jax_model
    port = port_models["fused_infer"]
    cache = {}

    def get(system, pbc):
        if (system, pbc) not in cache:
            pos, types, cell = _system(*SYSTEMS[system])
            fr = _frame(pos, types, cell, PBC[pbc])
            jb = to_jax(jax_batch_frames([jax_neighbor_list(dict(fr), R_MAX)], n_frames=1),
                        dtype=np.float64)
            out = force_call(params, jb)
            want = (float(np.asarray(out[keys.TOTAL_ENERGY]).sum()),
                    np.asarray(out[keys.FORCES])[: len(pos)])
            b = batch_frames([neighbor_list(dict(fr), R_MAX)], n_frames=1)
            out = port.apply_with_derivatives(to_torch(port.precompute_statics(b), torch.float64))
            plain = (float(out[keys.TOTAL_ENERGY].sum()), out[keys.FORCES].numpy()[: len(pos)])
            cache[system, pbc] = want, plain
        return cache[system, pbc]

    return get


def _decomposed(dd, model, pos):
    e, f_local = dd.make_energy_forces_fn(model)(dd.scatter_positions(pos))
    assert e.device == dd.devices[0] and not e.requires_grad
    return float(e), dd.gather_forces(f_local)


def _close(got, want):
    assert got[0] == pytest.approx(want[0], abs=1e-10, rel=0)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-10)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("pbc", ["all", "none"])
def test_slab_matches_jax_and_the_undecomposed_call(n_dev, pbc, references, port_models):
    pos, types, cell = _system(*SYSTEMS["slab"])
    dd = SlabDecomposition(pos, types, cell if pbc == "all" else None, PBC[pbc], R_MAX,
                           ["cpu"] * n_dev, dtype=torch.float64)
    got = _decomposed(dd, port_models["fused_infer"], pos)
    want, plain = references("slab", pbc)
    _close(got, want)
    _close(got, plain)


@pytest.mark.parametrize("shape", BRICK_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("pbc", ["all", "none", "mixed"])
def test_brick_matches_jax_and_the_undecomposed_call(shape, pbc, references, port_models):
    system = "brick12" if shape[0] >= 4 else "brick5"
    pos, types, cell = _system(*SYSTEMS[system])
    dd = BrickDecomposition(pos, types, cell if any(PBC[pbc]) else None, PBC[pbc], R_MAX,
                            ["cpu"] * int(np.prod(shape)), mesh_shape=shape,
                            dtype=torch.float64)
    got = _decomposed(dd, port_models["fused_infer"], pos)
    want, plain = references(system, pbc)
    _close(got, want)
    _close(got, plain)


def test_slab_matches_jax_decomposed_call_and_on_einsum(jax_model, port_models):
    jm, params, _ = jax_model
    pos, types, cell = _system(*SYSTEMS["slab"])
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("dp",))
    jdd = JaxSlab(pos, types, cell, PBC["all"], R_MAX, mesh, dtype=np.float64)
    e, f_local = jdd.make_energy_forces_fn(jm, params)(jdd.scatter_positions(pos))
    want = (float(e), jdd.gather_forces(np.asarray(f_local)))
    for backend in ("fused_infer", "einsum"):
        dd = SlabDecomposition(pos, types, cell, PBC["all"], R_MAX, ["cpu"] * 4,
                               dtype=torch.float64)
        _close(_decomposed(dd, port_models[backend], pos), want)


def _edge_set(eidx, eshift, emask):
    i, j = eidx[0][emask], eidx[1][emask]
    return sorted(zip(i.tolist(), j.tolist(), map(tuple, np.rint(eshift[emask]).astype(int))))


@pytest.mark.parametrize("kind", ["slab", "brick"])
def test_host_build_equals_jax(kind):
    pos, types, cell = _system(*SYSTEMS["brick5" if kind == "brick" else "slab"])
    pbc = PBC["mixed"] if kind == "brick" else PBC["all"]
    if kind == "brick":
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), ("bx", "by", "bz"))
        theirs = JaxBrick(pos, types, cell, pbc, R_MAX, mesh, dtype=np.float64)
        ours = BrickDecomposition(pos, types, cell, pbc, R_MAX, ["cpu"] * 8,
                                  mesh_shape=(2, 2, 2), dtype=torch.float64)
        assert (ours.S, ours.stages, ours.L) == (theirs.S, theirs.stages, theirs.L)
    else:
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("dp",))
        theirs = JaxSlab(pos, types, cell, pbc, R_MAX, mesh, dtype=np.float64)
        ours = SlabDecomposition(pos, types, cell, pbc, R_MAX, ["cpu"] * 4, dtype=torch.float64)
        assert ours.S == theirs.S
    assert (ours.No, ours.El, ours.D) == (theirs.No, theirs.El, theirs.D)
    for a, b in zip(ours.owned, theirs.owned):
        np.testing.assert_array_equal(a, b)
    D = ours.D
    for k, v in theirs.arrays.items():
        v = np.asarray(v).reshape((D,) + np.asarray(v).shape[len(np.asarray(v).shape)
                                                            - ours.arrays[k].ndim + 1:])
        if k in ("edge_index", "edge_shift"):
            continue
        np.testing.assert_allclose(ours.arrays[k], v, rtol=0, atol=0, err_msg=k)
    for d in range(D):
        a, b = ours.arrays, {k: np.asarray(v).reshape(ours.arrays[k].shape)
                             for k, v in theirs.arrays.items()}
        assert _edge_set(a["edge_index"][d], a["edge_shift"][d], a["edge_mask"][d]) == \
            _edge_set(b["edge_index"][d], b["edge_shift"][d], b["edge_mask"][d])


def test_width_assertions():
    pos, types, cell = _system(0, 4, 3, 3)  # 8 slabs of 0.7 A: too thin
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("dp",))
    for make in (lambda: JaxSlab(pos, types, cell, (True,) * 3, R_MAX, mesh),
                 lambda: SlabDecomposition(pos, types, cell, (True,) * 3, R_MAX, ["cpu"] * 8)):
        with pytest.raises(AssertionError, match="slab width"):
            make()
    pos, types, cell = _system(0, 2, 2, 2)  # a 2.8 A box: bricks of 1.4 A
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), ("bx", "by", "bz"))
    for make in (lambda: JaxBrick(pos, types, cell, (True,) * 3, R_MAX, mesh),
                 lambda: BrickDecomposition(pos, types, cell, (True,) * 3, R_MAX, ["cpu"] * 8,
                                            mesh_shape=(2, 2, 2))):
        with pytest.raises(AssertionError, match="brick width"):
            make()
    with pytest.raises(ValueError, match="mesh_shape"):
        BrickDecomposition(pos, types, cell, (True,) * 3, R_MAX, ["cpu"] * 3, mesh_shape=(2, 2))


@pytest.mark.parametrize("cls", [SlabDecomposition, BrickDecomposition])
def test_open_boundary_narrow_box_no_duplicate_edges(cls, jax_model, port_models):
    """D = 2 along an open axis with domains 1.7 A wide, in [r_max, 2 r_max):
    the ring still wraps, and an unmasked wrap ghost would duplicate a direct
    one (the JAX test of the same name)."""
    rng = np.random.RandomState(3)
    jm, params, force_call = jax_model
    n = 24
    pos = np.zeros((n, 3))
    pos[:, 0] = rng.uniform(0.05, 3.35, n)
    pos[:, 1] = rng.uniform(0.0, 2.0, n)
    pos[:, 2] = rng.uniform(0.0, 2.0, n)
    pos[0, 0], pos[1, 0] = 0.0, 3.4  # pin the bounding box to 3.4 wide
    types = rng.randint(0, 2, n).astype(np.int32)
    fr = _frame(pos, types, None, PBC["none"])
    jb = to_jax(jax_batch_frames([jax_neighbor_list(fr, R_MAX)], n_frames=1), dtype=np.float64)
    out = force_call(params, jb)
    want = (float(np.asarray(out[keys.TOTAL_ENERGY]).sum()), np.asarray(out[keys.FORCES])[:n])
    dd = cls(pos, types, None, PBC["none"], R_MAX, ["cpu"] * 2, dtype=torch.float64)
    _close(_decomposed(dd, port_models["fused_infer"], pos), want)


@pytest.fixture(scope="module")
def crystal():
    rng = np.random.RandomState(0)
    side = 10  # 8 slabs at r_max 1.6 need side * 1.4 / 8 >= 1.6
    grid = np.stack(np.meshgrid(*(np.arange(side),) * 3, indexing="ij"), -1
                    ).reshape(-1, 3).astype(np.float64)
    pos = grid * 1.4 + 0.05 * rng.randn(len(grid), 3)
    return pos, rng.randint(0, 2, len(grid)).astype(np.int32), np.diag([side * 1.4] * 3)


@pytest.mark.parametrize("kind", ["slab", "brick"])
def test_accounting_and_projection_equal_jax(kind, crystal):
    pos, types, cell = crystal
    if kind == "slab":
        mesh = jax.sharding.Mesh(np.array(jax.devices("cpu")[:4]), ("dd",))
        theirs = jax_accounting(JaxSlab(pos, types, cell, (True,) * 3, 1.6, mesh))
        ours = decomposition_accounting(SlabDecomposition(pos, types, cell, (True,) * 3, 1.6,
                                                          ["cpu"] * 4))
    else:
        mesh = jax.sharding.Mesh(np.array(jax.devices("cpu")[:8]).reshape(2, 2, 2),
                                 ("bx", "by", "bz"))
        theirs = jax_accounting(JaxBrick(pos, types, cell, (True,) * 3, 1.6, mesh))
        ours = decomposition_accounting(BrickDecomposition(pos, types, cell, (True,) * 3, 1.6,
                                                           ["cpu"] * 8, mesh_shape=(2, 2, 2)))
    assert ours == theirs
    spec = CHIP_SPECS["v5p"]
    want = jax_project_step(theirs, hbm_bytes_per_edge=42000.0, chip="v5p", roofline_frac=0.7)
    got = project_step(ours, hbm_bytes_per_edge=42000.0, hbm_GBps=spec["hbm_GBps"],
                       link_GBps=spec["ici_GBps"] / 6.0, roofline_frac=0.7)
    assert got == {k: v for k, v in want.items() if k != "chip"}


@pytest.mark.parametrize("kind", ["slab", "brick"])
def test_two_identical_calls_give_the_same_bits(kind, port_models):
    pos, types, cell = _system(*SYSTEMS["brick5" if kind == "brick" else "slab"])
    if kind == "brick":
        dd = BrickDecomposition(pos, types, cell, PBC["all"], R_MAX, ["cpu"] * 8,
                                mesh_shape=(2, 2, 2), dtype=torch.float64)
    else:
        dd = SlabDecomposition(pos, types, cell, PBC["all"], R_MAX, ["cpu"] * 4,
                               dtype=torch.float64)
    fn = dd.make_energy_forces_fn(port_models["fused_infer"])
    local = dd.scatter_positions(pos)
    (e1, f1), (e2, f2) = fn(local), fn(local)
    assert torch.equal(e1, e2)
    assert all(torch.equal(a, b) for a, b in zip(f1, f2))
