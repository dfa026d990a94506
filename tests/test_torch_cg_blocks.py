"""The compiled CG blocks of ``gather_tp_embed`` and ``bwd_embed``
(``csrc/cg_blocks.h``), the path table that walks them, and the per-irrep
ranges of kernels 7 and 8, on the CPU.

- The checked-in header is what ``ops/gen_cg_blocks.py`` writes, byte for
  byte, and its coefficients, parsed back, are ``lib/wigner.py``'s blocks
  ``wigner_3j * sqrt(2 l3 + 1)`` at 1e-15: 34 triples with l <= 3, 611
  coefficients.
- ``path_table`` on the TP layers of the flagship (83 entries), l_max 3
  (353), ``parity=False`` at 3 layers and the 3-layer l_max-3 model (611) and
  on a table with a path beyond the header (l = 4, walked entry by entry):
  read back from the header, the descriptors cover every entry exactly
  once, at its coefficient; a table that is not a multiple of a block
  raises.
- Every block's forward face (``CgBlock::fwd``) holds the same
  coefficients, read back from its literals.
- A plain emulation of each kernel's path-blocked traversal (the header's
  parsed coefficients per path, a path beyond the header entry by entry)
  equals its plain version at 1e-12 in float64: ``bwd_embed_reference``
  with and without gts, ``gather_tp_embed_reference`` whole and split.
- ``irrep_ranges`` (kernels 7 and 8's per-irrep [start, len) table) reproduces
  ``dim_to_irr``.

The kernels themselves run only on the card (``chip_smoke.py``).
"""

import re

import numpy as np
import pytest
import torch

from allegro_tpu_torch.lib import Irreps
from allegro_tpu_torch.model import AllegroModel
from allegro_tpu_torch.nn.allegro import compute_irreps_ladder
from allegro_tpu_torch.nn.contract import Contracter, enumerate_instructions, pack_w3j
from allegro_tpu_torch.nn.contract import sparse_entries
from allegro_tpu_torch.ops import fused_tp, gen_cg_blocks
from allegro_tpu_torch.ops.fused_tp import csr_row_ptr, irrep_ranges
from allegro_tpu_torch.lib.wigner import wigner_3j
from torch_threads import one_thread  # noqa: F401


def _parse_header():
    """{(l1, l2, l3): dense block} from the header's literals."""
    text = gen_cg_blocks.HEADER.read_text()
    blocks = {}
    for m in re.finditer(r"struct CgBlock<(\d), (\d), (\d)> \{(.*?)\n\};", text, re.S):
        ls = tuple(int(v) for v in m.groups()[:3])
        block = np.zeros(tuple(2 * l + 1 for l in ls))
        for coef, c, a, b in re.findall(
                r"static_cast<float>\(([-+0-9.e]+)\) \* g\[(\d+)\]; "
                r"dx\[(\d+)\] = fmaf\(t, e\[(\d+)\]", m.group(4)):
            block[int(a), int(b), int(c)] += float(coef)
        blocks[ls] = block
    return blocks


BLOCKS = _parse_header()


def test_header_is_what_the_generator_writes():
    assert gen_cg_blocks.HEADER.read_text() == gen_cg_blocks.render_header()
    assert list(BLOCKS) == list(gen_cg_blocks.TRIPLES)
    assert len(BLOCKS) == 34
    assert sum(int(np.count_nonzero(b)) for b in BLOCKS.values()) == 611
    for (l1, l2, l3), block in BLOCKS.items():
        want = wigner_3j(l1, l2, l3) * np.sqrt(2 * l3 + 1)
        np.testing.assert_allclose(block, want, rtol=0, atol=1e-15, err_msg=str((l1, l2, l3)))
        assert np.count_nonzero(block) == np.count_nonzero(np.abs(want) > 1e-12)


def _layers(**kw):
    m = AllegroModel(r_max=4.0, type_names=["A", "B"], num_scalar_features=8,
                     num_tensor_features=4, avg_num_neighbors=10.0, model_dtype="float64", **kw)
    return [t for t in m.module.modules() if isinstance(t, Contracter)]


def _covered(paths):
    """{(i, j, k, p): coef} of every entry the descriptors stand for, each
    counted once; a block's entries come from the parsed header."""
    got = {}
    for q, (p, tid, i0, j0, k0, n0, n1, _) in enumerate(paths.desc.tolist()):
        if tid == gen_cg_blocks.DEFAULT:
            items = [(tuple(paths.entry_idx[n, :3].tolist()), float(paths.entry_coef[n]))
                     for n in range(n0, n1)]
        else:
            block = BLOCKS[gen_cg_blocks.TRIPLES[tid]]
            items = [((i0 + a, j0 + b, k0 + c), float(paths.scale[q]) * block[a, b, c])
                     for a, b, c in np.argwhere(block != 0.0)]
        for (i, j, k), coef in items:
            assert (i, j, k, p) not in got, "an entry is covered twice"
            got[(i, j, k, p)] = coef
    return got


@pytest.mark.parametrize("kw,n_entries", [
    (dict(l_max=2), 83),
    (dict(l_max=3), 353),
    (dict(l_max=2, parity=False, num_layers=3), 83),
    (dict(l_max=3, num_layers=3), 611),
], ids=["flagship", "lmax3", "parity_false_3layers", "lmax3_3layers"])
def test_path_table_covers_every_entry_once(kw, n_entries):
    layers = _layers(**kw)
    assert layers[0].entry_idx.shape[0] == n_entries
    for tp in layers:
        paths = tp.cg_paths()
        n = tp.entry_idx.shape[0]
        ranges = paths.desc[:, 5:7].tolist()
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        want = {tuple(i): c for i, c in zip(tp.entry_idx.tolist(), tp.entry_coef.tolist())}
        got = _covered(paths)
        assert sorted(got) == sorted(want)
        for key, coef in want.items():
            assert abs(got[key] - coef) <= 1e-12, key
        assert (paths.desc[:, 1] != gen_cg_blocks.DEFAULT).all()


def _beyond_the_header(tp):
    """tp's entries plus one path of span 9 x 1 x 9 (l = 4, 0, 4: not in the
    header) with arbitrary coefficients."""
    P = int(tp.entry_idx[:, 3].max()) + 1
    extra = torch.tensor([(i, 0, i, P) for i in range(9)], dtype=torch.int32)
    idx = torch.cat([tp.entry_idx, extra])
    coef = torch.cat([tp.entry_coef, torch.linspace(0.5, 1.5, 9, dtype=torch.float64)])
    return idx, coef


def test_path_table_walks_paths_beyond_the_header_by_entry():
    (tp, _) = _layers(l_max=2)
    idx, coef = _beyond_the_header(tp)
    paths = gen_cg_blocks.path_table(idx, coef, torch.float64)
    tids = paths.desc[:, 1].tolist()
    assert tids[:-1] == tp.cg_paths().desc[:, 1].tolist() and tids[-1] == gen_cg_blocks.DEFAULT
    got = _covered(paths)
    want = {tuple(i): c for i, c in zip(idx.tolist(), coef.tolist())}
    assert sorted(got) == sorted(want)
    assert all(abs(got[k] - c) <= 1e-12 for k, c in want.items())


def test_path_table_refuses_a_table_that_is_not_a_block():
    (tp, _) = _layers(l_max=2)
    coef = tp.entry_coef.clone()
    n = int(np.argmax(np.bincount(tp.entry_idx[:, 3].numpy())[tp.entry_idx[:, 3].numpy()]))
    coef[n] *= 1.5  # one entry of the largest path
    with pytest.raises(ValueError, match="not a multiple of the CG block"):
        gen_cg_blocks.path_table(tp.entry_idx, coef)
    scaled = gen_cg_blocks.path_table(tp.entry_idx, tp.entry_coef * -2.0, torch.float64)
    assert torch.allclose(scaled.scale, torch.full_like(scaled.scale, -2.0), rtol=0, atol=1e-12)


def _emulate(sh, w2b, g, env, w, row_ptr, paths, row_specs, gts=None):
    """The kernel's traversal in plain float64: per edge, per path, the slices
    through the parsed block (or the entries, for the default case); dx0 then
    onto the factors; denv summed over each atom's edges in edge order."""
    E, U = sh.shape[0], w.shape[1]
    n_atoms = row_ptr.shape[0] - 1
    d2 = env.shape[1] // U
    g = fused_tp._fold_gts(g, gts).view(E, -1, U)
    specs = row_specs.long()
    wb = w2b.view(E, -1, U)
    x0 = sh[:, specs[:, 0], None] * wb[:, specs[:, 1]]  # [E, d1, U]
    centers = torch.searchsorted(row_ptr[1:].long(), torch.arange(E), right=True)
    env_e = torch.cat([env, env.new_zeros(1, env.shape[1])])[centers].view(E, d2, U)
    dx = torch.zeros_like(x0)
    den_e = torch.zeros_like(env_e)
    for q, (p, tid, i0, j0, k0, n0, n1, _) in enumerate(paths.desc.tolist()):
        ws = w[p] * paths.scale[q]
        if tid == gen_cg_blocks.DEFAULT:
            for n in range(n0, n1):
                i, j, k = paths.entry_idx[n, :3].tolist()
                t = paths.entry_coef[n] * ws * g[:, k]
                dx[:, i] += t * env_e[:, j]
                den_e[:, j] += t * x0[:, i]
            continue
        C = torch.as_tensor(BLOCKS[gen_cg_blocks.TRIPLES[tid]])
        a, b, c = C.shape
        gs = ws * g[:, k0:k0 + c]
        dx[:, i0:i0 + a] += torch.einsum("abc,ebu,ecu->eau", C, env_e[:, j0:j0 + b], gs)
        den_e[:, j0:j0 + b] += torch.einsum("abc,eau,ecu->ebu", C, x0[:, i0:i0 + a], gs)
    dsh = torch.zeros_like(sh)
    dwb = torch.zeros_like(wb)
    for i, (js, r) in enumerate(specs.tolist()):
        dsh[:, js] += (dx[:, i] * wb[:, r]).sum(-1)
        dwb[:, r] += dx[:, i] * sh[:, js, None]
    real = centers < n_atoms
    dsh, dwb, den_e = dsh * real[:, None], dwb * real[:, None, None], den_e * real[:, None, None]
    denv = torch.stack([den_e[row_ptr[a]:row_ptr[a + 1]].sum(0) for a in range(n_atoms)])
    return dsh, dwb.reshape(E, -1), denv.reshape(n_atoms, -1)


@pytest.mark.parametrize("l_max,beyond", [(2, False), (3, False), (2, True)],
                         ids=["lmax2", "lmax3", "beyond_the_header"])
@pytest.mark.parametrize("split", [False, True], ids=["whole", "gts"])
def test_path_blocked_traversal_equals_the_plain_version(l_max, beyond, split):
    """Layer 0 of the ladder; ``beyond``: with a path of l = 4 added (the
    kernel's default case, entry by entry)."""
    sh_irreps = Irreps.spherical_harmonics(l_max)
    out = compute_irreps_ladder(sh_irreps, Irreps("+".join(
        f"1x{l}{p}" for l in range(l_max + 1) for p in "eo")), 2)[1]
    w3j = pack_w3j(sh_irreps, sh_irreps, out, enumerate_instructions(sh_irreps, sh_irreps, out))
    entries = sparse_entries(w3j)
    idx = torch.tensor([e[:4] for e in entries], dtype=torch.int32)
    coef = torch.tensor([e[4] for e in entries], dtype=torch.float64)
    P, d1, d2, d3 = w3j.shape
    if beyond:  # rows 0..8 of x0, dim 0 of env, output dims 0..8
        idx = torch.cat([idx, torch.tensor([(i, 0, i, P) for i in range(9)], dtype=torch.int32)])
        coef = torch.cat([coef, torch.linspace(0.5, 1.5, 9, dtype=torch.float64)])
        P += 1
    paths = gen_cg_blocks.path_table(idx, coef, torch.float64)
    assert (paths.desc[:, 1] == gen_cg_blocks.DEFAULT).any().item() == beyond
    U, n_atoms = 3, 7
    rng = np.random.RandomState(l_max)
    centers = np.sort(np.r_[rng.choice([0, 1, 2, 4, 5, 6], 30), 0, 1, 2, 4, 5, 6])
    centers = np.r_[centers, [n_atoms] * 5].astype(np.int32)  # atom 3 has no edges
    E = centers.shape[0]
    d2i = [k for k, s in enumerate(sh_irreps.slices()) for _ in range(s.stop - s.start)]
    specs = torch.tensor([(j, d2i[j]) for j in range(d1)], dtype=torch.int32)
    t = lambda *s: torch.as_tensor(rng.randn(*s))  # noqa: E731
    sh, w2b, g, env, w = t(E, d2), t(E, len(sh_irreps) * U), t(E, d3 * U), t(n_atoms, d2 * U), \
        t(P, U)
    gts = t(E, U) if split else None
    row_ptr = torch.as_tensor(csr_row_ptr(centers, n_atoms))
    want = fused_tp.bwd_embed_reference(sh, w2b, g, env, w, torch.as_tensor(centers), n_atoms,
                                        idx, coef, specs, gts)
    got = _emulate(sh, w2b, g, env, w, row_ptr, paths, specs, gts)
    for a, b, name in zip(got, want, ("dsh", "dw2b", "denv")):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12, msg=name)


@pytest.mark.parametrize("sh", ["1x0e+1x1o+1x2e", "1x0e+1x1o+1x2e+1x3o", "1x0e+1x1e", "1x1o"])
def test_irrep_ranges_reproduce_dim_to_irr(sh):
    irreps = Irreps(sh)
    d2i = torch.tensor([k for k, s in enumerate(irreps.slices()) for _ in range(s.stop - s.start)],
                       dtype=torch.int32)
    ranges = irrep_ranges(d2i)
    assert ranges.dtype == torch.int32 and ranges.shape == (len(irreps), 2)
    expanded = [r for r, (start, n) in enumerate(ranges.tolist()) for _ in range(n)]
    assert expanded == d2i.tolist()
    assert [start for start, _ in ranges.tolist()] == [s.start for s in irreps.slices()]
    with pytest.raises(ValueError, match="contiguous"):
        irrep_ranges(torch.tensor([0, 1, 0], dtype=torch.int32))


def _parse_fwd():
    """{(l1, l2, l3): dense block} from the literals of the header's fwd
    faces."""
    text = gen_cg_blocks.HEADER.read_text()
    blocks = {}
    for m in re.finditer(r"struct CgBlock<(\d), (\d), (\d)> \{(.*?)\n\};", text, re.S):
        ls = tuple(int(v) for v in m.groups()[:3])
        body = m.group(4).split("void bwd(")[0]
        block = np.zeros(tuple(2 * l + 1 for l in ls))
        for coef, a, c, b in re.findall(
                r"static_cast<float>\(([-+0-9.e]+)\) \* x\[(\d+)\]; "
                r"out\[(\d+)\] = fmaf\(t, e\[(\d+)\], out\[\d+\]\)", body):
            block[int(a), int(b), int(c)] += float(coef)
        blocks[ls] = block
    return blocks


FWD_BLOCKS = _parse_fwd()


def test_forward_blocks_are_the_generators_blocks():
    assert list(FWD_BLOCKS) == list(gen_cg_blocks.TRIPLES)
    assert sum(int(np.count_nonzero(b)) for b in FWD_BLOCKS.values()) == 611
    for ls, block in FWD_BLOCKS.items():
        np.testing.assert_array_equal(block, gen_cg_blocks.cg_block(*ls), err_msg=str(ls))
        np.testing.assert_array_equal(block, BLOCKS[ls], err_msg=str(ls))


def _emulate_forward(sh, w2b, env, w, row_ptr, paths, row_specs, d3, split):
    """gather_tp_embed's traversal in plain float64: per atom segment, per
    edge, per path, the x0 slice times the path weight and scale through the
    parsed forward block (or the entries one by one, for the default case),
    added into the edge's output; sentinel edges get zero rows."""
    E, U = sh.shape[0], w.shape[1]
    n_atoms = row_ptr.shape[0] - 1
    d2 = env.shape[1] // U
    specs = row_specs.long()
    wb = w2b.view(E, -1, U)
    out = sh.new_zeros((E, d3, U))
    for a in range(n_atoms):
        seg = slice(int(row_ptr[a]), int(row_ptr[a + 1]))
        x0 = sh[seg][:, specs[:, 0], None] * wb[seg][:, specs[:, 1]]  # [n, d1, U]
        ea = env[a].view(d2, U)
        o = out[seg]
        for q, (p, tid, i0, j0, k0, n0, n1, _) in enumerate(paths.desc.tolist()):
            ws = w[p] * paths.scale[q]
            if tid == gen_cg_blocks.DEFAULT:
                for n in range(n0, n1):
                    i, j, k = paths.entry_idx[n, :3].tolist()
                    o[:, k] += paths.entry_coef[n] * ws * x0[:, i] * ea[j]
                continue
            C = torch.as_tensor(FWD_BLOCKS[gen_cg_blocks.TRIPLES[tid]])
            na, nb, nc = C.shape
            o[:, k0:k0 + nc] += torch.einsum("abc,eau,bu->ecu", C, ws * x0[:, i0:i0 + na],
                                             ea[j0:j0 + nb])
    out = out.reshape(E, d3 * U)
    return (out, out[:, :U]) if split else (out,)


@pytest.mark.parametrize("l_max,beyond", [(2, False), (3, False), (2, True)],
                         ids=["lmax2", "lmax3", "beyond_the_header"])
@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
def test_path_blocked_forward_equals_the_plain_version(l_max, beyond, split):
    """gather_tp_embed's path walk with the forward blocks, on layer 0 of the
    ladder; ``beyond``: with a path of l = 4 added (the default case)."""
    sh_irreps = Irreps.spherical_harmonics(l_max)
    out = compute_irreps_ladder(sh_irreps, Irreps("+".join(
        f"1x{l}{p}" for l in range(l_max + 1) for p in "eo")), 2)[1]
    w3j = pack_w3j(sh_irreps, sh_irreps, out, enumerate_instructions(sh_irreps, sh_irreps, out))
    entries = sparse_entries(w3j)
    idx = torch.tensor([e[:4] for e in entries], dtype=torch.int32)
    coef = torch.tensor([e[4] for e in entries], dtype=torch.float64)
    P, d1, d2, d3 = w3j.shape
    if beyond:
        idx = torch.cat([idx, torch.tensor([(i, 0, i, P) for i in range(9)], dtype=torch.int32)])
        coef = torch.cat([coef, torch.linspace(0.5, 1.5, 9, dtype=torch.float64)])
        P += 1
    paths = gen_cg_blocks.path_table(idx, coef, torch.float64)
    assert (paths.desc[:, 1] == gen_cg_blocks.DEFAULT).any().item() == beyond
    U, n_atoms = 3, 7
    rng = np.random.RandomState(10 + l_max)
    centers = np.sort(np.r_[rng.choice([0, 1, 2, 4, 5, 6], 30), 0, 1, 2, 4, 5, 6])
    centers = np.r_[centers, [n_atoms] * 5].astype(np.int32)  # atom 3 has no edges
    E = centers.shape[0]
    d2i = [k for k, s in enumerate(sh_irreps.slices()) for _ in range(s.stop - s.start)]
    specs = torch.tensor([(j, d2i[j]) for j in range(d1)], dtype=torch.int32)
    t = lambda *s: torch.as_tensor(rng.randn(*s))  # noqa: E731
    sh, w2b, env, w = t(E, d2), t(E, len(sh_irreps) * U), t(n_atoms, d2 * U), t(P, U)
    row_ptr = torch.as_tensor(csr_row_ptr(centers, n_atoms))
    want = fused_tp.gather_tp_embed_reference(sh, w2b, env, w, torch.as_tensor(centers), idx,
                                              coef, specs, d3, split)
    got = _emulate_forward(sh, w2b, env, w, row_ptr, paths, specs, d3, split)
    for a, b in zip(got, want if split else (want,)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
