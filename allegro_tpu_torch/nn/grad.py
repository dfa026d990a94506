"""Forces and virial/stress as derivatives of the total energy (twin of
``allegro_tpu/nn/grad.py``).

``forces = -∂E/∂pos`` and, with a cell, the symmetric-strain trick:
positions and cell are deformed by ``(I + ε)`` and ``virial = -∂E/∂ε`` at
``ε = 0``; ``stress = -virial / volume``. The force call takes the first
order (``create_graph=False``, outputs detached); training takes the second
(``create_graph=True``): the derivatives keep their graph, so a force loss
can be differentiated in the parameters. ``checkpoint_energy`` recomputes
the whole energy evaluation inside the backward pass (JAX's
``jax.checkpoint`` of ``apply_fn``): only its inputs are kept, and the
kernels run twice. Its result then holds the energies and the inputs, not
the model's per-edge intermediates: a tensor returned from the checkpointed
evaluation stays alive beside its recompute (JAX under ``jit`` drops the
outputs nobody reads; eager PyTorch cannot).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..data import keys
from .atomwise import frame_one_hot


def _detach(v):
    if isinstance(v, torch.Tensor):
        return v.detach()
    if isinstance(v, (tuple, list)):
        return type(v)(_detach(x) for x in v)
    return v


def force_stress_wrapper(apply_fn: Callable[[Dict], Dict], with_stress: bool = True,
                         create_graph: bool = False, checkpoint_energy: bool = False):
    """Wrap ``apply_fn(data) -> data`` to add FORCES (+ VIRIAL/STRESS)."""
    if checkpoint_energy:
        energy_fn = apply_fn

        def energies(d: Dict) -> Dict:
            out = energy_fn(d)
            return {k: v for k, v in out.items()
                    if k in d or k in (keys.TOTAL_ENERGY, keys.PER_ATOM_ENERGY)}

        def apply_fn(d: Dict) -> Dict:
            return checkpoint(energies, d, use_reentrant=False)

    def wrapped(data: Dict) -> Dict:
        with torch.enable_grad():
            return _with_derivatives(data)

    def _with_derivatives(data: Dict) -> Dict:
        pos = data[keys.POSITIONS].detach().requires_grad_(True)
        has_cell = keys.CELL in data and keys.EDGE_CELL_SHIFT in data
        do_stress = with_stress and has_cell
        d = dict(data)
        d.pop(keys.EDGE_VECTORS, None)
        d.pop(keys.EDGE_LENGTH, None)
        inputs = [pos]
        if do_stress:
            cell = data[keys.CELL] if data[keys.CELL].ndim == 3 else data[keys.CELL][None]
            strain = torch.zeros((cell.shape[0], 3, 3), dtype=pos.dtype, device=pos.device,
                                 requires_grad=True)
            inputs.append(strain)
            eps = 0.5 * (strain + strain.transpose(-1, -2))
            if keys.BATCH in data:
                # each atom's frame strain as a product with the frames'
                # one-hot: its transpose, the virial's sum over atoms, adds in
                # a fixed order (a gather's would be an index_add)
                onehot = frame_one_hot(data[keys.BATCH], cell.shape[0], pos.dtype)
                eps_atoms = (onehot.T @ eps.reshape(-1, 9)).reshape(-1, 3, 3)
            else:
                eps_atoms = eps[0].expand(pos.shape[0], 3, 3)
            d[keys.POSITIONS] = pos + torch.einsum("ni,nij->nj", pos, eps_atoms)
            d[keys.CELL] = cell + torch.einsum("fij,fjk->fik", cell, eps)
        else:
            d[keys.POSITIONS] = pos
        out = apply_fn(d)
        e_total = out[keys.TOTAL_ENERGY]
        if keys.FRAME_MASK in data:
            e_total = e_total * data[keys.FRAME_MASK].to(e_total.dtype)[:, None]
        grads = torch.autograd.grad(e_total.sum(), inputs, create_graph=create_graph)
        if not create_graph:
            # the graph is spent: hand back plain values, as the JAX call does
            out = {k: _detach(v) for k, v in out.items()}
        forces = -grads[0]
        if keys.NODE_MASK in data:
            forces = forces * data[keys.NODE_MASK].to(forces.dtype)[:, None]
        out[keys.FORCES] = forces
        if do_stress:
            # torch has no bfloat16 LU: a bf16 cell's determinant in
            # float32, rounded back (JAX's ``jnp.linalg.det`` keeps the dtype)
            wide = cell.float() if cell.dtype == torch.bfloat16 else cell
            volume = torch.linalg.det(wide).abs().to(cell.dtype)
            out[keys.VIRIAL] = -grads[1]
            out[keys.STRESS] = grads[1] / volume.clamp_min(1e-12)[:, None, None]
        return out

    return wrapped
