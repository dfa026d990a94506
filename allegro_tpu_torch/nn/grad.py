"""Forces and virial/stress as derivatives of the total energy (twin of
``allegro_tpu/nn/grad.py``).

``forces = -∂E/∂pos`` and, with a cell, the symmetric-strain trick:
positions and cell are deformed by ``(I + ε)`` and ``virial = -∂E/∂ε`` at
``ε = 0``; ``stress = -virial / volume``. The force call takes the first
order (``create_graph=False``, outputs detached); training takes the second
(``create_graph=True``): the derivatives keep their graph, so a force loss
can be differentiated in the parameters.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..data import keys


def _detach(v):
    if isinstance(v, torch.Tensor):
        return v.detach()
    if isinstance(v, (tuple, list)):
        return type(v)(_detach(x) for x in v)
    return v


def force_stress_wrapper(apply_fn: Callable[[Dict], Dict], with_stress: bool = True,
                         create_graph: bool = False):
    """Wrap ``apply_fn(data) -> data`` to add FORCES (+ VIRIAL/STRESS)."""

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
            if keys.BATCH in data:
                batch = data[keys.BATCH].long()
            else:
                batch = torch.zeros(pos.shape[0], dtype=torch.long, device=pos.device)
            strain = torch.zeros((cell.shape[0], 3, 3), dtype=pos.dtype, device=pos.device,
                                 requires_grad=True)
            inputs.append(strain)
            eps = 0.5 * (strain + strain.transpose(-1, -2))
            d[keys.POSITIONS] = pos + torch.einsum("ni,nij->nj", pos, eps.index_select(0, batch))
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
            volume = torch.linalg.det(cell).abs()
            out[keys.VIRIAL] = -grads[1]
            out[keys.STRESS] = grads[1] / volume.clamp_min(1e-12)[:, None, None]
        return out

    return wrapped
