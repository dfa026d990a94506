"""Communication and ghost accounting of the domain decompositions (twin
of ``allegro_tpu/parallel/accounting.py``).

Every halo payload is a fixed-shape array built at decomposition time, so
halo bytes, ghost fractions and transfer counts are exact host numbers.
``project_step`` combines them with a device's bandwidths, which the
caller gives: the port carries no device's figures.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def decomposition_accounting(dd, itemsize: int = 4) -> Dict:
    """Exact per-step communication of a Slab/Brick decomposition.

    One decomposed force call (``halo.DomainForceCall``): per stage, each
    domain sends its two send buffers ``[S, 3]``; the ghost forces return
    the same payloads in reverse. Everything is padded, so the bytes moved
    are exact.
    """
    from .brick import BrickDecomposition

    D = dd.D
    No, El = int(dd.No), int(dd.El)
    owned = dd.n_own.astype(int)
    if isinstance(dd, BrickDecomposition):
        stages = [int(dd.S[a]) for a in dd.stages]
        ghost_mask = np.concatenate(
            [np.asarray(st["ghost_mask"]) for st in dd._stage_arrays], axis=1
        )  # [D, sum of 2 S_a]
        L = int(dd.L)
        kind = "brick"
        mesh_shape = tuple(int(s) for s in dd.mesh_shape)
    else:  # slab
        stages = [int(dd.S)]
        ghost_mask = np.asarray(dd.arrays["ghost_mask"])
        L = No + 2 * int(dd.S)
        kind = "slab"
        mesh_shape = (D,)
    ghosts_real = ghost_mask.sum(axis=1).astype(int)  # [D]
    edge_mask = np.asarray(dd.arrays["edge_mask"]).reshape(D, -1)
    edges_real = edge_mask.sum(axis=1).astype(int)

    # one force call, per domain: per stage, 2 sends of [S, 3] (the halo)
    # and the same payloads back (the ghost forces)
    halo_fwd = sum(2 * s * 3 * itemsize for s in stages)
    transfers_fwd = 2 * len(stages)
    return {
        "kind": kind,
        "mesh_shape": list(mesh_shape),
        "n_devices": D,
        "n_atoms_total": int(dd.n_atoms),
        "owned_per_device_mean": float(owned.mean()),
        "owned_per_device_max": int(owned.max()),
        "owned_padded": No,
        "ghosts_per_device_mean": float(ghosts_real.mean()),
        "ghosts_per_device_max": int(ghosts_real.max()),
        "ghost_fraction": float(
            ghosts_real.mean() / max(owned.mean() + ghosts_real.mean(), 1.0)
        ),
        "local_rows_padded": L,
        "edges_per_device_mean": float(edges_real.mean()),
        "edges_padded": El,
        "send_pad_per_stage": stages,
        "ppermutes_per_step": 2 * transfers_fwd,  # the halo + the ghost forces
        "halo_bytes_per_device_fwd": halo_fwd,
        "halo_bytes_per_device_step": 2 * halo_fwd,
    }


def project_step(
    acct: Dict,
    hbm_bytes_per_edge: float,
    hbm_GBps: float,
    link_GBps: float,
    roofline_frac: float,
) -> Dict:
    """Project the decomposed per-step time from ``acct``
    (:func:`decomposition_accounting`) and a device's figures, all given by
    the caller: ``hbm_bytes_per_edge``, the memory traffic per edge of one
    force call; ``hbm_GBps``, the memory rate; ``link_GBps``, one link's
    rate in one direction; ``roofline_frac``, the share of the memory rate
    the force call reaches.

    Compute is modeled memory-bound; each stage's two sends run on two links
    at once; the exchange and the compute do not overlap, so the projection
    adds them.
    """
    compute_s = (
        acct["edges_padded"] * hbm_bytes_per_edge
        / (hbm_GBps * 1e9 * roofline_frac)
    )
    n_stages = max(len(acct["send_pad_per_stage"]), 1)
    # the two directions of one stage run on two links concurrently
    per_stage_bytes = acct["halo_bytes_per_device_step"] / (2 * n_stages)
    comm_s = n_stages * 2 * (per_stage_bytes / (link_GBps * 1e9))
    return {
        "compute_ms": round(compute_s * 1e3, 3),
        "comm_ms": round(comm_s * 1e3, 4),
        "comm_fraction": round(comm_s / (comm_s + compute_s), 5),
        "step_ms": round((compute_s + comm_s) * 1e3, 3),
        # wall-clock step time over all atoms (the domains run concurrently)
        "us_per_atom_projected": round(
            (compute_s + comm_s) * 1e6 / acct["n_atoms_total"], 4
        ),
    }
