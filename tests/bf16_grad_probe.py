"""How far a bfloat16 model's first-step gradients lie from JAX's, and why.

Not a test: the measurement behind ``SPREAD_GRAD`` of
``test_torch_model_dtype_bf16_train.py`` and behind ROADMAP's recorded
departure "A bfloat16 model's gradients are not JAX's bits". Run from the
repo root, on the CPU (about ten minutes)::

    JAX_PLATFORMS=cpu python tests/bf16_grad_probe.py

For the toy ``_toy("bfloat16")`` on ``_toy_batch(b)`` with weights from
seed s, and the loss sum F^2 + (sum E)^2, it prints, as max over the leaves
of max |g_a - g_b| / max(|g_a|, |g_b|):

1. per draw (s, b), JAX's own spread (every pair of its jitted einsum,
   pallas and fused gradients and its float32 einsum gradient), the port's
   gradient against JAX's same backend, and against the float32 one;
2. at seed 1 on ``einsum``: how many of layer 0's env sums and tensor
   products differ from JAX's, and the gradient gap against JAX jitted and
   run op by op (no fusion), with the port as it is, with its bfloat16
   segment sums rounding after each add as XLA's scatter-add does, and
   with that and its ``scatter_factor`` rounded to bfloat16 as JAX rounds
   a Python constant.
"""

import contextlib
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import torch

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parent.parent)]
jax.config.update("jax_enable_x64", True)  # as tests/conftest.py
jax.config.update("jax_default_matmul_precision", "highest")

from allegro_tpu.data import to_jax  # noqa: E402
from allegro_tpu.model import AllegroModel as JaxAllegroModel  # noqa: E402
from allegro_tpu.nn import contract as jax_contract  # noqa: E402
from allegro_tpu.ops import fused_tp as jax_ftp  # noqa: E402
from allegro_tpu.ops import pallas_contract as jax_pallas  # noqa: E402

from allegro_tpu_torch.data import keys, to_torch  # noqa: E402
from allegro_tpu_torch.model import AllegroModel, params_from_jax  # noqa: E402
from allegro_tpu_torch.nn import contract, edgewise, pair_potential  # noqa: E402
from allegro_tpu_torch.ops import fused_tp  # noqa: E402
from test_torch_bf16_track import _toy, _toy_batch  # noqa: E402

DRAWS = ((0, 9), (1, 21), (2, 22), (3, 23))
BACKENDS = ("einsum", "pallas", "fused")


def spread(a, b):
    worst = 0.0
    for k, g in a.items():
        x, y = g.double().numpy(), b[k].double().numpy()
        worst = max(worst, float(np.abs(x - y).max() / max(np.abs(x).max(), np.abs(y).max())))
    return worst


def jax_grads(params, batch, backend, dtype="bfloat16", jit=True):
    jm = JaxAllegroModel(**_toy(dtype, tp_kernel_backend=backend))
    jb = to_jax(jm.precompute_statics(batch), dtype=np.float32)

    def loss(p):
        out = jm.apply_with_derivatives(p, jb)
        return jnp.sum(out[keys.FORCES] ** 2) + out[keys.TOTAL_ENERGY].astype(jnp.float32).sum() ** 2

    if dtype != "bfloat16":
        params = jax.tree_util.tree_map(lambda a: a.astype(dtype), params)
    g = (jax.jit(jax.grad(loss)) if jit else jax.grad(loss))(params)
    return params_from_jax(jax.tree_util.tree_map(np.asarray, g))


def port_grads(params, batch, backend):
    m = AllegroModel(**_toy("bfloat16", tp_kernel_backend=backend))
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    out = m.apply_with_derivatives(to_torch(m.precompute_statics(batch), torch.float32),
                                   create_graph=True)
    loss = (out[keys.FORCES] ** 2).sum() + out[keys.TOTAL_ENERGY].float().sum() ** 2
    ps = m.parameters()
    return dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))


def _sequential_segment_sum(values, centers, n_atoms, _plain=fused_tp.segment_sum):
    """XLA's bfloat16 scatter-add: each segment's rows added one at a time
    in edge order, rounded after each add."""
    if values.dtype != torch.bfloat16:
        return _plain(values, centers, n_atoms)
    idx = centers.long().clamp(0, n_atoms)
    order = torch.argsort(idx, stable=True)
    seg = idx[order]
    counts = torch.bincount(seg, minlength=n_atoms + 1)
    rank = torch.arange(idx.shape[0]) - (torch.cumsum(counts, 0) - counts)[seg]
    out = values.new_zeros((n_atoms + 1,) + tuple(values.shape[1:]))
    for r in range(int(counts.max()) if idx.numel() else 0):
        sel = (rank == r).nonzero().squeeze(1)
        out = out.index_add(0, seg[sel], values[order[sel]])  # one row per segment
    return out[:n_atoms]


class _SequentialGather(torch.autograd.Function):
    """``gather_rows`` whose transpose is the sequential segment sum (JAX's
    gather transposes to a scatter-add)."""

    @staticmethod
    def forward(ctx, table, centers):
        ctx.save_for_backward(centers)
        ctx.n = table.shape[0]
        return fused_tp.gather_rows(table, centers)

    @staticmethod
    def backward(ctx, g):
        (centers,) = ctx.saved_tensors
        return _sequential_segment_sum(g, centers, ctx.n), None


@contextlib.contextmanager
def xla_rounding(constants):
    """The port's einsum path with XLA's rounding of its bfloat16 segment
    sums; with ``constants`` also its scatter factor rounded to bfloat16."""
    saved = (contract.segment_sum, contract.gather_rows, edgewise.segment_sum,
             pair_potential.segment_sum, contract.Contracter.env_sum)
    contract.segment_sum = edgewise.segment_sum = pair_potential.segment_sum = \
        _sequential_segment_sum
    contract.gather_rows = lambda t, c: (_SequentialGather.apply(t, c)
                                         if t.dtype == torch.bfloat16 else
                                         fused_tp.gather_rows(t, c))
    env_sum = saved[4]

    def rounded_env_sum(self, x2, centers, n_atoms, row_ptr=None):
        if constants and x2.dtype == torch.bfloat16 and self.scatter_factor is not None:
            x2 = x2 * torch.tensor(self.scatter_factor, dtype=x2.dtype)
            sf, self.scatter_factor = self.scatter_factor, None
            try:
                return env_sum(self, x2, centers, n_atoms, row_ptr)
            finally:
                self.scatter_factor = sf
        return env_sum(self, x2, centers, n_atoms, row_ptr)

    contract.Contracter.env_sum = rounded_env_sum
    try:
        yield
    finally:
        (contract.segment_sum, contract.gather_rows, edgewise.segment_sum,
         pair_potential.segment_sum, contract.Contracter.env_sum) = saved


def layer0_differences(params, batch):
    """Of layer 0's env sums and tensor products on einsum, how many differ
    from JAX's (op by op)."""
    seen = {"jax": [], "port": []}
    j_env, j_con = jax_contract.Contracter.env_sum, jax_contract.Contracter.contract
    p_env, p_con = contract.Contracter.env_sum, contract.Contracter.contract

    def rec(side, fn):
        def wrapped(self, *a):
            out = fn(self, *a)
            seen[side].append(np.asarray(out.astype(jnp.float32)) if side == "jax"
                              else out.detach().float().numpy())
            return out
        return wrapped

    jax_contract.Contracter.env_sum = rec("jax", j_env)
    jax_contract.Contracter.contract = rec("jax", j_con)
    contract.Contracter.env_sum = rec("port", p_env)
    contract.Contracter.contract = rec("port", p_con)
    try:
        jm = JaxAllegroModel(**_toy("bfloat16"))
        jm.module.apply(params, to_jax(jm.precompute_statics(batch), dtype=np.float32))
        m = AllegroModel(**_toy("bfloat16"))
        m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
        m.apply(to_torch(m.precompute_statics(batch), torch.float32))
    finally:
        jax_contract.Contracter.env_sum, jax_contract.Contracter.contract = j_env, j_con
        contract.Contracter.env_sum, contract.Contracter.contract = p_env, p_con
    out = []
    for name, a, t in zip(("env", "tensor product"), seen["jax"][:2], seen["port"][:2]):
        E, U, d = a.shape  # JAX's [E, U, d]; the port's [E, d*U]
        t = t.reshape(E, d, U).transpose(0, 2, 1)
        out.append(f"{name} {int((a != t).sum())} of {a.size}")
    return ", ".join(out)


def main():
    torch.set_num_threads(1)
    jax_ftp.INTERPRET = jax_pallas.INTERPRET = True
    for s, b in DRAWS:
        batch = _toy_batch(b)
        params = JaxAllegroModel(**_toy("bfloat16")).init(s, to_jax(batch, dtype=np.float32))
        jg = {be: jax_grads(params, batch, be) for be in BACKENDS}
        jg["float32"] = jax_grads(params, batch, "einsum", "float32")
        names = list(jg)
        own = max(spread(jg[x], jg[y]) for i, x in enumerate(names) for y in names[i + 1:])
        pg = {be: port_grads(params, batch, be) for be in BACKENDS}
        same = ", ".join(f"{be} {spread(pg[be], jg[be]):.3e}" for be in BACKENDS)
        f32 = max(spread(pg[be], jg["float32"]) for be in BACKENDS)
        print(f"seed {s} batch {b}: JAX's own spread {own:.3e}; the port against JAX's same "
              f"backend: {same}; against the float32 gradient at most {f32:.3e}", flush=True)
    s, b = DRAWS[1]
    batch = _toy_batch(b)
    params = JaxAllegroModel(**_toy("bfloat16")).init(s, to_jax(batch, dtype=np.float32))
    print(f"seed {s} einsum, layer 0 values that differ from JAX's: "
          f"{layer0_differences(params, batch)}")
    jit, eager = (jax_grads(params, batch, "einsum", jit=j) for j in (True, False))
    for label, ctx in (("as it is", contextlib.nullcontext()),
                       ("sequential bf16 segment sums", xla_rounding(False)),
                       ("and the scatter factor rounded", xla_rounding(True))):
        with ctx:
            g = port_grads(params, batch, "einsum")
        print(f"seed {s} einsum, the port {label}: against JAX jitted {spread(g, jit):.3e}, "
              f"op by op {spread(g, eager):.3e}", flush=True)


if __name__ == "__main__":
    main()
