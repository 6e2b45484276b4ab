"""Gradients of the port's fused attention (CPU: autograd through its plain
version) against the JAX package's Pallas backward kernel, run in interpret
mode as its own tests run it.

dq, dk, dv: atol 2e-5 / rtol 1e-4, the tolerance the forward is held to.
The table's gradient sums G*T*T products per row in another order in the
two packages (and the clipped rows 0 and 2*max_pos collect every distant
pair), so it is held to 1e-5 of its largest entry plus rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmgan_tpu.models.conformer import RelPosAttention as JaxRelPosAttention
from cmgan_tpu.ops import flash_attention as jfa
from cmgan_torch.convert import _linear
from cmgan_torch.models.conformer import RelPosAttention
from cmgan_torch.ops import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)

ATOL, RTOL = 2e-5, 1e-4


def _inputs(rng, g, tq, tk, max_pos, d=16):
    q = rng.standard_normal((g, tq, d)).astype(np.float32) * 0.5
    k = rng.standard_normal((g, tk, d)).astype(np.float32) * 0.5
    v = rng.standard_normal((g, tk, d)).astype(np.float32)
    table = rng.standard_normal((2 * max_pos + 1, d)).astype(np.float32)
    cot = rng.standard_normal((g, tq, d)).astype(np.float32)
    return q, k, v, table, cot


def _jax_grads(q, k, v, table, cot, max_pos, t_valid, q_offset):
    out, vjp = jax.vjp(
        lambda *a: jfa.flash_rel_attention_at(*a, max_pos, t_valid,
                                              jnp.asarray(q_offset, jnp.float32)),
        *map(jnp.asarray, (q, k, v, table)),
    )
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(cot))]


def _assert_grads(ours, ref):
    for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=name)
    np.testing.assert_allclose(ours[3], ref[3], atol=1e-5 * np.abs(ref[3]).max(), rtol=RTOL,
                               err_msg="dE")


@pytest.mark.parametrize("g,tq,tk,max_pos,t_valid,q_offset", [
    (3, 100, 100, 512, None, 0),   # T not a multiple of 64
    (2, 160, 160, 64, None, 0),    # max_pos < T: clipping active, rows 0 and 2*max_pos busy
    (2, 256, 256, 512, 150, 0),    # t_valid < T
    (2, 128, 256, 512, 256, 128),  # q_offset > 0 (Tk a multiple of 128, the JAX contract)
    (2, 96, 256, 64, 200, 128),    # all three at once
    (1, 1664, 1664, 1536, None, 0),  # the longest table the kernels are held to (3073 rows)
])
def test_plain_backward_matches_jax_kernel(rng, g, tq, tk, max_pos, t_valid, q_offset):
    q, k, v, table, cot = _inputs(rng, g, tq, tk, max_pos)
    out_j, ref = _jax_grads(q, k, v, table, cot, max_pos, t_valid, q_offset)
    tv = tk if t_valid is None else t_valid
    ours = fa.reference_attention_grads(
        *map(torch.from_numpy, (q, k, v, table)), max_pos, tv, q_offset, torch.from_numpy(cot)
    )
    _assert_grads([x.numpy() for x in ours], ref)
    if t_valid is not None:
        assert np.all(ours[1].numpy()[:, t_valid:] == 0) and np.all(ours[2].numpy()[:, t_valid:] == 0)


def test_wrapper_is_differentiable_on_the_cpu(rng):
    """The wrapper's own autograd path (what a CPU training step runs) gives
    `reference_attention_grads`, and counts a plain call, not a launch."""
    q, k, v, table, cot = map(torch.from_numpy, _inputs(rng, 2, 70, 70, 32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, table)]
    counts = (fa.launches, fa.backward_launches, fa.plain_calls)
    out = fa.flash_rel_attention_at(*leaves, 32, 60, 0)
    grads = torch.autograd.grad(out, leaves, cot)
    assert (fa.launches, fa.backward_launches, fa.plain_calls) == (
        counts[0], counts[1], counts[2] + 1)
    ref = fa.reference_attention_grads(q, k, v, table, 32, 60, 0, cot)
    for a, b in zip(grads, ref):
        # the same graph twice; the table's scatter-add sums in no fixed order
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_bf16_grads_come_back_in_bf16(rng):
    q, k, v, table, cot = (torch.from_numpy(a).bfloat16() for a in _inputs(rng, 2, 64, 64, 32))
    grads = fa.reference_attention_grads(q, k, v, table, 32, 64, 0, cot)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    ref = fa.reference_attention_grads(q.float(), k.float(), v.float(), table.float(), 32, 64, 0,
                                       cot.float())
    for a, b in zip(grads, ref):  # bf16 keeps 8 significant bits
        assert (a.float() - b).abs().max() <= 2e-2 * b.abs().max()


def _port_attention(jax_params, dim, heads, impl):
    mod = RelPosAttention(dim, heads=heads, dim_head=dim // heads, attention_impl=impl)
    p = jax_params["params"]
    sd = {
        "to_q.weight": _linear(np.asarray(p["to_q"]["dense"]["kernel"])),
        "to_kv.weight": _linear(np.asarray(p["to_kv"]["dense"]["kernel"])),
        "to_out.weight": _linear(np.asarray(p["to_out"]["dense"]["kernel"])),
        "to_out.bias": np.asarray(p["to_out"]["dense"]["bias"]),
        "rel_pos_emb.weight": np.asarray(p["rel_pos_emb"]),
    }
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return mod.train()


def test_relpos_attention_train_mode_flash_matches_xla_and_jax(rng):
    """The module in train mode (dropout 0): output and the gradients of x
    and of every parameter, flash against dense and against JAX's dense."""
    b, n, dim, heads = 2, 90, 32, 2
    x = rng.standard_normal((b, n, dim)).astype(np.float32) * 0.5
    cot = rng.standard_normal((b, n, dim)).astype(np.float32)
    jmod = JaxRelPosAttention(dim, heads=heads, dim_head=16, attention_impl="xla")
    variables = jmod.init({"params": jax.random.key(0)}, jnp.asarray(x))

    def jloss(params, xx):
        return jnp.sum(jmod.apply({"params": params}, xx, train=True) * cot)

    gp, gx = jax.grad(jloss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    ref = {
        "x": np.asarray(gx),
        "to_q.weight": _linear(np.asarray(gp["to_q"]["dense"]["kernel"])),
        "to_kv.weight": _linear(np.asarray(gp["to_kv"]["dense"]["kernel"])),
        "to_out.weight": _linear(np.asarray(gp["to_out"]["dense"]["kernel"])),
        "to_out.bias": np.asarray(gp["to_out"]["dense"]["bias"]),
        "rel_pos_emb.weight": np.asarray(gp["rel_pos_emb"]),
    }

    got = {}
    for impl in ("flash", "xla"):
        mod = _port_attention(variables, dim, heads, impl)
        xt = torch.from_numpy(x).requires_grad_()
        plain = fa.plain_calls
        (mod(xt) * torch.from_numpy(cot)).sum().backward()
        assert fa.plain_calls - plain == (1 if impl == "flash" else 0)
        got[impl] = {"x": xt.grad.numpy(),
                     **{k: p.grad.numpy() for k, p in mod.named_parameters()}}
    for name, r in ref.items():
        tol = dict(atol=5e-5 * max(1.0, np.abs(r).max()), rtol=1e-4)
        np.testing.assert_allclose(got["flash"][name], got["xla"][name], err_msg=name, **tol)
        np.testing.assert_allclose(got["flash"][name], r, err_msg=name, **tol)
