"""Head dims other than 16 through the port's fused attention, on the CPU,
against the JAX package's Pallas kernels in interpret mode (which take any
head dim).

The wrapper's plain version takes any D. On CUDA the tensor-core kernels
are built for D 16, 32 and 64, and a narrower head is zero-padded to the
next of them: the padding is checked here to leave the function and its
gradients as they are. A head over 64, of any width, takes the wide
kernels unpadded (`plan`). Tolerances as in test_torch_attention.py and
test_torch_attention_grad.py: atol 2e-5 / rtol 1e-4, the table's gradient
1e-5 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cmgan_tpu.models.conformer import RelPosAttention as JaxRelPosAttention
from cmgan_tpu.ops import flash_attention as jfa
from cmgan_torch.convert import _linear
from cmgan_torch.models.conformer import RelPosAttention
from cmgan_torch.ops import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)

ATOL, RTOL = 2e-5, 1e-4


def _inputs(rng, g, tq, tk, d, max_pos):
    q = rng.standard_normal((g, tq, d)).astype(np.float32) * d ** -0.5
    k = rng.standard_normal((g, tk, d)).astype(np.float32) * 0.5
    v = rng.standard_normal((g, tk, d)).astype(np.float32)
    table = rng.standard_normal((2 * max_pos + 1, d)).astype(np.float32)
    cot = rng.standard_normal((g, tq, d)).astype(np.float32)
    return q, k, v, table, cot


def _assert_grads(ours, ref):
    for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=name)
    np.testing.assert_allclose(ours[3], ref[3], atol=1e-5 * np.abs(ref[3]).max(), rtol=RTOL,
                               err_msg="dE")


@pytest.mark.parametrize("d,max_pos", [(8, 512), (8, 64), (32, 512), (24, 64),
                                       (80, 48), (128, 48), (200, 32), (320, 32), (100, 48)])
def test_wrapper_any_head_dim_matches_jax_kernel(rng, d, max_pos):
    """Forward and gradients of the wrapper (its plain version on the CPU)
    against the JAX kernel and its VJP at the same D."""
    q, k, v, table, cot = _inputs(rng, 3, 160, 160, d, max_pos)
    out_j, vjp = jax.vjp(lambda *a: jfa.flash_rel_attention(*a, max_pos),
                         *map(jnp.asarray, (q, k, v, table)))
    ref = [np.asarray(x) for x in vjp(jnp.asarray(cot))]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, table)]
    plain = fa.plain_calls
    out = fa.flash_rel_attention(*leaves, max_pos)
    assert fa.plain_calls == plain + 1 and out.shape == (3, 160, d)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=ATOL, rtol=RTOL)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    _assert_grads([x.numpy() for x in grads], ref)


@pytest.mark.parametrize("d", [1, 8, 24, 40])
def test_zero_padding_to_the_kernels_width_is_exact(rng, d):
    """What the CUDA wrapper does with a head the kernels are not built for:
    zero columns up to `kernel_head_dim(d)`, the output and every gradient
    sliced back. Through the plain version, against the unpadded head."""
    width = fa.kernel_head_dim(d)
    assert width in fa.KERNEL_HEAD_DIMS and width >= d
    q, k, v, table, cot = map(torch.from_numpy, _inputs(rng, 2, 96, 130, d, 64))
    ref = fa.reference_attention_grads(q, k, v, table, 64, 120, 20, cot)
    ref_out = fa.reference_attention(q, k, v, fa.make_rel_band(table, 130, 64), 120, 20)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, table)]
    padded = [F.pad(t, (0, width - d)) for t in leaves]
    out = fa.reference_attention(*padded[:3], fa.make_rel_band(padded[3], 130, 64), 120, 20)
    out = out[..., :d]
    grads = torch.autograd.grad(out, leaves, cot)
    torch.testing.assert_close(out, ref_out, atol=1e-6, rtol=1e-6)
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_kernel_head_dim_and_what_the_kernels_refuse():
    dims = (1, 16, 17, 32, 33, 48, 64, 65, 80, 128, 200, 256)
    assert [fa.kernel_head_dim(d) for d in dims] == [
        16, 16, 32, 32, 64, 64, 64, 65, 80, 128, 200, 256]
    # above 64 the wide kernels, unpadded; 64 and below the tensor-core ones
    assert [fa.wide_head_dim(d) for d in dims] == [False] * 7 + [True] * 5
    # the wide plan: (passes, columns a consumer warpgroup owns) of the
    # forward, (passes, columns a pass) of the backward's dq and dk/dv
    # kernels, and the zero columns the logits compute past D; no head dim is
    # refused
    expect = {
        65: ((1, 40), (1, 128), (1, 128), 15),
        80: ((1, 40), (1, 128), (1, 128), 0),
        100: ((1, 56), (1, 128), (1, 128), 12),
        128: ((1, 64), (1, 128), (1, 128), 0),
        256: ((1, 128), (2, 128), (2, 128), 0),
        257: ((1, 136), (3, 128), (3, 128), 15),
        320: ((1, 160), (3, 128), (3, 128), 0),
        512: ((2, 128), (4, 128), (4, 128), 0),
    }
    for d, (fwd, bwd_q, bwd_k, padded) in expect.items():
        p = fa.plan(d)
        assert (p.path, p.width, fa.kernel_head_dim(d)) == ("wide", d, d)
        assert (p.slabs["fwd"], p.slabs["bwd_q"], p.slabs["bwd_k"], p.padded_columns) == (
            fwd, bwd_q, bwd_k, padded)
    assert fa.plan(48).path == "tensor_core" and fa.plan(48).padded_columns == 16
    with pytest.raises(ValueError, match="at least 1"):
        fa.plan(0)


def _port_attention(variables, dim, heads, impl):
    mod = RelPosAttention(dim, heads=heads, dim_head=dim // heads, attention_impl=impl)
    p = variables["params"]
    sd = {
        "to_q.weight": _linear(np.asarray(p["to_q"]["dense"]["kernel"])),
        "to_kv.weight": _linear(np.asarray(p["to_kv"]["dense"]["kernel"])),
        "to_out.weight": _linear(np.asarray(p["to_out"]["dense"]["kernel"])),
        "to_out.bias": np.asarray(p["to_out"]["dense"]["bias"]),
        "rel_pos_emb.weight": np.asarray(p["rel_pos_emb"]),
    }
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return mod.train()


def _relpos_attention_flash_matches_jax(rng, b, n, dim, heads):
    """RelPosAttention with 'flash': output and the gradients of x and of
    every parameter against the JAX module with 'flash' (its Pallas forward
    and backward in interpret mode)."""
    x = rng.standard_normal((b, n, dim)).astype(np.float32) * 0.5
    cot = rng.standard_normal((b, n, dim)).astype(np.float32)
    jmod = JaxRelPosAttention(dim, heads=heads, dim_head=dim // heads, attention_impl="flash")
    variables = jmod.init({"params": jax.random.key(1)}, jnp.asarray(x))

    def jloss(params, xx):
        y = jmod.apply({"params": params}, xx, train=True)
        return jnp.sum(y * cot), y

    (_, y_ref), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    ref = {
        "x": np.asarray(gx),
        "to_q.weight": _linear(np.asarray(gp["to_q"]["dense"]["kernel"])),
        "to_kv.weight": _linear(np.asarray(gp["to_kv"]["dense"]["kernel"])),
        "to_out.weight": _linear(np.asarray(gp["to_out"]["dense"]["kernel"])),
        "to_out.bias": np.asarray(gp["to_out"]["dense"]["bias"]),
        "rel_pos_emb.weight": np.asarray(gp["rel_pos_emb"]),
    }
    mod = _port_attention(variables, dim, heads, "flash")
    xt = torch.from_numpy(x).requires_grad_()
    plain = fa.plain_calls
    y = mod(xt)
    (y * torch.from_numpy(cot)).sum().backward()
    assert fa.plain_calls == plain + 1
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=ATOL, rtol=RTOL)
    got = {"x": xt.grad.numpy(), **{k: p.grad.numpy() for k, p in mod.named_parameters()}}
    for name, r in ref.items():
        np.testing.assert_allclose(got[name], r, atol=ATOL * max(1.0, np.abs(r).max()),
                                   rtol=RTOL, err_msg=name)


def test_relpos_attention_two_heads_of_dim_8_flash_matches_jax(rng):
    """16 channels in 2 heads of dim 8: a head the tensor-core kernels pad."""
    _relpos_attention_flash_matches_jax(rng, 2, 150, 16, 2)


def test_relpos_attention_one_head_of_dim_128_flash_matches_jax(rng):
    """128 channels in 1 head: a head the wide kernels take."""
    _relpos_attention_flash_matches_jax(rng, 1, 140, 128, 1)
