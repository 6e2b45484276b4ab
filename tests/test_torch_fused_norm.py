"""The port's fused LayerNorm (CPU: its plain version; the gradient is the
port's own closed formula on any device) against the JAX package's
`fused_layernorm`, its Pallas kernel in interpret mode, and `_ln_reference`.

fp32: atol 2e-6 / rtol 1e-6 forward (the JAX package's own tolerance
against flax), 1e-5 / 1e-4 for gradients. bf16: one bf16 ulp of the output
(2e-2), both sides rounding the same fp32 math.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cmgan_tpu.ops import fused_norm as jfn
from cmgan_torch.ops import fused_norm as fn
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)


def _inputs(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
    scale = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, shape[-1]).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape", [(7, 33, 64), (1500, 64), (5, 130)])
def test_forward_matches_jax_fp32(rng, shape):
    x, scale, bias = _inputs(rng, shape)
    ours = fn.fused_layernorm(*map(torch.from_numpy, (x, scale, bias))).numpy()
    ref = np.asarray(jfn.fused_layernorm(*map(jnp.asarray, (x, scale, bias))))
    np.testing.assert_allclose(ours, ref, atol=2e-6, rtol=1e-6)
    kern = np.asarray(jfn._ln_forward(jnp.asarray(x).reshape(-1, shape[-1]), jnp.asarray(scale),
                                      jnp.asarray(bias), 1e-5, interpret=True))
    np.testing.assert_allclose(ours.reshape(-1, shape[-1]), kern, atol=2e-6, rtol=1e-6)
    lib = F.layer_norm(torch.from_numpy(x), shape[-1:], torch.from_numpy(scale),
                       torch.from_numpy(bias), 1e-5).numpy()
    np.testing.assert_allclose(ours, lib, atol=5e-6, rtol=1e-5)


def test_forward_bf16_matches_jax(rng):
    x, scale, bias = _inputs(rng, (2048, 64))
    xt = torch.from_numpy(x).bfloat16()
    ours = fn.fused_layernorm(xt, torch.from_numpy(scale), torch.from_numpy(bias))
    assert ours.dtype == torch.bfloat16
    ref = jfn._ln_reference(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(scale),
                            jnp.asarray(bias), 1e-5)
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradient_matches_jax(rng, dtype):
    x, scale, bias = _inputs(rng, (5, 33, 64))
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda *a: jfn.fused_layernorm(*a),
                     jnp.asarray(x).astype(jdt), jnp.asarray(scale), jnp.asarray(bias))
    ref = vjp(jnp.asarray(cot).astype(jdt))

    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(),
              torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()]
    out = fn.fused_layernorm(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot).to(tdt))
    assert grads[0].dtype == tdt and grads[1].dtype == torch.float32
    tol = dict(atol=1e-5, rtol=1e-4) if dtype == "float32" else dict(atol=6e-2, rtol=2e-2)
    for a, b in zip(grads, ref):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), **tol)


@pytest.mark.parametrize("c", [1, 3, 63, 513, 1024])
def test_any_width_matches_jax(rng, c):
    """Widths off the kernel's pair path (odd, or wider than a warp keeps in
    registers): forward and gradient against the JAX op, fp32."""
    x, scale, bias = _inputs(rng, (37, c))
    cot = rng.standard_normal(x.shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda *a: jfn.fused_layernorm(*a), *map(jnp.asarray, (x, scale, bias)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    out = fn.fused_layernorm(*leaves)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-6, rtol=1e-6)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    for a, b in zip(grads, vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-4)


def test_gradient_matches_autograd_through_the_plain_version(rng):
    x, scale, bias = map(torch.from_numpy, _inputs(rng, (40, 64)))
    cot = torch.from_numpy(rng.standard_normal((40, 64)).astype(np.float32))
    a = [t.clone().requires_grad_() for t in (x, scale, bias)]
    b = [t.clone().requires_grad_() for t in (x, scale, bias)]
    ga = torch.autograd.grad(fn.fused_layernorm(*a), a, cot)
    gb = torch.autograd.grad(fn._ln_reference(*b, 1e-5), b, cot)
    for p, q in zip(ga, gb):
        torch.testing.assert_close(p, q, atol=1e-5, rtol=1e-4)


def test_wrapper_counts_and_rejects(rng):
    x, scale, bias = map(torch.from_numpy, _inputs(rng, (4, 64)))
    launches, plain = fn.launches, fn.plain_calls
    fn.fused_layernorm(x, scale, bias)
    assert (fn.launches, fn.plain_calls) == (launches, plain + 1)
    with pytest.raises(TypeError):
        fn.fused_layernorm(x.double(), scale, bias)
    # an odd width, and one wider than the kernel's pair path keeps in a
    # warp's registers, are taken: the plain version against the JAX op
    for xs, s, b in ((x[:, :63].contiguous(), scale[:63], bias[:63]),
                     (torch.randn(2, 1024), torch.ones(1024), torch.zeros(1024))):
        ref = jfn.fused_layernorm(*(jnp.asarray(t.numpy()) for t in (xs, s, b)))
        np.testing.assert_allclose(fn.fused_layernorm(xs, s, b).numpy(), np.asarray(ref),
                                   atol=2e-6, rtol=1e-6)
    with pytest.raises(ValueError):  # no width at all
        fn.fused_layernorm(x[:, :0], scale[:0], bias[:0])
    with pytest.raises(ValueError):
        fn.fused_layernorm(x, scale[:32], bias)
    with pytest.raises(ValueError):
        fn.fused_layernorm(x.t(), torch.ones(4), torch.zeros(4))


def test_models_keep_the_plain_layernorm():
    """The op is not wired into the models (a measurement decides that)."""
    import inspect

    import cmgan_torch.models.conformer as conformer
    import cmgan_torch.models.layers as layers

    assert "fused_layernorm" not in inspect.getsource(conformer)
    assert "fused_layernorm" not in inspect.getsource(layers)


# (C, dtype, the path the kernel's plan picks for aligned rows)
PLAN_CASES = [
    (64, "float32", "regs"),      # 16 lanes a row, 2 rows a warp
    (64, "bfloat16", "regs"),     # 8 lanes a row, 4 rows a warp
    (48, "float32", "regs"),      # 12 words a row on 16 lanes
    (4, "float32", "regs"),       # one word a row, one lane
    (256, "float32", "regs"),     # a warp a row, 2 words a lane
    (1024, "bfloat16", "regs"),   # a warp a row, 4 words a lane
    (65, "bfloat16", "span"),     # odd
    (2048, "float32", "span"),    # 8 KB rows: wider than registers keep
    (12300, "float32", "long"),   # wider than a span block's shared memory
]


@pytest.mark.parametrize("c,dtype,path", PLAN_CASES, ids=[f"{c}-{d}" for c, d, _ in PLAN_CASES])
def test_plain_version_matches_jax_on_each_path(rng, c, dtype, path):
    """The width picks the kernel's path (`plan`); the plain version, which
    stands in for it on the CPU, against the JAX op at that width, forward."""
    tdt = getattr(torch, dtype)
    p = fn.plan(c, torch.finfo(tdt).bits // 8, aligned=True)
    assert p.path == path
    if path == "regs":  # the words of a row fit the lanes that share it
        assert p.lanes * p.chunks * 16 >= c * torch.finfo(tdt).bits // 8 and p.chunks * p.rows == 8
    x, scale, bias = _inputs(rng, (3, c))
    ours = fn.fused_layernorm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
                              torch.from_numpy(bias))
    ref = jfn.fused_layernorm(jnp.asarray(x).astype(getattr(jnp, dtype)), jnp.asarray(scale),
                              jnp.asarray(bias))
    tol = dict(atol=2e-6, rtol=1e-6) if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32), **tol)


def test_every_plan_is_built():
    """Each (lanes, words a lane, rows) the plan can pick for a row of 16-byte
    words has its instantiation in csrc/fused_layernorm.cu, and unaligned or
    ragged rows leave the register path."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(fn.__file__), "csrc", "fused_layernorm.cu")).read()
    built = {tuple(map(int, m)) for m in re.findall(r"launch_regs<T, (\d+), (\d+), (\d+)>", src)}
    picked = set()
    for itemsize in (4, 2):
        for c in range(16 // itemsize, fn.REGS_MAX_BYTES // itemsize + 1, 16 // itemsize):
            p = fn.plan(c, itemsize, aligned=True)
            assert p.path == "regs"
            picked.add((p.lanes, p.chunks, p.rows))
    assert picked == built
    assert fn.plan(64, 4, aligned=False).path == "span"
    assert fn.plan(63, 4, aligned=True).path == "span"
    assert fn.plan(fn.REGS_MAX_BYTES // 4 + 4, 4, aligned=True).path == "span"
    assert fn.plan((fn.SPAN_MAX_BYTES - fn.SPAN_SLACK) // 4 + 1, 4, aligned=True).path == "long"
