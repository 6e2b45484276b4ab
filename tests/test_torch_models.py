"""The port's layers, conformer block and TSCNet against the JAX package's,
with the same weights and numpy-seeded inputs, on the CPU in float32.

Tolerance 2e-4 is the generator parity the JAX package holds against the
CMGAN reference's torch code (PARITY.md). JAX params are perturbed away
from their init (unit scales, zero biases, BN stats 0/1), so a mapping
that swaps or drops one of them shows.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmgan_tpu.checkpoint import restore_variables
from cmgan_tpu.config import ModelConfig as JaxModelConfig
from cmgan_tpu.models import layers as jl
from cmgan_tpu.models.conformer import ConformerBlock as JaxConformerBlock
from cmgan_tpu.models.generator import TSCNet as JaxTSCNet
from cmgan_torch.config import ModelConfig
from cmgan_torch.convert import (
    _conformer_map, _conv2d, _lookup, state_dict_from_flax, stats_map,
)
from cmgan_torch.models import layers as tl
from cmgan_torch.models.conformer import ConformerBlock
from cmgan_torch.models.generator import TSCNet

ATOL, RTOL = 2e-4, 1e-3
CKPT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "reports", "trained_generator_r05_fold1_ema")
SMALL = dict(num_channels=16, num_tscb_blocks=1, dense_depth=2, attn_heads=2)


def _perturb(tree, rng, scale=0.1):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(np.shape(a)).astype(np.float32),
        tree,
    )


def _random_stats(tree, rng):
    return {
        "mean": rng.standard_normal(np.shape(tree["mean"])).astype(np.float32) * 0.1,
        "var": 0.5 + rng.random(np.shape(tree["var"])).astype(np.float32),
    } if set(tree) == {"mean", "var"} else {k: _random_stats(v, rng) for k, v in tree.items()}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def test_instance_norm(rng):
    x = rng.standard_normal((2, 9, 13, 4)).astype(np.float32)
    mod = jl.InstanceNorm()
    params = _perturb(mod.init(jax.random.key(0), jnp.asarray(x))["params"], rng)
    ref = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    ours = tl.InstanceNorm(4)
    ours.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                          "bias": torch.from_numpy(params["bias"])})
    np.testing.assert_allclose(_nhwc(ours(_nchw(x))), ref, atol=ATOL, rtol=RTOL)


def test_prelu_over_channels_and_last_axis(rng):
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    alpha = rng.standard_normal(3).astype(np.float32)
    ref = np.asarray(jl.PReLU(3).apply({"params": {"alpha": alpha}}, jnp.asarray(x)))
    chan = tl.PReLU(3)
    chan.weight.data = torch.from_numpy(alpha)
    np.testing.assert_allclose(_nhwc(chan(_nchw(x))), ref, atol=1e-7)
    last = tl.PReLU(3, init=-0.25, dim=-1)
    last.weight.data = torch.from_numpy(alpha)
    np.testing.assert_allclose(last(torch.from_numpy(x)).detach().numpy(), ref, atol=1e-7)
    assert tl.PReLU(201, init=-0.25, dim=-1).weight.detach().eq(-0.25).all()


def test_learnable_sigmoid(rng):
    x = rng.standard_normal((3, 8)).astype(np.float32)
    slope = rng.standard_normal(8).astype(np.float32)
    ref = np.asarray(jl.LearnableSigmoid(8, beta=2.0).apply(
        {"params": {"slope": slope}}, jnp.asarray(x)))
    ours = tl.LearnableSigmoid(8, beta=2.0)
    ours.slope.data = torch.from_numpy(slope)
    np.testing.assert_allclose(ours(torch.from_numpy(x)).detach().numpy(), ref, atol=1e-6)


def test_swish(rng):
    x = rng.standard_normal(100).astype(np.float32) * 4
    np.testing.assert_allclose(tl.swish(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.swish(jnp.asarray(x))), atol=1e-6)


def test_sub_pixel_conv_interleave(rng):
    x = rng.standard_normal((2, 5, 11, 6)).astype(np.float32)
    mod = jl.SubPixelConv(4, (1, 3), r=2)
    params = _perturb(mod.init(jax.random.key(1), jnp.asarray(x))["params"], rng)
    ref = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    ours = tl.SubPixelConv(6, 4, (1, 3), r=2)
    ours.conv.load_state_dict({
        "weight": torch.from_numpy(np.ascontiguousarray(_conv2d(params["conv"]["conv"]["kernel"]))),
        "bias": torch.from_numpy(params["conv"]["conv"]["bias"]),
    })
    out = _nhwc(ours(_nchw(x)))
    assert out.shape == ref.shape == (2, 5, 22, 4)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_torch_default_init_is_seeded():
    a = tl.torch_default_init_(TSCNet(ModelConfig(**SMALL)), torch.Generator().manual_seed(3))
    b = tl.torch_default_init_(TSCNet(ModelConfig(**SMALL)), torch.Generator().manual_seed(3))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    w = a.dense_encoder.dilated_dense.conv2.weight  # fan_in 2*16 channels * 2*3 taps
    assert w.abs().max() <= 1 / np.sqrt(2 * 16 * 6)


def test_conformer_block(rng):
    dim, n = 16, 37
    x = rng.standard_normal((3, n, dim)).astype(np.float32)
    jmod = JaxConformerBlock(dim, dim_head=8, heads=2, attention_impl="xla")
    variables = jax.jit(jmod.init)({"params": jax.random.key(2)}, jnp.asarray(x))
    params = _perturb(variables["params"], rng)
    stats = _random_stats(variables["batch_stats"], rng)
    ref = np.asarray(jax.jit(jmod.apply)({"params": params, "batch_stats": stats}, jnp.asarray(x)))

    ours = ConformerBlock(dim, dim_head=8, heads=2)
    sd = {
        key[len("blk."):]: torch.tensor(np.ascontiguousarray(tf(_lookup({"blk": params}, path))))
        for key, (path, tf) in _conformer_map("blk", "blk").items()
    }
    sd["conv.net.5.running_mean"] = torch.from_numpy(stats["conv"]["bn"]["mean"])
    sd["conv.net.5.running_var"] = torch.from_numpy(stats["conv"]["bn"]["var"])
    sd["conv.net.5.num_batches_tracked"] = torch.tensor(0)
    ours.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = ours.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_tscnet_small_config(rng):
    t, f = 41, 201
    jmod = JaxTSCNet(JaxModelConfig(**SMALL))
    variables = jax.jit(jmod.init)({"params": jax.random.key(4)}, jnp.zeros((1, t, f, 2)))
    params = _perturb(variables["params"], rng)
    stats = _random_stats(variables["batch_stats"], rng)
    x = rng.standard_normal((2, t, f, 2)).astype(np.float32) * 0.3
    re_j, im_j = jax.jit(jmod.apply)({"params": params, "batch_stats": stats}, jnp.asarray(x))

    ours = TSCNet(ModelConfig(**SMALL))
    ours.load_state_dict(state_dict_from_flax(params, stats, num_tscb=1, depth=2), strict=True)
    with torch.no_grad():
        re_t, im_t = ours.eval()(torch.from_numpy(x))
    assert re_t.shape == (2, t, f) and im_t.dtype == torch.float32
    np.testing.assert_allclose(re_t.numpy(), np.asarray(re_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(im_t.numpy(), np.asarray(im_j), atol=ATOL, rtol=RTOL)
    assert len(stats_map(1)) == 4


@pytest.fixture(scope="module")
def trained():
    """The committed fold-1 EMA generator, its input, and JAX's fp32 output."""
    variables = restore_variables(CKPT)
    x = np.random.default_rng(0).standard_normal((1, 41, 201, 2)).astype(np.float32) * 0.3
    re_j, im_j = jax.jit(JaxTSCNet(JaxModelConfig()).apply)(variables, jnp.asarray(x))
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"])
    return sd, x, np.asarray(re_j), np.asarray(im_j)


def test_tscnet_full_width_trained_checkpoint(trained):
    sd, x, re_j, im_j = trained
    ours = TSCNet(ModelConfig())
    ours.load_state_dict(sd, strict=True)
    with torch.no_grad():
        re_t, im_t = ours.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(re_t.numpy(), re_j, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(im_t.numpy(), im_j, atol=ATOL, rtol=RTOL)


def test_tscnet_bf16_against_fp32(trained):
    """bf16 convs/linears/attention (norms and softmax in fp32) against
    JAX's fp32 output. bf16 keeps 8 significant bits (unit roundoff
    2^-9 ~ 2e-3) and the signal crosses ~100 bf16 matmuls and convs; the
    JAX package's own bf16 run of this input and checkpoint is 1.0e-2
    from its fp32 output in relative L2, so the bound is twice that."""
    sd, x, re_j, im_j = trained
    ours = TSCNet(ModelConfig(), dtype=torch.bfloat16)
    ours.load_state_dict(sd, strict=True)
    with torch.no_grad():
        re_t, im_t = ours.eval()(torch.from_numpy(x))
    assert re_t.dtype == torch.float32
    for a, b in ((re_t.numpy(), re_j), (im_t.numpy(), im_j)):
        assert np.all(np.isfinite(a))
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 2e-2
