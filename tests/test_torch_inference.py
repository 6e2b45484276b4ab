"""The port's offline enhancement against the JAX package's `Enhancer`, on
the CPU, at a reduced width (32 channels, 1 TSCB, dense depth 2, 2 heads
of dim 16) with the same numpy-seeded weights and tracks.

The JAX side runs `attention_impl='xla'`: its own tests pin its flash
kernel to the dense path. The port runs 'auto', which takes the flash
wrapper (its plain version on the CPU) from 512 frames.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmgan_tpu import config as jcfg
from cmgan_tpu import inference as jinf
from cmgan_tpu.models.generator import TSCNet as JaxTSCNet
from cmgan_torch import config as tcfg
from cmgan_torch import inference as tinf
from cmgan_torch.convert import state_dict_from_flax
from cmgan_torch.ops import flash_attention as fa

SMALL = dict(num_channels=32, num_tscb_blocks=1, dense_depth=2, attn_heads=2)
SR = 16000
# enhanced audio is ~0.1 in amplitude; the generator's 2e-4 parity after
# the iSTFT and the un-normalization
ATOL, RTOL = 2e-4, 1e-3


def _track(n, seed):
    """A seeded sum of amplitude-modulated harmonics plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f0 = rng.uniform(100, 220)
    x = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.3)) / h for h in range(1, 6))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t))
    return (0.05 * x + 0.02 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(7)
    model = JaxTSCNet(jcfg.ModelConfig(**SMALL, attention_impl="xla"))
    variables = jax.jit(model.init)({"params": jax.random.key(5)}, jnp.zeros((1, 21, 201, 2)))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        variables["params"],
    )
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def enhancers(weights):
    jax_enh = jinf.Enhancer(
        jcfg.CMGANConfig(model=jcfg.ModelConfig(**SMALL, attention_impl="xla")), weights
    )
    sd = state_dict_from_flax(weights["params"], weights["batch_stats"], num_tscb=1, depth=2)
    port = tinf.Enhancer(tcfg.CMGANConfig(model=tcfg.ModelConfig(**SMALL)), sd, device="cpu")
    return jax_enh, port, sd


@pytest.mark.parametrize("length", [100, 16000, 16037, 67200, 256000, 300001, 700000])
def test_segment_track_and_bucket_pad_equal_jax(length):
    x = _track(length, length)
    for hop, cut in ((100, 256000), (100, 48000)):
        seg_t, pad_t = tinf.segment_track(x, hop, cut)
        seg_j, pad_j = jinf.segment_track(x, hop, cut)
        assert pad_t == pad_j
        np.testing.assert_array_equal(seg_t, seg_j)
        np.testing.assert_array_equal(tinf.bucket_pad(x, hop, cut, SR),
                                      jinf.bucket_pad(x, hop, cut, SR))


@pytest.mark.parametrize("mode", ["exact", "bucket"])
@pytest.mark.parametrize("seconds", [2.0, 4.2])
def test_enhancer_matches_jax(enhancers, mode, seconds):
    jax_enh, port, _ = enhancers
    x = _track(int(seconds * SR), 11)
    ref = jax_enh.enhance(x, mode=mode)
    ours = port.enhance(x, mode=mode)
    assert ours.shape == x.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


def test_auto_takes_flash_from_512_frames(enhancers):
    """Exact mode: 51000 samples are 511 frames (dense), 51100 are 512 (flash)."""
    _, port, sd = enhancers
    dense_port = tinf.Enhancer(
        tcfg.CMGANConfig(model=tcfg.ModelConfig(**SMALL, attention_impl="xla")), sd, device="cpu"
    )
    for n, flash_calls in ((51000, 0), (51100, 1)):
        x = _track(n, n)
        before = fa.plain_calls
        ours = port.enhance(x, mode="exact")
        assert fa.plain_calls - before == flash_calls, n  # one time conformer
        np.testing.assert_allclose(ours, dense_port.enhance(x, mode="exact"), atol=ATOL, rtol=RTOL)
    assert fa.launches == 0


@pytest.mark.parametrize("length", [1601, 16001, 40123])
def test_output_length_equals_input(enhancers, length):
    _, port, _ = enhancers
    x = _track(length, 3)
    for mode in ("exact", "bucket"):
        y = port.enhance(x, mode=mode)
        assert y.shape == (length,) and np.all(np.isfinite(y))


def test_enhance_batch_equals_enhance(enhancers):
    _, port, sd = enhancers
    short = tinf.Enhancer(
        tcfg.CMGANConfig(model=tcfg.ModelConfig(**SMALL),
                         eval=tcfg.EvalConfig(cut_len=3 * SR)),
        sd, device="cpu",
    )
    # two share the 2 s bucket, one sits alone in the 3 s bucket, and one
    # is longer than cut_len and takes the single-track path
    tracks = [_track(n, i) for i, n in enumerate((24000, 32000, 40000, 64000))]
    batched = short.enhance_batch(tracks, batch_cap=4)
    for x, y in zip(tracks, batched):
        assert y.shape == x.shape
        np.testing.assert_allclose(y, short.enhance(x, mode="bucket"), atol=1e-5, rtol=1e-5)


def test_config_copy_matches_jax():
    for tcls, jcls in ((tcfg.DSPConfig, jcfg.DSPConfig), (tcfg.ModelConfig, jcfg.ModelConfig),
                       (tcfg.EvalConfig, jcfg.EvalConfig), (tcfg.TrainConfig, jcfg.TrainConfig),
                       (tcfg.MeshConfig, jcfg.MeshConfig)):
        assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls()), tcls.__name__
    assert tcfg.ModelConfig().dim_head == jcfg.ModelConfig().dim_head == 16
    assert tcfg.DSPConfig().num_frames(16 * SR) == 2561
