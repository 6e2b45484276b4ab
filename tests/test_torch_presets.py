"""The port's 48 kHz long-form preset against the JAX package's, on the CPU.

The preset field by field, and a tiny-width 48 kHz pipeline (16 channels,
1 TSCB, dense depth 2, 2 heads of dim 8) through the port's `Enhancer`
against the JAX `Enhancer` on the same numpy-seeded weights and track.

The pipeline case takes 153,300 samples, 512 frames at hop 300, so that
'auto' takes the flash path on both sides: the JAX package's Pallas kernel
in interpret mode at G = 301 x 2 = 602 and D = 8, the port's wrapper its
plain version. That is the head-dim repair at model level. A 1 s track
(161 frames, dense on both sides) holds the 48 kHz geometry (601 bins ->
301 -> 601) in bucket mode. Tolerance 2e-4 / 1e-3, the enhanced audio's
parity limit (test_torch_inference.py).
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
from cmgan_torch.models.conformer import RelPosAttention
from cmgan_torch.ops import flash_attention as fa
from cmgan_torch.train.state import check_supported
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)

SR = 48_000
TINY = dict(num_channels=16, num_tscb_blocks=1, dense_depth=2, attn_heads=2)
ATOL, RTOL = 2e-4, 1e-3


@pytest.mark.parametrize("kw", [
    {},
    dict(seq_parallel=4),
    dict(num_tscb_blocks=2, num_channels=32, window_seconds=10),
])
def test_preset_equals_jax_field_by_field(kw):
    ours, theirs = tcfg.long_form_48k(**kw), jcfg.long_form_48k(**kw)
    fields = dataclasses.asdict(ours)
    # the port's one field the JAX package lacks: the window, Hamming as there
    assert fields["dsp"].pop("window") == "hamming"
    assert fields == dataclasses.asdict(theirs)
    seq = kw.get("seq_parallel", 1) > 1
    assert ours.dsp.dft_impl == ("matmul" if seq else "fft")
    assert ours.model.attention_impl == ("seq" if seq else "auto")
    # hop 300 at 48 kHz is 6.25 ms, the 16 kHz config's frame rate: a 30 s
    # window is 4801 frames, the 2 s training window 321
    assert ours.dsp.num_frames(ours.eval.cut_len) == 160 * kw.get("window_seconds", 30) + 1
    assert ours.dsp.num_frames(ours.train.cut_len) == 321
    assert ours.model.num_features == 601 and ours.dsp.hop / SR == 100 / 16_000


def test_seq_preset_is_built_but_its_model_raises():
    """The 'seq' preset's model builds ('seq' in the time conformer), runs
    only over a mesh, and its trainer needs a process group of 4 ranks."""
    cfg = tcfg.long_form_48k(seq_parallel=4)
    attn = RelPosAttention(cfg.model.num_channels, attention_impl=cfg.model.attention_impl)
    with pytest.raises(ValueError, match="mesh"):
        attn(torch.zeros(1, 40, cfg.model.num_channels))
    with pytest.raises(RuntimeError, match="process group"):
        check_supported(cfg)


def _track(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f0 = rng.uniform(100, 220)
    x = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.3)) / h for h in range(1, 6))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t))
    return (0.05 * x + 0.02 * rng.standard_normal(n)).astype(np.float32)


def _tiny(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **TINY))


@pytest.fixture(scope="module")
def enhancers():
    jax_cfg = _tiny(jcfg.long_form_48k())
    rng = np.random.default_rng(48)
    model = JaxTSCNet(jax_cfg.model)
    variables = jax.jit(model.init)({"params": jax.random.key(3)}, jnp.zeros((1, 21, 601, 2)))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        variables["params"],
    )
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    jax_enh = jinf.Enhancer(jax_cfg, {"params": params, "batch_stats": stats})
    sd = state_dict_from_flax(params, stats, num_tscb=1, depth=TINY["dense_depth"])
    port = tinf.Enhancer(_tiny(tcfg.long_form_48k()), sd, device="cpu")
    return jax_enh, port


def test_geometry_at_48k_matches_jax_dense(enhancers):
    jax_enh, port = enhancers
    x = _track(SR, 1)
    before = fa.plain_calls
    ours = port.enhance(x, mode="bucket")
    assert fa.plain_calls == before  # 161 frames: dense
    assert ours.shape == x.shape and np.all(np.isfinite(ours))
    np.testing.assert_allclose(ours, jax_enh.enhance(x, mode="bucket"), atol=ATOL, rtol=RTOL)


def test_two_heads_of_dim_8_take_flash_and_match_jax(enhancers):
    jax_enh, port = enhancers
    x = _track(153_300, 2)
    assert port.cfg.dsp.num_frames(x.size) == 512
    assert port.cfg.model.dim_head == 8
    before = fa.plain_calls
    ours = port.enhance(x, mode="exact")
    assert fa.plain_calls - before == 1  # one time conformer, through the wrapper
    np.testing.assert_allclose(ours, jax_enh.enhance(x, mode="exact"), atol=ATOL, rtol=RTOL)
