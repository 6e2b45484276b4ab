"""The port's bench (`cmgan_torch.bench`) and its tools on the CPU, where
nothing is timed: the device part of an enhancement call against the JAX
pipeline the root bench.py composes, the work a call counts against
JAX's own count and FlopCounterMode's, the K-window chain, the entries'
refusal without CUDA, and each cell's expected launches.

Tolerances: `enhance_tensor` against the JAX pipeline, relative L2 2e-4
(the generator tests' bound); the FLOP count against XLA's
`cost_analysis()` within 5% at full width (XLA also counts elementwise
work: 151.09 against 145.96 GFLOP a 2 s row); counts under 'xla' and
'auto', the chain against single calls and the counter against
FlopCounterMode: exact, and checked on the small model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cmgan_tpu.config import CMGANConfig as JaxConfig
from cmgan_tpu.config import ModelConfig as JaxModelConfig
from cmgan_tpu.dsp import istft as jistft
from cmgan_tpu.dsp import power_compress as jcompress
from cmgan_tpu.dsp import power_uncompress as juncompress
from cmgan_tpu.dsp import stft as jstft
from cmgan_tpu.models import TSCNet as JaxTSCNet
from cmgan_torch import bench
from cmgan_torch.config import CMGANConfig, ModelConfig, TrainConfig
from cmgan_torch.convert import state_dict_from_flax
from cmgan_torch.inference import Enhancer, enhance_tensor, load_generator
from cmgan_torch.models import TSCNet
from cmgan_torch.ops import flash_attention as fa
from cmgan_torch.tools import profile_dsp_share, serve_e2e_bench, serving_bench
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)

SMALL = dict(num_channels=16, num_tscb_blocks=2)
TINY = dict(num_channels=8, num_tscb_blocks=2, dense_depth=1, attn_heads=1)
SR = 16000


def _jax_pipeline(model, variables, segments, dsp):
    """The root bench.py's `enhance_core` (bench.py:84-93)."""
    spec = jstft(segments, dsp.n_fft, dsp.hop)
    packed = jcompress(spec, exponent=dsp.compress_exponent)
    est_real, est_imag = model.apply(variables, packed, train=False)
    est = juncompress(est_real.astype(jnp.float32), est_imag.astype(jnp.float32),
                      exponent=dsp.compress_exponent)
    return jistft(est, dsp.n_fft, dsp.hop)


@pytest.fixture(scope="module")
def small():
    """A small JAX generator with perturbed weights, and its port."""
    rng = np.random.default_rng(3)
    model = JaxTSCNet(JaxModelConfig(**SMALL, attention_impl="xla"))
    variables = jax.jit(model.init)({"params": jax.random.key(4)}, jnp.zeros((1, 21, 201, 2)))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    sd = state_dict_from_flax(params, stats, num_tscb=SMALL["num_tscb_blocks"])
    cfg = CMGANConfig(model=ModelConfig(**SMALL))
    return model, {"params": params, "batch_stats": stats}, cfg, load_generator(cfg, sd,
                                                                                device="cpu")


def _segments(batch, samples, seed):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((batch, samples))).astype(np.float32)


# (a) 321 frames (dense in both) and 513 (the port's flash wrapper, its
# plain version on the CPU; the JAX side 'xla')
@pytest.mark.parametrize("seconds", [2.0, 3.2])
def test_enhance_tensor_matches_the_jax_pipeline(small, seconds):
    jmodel, variables, cfg, model = small
    x = _segments(1, int(seconds * SR), seed=int(10 * seconds))
    pipeline = jax.jit(lambda v, s: _jax_pipeline(jmodel, v, s, JaxConfig().dsp))
    ref = np.asarray(pipeline(variables, jnp.asarray(x)))
    fa.plain_calls = 0
    with torch.inference_mode():
        out = enhance_tensor(model, cfg.dsp, torch.from_numpy(x)).numpy()
    assert fa.plain_calls == bench.kernel_launches(cfg, x.shape[1])
    assert out.shape == x.shape
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) <= 2e-4


# (b)
def test_flop_count_matches_xla_cost_analysis_at_full_width():
    jcfg = JaxConfig()
    dsp = jcfg.dsp
    jmodel = JaxTSCNet(jcfg.model)
    spec = jax.ShapeDtypeStruct((1, dsp.num_frames(2 * SR), dsp.num_freqs, 2), jnp.float32)
    variables = jax.eval_shape(lambda s: jmodel.init({"params": jax.random.key(0)}, s), spec)
    seg = jax.ShapeDtypeStruct((1, 2 * SR), jnp.float32)
    cost = jax.jit(lambda v, s: _jax_pipeline(jmodel, v, s, dsp)).lower(
        variables, seg).compile().cost_analysis()
    xla_flop = float((cost[0] if isinstance(cost, (list, tuple)) else cost)["flops"])
    work = bench.call_work(CMGANConfig(), None, 1, 2 * SR)
    assert abs(work["flop"] / xla_flop - 1) <= 0.05, (work["flop"], xla_flop)


def test_flop_count_is_flop_counter_modes_at_321_frames():
    """No pair is clipped at 321 frames (max_pos 512), so the attention
    formula is the dense path's three products and the whole count is what
    FlopCounterMode counts on the dense path. Exact at any width: checked
    on the small model."""
    cfg = CMGANConfig(model=ModelConfig(**SMALL, attention_impl="xla"))
    with torch.device("meta"):
        model = TSCNet(cfg.model).eval()
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        enhance_tensor(model, cfg.dsp, torch.empty(1, 2 * SR, device="meta"))
    work = bench.call_work(cfg, None, 1, 2 * SR)
    assert work["flop"] == counter.get_total_flops()
    assert work["attention_flop"] == counter.get_flop_counts()["Global"][torch.ops.aten.bmm]


# (c) exact at any width: checked on the small model, at the 641 frames
# where the kernel runs
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_work_is_the_same_under_xla_and_auto_at_641_frames(dtype):
    counts = [bench.call_work(CMGANConfig(model=ModelConfig(**SMALL, attention_impl=impl)),
                              dtype, 1, 4 * SR) for impl in ("xla", "auto")]
    assert counts[0] == counts[1]
    # each TSCB's time conformer over t frames (101 bins x heads groups)
    # and frequency conformer over 101 bins (t x heads groups): q k^T, the
    # position product and p v, 2 D flops a pair each; pairs at distance
    # >= max_pos (512) need no position product
    m = ModelConfig(**SMALL)
    t, bins, d = 641, (m.num_features + 1) // 2, m.dim_head
    g = bins * m.attn_heads
    far = sum(max(0, i - 511) + max(0, t - 1 - i - 511) for i in range(t))
    assert far > 0
    dense_time = 3 * 2 * d * g * t * t
    dense_freq = 3 * 2 * d * (t * m.attn_heads) * bins * bins
    expected = m.num_tscb_blocks * (dense_time + dense_freq - 2 * d * g * far)
    assert counts[0]["attention_flop"] == expected


# (d)
def test_chain_of_k_windows_equals_k_single_calls():
    cfg = CMGANConfig(model=ModelConfig(**TINY))
    model = load_generator(cfg, None, device="cpu")
    enhancer = Enhancer(cfg, model, device="cpu")
    x = _segments(1, SR, seed=5)
    with torch.inference_mode():
        chained = bench.chained(lambda t: enhance_tensor(model, cfg.dsp, t),
                                torch.from_numpy(x), 3).numpy()
    single = x
    for _ in range(3):
        single = enhancer._enhance_batch(single)
    np.testing.assert_array_equal(chained, single)


# (e)
@pytest.mark.parametrize("entry", [bench.main, serving_bench.main, serve_e2e_bench.main,
                                   profile_dsp_share.main])
def test_entries_raise_without_cuda(entry):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry([])


# (f) each cell's launches, from its shapes: 4 a 16 s segment, 6 a 30 s
# 48 kHz one, 4 and 4 a step at 64000, 4 a tick at 601 frames, none at 2 s
EXPECTED = {
    "enhance_2s_b16_bf16": {"kernel_1_a_call": 0},
    "train_b8_remat_fp32": {"kernel_1_a_step": 0, "kernel_2_a_step": 0},
    "enhance_16s_fp32": {"kernel_1_a_call": 4},
    "enhance_16s_bf16": {"kernel_1_a_call": 4},
    "enhance_48k_30s_fp32": {"kernel_1_a_call": 6},
    "train_b4_64000_fp32": {"kernel_1_a_step": 4, "kernel_2_a_step": 4},
    "stream_ticks": {"kernel_1_a_tick_1_24000": 0, "kernel_1_a_tick_8_24000": 0,
                     "kernel_1_a_tick_32_24000": 0, "kernel_1_a_tick_1_48000": 4,
                     "kernel_1_a_tick_8_48000": 4},
    "serve_e2e_8": {"kernel_1_a_tick": 4},
}


@pytest.mark.parametrize("name", sorted(bench.CELLS))
def test_cell_launches_follow_from_shapes(name):
    assert sorted(EXPECTED) == sorted(bench.CELLS)
    assert bench.CELLS[name].expected_launches() == EXPECTED[name]


@pytest.mark.parametrize("impl,samples", [("auto", 32000), ("auto", 64000), ("xla", 64000),
                                          ("flash", 32000)])
def test_kernel_launches_count_the_wrappers_calls(impl, samples):
    """The rule against the flash wrapper's calls on the CPU (its plain
    version), on a narrow model: the time conformer from 512 frames, the
    frequency conformer's 101 bins only under 'flash'."""
    cfg = CMGANConfig(model=ModelConfig(**TINY, attention_impl=impl))
    model = load_generator(cfg, None, device="cpu")
    fa.plain_calls = 0
    with torch.inference_mode():
        enhance_tensor(model, cfg.dsp, torch.from_numpy(_segments(1, samples, seed=6)))
    assert fa.plain_calls == bench.kernel_launches(cfg, samples)


def test_remat_step_runs_the_forward_twice():
    """A train cell's forward launches double under remat (the backward
    recomputes each TSCB), as Train.expected_launches says."""
    from cmgan_torch.train import Trainer

    cut = 8000  # under 'flash' both conformers of each TSCB take the kernel
    cfg = CMGANConfig(model=ModelConfig(**TINY, ndf=4, remat=True, attention_impl="flash"),
                      train=dataclasses.replace(TrainConfig(), batch_size=1, cut_len=cut))
    clean = _segments(1, cut, seed=7)
    trainer = Trainer(cfg, [(clean, clean)], None, device="cpu")
    fa.plain_calls = 0
    trainer.g_step(trainer.state, clean, clean + 0.01)
    assert fa.plain_calls == 2 * bench.kernel_launches(cfg, cut) == 2 * 4
    assert bench.Train(1, 64000, True, ("host",), why="").expected_launches() == {
        "kernel_1_a_step": 2 * 4, "kernel_2_a_step": 4}


def test_attention_work_counts_each_pair_once():
    """A query sees t_valid keys; near and far pairs partition them."""
    w = fa.attention_work(3, 100, 300, 250, 120, 64, 16, 4)
    assert w["near"] + w["far"] == 100 * 250 and w["exps"] == 3 * 100 * 250
    near = sum(1 for i in range(120, 220) for j in range(250) if abs(i - j) < 64)
    assert w["near"] == near
    assert w["flop"] == 2 * 16 * 3 * (3 * near + 2 * (100 * 250 - near))



@pytest.fixture(scope="module")
def g_step_gradients_xla():
    """The tiny model's G step through 'xla': (config, batch, gradients)."""
    from cmgan_torch.train import Trainer

    cut = 8000
    cfg = CMGANConfig(model=ModelConfig(**TINY, ndf=4, attention_impl="xla"),
                      train=dataclasses.replace(TrainConfig(), batch_size=1, cut_len=cut))
    clean = _segments(1, cut, seed=8)
    noisy = clean + 0.3 * _segments(1, cut, seed=9)
    trainer = Trainer(cfg, [(clean, noisy)], None, device="cpu")
    return cfg, clean, noisy, bench.g_step_record(trainer, clean, noisy)[2]


@pytest.mark.parametrize("mutation", [None, "dk"])
def test_g_step_gradient_check_fails_a_wrong_attention_backward(g_step_gradients_xla,
                                                                monkeypatch, mutation):
    """The training cell's gradient check ('flash' against 'xla', at the
    bench's limits) passes the plain version and fails it with dk 1% off
    (the forward unchanged: k + 0.01 (k - k.detach()) is k)."""
    from cmgan_torch.train import Trainer

    cfg, clean, noisy, ref = g_step_gradients_xla
    if mutation:
        plain = fa.reference_attention
        monkeypatch.setattr(fa, "reference_attention", lambda q, k, *a, **kw: plain(
            q, k + 0.01 * (k - k.detach()), *a, **kw))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, attention_impl="flash"))
    trainer = Trainer(cfg, [(clean, noisy)], None, device="cpu")
    whole, worst = bench.gradient_rel(bench.g_step_record(trainer, clean, noisy)[2], ref)
    held = whole <= bench.GSTEP_REL and worst <= bench.GSTEP_PARAM_REL
    assert held == (mutation is None), (whole, worst)
