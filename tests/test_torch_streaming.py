"""The port's streaming engine against the JAX package's, on the CPU, at a
tiny width (16 channels, 1 TSCB, dense depth 2, 2 heads) with the same
numpy-seeded weights and chunks.

The long-context case runs 16 channels in one head of dim 16, at a window
of 601 frames, where the port's 'auto' takes the kernel's plain version
and JAX runs 'xla'.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmgan_tpu import config as jcfg
from cmgan_tpu import streaming as jstream
from cmgan_tpu.models.generator import TSCNet as JaxTSCNet
from cmgan_torch import config as tcfg
from cmgan_torch import streaming as tstream
from cmgan_torch.convert import state_dict_from_flax
from cmgan_torch.inference import load_generator
from cmgan_torch.ops import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)

TINY = dict(num_channels=16, num_tscb_blocks=1, dense_depth=2, attn_heads=2)
LONG = dict(num_channels=16, num_tscb_blocks=1, dense_depth=2, attn_heads=1)
# enhanced audio after the iSTFT and the un-normalization, as for the
# offline Enhancer (test_torch_inference.py)
ATOL, RTOL = 2e-4, 1e-3
KW = dict(chunk=2000, left_context=6000, lookahead=1000, crossfade=200)


def _weights(model_kw, seed):
    """JAX TSCNet variables, perturbed by seeded noise, and the port's
    generator on the CPU with the same weights."""
    rng = np.random.default_rng(seed)
    model = JaxTSCNet(jcfg.ModelConfig(**model_kw, attention_impl="xla"))
    variables = jax.jit(model.init)({"params": jax.random.key(0)}, jnp.zeros((1, 21, 201, 2)))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        variables["params"],
    )
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    sd = state_dict_from_flax(params, stats, num_tscb=1, depth=model_kw["dense_depth"])
    cfg = tcfg.CMGANConfig(model=tcfg.ModelConfig(**model_kw))
    return {"params": params, "batch_stats": stats}, cfg, load_generator(cfg, sd, device="cpu"), sd


@pytest.fixture(scope="module")
def tiny():
    variables, cfg, model, sd = _weights(TINY, 1)
    jax_cfg = jcfg.CMGANConfig(model=jcfg.ModelConfig(**TINY, attention_impl="xla"))
    return jax_cfg, variables, cfg, model, sd


def _port(tiny, **kw):
    _, _, cfg, model, _ = tiny
    return tstream.StreamingEnhancer(cfg, model, device="cpu", **kw)


def _jax(tiny, **kw):
    jax_cfg, variables, *_ = tiny
    return jstream.StreamingEnhancer(jax_cfg, variables, **kw)


def _signal(n, seed, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _run(s, x, blocks=None):
    parts = [s.push(x)] if blocks is None else [s.push(x[i : i + blocks])
                                                for i in range(0, x.shape[-1], blocks)]
    return np.concatenate(parts + [s.flush()], axis=-1)


@pytest.mark.parametrize("emit,chunk,left_context,lookahead", [
    ("wola", 2000, 6000, 1000),
    ("crossfade", 2000, 6000, 1000),
    ("wola", 1000, 4000, 2000),   # lookahead > chunk: three estimates a sample
])
def test_stream_matches_jax_and_is_block_size_invariant(tiny, emit, chunk, left_context, lookahead):
    kw = dict(chunk=chunk, left_context=left_context, lookahead=lookahead, crossfade=200, emit=emit)
    n = 9_500  # not a multiple of chunk
    x = _signal(n, 3)
    ref = _run(_jax(tiny, **kw), x, blocks=3100)
    whole = _run(_port(tiny, **kw), x)
    assert whole.shape == (n,) and whole.dtype == np.float32
    assert float(np.sqrt(np.mean(whole**2))) > 1e-4  # non-degenerate output
    np.testing.assert_allclose(whole, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_run(_port(tiny, **kw), x, blocks=700), whole, atol=1e-6)


@pytest.mark.parametrize("chunk,lookahead", [(2000, 1000), (2000, 2000), (1000, 2000)])
def test_wola_weights_cover_every_sample(tiny, chunk, lookahead):
    """The shifted wola weight profiles sum to a constant over the emitted
    chunk (lookahead <= chunk: exactly 1; lookahead > chunk: a constant > 1,
    normalized away at emission), and equal the JAX package's."""
    kw = dict(chunk=chunk, left_context=4000, lookahead=lookahead, emit="wola")
    w = _port(tiny, **kw)._wola_w
    np.testing.assert_array_equal(w, _jax(tiny, **kw)._wola_w)
    total = np.zeros(chunk)
    for k in range(0, w.size, chunk):
        seg = w[k : k + chunk]
        total[: seg.size] += seg
    np.testing.assert_allclose(total, total[0], atol=1e-6)
    assert total[0] >= 1.0 - 1e-6


def test_zero_lookahead_falls_back_to_crossfade_and_latency(tiny):
    s = _port(tiny, chunk=2000, left_context=6000, lookahead=0, emit="wola")
    assert s.emit == "crossfade"
    s = _port(tiny, **KW)
    assert s.latency_samples == 3000 == _jax(tiny, **KW).latency_samples
    # the enhancer cannot emit sample i before having seen i + lookahead
    assert s.push(np.zeros(2000, np.float32)).size == 1000


def test_reset_restarts_the_stream(tiny):
    s = _port(tiny, **KW)
    x = _signal(8000, 4)
    first = _run(s, x)
    s.reset()
    np.testing.assert_array_equal(_run(s, x), first)


def test_lockstep_streams_match_jax_and_solo(tiny):
    xs = _signal(3 * 9000, 5).reshape(3, 9000) * np.array([[1.0], [0.5], [2.0]], np.float32)
    multi = _run(_port(tiny, num_streams=3, **KW), xs)
    assert multi.shape == (3, 9000)
    np.testing.assert_allclose(multi, _run(_jax(tiny, num_streams=3, **KW), xs),
                               atol=ATOL, rtol=RTOL)
    for i in range(3):
        np.testing.assert_allclose(multi[i], _run(_port(tiny, **KW), xs[i]), atol=1e-5)


def _chunks(x, n):
    return [x[i : i + n] for i in range(0, x.size, n)]


def test_batcher_slot_matches_solo_and_jax(tiny):
    """A slot's output depends only on its own chunk sequence: equal to a
    solo StreamingEnhancer with other slots active and the slot stalling,
    and to the JAX batcher fed the same ticks."""
    jax_cfg, variables, cfg, model, _ = tiny
    kw = dict(chunk=2000, left_context=6000, lookahead=1000)
    n = 8000
    xa, xb = _signal(n, 6), _signal(n, 7, 0.2)
    ref = _run(_port(tiny, **kw), xa)

    def drive(b):
        sa, sb = b.open(), b.open()
        a_chunks, b_chunks = _chunks(xa, 2000), _chunks(xb, 2000)
        drain = -(-1000 // 2000) + 1
        zeros = np.zeros(2000, np.float32)
        outs_a, outs_b = [], []
        # a ticks on every step, b only on even steps (stalls), plus drain
        # ticks for a's lookahead tail
        for t in range(len(a_chunks) + drain):
            blocks = {sa: a_chunks[t] if t < len(a_chunks) else zeros}
            if t % 2 == 0 and t // 2 < len(b_chunks):
                blocks[sb] = b_chunks[t // 2]
            out = b.step(blocks)
            outs_a.append(out[sa])
            outs_b.append(out.get(sb, np.zeros(0, np.float32)))
        return np.concatenate(outs_a)[:n], np.concatenate(outs_b)

    got_a, got_b = drive(tstream.StreamBatcher(cfg, model, num_slots=3, device="cpu", **kw))
    jax_a, jax_b = drive(jstream.StreamBatcher(jax_cfg, variables, num_slots=3, **kw))
    np.testing.assert_allclose(got_a, ref, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got_a, jax_a, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_b, jax_b, atol=ATOL, rtol=RTOL)


def test_batcher_slot_reuse_resets_state(tiny):
    """close + open hands back a slot with fresh state: a reused slot
    reproduces a fresh stream's output."""
    _, _, cfg, model, _ = tiny
    x = _signal(4000, 8)
    b = tstream.StreamBatcher(cfg, model, num_slots=1, chunk=2000, left_context=6000,
                              lookahead=1000, device="cpu")

    def run():
        s = b.open()
        assert s == 0
        outs = [b.step({s: c})[s] for c in _chunks(x, 2000)]
        outs += [b.step({s: np.zeros(2000, np.float32)})[s] for _ in range(2)]
        b.close(s)
        return np.concatenate(outs)[: x.size]

    np.testing.assert_array_equal(run(), run())


def test_batcher_slot_exhaustion_and_shape_checks(tiny):
    _, _, cfg, model, _ = tiny
    b = tstream.StreamBatcher(cfg, model, num_slots=2, chunk=2000, left_context=6000,
                              lookahead=1000, device="cpu")
    s0 = b.open()
    b.open()
    with pytest.raises(RuntimeError):
        b.open()
    assert b.step({}) == {}
    with pytest.raises(ValueError):
        b.step({s0: np.zeros(1999, np.float32)})
    b.close(s0)
    with pytest.raises(ValueError):
        b.close(s0)


def test_window_fn_raises_for_the_matmul_dft(tiny):
    """dft_impl is threaded through to the STFT, which now takes 'matmul': a
    'matmul' stream against the JAX package's 'matmul' stream, and near the
    port's 'fft' stream (the two DFTs differ by float32 rounding)."""
    jax_cfg, variables, cfg, model, _ = tiny
    cfg_mm = dataclasses.replace(cfg, dsp=tcfg.DSPConfig(dft_impl="matmul"))
    jax_mm = dataclasses.replace(jax_cfg, dsp=jcfg.DSPConfig(dft_impl="matmul"))
    x = _signal(9_500, 6)
    ours = _run(tstream.StreamingEnhancer(cfg_mm, model, device="cpu", **KW), x)
    ref = _run(jstream.StreamingEnhancer(jax_mm, variables, **KW), x, blocks=3100)
    assert ours.shape == x.shape and float(np.sqrt(np.mean(ours**2))) > 1e-4
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ours, _run(_port(tiny, **KW), x), atol=ATOL, rtol=RTOL)


def test_long_context_window_takes_the_kernel_and_matches_jax():
    """left_context 48000: 60000-sample windows of 601 frames. The port's
    'auto' runs kernel #1's plain version once per tick (one TSCB); JAX
    runs 'xla' on the same weights."""
    variables, cfg, model, _ = _weights(LONG, 2)
    jax_cfg = jcfg.CMGANConfig(model=jcfg.ModelConfig(**LONG, attention_impl="xla"))
    kw = dict(chunk=8000, left_context=48000, lookahead=4000)
    x = _signal(20000, 9)
    ticks = -(-x.size // kw["chunk"]) + (-(-kw["lookahead"] // kw["chunk"]) + 1)
    before = fa.plain_calls
    ours = _run(tstream.StreamingEnhancer(cfg, model, device="cpu", **kw), x)
    assert fa.plain_calls - before == ticks
    assert ours.shape == x.shape
    np.testing.assert_allclose(ours, _run(jstream.StreamingEnhancer(jax_cfg, variables, **kw), x),
                               atol=ATOL, rtol=RTOL)


def test_enhancers_share_one_generator(tiny):
    """Built from one TSCNet, enhancers and batchers share its parameters'
    storage (the counterpart of the JAX package sharing one jitted window
    program); built from a state_dict, each loads its own."""
    _, _, cfg, model, sd = tiny
    a = tstream.StreamingEnhancer(cfg, model, chunk=800, left_context=800, lookahead=400,
                                  crossfade=80, device="cpu")
    b = tstream.StreamingEnhancer(cfg, model, chunk=400, left_context=1200, lookahead=400,
                                  crossfade=80, device="cpu")
    c = tstream.StreamBatcher(cfg, model, num_slots=2, device="cpu", **KW)
    assert a.model is b.model is c.model is model
    ptrs = [p.data_ptr() for p in model.parameters()]
    for s in (a, b, c):
        assert [p.data_ptr() for p in s.model.parameters()] == ptrs
    own = tstream.StreamingEnhancer(cfg, sd, device="cpu", **KW)
    assert own.model is not model
    for p, q in zip(own.model.parameters(), model.parameters()):
        assert torch.equal(p, q) and p.data_ptr() != q.data_ptr()
    with pytest.raises(ValueError):  # a generator of another config is refused
        tstream.StreamingEnhancer(tcfg.CMGANConfig(), model, device="cpu")
