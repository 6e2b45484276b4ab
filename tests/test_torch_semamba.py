"""SEMamba in the port (models/semamba.py, ops/selective_scan.py, the RMSNorm
of ops/fused_norm.py, the magnitude/phase path of inference.enhance_tensor)
against the benchmark's plain reference (perfbench/reference/semamba.py),
on seeded weights, on the CPU (the kernels' plain versions). The cases
that need the card are marked `card` and skip without CUDA.

Tolerances, each from float32 rounding in another order of operations:
- the scan: rtol 1e-5, atol 1e-6 (the same recurrence, the reference's
  layout and flips against the port's in-place reverse); its inputs
  rounded to bfloat16 miss it by two orders of magnitude;
- a whole enhancement call: every row's relative L2 under 2e-5 (measured
  1.4e-6 to 2.3e-6 at the published widths: four blocks of float32
  matmuls, convolutions and scans summed in other orders); the scan or
  the projections in bfloat16 miss it by far.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cmgan_torch import dsp
from cmgan_torch.config import CMGANConfig, ModelConfig, SEMambaConfig, semamba_16k
from cmgan_torch.inference import Enhancer, build_generator, enhance_tensor, load_generator
from cmgan_torch.models import TSCNet
from cmgan_torch.models import semamba as port
from cmgan_torch.ops import fused_norm
from cmgan_torch.ops import selective_scan as ss
from cmgan_torch.streaming import StreamBatcher
from perfbench.archs import semamba as arch
from perfbench.reference import semamba as ref
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 4099
CALL_RTOL = 2e-5


def published() -> dict:
    with open(os.path.join(ROOT, "perfbench", "configs", "semamba_16k.json")) as f:
        return json.load(f)


def tiny() -> dict:
    """Small widths, every kind of layer: 2 blocks of d_inner 32."""
    return {**published(), "n_fft": 64, "hop": 16, "win_size": 64, "freq_bins": 33,
            "hid_feature": 16, "expand": 2, "d_inner": 32, "num_tfmamba": 2, "dense_depth": 2}


def pair(cfg: dict, seed: int = SEED):
    """The reference and the port's generator on the same seeded weights."""
    r = arch.generator(cfg).eval()
    weights = arch.seeded_state(r, seed, torch.device("cpu"))
    r.load_state_dict(weights, strict=True)
    pcfg = arch.port_config(cfg)
    return r, load_generator(pcfg, weights, None, "cpu"), pcfg


def row_rel(y, r):
    y, r = y.double(), r.double()
    return torch.linalg.vector_norm(y - r, dim=-1) / torch.linalg.vector_norm(r, dim=-1)


def scan_inputs(rows, length, d=32, n=16, r=4, delta=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(rows, length, d, generator=g)
    z = torch.randn(rows, length, d, generator=g)
    dt = torch.randn(rows, length, r, generator=g)
    B, C = torch.randn(rows, length, n, generator=g), torch.randn(rows, length, n, generator=g)
    w = torch.rand(d, r, generator=g) - 0.5
    lo, hi = math.log(1e-3), math.log(1e-1)
    dts = torch.exp(torch.rand(d, generator=g) * (hi - lo) + lo) if delta is None \
        else torch.full((d,), delta)
    bias = dts + torch.log(-torch.expm1(-dts))
    if delta is not None:
        w = w * 0.0  # delta exactly as given
    A = -torch.arange(1, n + 1, dtype=torch.float32).repeat(d, 1)
    D = torch.rand(d, generator=g) + 0.5
    return u, dt, w, bias, A, B, C, D, z


def reference_scan(u, dt, w, bias, A, B, C, D, z, reverse):
    """The reference's loop on the port's layout, the flips written out."""
    if reverse:
        u, dt, B, C, z = (t.flip(1) for t in (u, dt, B, C, z))
    delta = (w @ dt.transpose(1, 2))
    y = ref.selective_scan(u.transpose(1, 2), delta, A, B.transpose(1, 2), C.transpose(1, 2),
                           D, z.transpose(1, 2), bias).transpose(1, 2)
    return y.flip(1) if reverse else y


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("length,delta", [(1, None), (37, None), (261, None), (120, 0.1)],
                         ids=["length1", "odd_chunk", "many_chunks", "long_decay"])
def test_plain_scan_matches_the_reference_loop(reverse, length, delta):
    args = scan_inputs(3, length, delta=delta)
    y = ss.selective_scan(*args, reverse=reverse)
    r = reference_scan(*args, reverse)
    assert y.shape == r.shape and y.is_contiguous()
    torch.testing.assert_close(y, r, rtol=1e-5, atol=1e-6)


def test_scan_in_bfloat16_misses_the_tolerance():
    args = scan_inputs(3, 64)
    rounded = [t.bfloat16().float() for t in args]
    y = ss.selective_scan(*rounded)
    r = reference_scan(*args, False)
    assert not torch.allclose(y, r, rtol=1e-5 * 100, atol=1e-6 * 100)


def test_scan_takes_strided_operands():
    u, dt, w, bias, A, B, C, D, z = scan_inputs(2, 9)
    xz = torch.cat([u, z], -1)
    x_dbl = torch.cat([dt, B, C], -1)
    y = ss.selective_scan(xz[..., :32], x_dbl[..., :4], w, bias, A, x_dbl[..., 4:20],
                          x_dbl[..., 20:], D, xz[..., 32:])
    torch.testing.assert_close(y, ss.selective_scan(u, dt, w, bias, A, B, C, D, z), rtol=0,
                               atol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_causal_conv_matches_the_published_conv(reverse):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 11, 32, generator=g)
    conv = torch.nn.Conv1d(32, 32, 4, groups=32, padding=3)
    seq = x.flip(1) if reverse else x
    r = F.silu(conv(seq.transpose(1, 2))[..., :11]).transpose(1, 2)
    r = r.flip(1) if reverse else r
    with torch.no_grad():
        y = ss.causal_conv1d_silu(x, conv.weight, conv.bias, reverse)
    torch.testing.assert_close(y, r, rtol=1e-6, atol=1e-6)


def test_rmsnorm_matches_the_reference():
    g = torch.Generator().manual_seed(4)
    x, w = torch.randn(5, 7, 64, generator=g), torch.rand(64, generator=g) + 0.5
    r = ref.RMSNorm(64, 1e-5)
    with torch.no_grad():
        r.weight.copy_(w)
        torch.testing.assert_close(fused_norm.fused_rmsnorm(x, w), r(x), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        fused_norm.fused_rmsnorm(x.double(), w)


def test_state_dict_keys_match_the_reference_both_ways():
    cfg = published()
    r = arch.generator(cfg)
    p = build_generator(arch.port_config(cfg).model)
    assert list(r.state_dict()) == list(p.state_dict())
    assert {k: v.shape for k, v in r.state_dict().items()} == \
        {k: v.shape for k, v in p.state_dict().items()}
    p.load_state_dict(r.state_dict(), strict=True)
    r.load_state_dict(p.state_dict(), strict=True)
    assert "TSMamba.0.time_mamba.forward_blocks.0.mixer.A_log" in r.state_dict()
    assert "mask_decoder.lsigmoid.slope" in r.state_dict()
    n = sum(v.numel() for v in p.parameters())
    assert 2_200_000 < n < 2_300_000  # about 2.25 M parameters


@pytest.mark.parametrize("seed", [SEED, 11])
def test_enhance_tensor_matches_the_reference_at_tiny_widths(seed):
    cfg = tiny()
    r, p, pcfg = pair(cfg, seed)
    x = 0.1 * torch.randn(3, 640, generator=torch.Generator().manual_seed(seed))
    with torch.inference_mode():
        y = enhance_tensor(p, pcfg.dsp, x)
        want = arch.enhance(r, x, cfg)
    assert y.shape == want.shape == (3, 640)
    assert row_rel(y, want).max() < CALL_RTOL


def test_enhance_tensor_matches_the_reference_at_published_widths():
    cfg = published()
    r, p, pcfg = pair(cfg)
    x = 0.1 * torch.randn(2, 1600, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        y = enhance_tensor(p, pcfg.dsp, x)
        want = arch.enhance(r, x, cfg)
    assert row_rel(y, want).max() < CALL_RTOL


@pytest.mark.parametrize("where", ["scan", "projections"])
def test_lower_precision_misses_the_call_tolerance(monkeypatch, where):
    cfg = tiny()
    r, p, pcfg = pair(cfg)
    x = 0.1 * torch.randn(2, 640, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        want = arch.enhance(r, x, cfg)
    if where == "scan":
        real = ss.selective_scan
        monkeypatch.setattr(port, "selective_scan", lambda *a, **k: real(
            *[t.bfloat16().float() if torch.is_tensor(t) else t for t in a], **k))
    else:
        linear = F.linear
        monkeypatch.setattr(F, "linear", lambda x, w, b=None: linear(
            x.bfloat16(), w.bfloat16(), None if b is None else b.bfloat16()).float())
    with torch.inference_mode():
        y = enhance_tensor(p, pcfg.dsp, x)
    assert row_rel(y, want).max() > 10 * CALL_RTOL


def test_load_generator_builds_the_configs_model():
    cfg = semamba_16k()
    assert cfg.dsp.window == "hann" and cfg.model.d_inner == 256 and cfg.model.rank == 4
    assert CMGANConfig().dsp.window == "hamming"
    small = dataclasses.replace(cfg, model=SEMambaConfig(hid_feature=16, num_tfmamba=1,
                                                          dense_depth=1))
    m = load_generator(small, None, device="cpu", seed=3)
    assert isinstance(m, port.SEMamba) and not m.training
    mixer = m.TSMamba[0].time_mamba.forward_blocks[0].mixer
    torch.testing.assert_close(mixer.A_log[5], torch.log(torch.arange(1.0, 17.0)))
    assert torch.all(mixer.D == 1)
    delta = F.softplus(mixer.dt_proj.bias)
    assert delta.min() >= 1e-4 and delta.max() <= 0.1 + 1e-6
    assert load_generator(small, m, device="cpu") is m
    with pytest.raises(ValueError):
        load_generator(semamba_16k(), m, device="cpu")  # another model config
    assert isinstance(build_generator(ModelConfig(num_channels=16, num_tscb_blocks=1)), TSCNet)
    with pytest.raises(ValueError, match="float32"):
        build_generator(SEMambaConfig(), dtype=torch.bfloat16)


def test_enhancer_and_stream_batcher_run_it():
    cfg = dataclasses.replace(semamba_16k(), model=SEMambaConfig(hid_feature=16, num_tfmamba=1,
                                                                  dense_depth=1))
    rng = np.random.default_rng(0)
    enh = Enhancer(cfg, device="cpu", seed=1)
    track = (0.1 * rng.standard_normal(5000)).astype(np.float32)
    out = enh.enhance(track, mode="exact")
    assert out.shape == track.shape and np.all(np.isfinite(out))
    sb = StreamBatcher(cfg, enh.model, num_slots=2, chunk=1600, left_context=1600,
                       lookahead=400, device="cpu")
    slots = [sb.open(), sb.open()]
    for _ in range(3):
        outs = sb.step({s: (0.1 * rng.standard_normal(1600)).astype(np.float32) for s in slots})
        assert set(outs) == set(slots)
        assert all(np.all(np.isfinite(o)) for o in outs.values())


def test_cmgan_enhance_tensor_is_bitwise_unchanged():
    """The CMGAN path as it was: the default Hamming window inside stft and
    istft, power compression, the generator, uncompression."""
    cfg = CMGANConfig(model=ModelConfig(num_channels=16, num_tscb_blocks=1, dense_depth=2))
    model = load_generator(cfg, None, device="cpu", seed=5)
    x = 0.1 * torch.randn(2, 3200, generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        got = enhance_tensor(model, cfg.dsp, x)
        re, im = model(dsp.power_compress(dsp.stft(x, 400, 100), 0.3))
        want = dsp.istft(dsp.power_uncompress(re.float(), im.float(), 0.3), 400, 100)
    assert torch.equal(got, want)
    # the very window stft and istft take by default: the same cached tensor
    assert dsp.analysis_window("hamming", 400, x.dtype, x.device) is \
        dsp.hamming_window(400, x.dtype, x.device)


def test_hann_window_is_the_published_one():
    assert torch.equal(dsp.hann_window(400), torch.hann_window(400))
    x = 0.1 * torch.randn(2, 3200, generator=torch.Generator().manual_seed(6))
    assert torch.equal(dsp.stft(x, 400, 100, dsp.hann_window(400)), ref.stft(x, 400, 100).transpose(1, 2))
    with pytest.raises(ValueError):
        dsp.analysis_window("blackman", 400)


# -- on the card: marked `card`, skipped without CUDA -------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("rows,length", [(800, 2561), (20488, 100), (3, 37)],
                         ids=["time_rows", "freq_rows", "small"])
@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_scan_matches_plain_and_repeats_bitwise(card, rows, length, reverse):
    args = [t.to(card) for t in scan_inputs(rows, length, d=256, seed=rows)]
    before = ss.launches
    y = ss.selective_scan(*args, reverse=reverse)
    again = ss.selective_scan(*args, reverse=reverse)
    assert ss.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    torch.testing.assert_close(y, ss._scan_plain(*args, reverse), rtol=1e-4, atol=1e-5)


@pytest.mark.card
@pytest.mark.parametrize("rows,length,d", [(5, 300, 256)], ids=["four_groups_a_block"])
def test_cuda_scan_block_shapes_match_plain(card, rows, length, d):
    """4 groups of 32 channels a block, a length off the 32-step chunk; a
    d_inner off the 128-channel block or a dt_rank over 8 is refused."""
    args = [t.to(card) for t in scan_inputs(rows, length, d=d, seed=length)]
    for reverse in (False, True):
        y = ss.selective_scan(*args, reverse=reverse)
        torch.testing.assert_close(y, ss._scan_plain(*args, reverse), rtol=1e-4, atol=1e-5)
    for bad in (dict(d=96), dict(r=9)):
        with pytest.raises(ValueError):
            ss.selective_scan(*[t.to(card) for t in scan_inputs(3, 37, **bad)])


@pytest.mark.card
@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_conv_and_rmsnorm_match_plain(card, reverse):
    g = torch.Generator().manual_seed(7)
    xz = torch.randn(40, 301, 512, generator=g).to(card)
    w, b = (torch.randn(256, 4, generator=g) * 0.5).to(card), torch.randn(256, generator=g).to(card)
    convs, norms = ss.conv_launches, fused_norm.rms_launches
    y = ss.causal_conv1d_silu(xz[..., :256], w, b, reverse)
    torch.testing.assert_close(y, ss._conv_plain(xz[..., :256], w, b, reverse), rtol=1e-5,
                               atol=1e-6)
    x, s = torch.randn(4001, 64, generator=g).to(card), torch.rand(64, generator=g).to(card)
    torch.testing.assert_close(fused_norm.fused_rmsnorm(x, s), fused_norm._rms_reference(x, s, 1e-5),
                               rtol=1e-5, atol=1e-6)
    assert (ss.conv_launches, fused_norm.rms_launches) == (convs + 1, norms + 1)


@pytest.mark.card
def test_cuda_stft_is_the_references_bit_for_bit(card):
    x = 0.1 * torch.randn(8, 256000, device=card)
    got = dsp.stft(x, 400, 100, dsp.analysis_window("hann", 400, device=card))
    assert torch.equal(got, ref.stft(x, 400, 100).transpose(1, 2))
