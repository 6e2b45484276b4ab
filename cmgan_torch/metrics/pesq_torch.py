"""Batched wideband PESQ in PyTorch: the discriminator's labels on the GPU.

The port of the JAX package's `metrics/pesq_jax.py`. It evaluates the
calibrated perceptual model of `pesq_ref.py` (and of the C++ scorer in
native/pesq) on the device that holds the waveforms, so the fused
G + label + D step of `pesq_label_mode='device'` needs no host round
trip. Stock eager torch ops (rFFT, `unfold`, one matmul, elementwise);
no hand kernel, as the JAX package leaves this code to XLA.

Reformulations of the scalar spec, each as in the JAX version, so that
everything is fixed-shape and parallel:
- the IIR input filters run as zero-padded FFT multiplications over the
  whole waveform (lfilter up to a truncated impulse-response tail
  < 1e-20);
- level alignment measures band power with an |H_bp(f)|^2 weight on a
  whole-signal rFFT (Parseval);
- time alignment is skipped: training pairs are synchronized by
  construction;
- band powers come from one [bins, bands] matmul;
- the first-order gain smoother is one product with a [F, F]
  lower-triangular decay matrix instead of a scan over frames.

Computed in float32 (as JAX computes without x64), differentiable with
respect to `deg`. Constants are built on the host in numpy once and
cached per device (and per signal length for the filters).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cmgan_torch.metrics import pesq_ref as _spec

_FS = _spec._FS
_FRAME = _spec._FRAME
_SHIFT = _spec._SHIFT
_NBANDS = _spec._NBANDS
_FILTER_TAIL = 4096   # impulse-response samples kept by the FFT filter
_SMOOTH = 0.8         # the gain smoother: h_t = 0.8 h_{t-1} + 0.2 g_t, h_{-1} = 1
_BURST, _BURST_STRIDE = 20, 10


def _freq_response(b, a, freqs):
    """H(f) of an IIR filter at the given frequencies (numpy, complex128)."""
    z = np.exp(-1j * 2.0 * np.pi * freqs / _FS)
    num = sum(bk * z**k for k, bk in enumerate(b))
    den = sum(ak * z**k for k, ak in enumerate(a))
    return num / den


def _next_pow2(n: int) -> int:
    return 1 << int(np.ceil(np.log2(n)))


@functools.lru_cache(maxsize=8)
def _constants(device: torch.device):
    """(band matrix [bins, bands], width_bark, abs_thresh, zwicker_exp,
    Hann window), float32 on `device`."""
    c = _spec._constants()
    n_bins = _FRAME // 2 + 1
    band = np.zeros((n_bins, _NBANDS))
    counts = np.bincount(c.band_of_bin[c.valid], minlength=_NBANDS)
    for k in np.flatnonzero(c.valid):
        band[k, c.band_of_bin[k]] = 1.0 / counts[c.band_of_bin[k]]
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(_FRAME) / _FRAME))
    return tuple(torch.from_numpy(x.astype(np.float32)).to(device)
                 for x in (band, c.width_bark, c.abs_thresh, c.zwicker_exp, window))


@functools.lru_cache(maxsize=16)
def _filters(n: int, device: torch.device):
    """For signals of n samples: the high-pass response on the rFFT grid of
    the next power of two >= n + tail (complex64), and the band-pass power
    weight |H_bp|^2 on that of the next power of two >= n (float32)."""
    nfft_hp, nfft_bp = _next_pow2(n + _FILTER_TAIL), _next_pow2(n)
    hp = _freq_response(_spec._HP_B, _spec._HP_A, np.arange(nfft_hp // 2 + 1) * _FS / nfft_hp)
    bp = _freq_response(_spec._BP_B, _spec._BP_A, np.arange(nfft_bp // 2 + 1) * _FS / nfft_bp)
    return (torch.from_numpy(hp.astype(np.complex64)).to(device),
            torch.from_numpy((np.abs(bp) ** 2).astype(np.float32)).to(device))


@functools.lru_cache(maxsize=16)
def _smoother(n_frames: int, device: torch.device):
    """(M [F, F], h0 [F]) with h = g @ M + h0 the smoother's output:
    M[k, t] = 0.2 * 0.8^(t-k) for k <= t, and h0[t] = 0.8^(t+1) carries the
    initial state 1."""
    t = np.arange(n_frames)
    lag = t[None, :] - t[:, None]
    decay = np.where(lag >= 0, (1.0 - _SMOOTH) * _SMOOTH ** np.maximum(lag, 0), 0.0)
    return (torch.from_numpy(decay.astype(np.float32)).to(device),
            torch.from_numpy((_SMOOTH ** (t + 1.0)).astype(np.float32)).to(device))


def _level_scale(x, bp_weight):
    """sqrt(target / band power), band power by a whole-signal rFFT."""
    n = x.shape[-1]
    nfft = _next_pow2(n)
    spec_pow = torch.fft.rfft(x, nfft, dim=-1).abs() ** 2
    # one-sided spectrum: doubled to count negative frequencies (the
    # 350-3250 Hz measurement band excludes DC and Nyquist)
    band_power = 2.0 * torch.sum(spec_pow * bp_weight, dim=-1) / (float(nfft) * float(n))
    return torch.sqrt(_spec._TARGET_POWER / band_power.clamp_min(1e-20))


def _fft_iir_filter(x, response):
    n = x.shape[-1]
    nfft = 2 * (response.shape[-1] - 1)
    return torch.fft.irfft(torch.fft.rfft(x, nfft, dim=-1) * response, nfft, dim=-1)[..., :n]


def _aggregate(x):
    """L6 over 50%-overlapped 20-frame bursts, then L2 over the bursts."""
    if x.shape[-1] < _BURST:
        bursts = torch.mean(x**6, dim=-1, keepdim=True) ** (1 / 6)
    else:
        bursts = torch.mean(x.unfold(-1, _BURST, _BURST_STRIDE) ** 6, dim=-1) ** (1 / 6)
    return torch.sqrt(torch.mean(bursts**2, dim=-1))


def pesq_mos_torch(ref: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Batched wideband PESQ MOS-LQO for synchronized pairs.

    ref, deg: [B, N] 16 kHz waveforms on one device -> [B] float32 scores
    on that device. Differentiable with respect to `deg`.
    """
    ref, deg = ref.float(), deg.float()
    if ref.shape != deg.shape or ref.dim() != 2:
        raise ValueError(f"expected two [B, N] tensors, got {tuple(ref.shape)} and {tuple(deg.shape)}")
    n = ref.shape[-1]
    if n < _FRAME:
        raise ValueError(f"PESQ needs at least {_FRAME} samples, got {n}")
    band, width, thresh, zexp, window = _constants(ref.device)
    hp, bp_weight = _filters(n, ref.device)

    ref = ref * _level_scale(ref, bp_weight)[:, None]
    deg = deg * _level_scale(deg, bp_weight)[:, None]
    ref = _fft_iir_filter(ref, hp)
    deg = _fft_iir_filter(deg, hp)

    spec_scale = _FRAME / (_FRAME * 0.375) ** 2

    def band_powers(x):
        frames = x.unfold(-1, _FRAME, _SHIFT) * window               # [B, F, FRAME]
        return (torch.fft.rfft(frames, dim=-1).abs() ** 2 * spec_scale) @ band  # [B, F, NBANDS]

    p_ref = band_powers(ref)
    p_deg = band_powers(deg)

    audible_ref = torch.sum(torch.where(p_ref > thresh, p_ref, 0.0) * width, dim=-1)  # [B, F]
    active = (audible_ref >= 1e5).float()

    # frequency compensation over active frames (all frames where none is)
    w_act = torch.where(active.amax(dim=1, keepdim=True) > 0, active, 1.0)[..., None]
    denom = torch.sum(w_act, dim=1)
    mean_ref = torch.sum(p_ref * w_act, dim=1) / denom
    mean_deg = torch.sum(p_deg * w_act, dim=1) / denom
    band_gain = torch.clamp(((mean_deg + 1000.0) / (mean_ref + 1000.0)) ** 0.2, 0.01, 100.0)
    p_ref = p_ref * band_gain[:, None, :]

    # short-term gain compensation, first-order smoothed over frames
    e_ref = torch.sum(p_ref * width, dim=-1)
    e_deg = torch.sum(p_deg * width, dim=-1)
    gain = ((e_ref + 5e3) / (e_deg + 5e3)) ** _spec._GAIN_COMP_EXP
    decay, h0 = _smoother(gain.shape[-1], ref.device)
    h = torch.clamp(gain @ decay + h0, 3e-4, 5.0)
    p_deg = p_deg * h[..., None]

    # Zwicker loudness
    def loudness(p):
        ratio = torch.clamp_min(p / thresh, 0.0)
        return torch.clamp_min(
            _spec._LOUDNESS_SCALE * (thresh / 0.5) ** zexp * ((0.5 + 0.5 * ratio) ** zexp - 1.0),
            0.0)

    l_ref = loudness(p_ref)
    l_deg = loudness(p_deg)

    d = l_deg - l_ref
    mask = 0.25 * torch.minimum(l_deg, l_ref)
    d_masked = torch.sign(d) * torch.clamp_min(torch.abs(d) - mask, 0.0)

    asym = ((p_deg + 50.0) / (p_ref + 50.0)) ** 1.2
    asym = torch.where(asym < 3.0, 0.0, torch.clamp_max(asym, 12.0))

    d_frame = torch.sqrt(torch.sum((d_masked * width) ** 2, dim=-1) * _NBANDS)
    da_frame = torch.sum(torch.abs(d_masked) * asym * width, dim=-1)

    weight = ((audible_ref + 1e5) / 1e7) ** 0.04
    d_frame = torch.clamp_max(d_frame / weight, 45.0)
    da_frame = torch.clamp_max(da_frame / weight, 45.0)

    raw = (4.5
           - _spec._D_WEIGHT * _aggregate(d_frame) ** _spec._D_POWER
           - _spec._DA_WEIGHT * _aggregate(da_frame) ** _spec._DA_POWER)
    return 0.999 + 4.0 / (1.0 + torch.exp(-1.3669 * raw + 3.8224))


def pesq_labels_torch(clean: torch.Tensor, est: torch.Tensor,
                      batch_valid_floor: float = 1e-12) -> torch.Tensor:
    """Training labels on the device: scores [B] with -1 for degenerate rows.

    Mirrors the host labeler (`train.steps.pesq_labels_host`): a silent
    clean or est row, or a non-finite score, is a failure that makes the
    discriminator skip the batch. Reads nothing back to the host.
    """
    clean, est = clean.float(), est.float()
    scores = pesq_mos_torch(clean, est)
    energy = torch.sum(clean * clean, dim=-1) * torch.sum(est * est, dim=-1)
    bad = ~torch.isfinite(scores) | (energy <= batch_valid_floor)
    return torch.where(bad, -1.0, scores)
