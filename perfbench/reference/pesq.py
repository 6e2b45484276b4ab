"""The discriminator's labels in plain PyTorch: batched wideband PESQ
(P.862.2 structure) of synchronized pairs, as the recipe's
`pesq_label_mode='device'` computes them, frozen here.

Level alignment on the 350-3250 Hz band power (Parseval on one rFFT),
the 100 Hz high-pass as an FFT filter, 32 ms Hann frames, 49 Bark bands
(z = 7 asinh(f / 650)), frequency and smoothed short-term gain
compensation, Zwicker loudness, symmetric and asymmetric disturbances,
L6 over 20-frame bursts then L2, and the logistic MOS mapping. The
constants are derived from the published formulas; the disturbance
weights are the calibration the recipe's labeler uses.
"""

from __future__ import annotations

import numpy as np
import torch

FS, FRAME, SHIFT, BANDS = 16_000, 512, 256, 49
TARGET_POWER = 1e7
ZWICKER_EXP = 0.23
LOUDNESS_SCALE = 0.1866055
GAIN_COMP_EXP = 0.5
D_WEIGHT, D_POWER = 1.41e-05, 3.2379832
DA_WEIGHT, DA_POWER = 0.4424533, 0.296617
HP = ((0.9726138984998438, -1.9452277969996876, 0.9726138984998438),
      (1.0, -1.9444776577670935, 0.9459779362322813))
BP = ((0.17700538222951706, 0.0, -0.3540107644590341, 0.0, 0.17700538222951706),
      (1.0, -2.266085202402198, 1.9183268001686336, -0.8538508436231806, 0.21791242519290044))
FILTER_TAIL = 4096
SMOOTH = 0.8


def _bark(f):
    return 7.0 * np.arcsinh(f / 650.0)


def _constants():
    """(band matrix [bins, bands], Bark widths, thresholds, Zwicker
    exponents, Hann window) in float64."""
    freqs = np.arange(FRAME // 2 + 1) * FS / FRAME
    z_edges = np.linspace(_bark(100.0), _bark(8000.0), BANDS + 1)
    f_edges = 650.0 * np.sinh(z_edges / 7.0)
    band_of_bin = np.digitize(freqs, f_edges) - 1
    valid = (band_of_bin >= 0) & (band_of_bin < BANDS)
    counts = np.bincount(band_of_bin[valid], minlength=BANDS)
    band = np.zeros((freqs.size, BANDS))
    for k in np.flatnonzero(valid):
        band[k, band_of_bin[k]] = 1.0 / counts[band_of_bin[k]]
    centers = 0.5 * (f_edges[1:] + f_edges[:-1])
    f = np.maximum(centers, 20.0) / 1000.0
    thr_db = 3.64 * f ** -0.8 - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2) + 1e-3 * f ** 4
    zexp = np.where(_bark(centers) < 4.0,
                    ZWICKER_EXP * (1.0 + 0.5 * (4.0 - _bark(centers)) / 4.0), ZWICKER_EXP)
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(FRAME) / FRAME))
    return band, np.diff(z_edges), 10.0 ** (thr_db / 10.0), zexp, hann


def _response(ba, nfft: int):
    b, a = ba
    z = np.exp(-1j * 2.0 * np.pi * np.arange(nfft // 2 + 1) / nfft)
    return sum(c * z ** i for i, c in enumerate(b)) / sum(c * z ** i for i, c in enumerate(a))


def _pow2(n: int) -> int:
    return 1 << int(np.ceil(np.log2(n)))


def _aggregate(x):
    bursts = torch.mean(x.unfold(-1, 20, 10) ** 6, dim=-1) ** (1 / 6)
    return torch.sqrt(torch.mean(bursts ** 2, dim=-1))


def pesq_mos(ref: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """[B, N] 16 kHz pairs (N >= 20 frames) -> [B] MOS-LQO."""
    dev = ref.device
    n = ref.shape[-1]

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    band, width, thresh, zexp, hann = (t(c) for c in _constants())
    nfft_bp, nfft_hp = _pow2(n), _pow2(n + FILTER_TAIL)
    bp_w = t(np.abs(_response(BP, nfft_bp)) ** 2)
    hp = torch.as_tensor(_response(HP, nfft_hp).astype(np.complex64), device=dev)

    def prepare(x):
        power = torch.fft.rfft(x, nfft_bp, dim=-1).abs() ** 2
        band_power = 2.0 * torch.sum(power * bp_w, dim=-1) / (float(nfft_bp) * float(n))
        x = x * torch.sqrt(TARGET_POWER / band_power.clamp_min(1e-20))[:, None]
        x = torch.fft.irfft(torch.fft.rfft(x, nfft_hp, dim=-1) * hp, nfft_hp, dim=-1)[..., :n]
        frames = x.unfold(-1, FRAME, SHIFT) * hann
        return (torch.fft.rfft(frames, dim=-1).abs() ** 2 * (FRAME / (FRAME * 0.375) ** 2)) @ band

    p_ref, p_deg = prepare(ref.float()), prepare(deg.float())
    audible = torch.sum(torch.where(p_ref > thresh, p_ref, 0.0) * width, dim=-1)
    active = (audible >= 1e5).float()
    w_act = torch.where(active.amax(dim=1, keepdim=True) > 0, active, 1.0)[..., None]
    denom = torch.sum(w_act, dim=1)
    gain_f = torch.clamp(((torch.sum(p_deg * w_act, dim=1) / denom + 1000.0)
                          / (torch.sum(p_ref * w_act, dim=1) / denom + 1000.0)) ** 0.2,
                         0.01, 100.0)
    p_ref = p_ref * gain_f[:, None, :]
    gain = ((torch.sum(p_ref * width, -1) + 5e3) / (torch.sum(p_deg * width, -1) + 5e3)) \
        ** GAIN_COMP_EXP
    frames = gain.shape[-1]
    lag = np.arange(frames)[None, :] - np.arange(frames)[:, None]
    decay = t(np.where(lag >= 0, (1.0 - SMOOTH) * SMOOTH ** np.maximum(lag, 0), 0.0))
    h0 = t(SMOOTH ** (np.arange(frames) + 1.0))
    p_deg = p_deg * torch.clamp(gain @ decay + h0, 3e-4, 5.0)[..., None]

    def loudness(p):
        ratio = torch.clamp_min(p / thresh, 0.0)
        return torch.clamp_min(LOUDNESS_SCALE * (thresh / 0.5) ** zexp
                               * ((0.5 + 0.5 * ratio) ** zexp - 1.0), 0.0)

    l_ref, l_deg = loudness(p_ref), loudness(p_deg)
    d = l_deg - l_ref
    d = torch.sign(d) * torch.clamp_min(torch.abs(d) - 0.25 * torch.minimum(l_deg, l_ref), 0.0)
    asym = ((p_deg + 50.0) / (p_ref + 50.0)) ** 1.2
    asym = torch.where(asym < 3.0, 0.0, torch.clamp_max(asym, 12.0))
    weight = ((audible + 1e5) / 1e7) ** 0.04
    d_frame = torch.clamp_max(torch.sqrt(torch.sum((d * width) ** 2, -1) * BANDS) / weight, 45.0)
    da_frame = torch.clamp_max(torch.sum(torch.abs(d) * asym * width, -1) / weight, 45.0)
    raw = (4.5 - D_WEIGHT * _aggregate(d_frame) ** D_POWER
           - DA_WEIGHT * _aggregate(da_frame) ** DA_POWER)
    return 0.999 + 4.0 / (1.0 + torch.exp(-1.3669 * raw + 3.8224))


def labels(clean: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    """Scores [B], -1 for a silent row or a score that is not finite."""
    scores = pesq_mos(clean, est)
    energy = torch.sum(clean * clean, -1) * torch.sum(est * est, -1)
    return torch.where(~torch.isfinite(scores) | (energy <= 1e-12), -1.0, scores)
