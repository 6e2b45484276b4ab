"""Evaluation metric suite: PESQ, CSIG, CBAK, COVL, SSNR, STOI.

`compute_metrics` mirrors the CMGAN reference's entry point
(src/tools/compute_metrics.py:26-77), as the JAX package's does:
identical trimming, 95%-trimmed WSS/LLR means, composite regressions and
clamps. Host code in numpy float64. PESQ comes from the port's C++
P.862.2 library (native/pesq, built with g++ at first use); it builds or
raises, and no other scorer stands in for it.
"""

from __future__ import annotations

import numpy as np

from cmgan_torch.metrics.composite import composite_scores, llr, snr, wss
from cmgan_torch.metrics.stoi import stoi

_TRIM_ALPHA = 0.95


def pesq_wb(clean: np.ndarray, degraded: np.ndarray, sample_rate: int = 16000) -> float:
    """Wideband PESQ (ITU-T P.862.2) MOS-LQO via the native library."""
    from cmgan_torch.metrics.pesq_native import pesq

    return pesq(sample_rate, clean, degraded, mode="wb")


def compute_metrics(clean, enhanced, sample_rate: int = 16000, path: int = 0):
    """Returns (pesq, csig, cbak, covl, ssnr, stoi) for one track pair."""
    if path == 1:
        from scipy.io import wavfile

        sr1, clean = wavfile.read(clean)
        sr2, enhanced = wavfile.read(enhanced)
        if sr1 != sr2:
            raise ValueError("sample-rate mismatch between files")
        sample_rate = sr1

    clean = np.asarray(clean, np.float64)
    enhanced = np.asarray(enhanced, np.float64)
    if clean.size != enhanced.size:
        n = min(clean.size, enhanced.size)
        clean = clean[:n] + np.spacing(1)
        enhanced = enhanced[:n] + np.spacing(1)

    wss_frames = np.sort(wss(clean, enhanced, sample_rate))
    wss_dist = float(np.mean(wss_frames[: round(wss_frames.size * _TRIM_ALPHA)]))

    llr_frames = np.sort(llr(clean, enhanced, sample_rate))
    llr_mean = float(np.mean(llr_frames[: round(llr_frames.size * _TRIM_ALPHA)]))

    _, seg_frames = snr(clean, enhanced, sample_rate)
    seg_snr = float(np.mean(seg_frames))

    pesq_mos = pesq_wb(clean, enhanced, sample_rate)

    csig, cbak, covl = composite_scores(pesq_mos, llr_mean, wss_dist, seg_snr)
    stoi_score = stoi(clean, enhanced, sample_rate)

    return pesq_mos, csig, cbak, covl, seg_snr, stoi_score


__all__ = [
    "compute_metrics",
    "composite_scores",
    "llr",
    "pesq_wb",
    "snr",
    "stoi",
    "wss",
]
