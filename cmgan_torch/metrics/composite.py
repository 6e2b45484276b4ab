"""Objective speech-quality measures: WSS, LLR, SNR/segSNR and the
CSIG/CBAK/COVL composites. The port's own copy of the JAX package's
`metrics/composite.py` (numpy, float64).

Numerically equivalent to the MATLAB-derived suite the reference
validated against Loizou's original on all 824 VCTK-DEMAND test tracks
(reference: src/tools/compute_metrics.py:26-397, logs in
src/tools/Noisy_metrics_results/). This implementation is vectorized
across frames (single filterbank matmul + cumulative-extrema peak
search instead of per-frame Python loops), which is ~2 orders of
magnitude faster on the 824-track evaluation; intentional quirks of the
original (asymmetric peak indexing, frame-count formulas, silence
behavior) are preserved so the checked-in golden aggregates still hold.
"""

from __future__ import annotations

import numpy as np

# Critical-band center frequencies / bandwidths in Hz (Klatt 1982).
_CENT_FREQ = np.array([
    50.0, 120.0, 190.0, 260.0, 330.0, 400.0, 470.0, 540.0, 617.372,
    703.378, 798.717, 904.128, 1020.38, 1148.30, 1288.72, 1442.54,
    1610.70, 1794.16, 1993.93, 2211.08, 2446.71, 2701.97, 2978.04,
    3276.17, 3597.63,
])
_BANDWIDTH = np.array([
    70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 77.3724, 86.0056,
    95.3398, 105.411, 116.256, 127.914, 140.423, 153.823, 168.154,
    183.457, 199.776, 217.153, 235.631, 255.255, 276.072, 298.126,
    321.465, 346.136,
])

_KMAX = 20.0  # Klatt's global-peak weighting constant
_KLOCMAX = 1.0  # Klatt's local-peak weighting constant


def _analysis_window(winlength: int) -> np.ndarray:
    # Hann window without endpoints: 0.5*(1-cos(2*pi*(1..N)/(N+1))).
    n = np.arange(1, winlength + 1)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * n / (winlength + 1)))


def _frame(x: np.ndarray, winlength: int, skiprate: int, num_frames: int) -> np.ndarray:
    idx = np.arange(num_frames)[:, None] * skiprate + np.arange(winlength)[None, :]
    return x[idx]


def _critical_band_filters(n_fftby2: int, max_freq: float) -> np.ndarray:
    bw_min = _BANDWIDTH[0]
    min_factor = np.exp(-30.0 / (2.0 * 2.303))  # -30 dB filter floor
    j = np.arange(n_fftby2)[None, :]
    f0 = np.floor(_CENT_FREQ / max_freq * n_fftby2)[:, None]
    bw = (_BANDWIDTH / max_freq * n_fftby2)[:, None]
    norm_factor = (np.log(bw_min) - np.log(_BANDWIDTH))[:, None]
    filt = np.exp(-11.0 * ((j - f0) / bw) ** 2 + norm_factor)
    return np.where(filt > min_factor, filt, 0.0)


def _band_energies_db(frames: np.ndarray, crit_filter: np.ndarray, n_fft: int) -> np.ndarray:
    spec = np.abs(np.fft.fft(frames, n_fft, axis=-1)) ** 2
    energy = spec[:, : crit_filter.shape[1]] @ crit_filter.T
    return 10.0 * np.log10(np.maximum(energy, 1e-10))


def _nearest_peaks(energy: np.ndarray, slope: np.ndarray) -> np.ndarray:
    """Replicates the reference's per-band peak search, vectorized.

    For band i with positive slope, walk right to the first n with
    slope[n] <= 0 and take energy[n-1]; with non-positive slope, walk
    left to the first n with slope[n] > 0 and take energy[n+1]
    (reference: src/tools/compute_metrics.py:218-241, indexing quirks
    included).
    """
    num_frames, nb = slope.shape  # nb = num_crit - 1
    cols = np.arange(nb)[None, :]

    # smallest n >= i with slope[n] <= 0, else nb
    stop_r = np.where(slope <= 0, cols, nb)
    stop_r = np.minimum.accumulate(stop_r[:, ::-1], axis=1)[:, ::-1]
    peak_right = np.take_along_axis(energy, np.maximum(stop_r - 1, 0), axis=1)

    # largest n <= i with slope[n] > 0, else -1
    stop_l = np.where(slope > 0, cols, -1)
    stop_l = np.maximum.accumulate(stop_l, axis=1)
    peak_left = np.take_along_axis(
        energy, np.minimum(stop_l + 1, energy.shape[1] - 1), axis=1
    )

    return np.where(slope > 0, peak_right, peak_left)


def wss(clean: np.ndarray, processed: np.ndarray, sample_rate: int) -> np.ndarray:
    """Weighted Spectral Slope distortion per frame."""
    clean = np.asarray(clean, np.float64)
    processed = np.asarray(processed, np.float64)
    if clean.size != processed.size:
        raise ValueError("signals must have the same length")

    winlength = int(np.round(30 * sample_rate / 1000))
    skiprate = winlength // 4
    max_freq = sample_rate / 2
    num_crit = len(_CENT_FREQ)
    n_fft = int(2 ** np.ceil(np.log2(2 * winlength)))
    n_fftby2 = n_fft // 2

    crit_filter = _critical_band_filters(n_fftby2, max_freq)
    num_frames = int(clean.size / skiprate - winlength / skiprate)
    window = _analysis_window(winlength)

    cf = _frame(clean / 32768.0, winlength, skiprate, num_frames) * window
    pf = _frame(processed / 32768.0, winlength, skiprate, num_frames) * window

    ce = _band_energies_db(cf, crit_filter, n_fft)  # [F, 25]
    pe = _band_energies_db(pf, crit_filter, n_fft)

    cs = ce[:, 1:num_crit] - ce[:, : num_crit - 1]  # [F, 24]
    ps = pe[:, 1:num_crit] - pe[:, : num_crit - 1]

    c_peak = _nearest_peaks(ce, cs)
    p_peak = _nearest_peaks(pe, ps)

    db_max_c = np.max(ce, axis=1, keepdims=True)
    db_max_p = np.max(pe, axis=1, keepdims=True)

    w_clean = (_KMAX / (_KMAX + db_max_c - ce[:, : num_crit - 1])) * (
        _KLOCMAX / (_KLOCMAX + c_peak - ce[:, : num_crit - 1])
    )
    w_proc = (_KMAX / (_KMAX + db_max_p - pe[:, : num_crit - 1])) * (
        _KLOCMAX / (_KLOCMAX + p_peak - pe[:, : num_crit - 1])
    )
    w = 0.5 * (w_clean + w_proc)
    slope_diff = cs - ps
    return np.sum(w * slope_diff**2, axis=1) / np.sum(w, axis=1)


def _levinson_batch(R: np.ndarray, order: int) -> np.ndarray:
    """Levinson-Durbin over a batch of autocorrelations R [F, order+1].

    Returns LPC parameter vectors [F, order+1] as (1, -a_1, ..., -a_p).
    """
    num_frames = R.shape[0]
    a = np.zeros((num_frames, order))
    E = R[:, 0].copy()
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(order):
            if i == 0:
                acc = np.zeros(num_frames)
            else:
                acc = np.sum(a[:, :i] * R[:, i:0:-1], axis=1)
            k = (R[:, i + 1] - acc) / E
            if i > 0:
                a[:, :i] = a[:, :i] - a[:, i - 1 :: -1] * k[:, None]
            a[:, i] = k
            E = (1.0 - k * k) * E
    return np.concatenate([np.ones((num_frames, 1)), -a], axis=1)


def _toeplitz_quadratic(R: np.ndarray, A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Batched A' T(R) B where T(R) is the symmetric Toeplitz of R [F, p+1]."""
    p1 = R.shape[1]
    # cross-correlation c_k = sum_i A_i B_{i+k} + sum_i B_i A_{i+k} (k>0), c_0 = sum A_i B_i
    out = R[:, 0] * np.sum(A * B, axis=1)
    for k in range(1, p1):
        c = np.sum(A[:, :-k] * B[:, k:], axis=1) + np.sum(B[:, :-k] * A[:, k:], axis=1)
        out = out + R[:, k] * c
    return out


def llr(clean: np.ndarray, processed: np.ndarray, sample_rate: int) -> np.ndarray:
    """Log-Likelihood Ratio per frame via order-16 LPC (order 10 below 10 kHz)."""
    clean = np.asarray(clean, np.float64)
    processed = np.asarray(processed, np.float64)
    if clean.size != processed.size:
        raise ValueError("signals must have the same length")

    winlength = int(np.round(30 * sample_rate / 1000))
    skiprate = winlength // 4
    order = 10 if sample_rate < 10000 else 16
    num_frames = int((clean.size - winlength) / skiprate)
    window = _analysis_window(winlength)

    cf = _frame(clean, winlength, skiprate, num_frames) * window
    pf = _frame(processed, winlength, skiprate, num_frames) * window

    def autocorr(frames):
        return np.stack(
            [np.sum(frames[:, : winlength - k] * frames[:, k:], axis=1) for k in range(order + 1)],
            axis=1,
        )

    Rc = autocorr(cf)
    Rp = autocorr(pf)
    Ac = _levinson_batch(Rc, order)
    Ap = _levinson_batch(Rp, order)

    with np.errstate(divide="ignore", invalid="ignore"):
        numerator = _toeplitz_quadratic(Rc, Ap, Ap)
        denominator = _toeplitz_quadratic(Rc, Ac, Ac)
        return np.log(numerator / denominator)


def snr(clean: np.ndarray, processed: np.ndarray, sample_rate: int):
    """(overall SNR, per-frame segmental SNR clamped to [-10, 35] dB)."""
    clean = np.asarray(clean, np.float64)
    processed = np.asarray(processed, np.float64)
    if clean.size != processed.size:
        raise ValueError("signals must have the same length")

    overall = 10.0 * np.log10(
        np.sum(clean**2) / np.sum((clean - processed) ** 2)
    )

    winlength = round(30 * sample_rate / 1000)
    skiprate = winlength // 4
    num_frames = int(clean.size / skiprate - winlength / skiprate)
    window = _analysis_window(winlength)

    cf = _frame(clean, winlength, skiprate, num_frames) * window
    pf = _frame(processed, winlength, skiprate, num_frames) * window

    eps = np.spacing(1)
    sig = np.sum(cf**2, axis=1)
    noise = np.sum((cf - pf) ** 2, axis=1)
    seg = 10.0 * np.log10(sig / (noise + eps) + eps)
    return overall, np.clip(seg, -10.0, 35.0)


def composite_scores(pesq_mos: float, llr_mean: float, wss_dist: float, seg_snr: float):
    """CSIG/CBAK/COVL regressions, clamped to [1, 5].

    Reference: src/tools/compute_metrics.py:65-73 (Loizou's coefficients).
    """
    csig = 3.093 - 1.029 * llr_mean + 0.603 * pesq_mos - 0.009 * wss_dist
    cbak = 1.634 + 0.478 * pesq_mos - 0.007 * wss_dist + 0.063 * seg_snr
    covl = 1.594 + 0.805 * pesq_mos - 0.512 * llr_mean - 0.007 * wss_dist
    clamp = lambda v: float(min(5.0, max(1.0, v)))
    return clamp(csig), clamp(cbak), clamp(covl)
