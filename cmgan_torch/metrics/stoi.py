"""STOI (short-time objective intelligibility), Taal et al. 2010. The
port's own copy of the JAX package's `metrics/stoi.py` (numpy / scipy).

Numerically equivalent to the reference's MATLAB-derived port
(src/tools/compute_metrics.py:400-599), including its quirks: the
one-sample-early energy mask in silent-frame removal, scipy STFT
scaling (cancels in the correlations), and the third-octave band-count
trimming rule.
"""

from __future__ import annotations

import numpy as np

# scipy.signal is imported where it is used: importing it at the top would
# import numpy.testing, which runs a subprocess, whenever the port is imported

_FS = 10_000  # internal sample rate
_N_FRAME = 256
_K_FFT = 512
_NUM_BANDS = 15
_MIN_CF = 150.0  # Hz, first third-octave center
_N_SEG = 30  # frames per intermediate-intelligibility segment
_BETA = -15.0  # lower SDR bound (dB)
_DYN_RANGE = 40.0  # speech dynamic range (dB)


def _hann_interior(n: int) -> np.ndarray:
    from scipy import signal

    return signal.windows.hann(n + 2)[1 : n + 1]


def third_octave_bands(fs: int, n_fft: int, num_bands: int, min_cf: float):
    """Third-octave band matrix [J, n_fft//2+1] and center frequencies."""
    f = np.linspace(0, fs, n_fft + 1)[: n_fft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3.0) * min_cf
    fl = np.sqrt(cf * 2.0 ** ((k - 1) / 3.0) * min_cf)
    fr = np.sqrt(cf * 2.0 ** ((k + 1) / 3.0) * min_cf)
    A = np.zeros((num_bands, f.size))
    for i in range(num_bands):
        lo = int(np.argmin((f - fl[i]) ** 2))
        hi = int(np.argmin((f - fr[i]) ** 2))
        A[i, lo:hi] = 1.0

    # Trim trailing bands whose bin count stops decreasing (degenerate at
    # the Nyquist edge) — keeps the same band count as the original.
    rnk = np.sum(A, axis=1)
    result = 0
    for i in range(rnk.size - 1):
        if rnk[i + 1] >= rnk[i] and rnk[i + 1] != 0:
            result = i
    keep = result + 2
    return A[:keep], cf[:keep]


def _remove_silent_frames(x, y, dyn_range, n, k):
    frames = np.arange(0, x.size - n, k)
    w = _hann_interior(n)
    # NOTE: energy mask indexes one sample early (frames[j]-1), wrapping
    # at -1 — reproduced from the reference (compute_metrics.py:563-567).
    jj = frames[:, None] + np.arange(-1, n - 1)[None, :]
    energies = 20.0 * np.log10(
        np.linalg.norm(x[jj] * w, axis=1) / np.sqrt(n)
    )
    mask = (energies - np.max(energies) + dyn_range) > 0

    x_sil = np.zeros(x.size)
    y_sil = np.zeros(y.size)
    count = 0
    last_end = 0
    for j in range(frames.size):
        if mask[j]:
            src = slice(frames[j], frames[j] + n)
            dst = slice(frames[count], frames[count] + n)
            x_sil[dst] += x[src] * w
            y_sil[dst] += y[src] * w
            last_end = frames[count] + n
            count += 1
    return x_sil[:last_end], y_sil[:last_end]


def _stdft(x, n, k, n_fft):
    from scipy import signal

    num_frames = int((x.size - n) / k)
    w = _hann_interior(n)
    stft = signal.stft(
        x,
        window=w,
        nperseg=n,
        noverlap=k,
        nfft=n_fft,
        return_onesided=False,
        boundary=None,
    )[2]
    return stft.T[:num_frames, :]


def stoi(clean: np.ndarray, processed: np.ndarray, sample_rate: int) -> float:
    x = np.asarray(clean, np.float64)
    y = np.asarray(processed, np.float64)
    if x.size != y.size:
        raise ValueError("signals must have the same length")

    band_matrix, _ = third_octave_bands(_FS, _K_FFT, _NUM_BANDS, _MIN_CF)

    if sample_rate != _FS:
        from scipy import signal

        x = signal.resample_poly(x, _FS, sample_rate)
        y = signal.resample_poly(y, _FS, sample_rate)

    x, y = _remove_silent_frames(x, y, _DYN_RANGE, _N_FRAME, _N_FRAME // 2)

    x_spec = _stdft(x, _N_FRAME, _N_FRAME / 2, _K_FFT).T[: _K_FFT // 2 + 1]
    y_spec = _stdft(y, _N_FRAME, _N_FRAME / 2, _K_FFT).T[: _K_FFT // 2 + 1]

    X = np.sqrt(band_matrix @ np.abs(x_spec) ** 2)  # [J, frames]
    Y = np.sqrt(band_matrix @ np.abs(y_spec) ** 2)

    num_frames = X.shape[1]
    clip_c = 10.0 ** (-_BETA / 20.0)
    num_segments = num_frames - _N_SEG + 1
    if num_segments <= 0:
        return float("nan")

    d_total = 0.0
    for m in range(num_segments):
        X_seg = X[:, m : m + _N_SEG]
        Y_seg = Y[:, m : m + _N_SEG]
        alpha = np.sqrt(
            np.sum(X_seg**2, axis=1, keepdims=True)
            / np.sum(Y_seg**2, axis=1, keepdims=True)
        )
        Y_prime = np.minimum(Y_seg * alpha, X_seg * (1.0 + clip_c))
        xn = X_seg - np.mean(X_seg, axis=1, keepdims=True)
        xn /= np.linalg.norm(xn, axis=1, keepdims=True)
        yn = Y_prime - np.mean(Y_prime, axis=1, keepdims=True)
        yn /= np.linalg.norm(yn, axis=1, keepdims=True)
        # Divisor is the nominal J=15, not the trimmed band count
        # (reference: compute_metrics.py:466).
        d_total += np.sum(xn * yn) / _NUM_BANDS

    return float(d_total / num_segments)
