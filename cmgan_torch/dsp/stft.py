"""STFT / iSTFT front-end with torch.stft semantics, time-major.

n_fft=400, hop=100, periodic Hamming window (SEMamba: periodic Hann,
`analysis_window`), onesided, center=True (reflect padding),
normalized=False. Spectrograms are `[..., T, F]` (torch.stft lays them
out `[..., F, T]`), as in the JAX package.

The DFT is `torch.fft` (`dft_impl='fft'`) or two products with cached
cos/sin matrices (`dft_impl='matmul'`: `rdft_matmul`, `irdft_matmul`),
as in the JAX package.

The overlap-add in `istft` uses `n_fft % hop == 0`: each frame splits
into `n_fft // hop` hop-sized chunks and the OLA is a static sum of
shifted chunk streams, then the window-square envelope is divided out.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _device_constants(arrays, dtype, device):
    """float64 numpy arrays as tensors of `dtype` on `device`, made outside
    inference mode (a constant first made under `torch.inference_mode`
    still serves autograd)."""
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in arrays)


@functools.lru_cache(maxsize=16)
def hamming_window(n_fft: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hamming window, identical to torch.hamming_window(n_fft).
    Built once per (size, type, device): a copy from host memory to the GPU
    waits for the host, so making it at every call would stall the stream.
    Callers must not write to it."""
    n = np.arange(n_fft)
    return _device_constants((0.54 - 0.46 * np.cos(2.0 * np.pi * n / n_fft),), dtype, device)[0]


@functools.lru_cache(maxsize=16)
def hann_window(n_fft: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window: torch.hann_window(n_fft) made on the CPU in
    float32 and copied, bit for bit SEMamba's (`torch.hann_window(win_size)
    .to(y.device)`), since the generator's phase input jumps by 2 pi where
    a bin's imaginary part changes sign. Cached as `hamming_window` is."""
    with torch.inference_mode(False):
        return torch.hann_window(n_fft, periodic=True).to(device=device, dtype=dtype)


WINDOWS = {"hamming": hamming_window, "hann": hann_window}


def analysis_window(name: str, n_fft: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The cached periodic window `name` ('hamming' or 'hann', as
    `DSPConfig.window` names it)."""
    if name not in WINDOWS:
        raise ValueError(f"unknown window {name!r}; known: {sorted(WINDOWS)}")
    return WINDOWS[name](n_fft, dtype, device)


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Center-pad (reflect) and slice into overlapping frames.

    x: [..., L] -> [..., T, n_fft] with T = L // hop + 1.
    """
    pad = n_fft // 2
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    xp = xp.reshape(*lead, xp.shape[-1])
    return xp.unfold(-1, n_fft, hop)


@functools.lru_cache(maxsize=16)
def _rdft_matrices(n_fft: int, dtype=torch.float32, device=None):
    """The real-input DFT as two [n_fft, F] product operands, cos and sin of
    -2 pi n k / n_fft. Built once per (size, type, device), like the window;
    callers must not write to them."""
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = -2.0 * np.pi * np.outer(n, k) / n_fft
    return _device_constants((np.cos(ang), np.sin(ang)), dtype, device)


@functools.lru_cache(maxsize=16)
def _irdft_matrices(n_fft: int, dtype=torch.float32, device=None):
    """The onesided inverse DFT as two [F, n_fft] product operands:
    x[n] = (1/N) sum_k w_k (Re X_k cos(2 pi k n / N) - Im X_k sin(...)),
    w_k = 2 except w_0 = w_{N/2} = 1 (the hermitian fold)."""
    nf = n_fft // 2 + 1
    k = np.arange(nf)
    n = np.arange(n_fft)
    ang = 2.0 * np.pi * np.outer(k, n) / n_fft
    w = np.full(nf, 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    scale = w[:, None] / n_fft
    return _device_constants((np.cos(ang) * scale, np.sin(ang) * scale), dtype, device)


def rdft_matmul(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    """rFFT of the last axis as two matrix products: [..., n_fft] -> complex
    [..., F]. Within ~1e-5 of `torch.fft.rfft` in float32."""
    cos, sin = _rdft_matrices(n_fft, frames.dtype, frames.device)
    return torch.complex(frames @ cos, frames @ sin)  # sin already carries the -2 pi


def irdft_matmul(spec: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Inverse of `rdft_matmul`: complex [..., F] -> real [..., n_fft]."""
    re, im = spec.real, spec.imag
    cos, sin = _irdft_matrices(n_fft, re.dtype, spec.device)
    return re @ cos - im @ sin


def _check_dft_impl(dft_impl: str):
    if dft_impl not in ("fft", "matmul"):
        raise ValueError(f"unknown dft_impl {dft_impl!r}")


def stft(
    x: torch.Tensor,
    n_fft: int = 400,
    hop: int = 100,
    window: torch.Tensor | None = None,
    dft_impl: str = "fft",
) -> torch.Tensor:
    """Onesided centered STFT. x: [..., L] -> complex [..., T, F].
    dft_impl: 'fft' (torch.fft.rfft) or 'matmul' (`rdft_matmul`)."""
    _check_dft_impl(dft_impl)
    if window is None:
        window = hamming_window(n_fft, x.dtype, x.device)
    frames = frame_signal(x, n_fft, hop) * window
    if dft_impl == "matmul":
        return rdft_matmul(frames, n_fft)
    return torch.fft.rfft(frames, n=n_fft, dim=-1)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """OLA of [..., T, n_fft] frames at stride `hop` -> [..., (T-1)*hop + n_fft]."""
    *lead, num_frames, n_fft = frames.shape
    if n_fft % hop:
        raise ValueError("overlap-add requires hop | n_fft")
    ratio = n_fft // hop
    chunks = frames.reshape(*lead, num_frames, ratio, hop)
    out = frames.new_zeros((*lead, num_frames + ratio - 1, hop))
    for j in range(ratio):
        # chunk j of frame k lands in output slot k + j
        out[..., j : j + num_frames, :] += chunks[..., :, j, :]
    return out.reshape(*lead, (num_frames + ratio - 1) * hop)


def istft(
    spec: torch.Tensor,
    n_fft: int = 400,
    hop: int = 100,
    window: torch.Tensor | None = None,
    length: int | None = None,
    dft_impl: str = "fft",
) -> torch.Tensor:
    """Centered inverse STFT with window-square OLA normalization.

    spec: complex [..., T, F] -> [..., (T-1)*hop] (or `length` samples).
    Matches torch.istft(onesided=True, center=True).
    dft_impl: 'fft' (torch.fft.irfft) or 'matmul' (`irdft_matmul`).
    """
    _check_dft_impl(dft_impl)
    if window is None:
        window = hamming_window(n_fft, torch.float32, spec.device)
    num_frames = spec.shape[-2]
    if dft_impl == "matmul":
        frames = irdft_matmul(spec, n_fft) * window
    else:
        frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    y = _overlap_add(frames, hop)
    # window-square envelope, the same for every batch element
    norm = _overlap_add((window * window).expand(num_frames, n_fft), hop)
    y = y / norm
    pad = n_fft // 2
    out_len = (num_frames - 1) * hop if length is None else length
    return y[..., pad : pad + out_len]


def power_compress(spec: torch.Tensor, exponent: float = 0.3) -> torch.Tensor:
    """mag <- mag**exponent. complex [..., T, F] -> real [..., T, F, 2]."""
    re, im = spec.real, spec.imag
    mag = torch.sqrt(re * re + im * im)
    phase = torch.atan2(im, re)
    cmag = mag**exponent
    return torch.stack([cmag * torch.cos(phase), cmag * torch.sin(phase)], dim=-1)


def power_uncompress(
    re: torch.Tensor, im: torch.Tensor, exponent: float = 0.3
) -> torch.Tensor:
    """Invert power-law compression -> complex [..., T, F]."""
    mag = torch.sqrt(re * re + im * im)
    phase = torch.atan2(im, re)
    umag = mag ** (1.0 / exponent)
    return torch.complex(umag * torch.cos(phase), umag * torch.sin(phase))


def mag_pha_compress(spec: torch.Tensor, exponent: float = 0.3):
    """complex [..., T, F] -> (|X|**exponent, angle(X)), each real [..., T, F]:
    SEMamba's `mag_phase_stft` without its `addeps` option."""
    re, im = spec.real, spec.imag
    return torch.sqrt(re * re + im * im) ** exponent, torch.atan2(im, re)


def mag_pha_uncompress(mag: torch.Tensor, pha: torch.Tensor,
                       exponent: float = 0.3) -> torch.Tensor:
    """(compressed magnitude, phase) -> complex mag**(1/exponent) e^{i pha}."""
    umag = mag ** (1.0 / exponent)
    return torch.complex(umag * torch.cos(pha), umag * torch.sin(pha))


def rms_normalize(noisy: torch.Tensor, clean: torch.Tensor | None = None):
    """Scale by c = sqrt(L / sum(noisy^2)), computed from noisy only.

    Returns (noisy*c, c) or (noisy*c, clean*c, c); c has shape [..., 1].
    """
    length = noisy.shape[-1]
    c = torch.sqrt(length / torch.sum(noisy * noisy, dim=-1, keepdim=True))
    if clean is None:
        return noisy * c, c
    return noisy * c, clean * c, c
