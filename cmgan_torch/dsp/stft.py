"""STFT / iSTFT front-end with torch.stft semantics, time-major.

n_fft=400, hop=100, periodic Hamming window, onesided, center=True
(reflect padding), normalized=False. Spectrograms are `[..., T, F]`
(torch.stft lays them out `[..., F, T]`), as in the JAX package.

The overlap-add in `istft` uses `n_fft % hop == 0`: each frame splits
into `n_fft // hop` hop-sized chunks and the OLA is a static sum of
shifted chunk streams, then the window-square envelope is divided out.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hamming_window(n_fft: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hamming window, identical to torch.hamming_window(n_fft)."""
    n = np.arange(n_fft)
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / n_fft)
    return torch.as_tensor(w, dtype=dtype, device=device)


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Center-pad (reflect) and slice into overlapping frames.

    x: [..., L] -> [..., T, n_fft] with T = L // hop + 1.
    """
    pad = n_fft // 2
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    xp = xp.reshape(*lead, xp.shape[-1])
    return xp.unfold(-1, n_fft, hop)


def _check_dft_impl(dft_impl: str):
    if dft_impl == "matmul":
        raise NotImplementedError(
            "dft_impl='matmul' belongs to seq-parallel training, not ported yet"
        )
    if dft_impl != "fft":
        raise ValueError(f"unknown dft_impl {dft_impl!r}")


def stft(
    x: torch.Tensor,
    n_fft: int = 400,
    hop: int = 100,
    window: torch.Tensor | None = None,
    dft_impl: str = "fft",
) -> torch.Tensor:
    """Onesided centered STFT. x: [..., L] -> complex [..., T, F]."""
    _check_dft_impl(dft_impl)
    if window is None:
        window = hamming_window(n_fft, x.dtype, x.device)
    frames = frame_signal(x, n_fft, hop) * window
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
    """
    _check_dft_impl(dft_impl)
    if window is None:
        window = hamming_window(n_fft, torch.float32, spec.device)
    num_frames = spec.shape[-2]
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


def rms_normalize(noisy: torch.Tensor, clean: torch.Tensor | None = None):
    """Scale by c = sqrt(L / sum(noisy^2)), computed from noisy only.

    Returns (noisy*c, c) or (noisy*c, clean*c, c); c has shape [..., 1].
    """
    length = noisy.shape[-1]
    c = torch.sqrt(length / torch.sum(noisy * noisy, dim=-1, keepdim=True))
    if clean is None:
        return noisy * c, c
    return noisy * c, clean * c, c
