"""The reference's signal path in plain PyTorch: a centred STFT with a
periodic Hamming window (torch.stft), its inverse by overlap-add with
the window-square envelope divided out (F.fold), and CMGAN's power-law
compression of the magnitude."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def window(n_fft: int, device) -> torch.Tensor:
    return torch.hamming_window(n_fft, periodic=True, dtype=torch.float32, device=device)


def stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[B, L] -> complex [B, T, F], T = L // hop + 1."""
    spec = torch.stft(x, n_fft, hop, window=window(n_fft, x.device), center=True,
                      pad_mode="reflect", return_complex=True)
    return spec.transpose(1, 2)


def istft(spec: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """complex [B, T, F] -> [B, (T - 1) * hop]."""
    b, t, _ = spec.shape
    w = window(n_fft, spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * w
    total = (t - 1) * hop + n_fft

    def overlap_add(cols):  # [B, n_fft, T] -> [B, total]
        return F.fold(cols, (1, total), (1, n_fft), stride=(1, hop)).reshape(cols.shape[0], total)

    y = overlap_add(frames.transpose(1, 2))
    envelope = overlap_add((w * w)[None, :, None].expand(1, n_fft, t))
    return (y / envelope)[:, n_fft // 2: n_fft // 2 + (t - 1) * hop]


def compress(spec: torch.Tensor, exponent: float) -> torch.Tensor:
    """complex [..., T, F] -> [..., T, F, 2], the magnitude to the power."""
    mag, phase = spec.abs(), torch.atan2(spec.imag, spec.real)
    cmag = mag ** exponent
    return torch.stack([cmag * torch.cos(phase), cmag * torch.sin(phase)], dim=-1)


def uncompress(re: torch.Tensor, im: torch.Tensor, exponent: float) -> torch.Tensor:
    mag = torch.sqrt(re * re + im * im) ** (1.0 / exponent)
    phase = torch.atan2(im, re)
    return torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))


def enhance(model, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Segments [B, L] -> enhanced [B, (T - 1) * hop] through `model`."""
    n_fft, hop, e = cfg["n_fft"], cfg["hop"], cfg["compress_exponent"]
    re, im = model(compress(stft(x, n_fft, hop), e))
    return istft(uncompress(re, im, e), n_fft, hop)
