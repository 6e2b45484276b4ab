"""TSCNet generator: dense dilated encoder, two-stage (time/freq)
conformer blocks, decoupled mask + complex decoders.

NCHW inside (`[B, C, T, F]`), with the CMGAN reference's module names so
its state_dict loads with strict=True. The public interface keeps the
JAX package's layout:

Input:  packed compressed spectrogram [B, T, F, 2] (re, im).
Output: (est_real, est_imag), each [B, T, F], float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cmgan_torch.config import ModelConfig
from cmgan_torch.models.conformer import ConformerBlock
from cmgan_torch.models.layers import Conv2d, InstanceNorm, PReLU, SubPixelConv


class DilatedDenseNet(nn.Module):
    """Densely connected dilated conv stack, time-causal.

    Layer i pads time (2^i before, 0 after) and frequency (1, 1), convs
    with kernel (2, 3) and time dilation 2^i over the concatenation
    [out_{i-1}, ..., out_0, x], then InstanceNorm and PReLU.
    """

    def __init__(self, depth: int = 4, channels: int = 64, compute_dtype=None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"conv{i + 1}", Conv2d(
                channels * (i + 1), channels, (2, 3), dilation=(2**i, 1),
                compute_dtype=compute_dtype,
            ))
            setattr(self, f"norm{i + 1}", InstanceNorm(channels))
            setattr(self, f"prelu{i + 1}", PReLU(channels))

    def forward(self, x):
        skip = x
        out = x
        for i in range(self.depth):
            y = F.pad(skip, (1, 1, 2**i, 0))
            y = getattr(self, f"conv{i + 1}")(y)
            y = getattr(self, f"norm{i + 1}")(y)
            out = getattr(self, f"prelu{i + 1}")(y)
            skip = torch.cat([out, skip], dim=1)
        return out


class DenseEncoder(nn.Module):
    """1x1 conv (3->C) + IN + PReLU -> DilatedDenseNet -> frequency
    downsample conv k=(1,3) stride (1,2) pad (0,1) + IN + PReLU. F 201 -> 101."""

    def __init__(self, in_channels: int = 3, channels: int = 64, depth: int = 4,
                 compute_dtype=None):
        super().__init__()
        cd = compute_dtype
        self.conv_1 = nn.Sequential(
            Conv2d(in_channels, channels, (1, 1), compute_dtype=cd),
            InstanceNorm(channels),
            PReLU(channels),
        )
        self.dilated_dense = DilatedDenseNet(depth, channels, cd)
        self.conv_2 = nn.Sequential(
            Conv2d(channels, channels, (1, 3), stride=(1, 2), padding=(0, 1), compute_dtype=cd),
            InstanceNorm(channels),
            PReLU(channels),
        )

    def forward(self, x):
        return self.conv_2(self.dilated_dense(self.conv_1(x)))


class TSCB(nn.Module):
    """Two-stage conformer block: a time conformer over [B*F, T, C], then a
    frequency conformer over [B*T, F, C], each with an outer residual."""

    def __init__(self, cfg: ModelConfig, compute_dtype=None):
        super().__init__()

        def block(attention_impl):
            return ConformerBlock(
                dim=cfg.num_channels, dim_head=cfg.dim_head, heads=cfg.attn_heads,
                ff_mult=cfg.ff_mult, conv_expansion_factor=cfg.conv_expansion_factor,
                conv_kernel_size=cfg.conv_kernel_size, attn_dropout=cfg.attn_dropout,
                ff_dropout=cfg.ff_dropout, conv_dropout=cfg.conv_dropout,
                max_pos_emb=cfg.max_rel_pos, attention_impl=attention_impl,
                compute_dtype=compute_dtype,
            )

        self.time_conformer = block(cfg.attention_impl)
        self.freq_conformer = block(cfg.attention_impl)

    def forward(self, x):
        b, c, t, f = x.shape
        xt = x.permute(0, 3, 2, 1).reshape(b * f, t, c)
        xt = self.time_conformer(xt) + xt
        xf = xt.reshape(b, f, t, c).transpose(1, 2).reshape(b * t, f, c)
        xf = self.freq_conformer(xf) + xf
        return xf.reshape(b, t, f, c).permute(0, 3, 1, 2)


class MaskDecoder(nn.Module):
    """DilatedDenseNet -> sub-pixel frequency upsample (x2) -> conv k=(1,2)
    C->1 -> IN + PReLU -> 1x1 conv -> per-frequency PReLU (init -0.25).
    Returns the magnitude mask [B, T, F]."""

    def __init__(self, num_features: int, channels: int = 64, depth: int = 4,
                 compute_dtype=None):
        super().__init__()
        cd = compute_dtype
        self.dense_block = DilatedDenseNet(depth, channels, cd)
        self.sub_pixel = SubPixelConv(channels, channels, (1, 3), 2, cd)
        self.conv_1 = Conv2d(channels, 1, (1, 2), compute_dtype=cd)
        self.norm = InstanceNorm(1)
        self.prelu = PReLU(1)
        self.final_conv = Conv2d(1, 1, (1, 1), compute_dtype=cd)
        # over frequency, the last axis of [B, T, F]
        self.prelu_out = PReLU(num_features, init=-0.25, dim=-1)

    def forward(self, x):
        x = self.sub_pixel(self.dense_block(x))
        x = self.prelu(self.norm(self.conv_1(x)))
        x = self.final_conv(x)[:, 0]
        return self.prelu_out(x)


class ComplexDecoder(nn.Module):
    """DilatedDenseNet -> sub-pixel frequency upsample (x2) -> IN + PReLU ->
    conv k=(1,2) C->2. Returns [B, 2, T, F]."""

    def __init__(self, channels: int = 64, depth: int = 4, compute_dtype=None):
        super().__init__()
        cd = compute_dtype
        self.dense_block = DilatedDenseNet(depth, channels, cd)
        self.sub_pixel = SubPixelConv(channels, channels, (1, 3), 2, cd)
        self.prelu = PReLU(channels)
        self.norm = InstanceNorm(channels)
        self.conv = Conv2d(channels, 2, (1, 2), compute_dtype=cd)

    def forward(self, x):
        x = self.sub_pixel(self.dense_block(x))
        return self.conv(self.prelu(self.norm(x)))


class TSCNet(nn.Module):
    """The CMGAN generator. `dtype` is the compute type of its convs,
    linears and attention (None or float32: float32; bfloat16: mixed, with
    norms and the softmax in float32)."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), dtype: torch.dtype | None = None):
        super().__init__()
        cd = None if dtype in (None, torch.float32) else dtype
        self.cfg = cfg
        self.dense_encoder = DenseEncoder(3, cfg.num_channels, cfg.dense_depth, cd)
        for i in range(cfg.num_tscb_blocks):
            setattr(self, f"TSCB_{i + 1}", TSCB(cfg, cd))
        self.mask_decoder = MaskDecoder(cfg.num_features, cfg.num_channels, cfg.dense_depth, cd)
        self.complex_decoder = ComplexDecoder(cfg.num_channels, cfg.dense_depth, cd)

    def forward(self, spec):
        # spec: [B, T, F, 2] compressed (re, im)
        spec = spec.float()
        re, im = spec[..., 0], spec[..., 1]
        mag = torch.sqrt(re * re + im * im)
        phase = torch.atan2(im, re)
        x = torch.stack([mag, re, im], dim=1)  # [B, 3, T, F]

        x = self.dense_encoder(x)
        for i in range(self.cfg.num_tscb_blocks):
            x = getattr(self, f"TSCB_{i + 1}")(x)

        out_mag = self.mask_decoder(x).float() * mag
        complex_out = self.complex_decoder(x).float()
        final_real = out_mag * torch.cos(phase) + complex_out[:, 0]
        final_imag = out_mag * torch.sin(phase) + complex_out[:, 1]
        return final_real, final_imag
