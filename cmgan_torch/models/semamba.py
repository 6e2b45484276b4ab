"""SEMamba's generator (Chao et al., "An Investigation of Incorporating
Mamba for Speech Enhancement", IEEE SLT 2024; github.com/RoyChao19477/SEMamba,
models/{generator,mamba_block,codec_module}.py): MP-SENet's dense
magnitude/phase codec around TF-Mamba blocks.

Input:  [B, 2, T, F], the compressed magnitude |X|**0.3 and the phase
        angle(X) of the STFT, stacked.
Output: (magnitude, phase), each [B, T, F], float32: the compressed
        magnitude (the mask times the input's) and the phase, atan2 of the
        phase decoder's two outputs.

NCHW inside (`[B, C, T, F]`), with the published module names, so that a
published state dict loads with strict=True:

- dense_encoder: 1x1 conv (2 -> C), InstanceNorm, PReLU; a DenseBlock of
  depth 4 (layer i: a 3x3 conv with time dilation 2^i and padding (2^i, 1)
  over the concatenation of every earlier output and the input, newest
  first; InstanceNorm, PReLU); a (1, 3) conv at stride (1, 2) (F 201 ->
  100), InstanceNorm, PReLU;
- TSMamba.{i} (TF-Mamba blocks): x <- tlinear(BiMamba_t(x)) + x over
  [B*F', T, C], then x <- flinear(BiMamba_f(x)) + x over [B*T, F', C].
  BiMamba(x) = [M_fwd(x), flip(M_bwd(flip(x)))] on channels, M(x) = x +
  Mamba(RMSNorm(x)); tlinear and flinear are 1x1 ConvTranspose1d (2C -> C);
- Mamba (mamba_ssm's Mamba-1): in_proj (C -> 2 d_inner, no bias) into u
  and z; u <- SiLU(causal depthwise conv1d(u)); x_proj (d_inner -> R + 2N,
  no bias) into dt, B, C; delta = softplus(dt_proj(dt)); the selective scan
  with A = -exp(A_log) and the skip D; y * SiLU(z); out_proj (d_inner -> C);
- mask_decoder: a DenseBlock, a (1, 3) ConvTranspose2d at stride (1, 2)
  (back to 201 bins), a 1x1 conv (C -> 1), InstanceNorm, PReLU, a 1x1 conv,
  then beta * sigmoid(slope[f] * x), times the input magnitude;
- phase_decoder: a DenseBlock, the ConvTranspose2d, InstanceNorm, PReLU,
  then atan2 of two 1x1 convs (imaginary, real).

The backward direction runs on the sequence as it lies: the convolution and
the scan take `reverse` (ops/selective_scan.py), which is the flip, the
layer, and the flip back, with no copies. The dense blocks skip the
published code's last concatenation, whose result nothing reads. The
convolution, the scan and RMSNorm are the port's kernels on CUDA
(`ops.selective_scan`, `ops.fused_norm.fused_rmsnorm`), their plain versions
on the CPU. float32 only, inference only.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from cmgan_torch.config import SEMambaConfig
from cmgan_torch.models.layers import Conv2d, InstanceNorm, PReLU, torch_default_init_
from cmgan_torch.ops.fused_norm import fused_rmsnorm
from cmgan_torch.ops.selective_scan import causal_conv1d_silu, selective_scan
from cmgan_torch.utils.profiling import span


class DenseBlock(nn.Module):
    """Layer i: a 3x3 conv with time dilation 2^i, zero padding (2^i, 1).
    Where the dilation is over 1 the padding is made by F.pad and the conv
    runs unpadded, the same sums: cuDNN then takes its implicit-GEMM kernel,
    about 1.6x faster on the H100 at the codec's shapes than the kernel it
    picks for a padded dilated conv (PERF.md)."""

    def __init__(self, channels: int, depth: int = 4):
        super().__init__()
        self.dense_block = nn.ModuleList(
            nn.Sequential(Conv2d(channels * (i + 1), channels, (3, 3), dilation=(2 ** i, 1),
                                 padding=(1, 1) if i == 0 else 0),
                          InstanceNorm(channels), PReLU(channels))
            for i in range(depth))

    def forward(self, x):
        skip = x
        for i, layer in enumerate(self.dense_block):
            x = layer(skip if i == 0 else F.pad(skip, (1, 1, 2 ** i, 2 ** i)))
            if i + 1 < len(self.dense_block):
                skip = torch.cat([x, skip], dim=1)
        return x


class DenseEncoder(nn.Module):
    def __init__(self, cfg: SEMambaConfig):
        super().__init__()
        c = cfg.hid_feature
        self.dense_conv_1 = nn.Sequential(Conv2d(cfg.input_channel, c, (1, 1)), InstanceNorm(c),
                                          PReLU(c))
        self.dense_block = DenseBlock(c, cfg.dense_depth)
        self.dense_conv_2 = nn.Sequential(Conv2d(c, c, (1, 3), stride=(1, 2)), InstanceNorm(c),
                                          PReLU(c))

    def forward(self, x):
        return self.dense_conv_2(self.dense_block(self.dense_conv_1(x)))


class LearnableSigmoid2D(nn.Module):
    """beta * sigmoid(slope[f] * x) over the last axis of [..., F]; the
    published slope is [F, 1]."""

    def __init__(self, num_features: int, beta: float):
        super().__init__()
        self.beta = beta
        self.slope = nn.Parameter(torch.ones(num_features, 1))

    def forward(self, x):
        return self.beta * torch.sigmoid(self.slope[:, 0] * x)


class MagDecoder(nn.Module):
    def __init__(self, cfg: SEMambaConfig):
        super().__init__()
        c, out = cfg.hid_feature, cfg.output_channel
        self.dense_block = DenseBlock(c, cfg.dense_depth)
        self.mask_conv = nn.Sequential(
            nn.ConvTranspose2d(c, c, (1, 3), (1, 2)), Conv2d(c, out, (1, 1)), InstanceNorm(out),
            PReLU(out), Conv2d(out, out, (1, 1)))
        self.lsigmoid = LearnableSigmoid2D(cfg.num_features, cfg.beta)

    def forward(self, x):
        return self.lsigmoid(self.mask_conv(self.dense_block(x)))


class PhaseDecoder(nn.Module):
    def __init__(self, cfg: SEMambaConfig):
        super().__init__()
        c, out = cfg.hid_feature, cfg.output_channel
        self.dense_block = DenseBlock(c, cfg.dense_depth)
        self.phase_conv = nn.Sequential(nn.ConvTranspose2d(c, c, (1, 3), (1, 2)), InstanceNorm(c),
                                        PReLU(c))
        self.phase_conv_r = Conv2d(c, out, (1, 1))
        self.phase_conv_i = Conv2d(c, out, (1, 1))

    def forward(self, x):
        x = self.phase_conv(self.dense_block(x))
        return torch.atan2(self.phase_conv_i(x), self.phase_conv_r(x))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return fused_rmsnorm(x.contiguous(), self.weight, self.eps)


class Mamba(nn.Module):
    """mamba_ssm's Mamba-1 mixer on h [rows, L, d_model]; `reverse` scans
    from the last step to the first (the mixer of the flipped rows, flipped
    back)."""

    def __init__(self, cfg: SEMambaConfig):
        super().__init__()
        c, d, n, r = cfg.hid_feature, cfg.d_inner, cfg.d_state, cfg.rank
        self.d_inner, self.d_state, self.dt_rank = d, n, r
        self.in_proj = nn.Linear(c, 2 * d, bias=False)
        self.conv1d = nn.Conv1d(d, d, cfg.d_conv, groups=d, padding=cfg.d_conv - 1)
        self.x_proj = nn.Linear(d, r + 2 * n, bias=False)
        self.dt_proj = nn.Linear(r, d)
        self.A_log = nn.Parameter(torch.log(torch.arange(1, n + 1, dtype=torch.float32)).repeat(d, 1))
        self.D = nn.Parameter(torch.ones(d))
        self.out_proj = nn.Linear(d, c, bias=False)

    @torch.no_grad()
    def mamba_init_(self, generator: torch.Generator):
        """Mamba-1's own init of A_log, D and dt_proj's bias (the inverse
        softplus of a delta log-uniform in [1e-3, 1e-1])."""
        n = self.d_state
        self.A_log.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32)).repeat(
            self.d_inner, 1))
        self.D.fill_(1.0)
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(torch.rand(self.d_inner, generator=generator) * (hi - lo) + lo)
        dt = dt.clamp(min=1e-4)
        self.dt_proj.bias.copy_(dt + torch.log(-torch.expm1(-dt)))

    def forward(self, h, reverse: bool = False):
        d, n, r = self.d_inner, self.d_state, self.dt_rank
        xz = F.linear(h, self.in_proj.weight)
        u = causal_conv1d_silu(xz[..., :d], self.conv1d.weight, self.conv1d.bias, reverse)
        x_dbl = F.linear(u, self.x_proj.weight)
        y = selective_scan(u, x_dbl[..., :r], self.dt_proj.weight, self.dt_proj.bias,
                           -torch.exp(self.A_log), x_dbl[..., r:r + n], x_dbl[..., r + n:],
                           self.D, xz[..., d:], reverse)
        return F.linear(y, self.out_proj.weight)


class Block(nn.Module):
    """x + Mamba(RMSNorm(x)): mamba_ssm's pre-norm Block."""

    def __init__(self, cfg: SEMambaConfig):
        super().__init__()
        self.norm = RMSNorm(cfg.hid_feature, cfg.norm_epsilon)
        self.mixer = Mamba(cfg)

    def forward(self, x, reverse: bool = False):
        return x + self.mixer(self.norm(x), reverse)


class MambaBlock(nn.Module):
    """BiMamba: [forward layers over x, backward layers over x reversed]
    concatenated on channels; one layer each way (`n_layer` 1)."""

    def __init__(self, cfg: SEMambaConfig):
        super().__init__()
        self.forward_blocks = nn.ModuleList([Block(cfg)])
        self.backward_blocks = nn.ModuleList([Block(cfg)])

    def forward(self, x):
        xf, xb = x, x
        for layer in self.forward_blocks:
            xf = layer(xf)
        for layer in self.backward_blocks:
            xb = layer(xb, reverse=True)
        return torch.cat([xf, xb], dim=-1)


def _join(linear: nn.ConvTranspose1d, x):
    """A 1x1 ConvTranspose1d over the channels of x [rows, L, 2C]."""
    return F.linear(x, linear.weight[:, :, 0].t(), linear.bias)


class TFMambaBlock(nn.Module):
    def __init__(self, cfg: SEMambaConfig):
        super().__init__()
        c = cfg.hid_feature
        self.time_mamba = MambaBlock(cfg)
        self.freq_mamba = MambaBlock(cfg)
        self.tlinear = nn.ConvTranspose1d(2 * c, c, 1)
        self.flinear = nn.ConvTranspose1d(2 * c, c, 1)

    def forward(self, x):
        b, c, t, f = x.shape
        with span("cmgan.model.time_mamba"):
            xt = x.permute(0, 3, 2, 1).reshape(b * f, t, c)
            xt = _join(self.tlinear, self.time_mamba(xt)) + xt
        with span("cmgan.model.freq_mamba"):
            xf = xt.reshape(b, f, t, c).transpose(1, 2).reshape(b * t, f, c)
            xf = _join(self.flinear, self.freq_mamba(xf)) + xf
        return xf.reshape(b, t, f, c).permute(0, 3, 1, 2)


class SEMamba(nn.Module):
    """The generator (module docstring). `dtype` None or float32: the
    scan's kernel is float32 alone."""

    # inference.enhance_tensor feeds it (compressed magnitude, phase)
    mag_pha = True

    def __init__(self, cfg: SEMambaConfig = SEMambaConfig(), dtype: torch.dtype | None = None):
        super().__init__()
        if dtype not in (None, torch.float32):
            raise ValueError(f"SEMamba runs in float32 alone; dtype {dtype}")
        self.cfg = cfg
        self.dense_encoder = DenseEncoder(cfg)
        self.TSMamba = nn.ModuleList(TFMambaBlock(cfg) for _ in range(cfg.num_tfmamba))
        self.mask_decoder = MagDecoder(cfg)
        self.phase_decoder = PhaseDecoder(cfg)

    @torch.no_grad()
    def seeded_init_(self, generator: torch.Generator):
        """Weights drawn from `generator`: torch's defaults, then every
        mixer's A_log, D and dt_proj bias as Mamba-1 draws them."""
        torch_default_init_(self, generator)
        for m in self.modules():
            if isinstance(m, Mamba):
                m.mamba_init_(generator)

    def forward(self, x):
        # x: [B, 2, T, F], the compressed magnitude and the phase
        with span("cmgan.model.encoder"):
            x = x.float()
            mag = x[:, 0]
            h = self.dense_encoder(x)
        for block in self.TSMamba:
            h = block(h)
        with span("cmgan.model.mask_decoder"):
            mag = self.mask_decoder(h)[:, 0] * mag
        with span("cmgan.model.phase_decoder"):
            pha = self.phase_decoder(h)[:, 0]
        return mag, pha
