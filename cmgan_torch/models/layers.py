"""Shared layers and torch-default initialization.

Feature maps are NCHW (`[B, C, T, F]`: time on H, frequency on W) and
sequences `[N, T, C]`, as in the CMGAN reference, so parameter names and
shapes follow its state_dict layout.

`compute_dtype` mirrors the JAX package's `dtype`: convolutions and
linear layers cast their input and parameters to it (None keeps the
parameters' float32); norms always compute in float32 and return
float32, as flax's norms do when their parameters are float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def _cast(layer, x):
    dt = layer.compute_dtype or layer.weight.dtype
    w = layer.weight.to(dt)
    b = None if layer.bias is None else layer.bias.to(dt)
    return x.to(dt), w, b


class Linear(nn.Linear):
    def __init__(self, in_features, out_features, bias=True, compute_dtype=None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return F.linear(*_cast(self, x))


class Conv1d(nn.Conv1d):
    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return self._conv_forward(*_cast(self, x))


class Conv2d(nn.Conv2d):
    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return self._conv_forward(*_cast(self, x))


class InstanceNorm(nn.InstanceNorm2d):
    """InstanceNorm2d(affine=True): per (sample, channel) over T and F,
    biased variance, eps 1e-5, no running stats. float32 math."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, affine=True)

    def forward(self, x):
        return super().forward(x.float())


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, eps 1e-5, float32 math."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return super().forward(x.float())


class PReLU(nn.Module):
    """PReLU with one slope per entry of axis `dim` (nn.PReLU uses axis 1;
    the mask decoder's per-frequency PReLU acts on the last axis)."""

    def __init__(self, num_parameters: int = 1, init: float = 0.25, dim: int = 1):
        super().__init__()
        self.dim = dim
        self.init = init
        self.weight = nn.Parameter(torch.full((num_parameters,), init))

    def forward(self, x):
        shape = [1] * x.dim()
        shape[self.dim] = -1
        alpha = self.weight.reshape(shape)
        return torch.where(x >= 0, x, alpha * x)


class LearnableSigmoid(nn.Module):
    """beta * sigmoid(slope * x) with a learnable per-feature slope."""

    def __init__(self, in_features: int = 1, beta: float = 1.0):
        super().__init__()
        self.beta = beta
        self.slope = nn.Parameter(torch.ones(in_features))

    def forward(self, x):
        return self.beta * torch.sigmoid(self.slope * x)


class SubPixelConv(nn.Module):
    """Sub-pixel upsampling along frequency (the reference's
    SPConvTranspose2d): pad F by (1, 1), conv to r*C channels, and
    interleave out[b, c, t, f*r + j] = conv[b, j*C + c, t, f].
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(1, 3),
                 r: int = 2, compute_dtype=None):
        super().__init__()
        self.out_channels = out_channels
        self.r = r
        self.conv = Conv2d(in_channels, out_channels * r, kernel_size,
                           compute_dtype=compute_dtype)

    def forward(self, x):
        y = self.conv(F.pad(x, (1, 1, 0, 0)))
        b, _, t, f = y.shape
        y = y.reshape(b, self.r, self.out_channels, t, f).permute(0, 2, 3, 4, 1)
        return y.reshape(b, self.out_channels, t, f * self.r)


def swish(x):
    return x * torch.sigmoid(x)


@torch.no_grad()
def torch_default_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter with torch's default initializers from one
    seeded generator: conv/linear weights and biases U(+-1/sqrt(fan_in))
    (kaiming_uniform with a=sqrt(5)), embeddings N(0, 1), norms 1 / 0,
    PReLU slopes their `init`, BatchNorm running stats 0 / 1.
    """
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, (nn.LayerNorm, nn.InstanceNorm2d, nn.BatchNorm1d)):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
            if isinstance(m, nn.BatchNorm1d):
                m.reset_running_stats()
        elif isinstance(m, PReLU):
            m.weight.fill_(m.init)
        elif isinstance(m, LearnableSigmoid):
            m.slope.fill_(1.0)
    return module
