"""Metric discriminator: predicts the (normalized) PESQ of an enhanced
magnitude spectrogram given the clean one.

4x [spectral-norm conv k=4 s=2 p=1 (no bias) -> InstanceNorm -> PReLU]
with channels 2 -> ndf -> 2ndf -> 4ndf -> 8ndf, global max-pool,
SN-linear 8ndf -> 4ndf, dropout 0.3, PReLU, SN-linear -> 1, learnable
sigmoid. NCHW inside ([B, 2, T, F]); the interface takes the JAX
package's [B, T, F] magnitudes.

`SpectralNorm` keeps the state flax's `nn.SpectralNorm` keeps, so the
JAX package's discriminator variables carry over
(`convert.disc_state_dict_from_flax`) and one update leaves both in the
same state.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cmgan_torch.config import ModelConfig
from cmgan_torch.models.layers import Conv2d, InstanceNorm, LearnableSigmoid, Linear, PReLU


def _l2_normalize(x, eps: float):
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralNorm(nn.Module):
    """Divide a layer's weight by its largest singular value, estimated by
    one power-iteration step per call, as flax `nn.SpectralNorm` does.

    State: `u` [1, O], the running left vector, and `sigma`, the last
    estimate. Every call, in training or not, takes one step from the
    stored `u` and divides by the sigma it finds; only a call in training
    mode stores the new `u` and `sigma` (flax's `update_stats=True`).
    The weight [O, ...] is read as the matrix [prod(...), O], the output
    axis last; u, v carry no gradient, sigma = v W u^T does.
    """

    def __init__(self, layer: nn.Module, eps: float = 1e-12):
        super().__init__()
        self.layer = layer
        self.eps = eps
        self.register_buffer("u", torch.randn(1, layer.weight.shape[0]))
        self.register_buffer("sigma", torch.ones(()))

    @torch.no_grad()
    def reset_state(self, generator: torch.Generator):
        """u ~ N(0, 1) from `generator`, sigma = 1: flax's initial state."""
        self.u.normal_(0.0, 1.0, generator=generator)
        self.sigma.fill_(1.0)

    def normalized_weight(self):
        w = self.layer.weight
        mat = w.reshape(w.shape[0], -1).t()  # [I, O]
        with torch.no_grad():
            v = _l2_normalize(self.u @ mat.t(), self.eps)
            u = _l2_normalize(v @ mat, self.eps)
        sigma = (v @ mat @ u.t())[0, 0]
        if self.training:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x):
        layer = self.layer
        w = self.normalized_weight()
        dt = layer.compute_dtype or w.dtype
        bias = None if layer.bias is None else layer.bias.to(dt)
        if isinstance(layer, nn.Conv2d):
            return layer._conv_forward(x.to(dt), w.to(dt), bias)
        return F.linear(x.to(dt), w.to(dt), bias)


class MetricDiscriminator(nn.Module):
    """clean_mag, est_mag: [B, T, F] -> score [B, 1] in (0, 1). `dtype` is
    the compute type of the convs and linears (norms in float32)."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), dtype: torch.dtype | None = None):
        super().__init__()
        cd = None if dtype in (None, torch.float32) else dtype
        ndf = cfg.ndf
        channels = (2, ndf, 2 * ndf, 4 * ndf, 8 * ndf)
        for i in range(4):
            setattr(self, f"conv{i + 1}", SpectralNorm(Conv2d(
                channels[i], channels[i + 1], (4, 4), stride=(2, 2), padding=(1, 1),
                bias=False, compute_dtype=cd,
            )))
            setattr(self, f"norm{i + 1}", InstanceNorm(channels[i + 1]))
            setattr(self, f"prelu{i + 1}", PReLU(channels[i + 1]))
        self.fc1 = SpectralNorm(Linear(8 * ndf, 4 * ndf, compute_dtype=cd))
        self.dropout = nn.Dropout(cfg.disc_dropout)
        self.fc_prelu = PReLU(4 * ndf)
        self.fc2 = SpectralNorm(Linear(4 * ndf, 1, compute_dtype=cd))
        self.sigmoid = LearnableSigmoid(1)

    def forward(self, clean_mag, est_mag):
        x = torch.stack([clean_mag, est_mag], dim=1)  # [B, 2, T, F]
        for i in range(1, 5):
            x = getattr(self, f"conv{i}")(x)
            x = getattr(self, f"prelu{i}")(getattr(self, f"norm{i}")(x))
        x = x.amax(dim=(2, 3))  # AdaptiveMaxPool2d(1)
        x = self.fc_prelu(self.dropout(self.fc1(x)))
        return self.sigmoid(self.fc2(x))
