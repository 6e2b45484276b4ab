"""CMGAN in plain PyTorch, float32: the benchmark's frozen reference.

The generator (TSCNet) and the metric discriminator as published
(ruizhecao96/CMGAN, src/models/{generator,conformer,discriminator}.py),
with the module names of that code so that one state dict loads into
this model and into the program under test with strict=True. Attention
is dense (`dense_rel_attention`), computed in blocks of query groups
where the [G, T, T] logits would not fit. Nothing here imports the
program.

Departures from the published code, each one the program also makes:
- BatchNorm in training moves its running variance with the biased batch
  variance (flax's rule); it does not change a step's output;
- the spectral norm keeps flax's state (`u`, `sigma`) and takes one
  power-iteration step a call from the stored `u`;
- dropout acts on the attention's output after `to_out`.

The attention core, and the hook through which the work counter records
it, are perfbench/reference/attention.py.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.attention import dense_rel_attention


class PReLU(nn.Module):
    def __init__(self, n: int = 1, init: float = 0.25, dim: int = 1):
        super().__init__()
        self.dim = dim
        self.init = init
        self.weight = nn.Parameter(torch.full((n,), init))

    def forward(self, x):
        shape = [1] * x.dim()
        shape[self.dim] = -1
        return torch.where(x >= 0, x, self.weight.reshape(shape) * x)


class LearnableSigmoid(nn.Module):
    def __init__(self, n: int = 1, beta: float = 1.0):
        super().__init__()
        self.beta = beta
        self.slope = nn.Parameter(torch.ones(n))

    def forward(self, x):
        return self.beta * torch.sigmoid(self.slope * x)


def _norm(c):
    return nn.InstanceNorm2d(c, affine=True)


class DilatedDenseNet(nn.Module):
    def __init__(self, depth: int, channels: int):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"conv{i + 1}", nn.Conv2d(channels * (i + 1), channels, (2, 3),
                                                    dilation=(2 ** i, 1)))
            setattr(self, f"norm{i + 1}", _norm(channels))
            setattr(self, f"prelu{i + 1}", PReLU(channels))

    def forward(self, x):
        skip = x
        for i in range(self.depth):
            out = getattr(self, f"conv{i + 1}")(F.pad(skip, (1, 1, 2 ** i, 0)))
            out = getattr(self, f"prelu{i + 1}")(getattr(self, f"norm{i + 1}")(out))
            skip = torch.cat([out, skip], dim=1)
        return out


class DenseEncoder(nn.Module):
    def __init__(self, channels: int, depth: int):
        super().__init__()
        self.conv_1 = nn.Sequential(nn.Conv2d(3, channels, (1, 1)), _norm(channels),
                                    PReLU(channels))
        self.dilated_dense = DilatedDenseNet(depth, channels)
        self.conv_2 = nn.Sequential(nn.Conv2d(channels, channels, (1, 3), (1, 2), (0, 1)),
                                    _norm(channels), PReLU(channels))

    def forward(self, x):
        return self.conv_2(self.dilated_dense(self.conv_1(x)))


class Swish(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(x)


class Transpose(nn.Module):
    def forward(self, x):
        return x.transpose(1, 2)


class GLU(nn.Module):
    def forward(self, x):
        value, gate = x.chunk(2, dim=1)
        return value * torch.sigmoid(gate)


class DepthWiseConv1d(nn.Module):
    def __init__(self, channels: int, kernel: int):
        super().__init__()
        self.padding = (kernel // 2, kernel // 2 - (kernel + 1) % 2)
        self.conv = nn.Conv1d(channels, channels, kernel, groups=channels)

    def forward(self, x):
        return self.conv(F.pad(x, self.padding))


class BatchNorm(nn.BatchNorm1d):
    """Batch statistics in training (biased variance, E[x^2] - E[x]^2),
    running ones in eval; running stats move 0.1 towards the batch's."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=(0, 2))
        var = ((x * x).mean(dim=(0, 2)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(mean, alpha=0.1)
            self.running_var.mul_(0.9).add_(var, alpha=0.1)
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[None, :, None]) * mul[None, :, None] + self.bias[None, :, None]


class Scale(nn.Module):
    def __init__(self, scale: float, fn: nn.Module):
        super().__init__()
        self.scale = scale
        self.fn = fn

    def forward(self, x):
        return self.fn(x) * self.scale


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int, dropout: float):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, dim * mult), Swish(), nn.Dropout(dropout),
                                 nn.Linear(dim * mult, dim), nn.Dropout(dropout))

    def forward(self, x):
        return self.net(x)


class RelPosAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, dropout: float, max_pos: int):
        super().__init__()
        self.heads, self.dim_head, self.max_pos = heads, dim_head, max_pos
        self.to_q = nn.Linear(dim, heads * dim_head, bias=False)
        self.to_kv = nn.Linear(dim, 2 * heads * dim_head, bias=False)
        self.to_out = nn.Linear(heads * dim_head, dim)
        self.rel_pos_emb = nn.Embedding(2 * max_pos + 1, dim_head)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        q = self.to_q(x)
        k, v = self.to_kv(x).chunk(2, dim=-1)
        q, k, v = (t.reshape(b, n, h, d).transpose(1, 2).reshape(b * h, n, d) for t in (q, k, v))
        out = dense_rel_attention(q, k, v, self.rel_pos_emb.weight, self.max_pos)
        out = out.reshape(b, h, n, d).transpose(1, 2).reshape(b, n, h * d)
        return self.dropout(self.to_out(out))


class ConformerBlock(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        dim, inner = m["num_channels"], m["num_channels"] * m["conv_expansion_factor"]
        self.ff1 = Scale(0.5, PreNorm(dim, FeedForward(dim, m["ff_mult"], m["ff_dropout"])))
        self.attn = PreNorm(dim, RelPosAttention(dim, m["attn_heads"], m["dim_head"],
                                                 m["attn_dropout"], m["max_rel_pos"]))
        self.conv = _ConvModule(dim, inner, m["conv_kernel_size"], m["conv_dropout"])
        self.ff2 = Scale(0.5, PreNorm(dim, FeedForward(dim, m["ff_mult"], m["ff_dropout"])))
        self.post_norm = nn.LayerNorm(dim)

    def forward(self, x):
        x = x + self.ff1(x)
        x = x + self.attn(x)
        x = x + self.conv(x)
        x = x + self.ff2(x)
        return self.post_norm(x)


class _ConvModule(nn.Module):
    def __init__(self, dim: int, inner: int, kernel: int, dropout: float):
        super().__init__()
        self.net = nn.Sequential(
            nn.LayerNorm(dim), Transpose(), nn.Conv1d(dim, 2 * inner, 1), GLU(),
            DepthWiseConv1d(inner, kernel), BatchNorm(inner), Swish(),
            nn.Conv1d(inner, dim, 1), Transpose(), nn.Dropout(dropout))

    def forward(self, x):
        return self.net(x)


class TSCB(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        self.time_conformer = ConformerBlock(m)
        self.freq_conformer = ConformerBlock(m)

    def forward(self, x):
        b, c, t, f = x.shape
        xt = x.permute(0, 3, 2, 1).reshape(b * f, t, c)
        xt = self.time_conformer(xt) + xt
        xf = xt.reshape(b, f, t, c).transpose(1, 2).reshape(b * t, f, c)
        xf = self.freq_conformer(xf) + xf
        return xf.reshape(b, t, f, c).permute(0, 3, 1, 2)


class SPConvTranspose2d(nn.Module):
    """Sub-pixel upsampling along frequency by r."""

    def __init__(self, channels: int, r: int = 2):
        super().__init__()
        self.r, self.out_channels = r, channels
        self.conv = nn.Conv2d(channels, channels * r, (1, 3))

    def forward(self, x):
        y = self.conv(F.pad(x, (1, 1, 0, 0)))
        b, _, t, f = y.shape
        y = y.reshape(b, self.r, self.out_channels, t, f).permute(0, 2, 3, 4, 1)
        return y.reshape(b, self.out_channels, t, f * self.r)


class MaskDecoder(nn.Module):
    def __init__(self, bins: int, channels: int, depth: int):
        super().__init__()
        self.dense_block = DilatedDenseNet(depth, channels)
        self.sub_pixel = SPConvTranspose2d(channels)
        self.conv_1 = nn.Conv2d(channels, 1, (1, 2))
        self.norm = _norm(1)
        self.prelu = PReLU(1)
        self.final_conv = nn.Conv2d(1, 1, (1, 1))
        self.prelu_out = PReLU(bins, init=-0.25, dim=-1)

    def forward(self, x):
        x = self.sub_pixel(self.dense_block(x))
        x = self.final_conv(self.prelu(self.norm(self.conv_1(x))))[:, 0]
        return self.prelu_out(x)


class ComplexDecoder(nn.Module):
    def __init__(self, channels: int, depth: int):
        super().__init__()
        self.dense_block = DilatedDenseNet(depth, channels)
        self.sub_pixel = SPConvTranspose2d(channels)
        self.prelu = PReLU(channels)
        self.norm = _norm(channels)
        self.conv = nn.Conv2d(channels, 2, (1, 2))

    def forward(self, x):
        x = self.sub_pixel(self.dense_block(x))
        return self.conv(self.prelu(self.norm(x)))


class TSCNet(nn.Module):
    """spec [B, T, F, 2] (compressed re, im) -> (re, im), each [B, T, F]."""

    def __init__(self, m: dict):
        super().__init__()
        self.blocks = m["num_tscb_blocks"]
        c, depth = m["num_channels"], m["dense_depth"]
        self.dense_encoder = DenseEncoder(c, depth)
        for i in range(self.blocks):
            setattr(self, f"TSCB_{i + 1}", TSCB(m))
        self.mask_decoder = MaskDecoder(m["n_fft"] // 2 + 1, c, depth)
        self.complex_decoder = ComplexDecoder(c, depth)

    def forward(self, spec):
        re, im = spec[..., 0], spec[..., 1]
        mag = torch.sqrt(re * re + im * im)
        phase = torch.atan2(im, re)
        x = self.dense_encoder(torch.stack([mag, re, im], dim=1))
        for i in range(self.blocks):
            x = getattr(self, f"TSCB_{i + 1}")(x)
        out_mag = self.mask_decoder(x) * mag
        cplx = self.complex_decoder(x)
        return out_mag * torch.cos(phase) + cplx[:, 0], out_mag * torch.sin(phase) + cplx[:, 1]


def _l2_normalize(x, eps: float = 1e-12):
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralNorm(nn.Module):
    """The layer's weight over its largest singular value, one power step
    a call from the stored `u` (stored back in training)."""

    def __init__(self, layer: nn.Module):
        super().__init__()
        self.layer = layer
        self.register_buffer("u", torch.randn(1, layer.weight.shape[0]))
        self.register_buffer("sigma", torch.ones(()))

    def forward(self, x):
        w = self.layer.weight
        mat = w.reshape(w.shape[0], -1).t()
        with torch.no_grad():
            v = _l2_normalize(self.u @ mat.t())
            u = _l2_normalize(v @ mat)
        sigma = (v @ mat @ u.t())[0, 0]
        if self.training:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        w = w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        if isinstance(self.layer, nn.Conv2d):
            return self.layer._conv_forward(x, w, self.layer.bias)
        return F.linear(x, w, self.layer.bias)


class Discriminator(nn.Module):
    """(clean_mag, est_mag) [B, T, F] -> [B, 1] in (0, 1)."""

    def __init__(self, m: dict):
        super().__init__()
        ndf = m["ndf"]
        ch = (2, ndf, 2 * ndf, 4 * ndf, 8 * ndf)
        for i in range(4):
            setattr(self, f"conv{i + 1}", SpectralNorm(
                nn.Conv2d(ch[i], ch[i + 1], (4, 4), (2, 2), (1, 1), bias=False)))
            setattr(self, f"norm{i + 1}", _norm(ch[i + 1]))
            setattr(self, f"prelu{i + 1}", PReLU(ch[i + 1]))
        self.fc1 = SpectralNorm(nn.Linear(8 * ndf, 4 * ndf))
        self.dropout = nn.Dropout(m["disc_dropout"])
        self.fc_prelu = PReLU(4 * ndf)
        self.fc2 = SpectralNorm(nn.Linear(4 * ndf, 1))
        self.sigmoid = LearnableSigmoid(1)

    def forward(self, clean_mag, est_mag):
        x = torch.stack([clean_mag, est_mag], dim=1)
        for i in range(1, 5):
            x = getattr(self, f"conv{i}")(x)
            x = getattr(self, f"prelu{i}")(getattr(self, f"norm{i}")(x))
        x = self.fc_prelu(self.dropout(self.fc1(x.amax(dim=(2, 3)))))
        return self.sigmoid(self.fc2(x))


@torch.no_grad()
def seeded_state(module: nn.Module, seed: int, device) -> dict:
    """A state dict for `module` drawn from `seed` on `device` in two
    calls of a generator there (one uniform, one normal draw, sliced):
    convolution and linear weights and biases U(+-1/sqrt(fan_in)),
    embeddings and spectral-norm vectors N(0, 1), norms 1 and 0, PReLU
    slopes their init, the sigmoid's slope 1, running stats 0 and 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    uniform, normal, fixed = [], [], {}
    for prefix, m in module.named_modules():
        p = prefix + "." if prefix else ""
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            uniform += [(p + n, t.shape, bound) for n, t in m.named_parameters(recurse=False)]
        elif isinstance(m, nn.Embedding):
            normal.append((p + "weight", m.weight.shape))
        elif isinstance(m, SpectralNorm):
            normal.append((p + "u", m.u.shape))
            fixed[p + "sigma"] = torch.ones((), device=device)
        elif isinstance(m, (nn.LayerNorm, nn.InstanceNorm2d, nn.BatchNorm1d)):
            fixed[p + "weight"] = torch.ones(m.weight.shape, device=device)
            fixed[p + "bias"] = torch.zeros(m.bias.shape, device=device)
            if isinstance(m, nn.BatchNorm1d):
                fixed[p + "running_mean"] = torch.zeros(m.running_mean.shape, device=device)
                fixed[p + "running_var"] = torch.ones(m.running_var.shape, device=device)
                fixed[p + "num_batches_tracked"] = torch.zeros((), dtype=torch.long,
                                                               device=device)
        elif isinstance(m, PReLU):
            fixed[p + "weight"] = torch.full(m.weight.shape, m.init, device=device)
        elif isinstance(m, LearnableSigmoid):
            fixed[p + "slope"] = torch.ones(m.slope.shape, device=device)
    out = dict(fixed)
    flat = torch.rand(sum(math.prod(s) for _, s, _ in uniform), generator=gen, device=device)
    at = 0
    for name, shape, bound in uniform:
        n = math.prod(shape)
        out[name] = (flat[at:at + n] * (2 * bound) - bound).reshape(shape)
        at += n
    flat = torch.randn(sum(math.prod(s) for _, s in normal), generator=gen, device=device)
    at = 0
    for name, shape in normal:
        n = math.prod(shape)
        out[name] = flat[at:at + n].reshape(shape).clone()
        at += n
    missing = set(module.state_dict()) ^ set(out)
    if missing:
        raise ValueError(f"seeded_state does not cover {sorted(missing)}")
    return {k: out[k] for k in module.state_dict()}
