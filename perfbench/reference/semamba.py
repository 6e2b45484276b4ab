"""SEMamba in plain PyTorch, float32: the benchmark's frozen reference for
the `semamba` architecture.

The generator as published (R. Chao et al., IEEE SLT 2024;
github.com/RoyChao19477/SEMamba, models/{generator,mamba_block,
codec_module}.py, with mamba_ssm's Mamba-1 mixer, pre-norm Block and
RMSNorm), with the module names of that code so that one state dict loads
into this model and into the program under test with strict=True, and its
signal path (models/stfts.py: `mag_phase_stft` without `addeps`,
`mag_phase_istft`). Nothing here imports the program.

The selective scan is mamba_ssm's `selective_scan_ref` written as a loop
over the length, with elementwise operations only: the work counter
(perfbench/work.py) therefore counts the projections and convolutions,
and the scan's own work is counted by formula (`perfbench.archs.semamba.
scan_work`). It runs in blocks of rows, so that its [rows, d_inner,
d_state] state fits beside the rest on one card.

Departure from the published code, which the program also makes: the dense
blocks skip their last concatenation, whose result nothing reads.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

ROW_BLOCK = 4096  # rows of a scan at a time


def window(n_fft: int, device) -> torch.Tensor:
    """The published window: torch.hann_window made on the CPU, then moved."""
    return torch.hann_window(n_fft).to(device)


def stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[B, L] -> complex [B, F, T] (torch.stft's layout), T = L // hop + 1."""
    return torch.stft(x, n_fft, hop, window=window(n_fft, x.device), center=True,
                      pad_mode="reflect", return_complex=True)


def istft(spec: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """complex [B, F, T] -> [B, (T - 1) * hop], by overlap-add with the
    window-square envelope divided out."""
    b, _, t = spec.shape
    w = window(n_fft, spec.device)
    frames = torch.fft.irfft(spec.transpose(1, 2), n=n_fft, dim=-1) * w
    total = (t - 1) * hop + n_fft

    def overlap_add(cols):  # [B, n_fft, T] -> [B, total]
        return F.fold(cols, (1, total), (1, n_fft), stride=(1, hop)).reshape(cols.shape[0], total)

    y = overlap_add(frames.transpose(1, 2))
    envelope = overlap_add((w * w)[None, :, None].expand(1, n_fft, t))
    return (y / envelope)[:, n_fft // 2: n_fft // 2 + (t - 1) * hop]


def selective_scan(u, delta, A, B, C, D, z, delta_bias):
    """mamba_ssm's selective_scan_ref with delta_softplus: u, delta, z [b, d,
    l]; A [d, n]; B, C [b, n, l]; D, delta_bias [d]. A loop over l. On the
    meta device (the work counter, which counts none of its elementwise
    operations) it returns the output's shape at once."""
    out = torch.empty_like(u)
    if u.is_meta:
        return out
    for lo in range(0, u.shape[0], ROW_BLOCK):
        rows = slice(lo, lo + ROW_BLOCK)
        dl = F.softplus(delta[rows] + delta_bias[:, None])
        uu, bb, cc = u[rows], B[rows], C[rows]
        h = uu.new_zeros(uu.shape[0], uu.shape[1], A.shape[1])
        ys = []
        for i in range(uu.shape[2]):
            h = torch.exp(dl[:, :, i, None] * A) * h \
                + (dl[:, :, i] * uu[:, :, i])[:, :, None] * bb[:, None, :, i]
            ys.append((h * cc[:, None, :, i]).sum(-1))
        y = torch.stack(ys, dim=2) + uu * D[:, None]
        out[rows] = y * F.silu(z[rows])
    return out


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight


class Mamba(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        c, n, k = m["hid_feature"], m["d_state"], m["d_conv"]
        d = m["expand"] * c
        r = math.ceil(c / 16) if m["dt_rank"] == "auto" else m["dt_rank"]
        self.d_inner, self.d_state, self.dt_rank = d, n, r
        self.in_proj = nn.Linear(c, 2 * d, bias=False)
        self.conv1d = nn.Conv1d(d, d, k, groups=d, padding=k - 1, bias=True)
        self.x_proj = nn.Linear(d, r + 2 * n, bias=False)
        self.dt_proj = nn.Linear(r, d, bias=True)
        self.A_log = nn.Parameter(torch.empty(d, n))
        self.D = nn.Parameter(torch.empty(d))
        self.out_proj = nn.Linear(d, c, bias=False)

    def forward(self, hidden):  # [b, l, c]
        length = hidden.shape[1]
        xz = self.in_proj(hidden).transpose(1, 2)  # [b, 2d, l]
        x, z = xz.chunk(2, dim=1)
        x = F.silu(self.conv1d(x)[..., :length])
        x_dbl = self.x_proj(x.transpose(1, 2))  # [b, l, r + 2n]
        dt, B, C = torch.split(x_dbl, [self.dt_rank, self.d_state, self.d_state], dim=-1)
        delta = self.dt_proj.weight @ dt.transpose(1, 2)  # [b, d, l]
        y = selective_scan(x, delta, -torch.exp(self.A_log), B.transpose(1, 2),
                           C.transpose(1, 2), self.D, z, self.dt_proj.bias)
        return self.out_proj(y.transpose(1, 2))


class Block(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        self.norm = RMSNorm(m["hid_feature"], m["norm_epsilon"])
        self.mixer = Mamba(m)

    def forward(self, x):
        return self.mixer(self.norm(x)) + x


class MambaBlock(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        self.forward_blocks = nn.ModuleList([Block(m)])
        self.backward_blocks = nn.ModuleList([Block(m)])

    def forward(self, x):
        xf, xb = x, torch.flip(x, [1])
        for layer in self.forward_blocks:
            xf = layer(xf)
        for layer in self.backward_blocks:
            xb = layer(xb)
        return torch.cat([xf, torch.flip(xb, [1])], dim=-1)


class TFMambaBlock(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        c = m["hid_feature"]
        self.time_mamba = MambaBlock(m)
        self.freq_mamba = MambaBlock(m)
        self.tlinear = nn.ConvTranspose1d(2 * c, c, 1, stride=1)
        self.flinear = nn.ConvTranspose1d(2 * c, c, 1, stride=1)

    def forward(self, x):
        b, c, t, f = x.shape
        x = x.permute(0, 3, 2, 1).contiguous().view(b * f, t, c)
        x = self.tlinear(self.time_mamba(x).permute(0, 2, 1)).permute(0, 2, 1) + x
        x = x.view(b, f, t, c).permute(0, 2, 1, 3).contiguous().view(b * t, f, c)
        x = self.flinear(self.freq_mamba(x).permute(0, 2, 1)).permute(0, 2, 1) + x
        return x.view(b, t, f, c).permute(0, 3, 1, 2)


def _conv_norm_prelu(cin: int, cout: int, kernel, **kw):
    return nn.Sequential(nn.Conv2d(cin, cout, kernel, **kw), nn.InstanceNorm2d(cout, affine=True),
                         nn.PReLU(cout))


class DenseBlock(nn.Module):
    def __init__(self, c: int, depth: int):
        super().__init__()
        self.dense_block = nn.ModuleList(
            _conv_norm_prelu(c * (i + 1), c, (3, 3), dilation=(2 ** i, 1), padding=(2 ** i, 1))
            for i in range(depth))

    def forward(self, x):
        skip = x
        for i, layer in enumerate(self.dense_block):
            x = layer(skip)
            if i + 1 < len(self.dense_block):
                skip = torch.cat([x, skip], dim=1)
        return x


class DenseEncoder(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        c = m["hid_feature"]
        self.dense_conv_1 = _conv_norm_prelu(m["input_channel"], c, (1, 1))
        self.dense_block = DenseBlock(c, m["dense_depth"])
        self.dense_conv_2 = _conv_norm_prelu(c, c, (1, 3), stride=(1, 2))

    def forward(self, x):
        return self.dense_conv_2(self.dense_block(self.dense_conv_1(x)))


class LearnableSigmoid2D(nn.Module):
    def __init__(self, in_features: int, beta: float):
        super().__init__()
        self.beta = beta
        self.slope = nn.Parameter(torch.ones(in_features, 1))

    def forward(self, x):  # [b, f, t]
        return self.beta * torch.sigmoid(self.slope * x)


class MagDecoder(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        c, out = m["hid_feature"], m["output_channel"]
        self.dense_block = DenseBlock(c, m["dense_depth"])
        self.mask_conv = nn.Sequential(
            nn.ConvTranspose2d(c, c, (1, 3), (1, 2)), nn.Conv2d(c, out, (1, 1)),
            nn.InstanceNorm2d(out, affine=True), nn.PReLU(out), nn.Conv2d(out, out, (1, 1)))
        self.lsigmoid = LearnableSigmoid2D(m["n_fft"] // 2 + 1, m["beta"])

    def forward(self, x):
        x = self.mask_conv(self.dense_block(x))  # [b, 1, t, f]
        x = self.lsigmoid(x[:, 0].transpose(1, 2))  # [b, f, t]
        return x.transpose(1, 2)[:, None]


class PhaseDecoder(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        c, out = m["hid_feature"], m["output_channel"]
        self.dense_block = DenseBlock(c, m["dense_depth"])
        self.phase_conv = nn.Sequential(nn.ConvTranspose2d(c, c, (1, 3), (1, 2)),
                                        nn.InstanceNorm2d(c, affine=True), nn.PReLU(c))
        self.phase_conv_r = nn.Conv2d(c, out, (1, 1))
        self.phase_conv_i = nn.Conv2d(c, out, (1, 1))

    def forward(self, x):
        x = self.phase_conv(self.dense_block(x))
        return torch.atan2(self.phase_conv_i(x), self.phase_conv_r(x))


class SEMamba(nn.Module):
    """(noisy_mag, noisy_pha) [B, F, T] -> (mag, pha, com): the published
    forward."""

    def __init__(self, m: dict):
        super().__init__()
        self.dense_encoder = DenseEncoder(m)
        self.TSMamba = nn.ModuleList(TFMambaBlock(m) for _ in range(m["num_tfmamba"]))
        self.mask_decoder = MagDecoder(m)
        self.phase_decoder = PhaseDecoder(m)

    def forward(self, noisy_mag, noisy_pha):
        noisy_mag = noisy_mag.transpose(1, 2)[:, None]  # [B, 1, T, F]
        noisy_pha = noisy_pha.transpose(1, 2)[:, None]
        x = self.dense_encoder(torch.cat([noisy_mag, noisy_pha], dim=1))
        for block in self.TSMamba:
            x = block(x)
        mag = (self.mask_decoder(x) * noisy_mag)[:, 0].transpose(1, 2)  # [B, F, T]
        pha = self.phase_decoder(x)[:, 0].transpose(1, 2)
        com = torch.stack([mag * torch.cos(pha), mag * torch.sin(pha)], dim=-1)
        return mag, pha, com


def enhance(model, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Segments [B, L] -> enhanced [B, (T - 1) * hop] through `model`:
    mag_phase_stft, the generator, mag_phase_istft."""
    n_fft, hop, e = cfg["n_fft"], cfg["hop"], cfg["compress_factor"]
    spec = stft(x, n_fft, hop)
    mag, pha, _ = model(torch.abs(spec) ** e, torch.angle(spec))
    mag = mag ** (1.0 / e)
    return istft(torch.complex(mag * torch.cos(pha), mag * torch.sin(pha)), n_fft, hop)


@torch.no_grad()
def seeded_state(module: nn.Module, seed: int, device) -> dict:
    """A state dict for `module` drawn from `seed` on `device` in two calls of
    a generator there (uniform draws, sliced): convolution and linear
    weights and biases U(+-1/sqrt(fan_in)), but each mixer's dt_proj bias,
    the inverse softplus of a delta log-uniform in [1e-3, 1e-1] (Mamba-1's
    init); A_log = log(1..d_state) on every channel and D = 1 (Mamba-1's);
    norms 1 (and 0), PReLU slopes 0.25, the sigmoid's slopes 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    uniform, dt_bias, fixed = [], [], {}
    for prefix, m in module.named_modules():
        p = prefix + "." if prefix else ""
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            for n, t in m.named_parameters(recurse=False):
                if p + n in dt_bias:
                    continue
                uniform.append((p + n, t.shape, bound))
        if isinstance(m, Mamba):
            dt_bias.append(p + "dt_proj.bias")
            n = m.d_state
            fixed[p + "A_log"] = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                                        device=device)).repeat(m.d_inner, 1)
            fixed[p + "D"] = torch.ones(m.d_inner, device=device)
        elif isinstance(m, (nn.InstanceNorm2d, RMSNorm)):
            fixed[p + "weight"] = torch.ones(m.weight.shape, device=device)
            if isinstance(m, nn.InstanceNorm2d):
                fixed[p + "bias"] = torch.zeros(m.bias.shape, device=device)
        elif isinstance(m, nn.PReLU):
            fixed[p + "weight"] = torch.full(m.weight.shape, 0.25, device=device)
        elif isinstance(m, LearnableSigmoid2D):
            fixed[p + "slope"] = torch.ones(m.slope.shape, device=device)
    out = dict(fixed)
    flat = torch.rand(sum(math.prod(s) for _, s, _ in uniform), generator=gen, device=device)
    at = 0
    for name, shape, bound in uniform:
        n = math.prod(shape)
        out[name] = (flat[at:at + n] * (2 * bound) - bound).reshape(shape)
        at += n
    d_inner = [module.get_submodule(name[: -len(".dt_proj.bias")]).d_inner for name in dt_bias]
    flat = torch.rand(sum(d_inner), generator=gen, device=device)
    lo, hi = math.log(1e-3), math.log(1e-1)
    at = 0
    for name, d in zip(dt_bias, d_inner):
        dt = torch.exp(flat[at:at + d] * (hi - lo) + lo).clamp(min=1e-4)
        out[name] = dt + torch.log(-torch.expm1(-dt))
        at += d
    missing = set(module.state_dict()) ^ set(out)
    if missing:
        raise ValueError(f"seeded_state does not cover {sorted(missing)}")
    return {k: out[k] for k in module.state_dict()}
