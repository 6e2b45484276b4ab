"""Conformer block: half-step FFNs, MHSA with Shaw relative positions,
and a depthwise-conv/GLU module, on sequences [N, T, C].

  x += 0.5*FF1(LN x); x += Attn(LN x); x += ConvModule(x); x += 0.5*FF2(LN x);
  x = LN(x)

Module nesting follows the CMGAN reference (lucidrains' conformer:
Scale / PreNorm wrappers, `conv.net.<i>` indices), so the state_dict keys
are the reference's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cmgan_torch.models.layers import Conv1d, LayerNorm, Linear, swish
from cmgan_torch.ops import flash_attention

FLASH_MIN_FRAMES = 512  # 'auto' takes the kernel from this sequence length


class Swish(nn.Module):
    def forward(self, x):
        return swish(x)


class GLU(nn.Module):
    """Value first, gate second, along `dim`."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        value, gate = x.chunk(2, dim=self.dim)
        return value * torch.sigmoid(gate)


class Transpose(nn.Module):
    """[N, T, C] <-> [N, C, T]."""

    def forward(self, x):
        return x.transpose(1, 2)


class DepthWiseConv1d(nn.Module):
    def __init__(self, channels: int, kernel_size: int, compute_dtype=None):
        super().__init__()
        pad = kernel_size // 2
        self.padding = (pad, pad - (kernel_size + 1) % 2)
        self.conv = Conv1d(channels, channels, kernel_size, groups=channels,
                           compute_dtype=compute_dtype)

    def forward(self, x):
        return self.conv(F.pad(x, self.padding))


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm1d over [N, C, T], float32 math (eval uses running stats)."""

    def forward(self, x):
        return super().forward(x.float())


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
        self.norm = LayerNorm(dim)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class FeedForward(nn.Module):
    """Linear d->mult*d, swish, dropout, Linear ->d, dropout."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0, compute_dtype=None):
        super().__init__()
        self.net = nn.Sequential(
            Linear(dim, dim * mult, compute_dtype=compute_dtype),
            Swish(),
            nn.Dropout(dropout),
            Linear(dim * mult, dim, compute_dtype=compute_dtype),
            nn.Dropout(dropout),
        )

    def forward(self, x):
        return self.net(x)


class RelPosAttention(nn.Module):
    """MHSA with Shaw relative positional embedding.

    pos[i, j] = q_i . E[clip(i - j, +-max_pos) + max_pos] * scale is added
    to the content logits. attention_impl: 'xla' computes dense logits;
    'flash' calls the fused kernel (ops/flash_attention.py); 'auto' takes
    flash from FLASH_MIN_FRAMES frames. Dropout acts on the output after
    to_out, never on the attention weights, so every impl computes the
    same function.
    """

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 16,
                 dropout: float = 0.0, max_pos_emb: int = 512,
                 attention_impl: str = "auto", compute_dtype=None):
        super().__init__()
        if attention_impl == "seq":
            raise NotImplementedError(
                "attention_impl='seq' (sequence-parallel attention) is not ported yet"
            )
        if attention_impl not in ("xla", "flash", "auto"):
            raise ValueError(f"unknown attention_impl {attention_impl!r}")
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.max_pos_emb = max_pos_emb
        self.attention_impl = attention_impl
        self.compute_dtype = compute_dtype
        self.to_q = Linear(dim, inner, bias=False, compute_dtype=compute_dtype)
        self.to_kv = Linear(dim, 2 * inner, bias=False, compute_dtype=compute_dtype)
        self.to_out = Linear(inner, dim, compute_dtype=compute_dtype)
        self.rel_pos_emb = nn.Embedding(2 * max_pos_emb + 1, dim_head)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        scale = d**-0.5
        q = self.to_q(x)
        k, v = self.to_kv(x).chunk(2, dim=-1)
        q, k, v = (t.reshape(b, n, h, d).transpose(1, 2) for t in (q, k, v))
        table = self.rel_pos_emb.weight

        use_flash = self.attention_impl == "flash" or (
            self.attention_impl == "auto" and n >= FLASH_MIN_FRAMES
        )
        if use_flash:
            compute = self.compute_dtype or torch.float32
            # the kernel adds q.k and q.E with no scale of its own: the
            # pre-scaled q carries the one softmax scale for both terms,
            # so the table goes in unscaled
            qs = (q * scale).to(compute).reshape(b * h, n, d).contiguous()
            ks = k.to(compute).reshape(b * h, n, d).contiguous()
            vs = v.to(compute).reshape(b * h, n, d).contiguous()
            out = flash_attention.flash_rel_attention(
                qs, ks, vs, table.to(compute).contiguous(), self.max_pos_emb
            ).reshape(b, h, n, d)
        else:
            logits = torch.einsum("bhid,bhjd->bhij", q, k) * scale
            pos = torch.arange(n, device=x.device)
            dist = (pos[:, None] - pos[None, :]).clamp(
                -self.max_pos_emb, self.max_pos_emb
            ) + self.max_pos_emb
            rel_emb = table[dist].to(q.dtype)  # [n, n, d]
            logits = logits + torch.einsum("bhid,ijd->bhij", q, rel_emb) * scale
            # softmax in float32 also under bf16: a bf16 exp/normalize
            # visibly skews the attention weights
            attn = torch.softmax(logits.float(), dim=-1)
            out = torch.einsum("bhij,bhjd->bhid", attn.to(v.dtype), v)

        out = out.transpose(1, 2).reshape(b, n, h * d)
        return self.dropout(self.to_out(out))


class ConformerConvModule(nn.Module):
    """LN -> pointwise conv (2x expansion) -> GLU -> depthwise conv k=31
    -> BatchNorm -> swish -> pointwise conv -> dropout."""

    def __init__(self, dim: int, expansion_factor: int = 2, kernel_size: int = 31,
                 dropout: float = 0.0, compute_dtype=None):
        super().__init__()
        inner = dim * expansion_factor
        self.net = nn.Sequential(
            LayerNorm(dim),
            Transpose(),
            Conv1d(dim, 2 * inner, 1, compute_dtype=compute_dtype),
            GLU(dim=1),
            DepthWiseConv1d(inner, kernel_size, compute_dtype=compute_dtype),
            BatchNorm(inner, eps=1e-5),
            Swish(),
            Conv1d(inner, dim, 1, compute_dtype=compute_dtype),
            Transpose(),
            nn.Dropout(dropout),
        )

    def forward(self, x):
        return self.net(x)


class ConformerBlock(nn.Module):
    def __init__(self, dim: int, dim_head: int = 16, heads: int = 4, ff_mult: int = 4,
                 conv_expansion_factor: int = 2, conv_kernel_size: int = 31,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 conv_dropout: float = 0.0, max_pos_emb: int = 512,
                 attention_impl: str = "auto", compute_dtype=None):
        super().__init__()
        cd = compute_dtype
        self.ff1 = Scale(0.5, PreNorm(dim, FeedForward(dim, ff_mult, ff_dropout, cd)))
        self.attn = PreNorm(dim, RelPosAttention(
            dim, heads=heads, dim_head=dim_head, dropout=attn_dropout,
            max_pos_emb=max_pos_emb, attention_impl=attention_impl, compute_dtype=cd,
        ))
        self.conv = ConformerConvModule(dim, conv_expansion_factor, conv_kernel_size,
                                        conv_dropout, cd)
        self.ff2 = Scale(0.5, PreNorm(dim, FeedForward(dim, ff_mult, ff_dropout, cd)))
        self.post_norm = LayerNorm(dim)

    def forward(self, x):
        x = x + self.ff1(x)
        x = x + self.attn(x)
        x = x + self.conv(x)
        x = x + self.ff2(x)
        return self.post_norm(x)
