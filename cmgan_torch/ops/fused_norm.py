"""Single-pass fused LayerNorm over the last axis, and RMSNorm.

`fused_layernorm(x, scale, bias, eps)` normalises x [..., C] with fp32
statistics in the E[x^2] - E[x]^2 form, eps inside the rsqrt and an
fp32 affine, and returns x's dtype (fp32 or bf16), for any width C >= 1.
For CUDA tensors the forward is the hand-written kernel in
`csrc/fused_layernorm.cu`, on the path `plan` picks: rows held in
registers, 16 bytes a lane and load, where rows are whole 16-byte words
of at most 4 KB at aligned addresses (C = 64: 8 lanes a row in bf16, 16
in fp32); otherwise a block's run of rows copied through shared memory
in 16-byte words; rows wider than 48 KB a block each, in two passes. It
raises rather than fall back. For CPU tensors it is the plain version,
`_ln_reference`. The
backward is the plain closed formula on either device, as in the JAX
package.

The models reach the forward through `cmgan_torch.models.layers.LayerNorm`
on CUDA when autograd is not recording (enhancement, streaming,
validation): at x [518736, 64] fp32 the kernel took 0.095 ms against
`F.layer_norm`'s 0.750 on an H100 (PERF.md). Training keeps ATen's
LayerNorm for its fused backward.

`fused_rmsnorm(x, weight, eps)` is SEMamba's RMSNorm (x * rsqrt(E[x^2] +
eps) * weight), float32, forward only: one launch of its own kernel
(`csrc/fused_rmsnorm.cu`, a library apart, so CMGAN builds nothing of it)
for CUDA tensors, `_rms_reference` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from cmgan_torch.ops import _build

KERNEL = "fused_layernorm"
RMS_KERNEL = "fused_rmsnorm"

# Kernel launches; the wrapper adds one per launch. Callers reset to 0.
launches = 0
rms_launches = 0
# Calls the wrapper served with the plain version (CPU tensors).
plain_calls = 0

REGS_MAX_BYTES = 4096         # the widest row held in registers (32 lanes x 8 words)
SPAN_MAX_BYTES = 48 * 1024    # a span block's shared memory (csrc/fused_layernorm.cu)
SPAN_SLACK = 32               # ... of which the two ends' 16-byte lines may take this
# the rows a span block owns: 8 KB of them, at least 8 rows (measured on the
# H100 at C 63, 65 and 513: larger spans leave under one wave of blocks,
# whose loads, sums and stores then cannot overlap; PERF.md)
SPAN_TARGET_BYTES, SPAN_MIN_ROWS = 8 * 1024, 8


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel reads a row. path 'regs': `lanes` lanes share a row,
    each holding `chunks` 16-byte words of it, for `rows` rows at once;
    'span': a block owns `rows` rows, staged in shared memory; 'long': a
    block a row, two passes."""

    path: str
    lanes: int = 0
    chunks: int = 0
    rows: int = 1


PATH_CODES = {"regs": 0, "span": 1, "long": 2}


def plan(c: int, itemsize: int, aligned: bool) -> Plan:
    """The kernel's path for rows of c elements of itemsize bytes; aligned:
    x, y, scale and bias all start at 16-byte boundaries."""
    row_bytes = c * itemsize
    if aligned and row_bytes % 16 == 0 and row_bytes <= REGS_MAX_BYTES:
        words = row_bytes // 16
        if words <= 32:  # one word a lane, a power of two of lanes a row, 8 rows at once
            return Plan("regs", lanes=1 << (words - 1).bit_length(), chunks=1, rows=8)
        chunks = 2 if words <= 64 else 4 if words <= 128 else 8
        return Plan("regs", lanes=32, chunks=chunks, rows=8 // chunks)
    room = (SPAN_MAX_BYTES - SPAN_SLACK) // row_bytes  # rows a span block can hold
    if room >= 1:
        return Plan("span", rows=min(room, max(SPAN_MIN_ROWS, SPAN_TARGET_BYTES // row_bytes)))
    return Plan("long")


def _stats(x, eps: float):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    return xf, mean, torch.rsqrt(var + eps)


def _ln_reference(x, scale, bias, eps: float):
    """The plain version: same math and dtypes as the kernel."""
    xf, mean, rstd = _stats(x, eps)
    return ((xf - mean) * rstd * scale.float() + bias.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load(KERNEL)
    fn = lib.cmgan_fused_layernorm_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float] + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.cmgan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cmgan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, scale, bias):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: dtype {x.dtype}; the kernel takes float32 or bfloat16")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"x needs a last axis of at least 1; got {tuple(x.shape)}")
    c = x.shape[-1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (c,):
            raise ValueError(f"{name} {tuple(t.shape)}, expected {(c,)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _forward(x, scale, bias, eps: float):
    global launches, plain_calls
    if x.device.type == "cpu":
        plain_calls += 1
        return _ln_reference(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    if x.numel() == 0:
        return torch.empty_like(x)
    lib = _kernel()
    c = x.shape[-1]
    scale32, bias32 = scale.float().contiguous(), bias.float().contiguous()
    y = torch.empty_like(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, y, scale32, bias32))
    p = plan(c, x.element_size(), aligned)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.cmgan_fused_layernorm_fwd(
            x.data_ptr(), scale32.data_ptr(), bias32.data_ptr(), y.data_ptr(),
            x.numel() // c, c, eps, int(x.dtype == torch.bfloat16),
            PATH_CODES[p.path], p.lanes, p.chunks, p.rows, stream,
        )
    if rc != 0:
        msg = lib.cmgan_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_layernorm launch failed: CUDA error {rc} ({msg})")
    launches += 1
    return y


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        xf, mean, rstd = _stats(x, ctx.eps)
        gf = g.float()
        xhat = (xf - mean) * rstd
        gs = gf * scale.float()
        dx = rstd * (gs - gs.mean(dim=-1, keepdim=True)
                     - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
        lead = tuple(range(x.dim() - 1))
        dscale = (gf * xhat).sum(dim=lead)
        dbias = gf.sum(dim=lead)
        return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype), None


def fused_layernorm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last axis; x [..., C], scale and bias [C].

    Output dtype is x's (statistics and affine in fp32). Differentiable
    in x, scale and bias.
    """
    _check(x, scale, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        return _FusedLayerNorm.apply(x, scale, bias, float(eps))
    return _forward(x, scale, bias, float(eps))


def _rms_reference(x, weight, eps: float):
    """RMSNorm's plain version: the kernel's math."""
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * weight


@functools.lru_cache(maxsize=None)
def _rms_kernel():
    lib = _build.load(RMS_KERNEL)
    fn = lib.cmgan_fused_rmsnorm_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.cmgan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cmgan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_rmsnorm(x, weight, eps: float = 1e-5):
    """RMSNorm over the last axis: x [..., C] float32, weight [C]. Forward
    only. On CUDA, C a multiple of 4 up to 512 and x contiguous (else it
    raises)."""
    global rms_launches
    c = x.shape[-1]
    if x.dtype != torch.float32 or weight.shape != (c,):
        raise ValueError(f"x {x.dtype} {tuple(x.shape)}, weight {tuple(weight.shape)}: the "
                         "norm takes float32 x [..., C] and weight [C]")
    if x.device.type == "cpu":
        return _rms_reference(x, weight, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    w = weight.detach().float().contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _rms_kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.cmgan_fused_rmsnorm_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                         x.numel() // c, c, eps, stream)
    if rc != 0:
        msg = lib.cmgan_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_rmsnorm launch failed: CUDA error {rc} ({msg})")
    rms_launches += 1
    return y
