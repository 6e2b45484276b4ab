"""Single-pass fused LayerNorm over the last axis.

`fused_layernorm(x, scale, bias, eps)` normalises x [..., C] with fp32
statistics in the E[x^2] - E[x]^2 form, eps inside the rsqrt and an
fp32 affine, and returns x's dtype (fp32 or bf16), for any width C >= 1.
For CUDA tensors the forward is the hand-written kernel in
`csrc/fused_layernorm.cu` (one warp a row; x read once and y written
once for an even C up to 512, two passes over the row otherwise) or it
raises; for CPU tensors it is the plain version, `_ln_reference`. The
backward is the plain closed formula on either device, as in the JAX
package.

The op is not wired into the models: they use
`cmgan_torch.models.layers.LayerNorm`. Whether the kernel should take
its place is decided by its measured time against `F.layer_norm`
(PERF.md).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cmgan_torch.ops import _build

KERNEL = "fused_layernorm"

# Kernel launches; the wrapper adds one per launch. Callers reset to 0.
launches = 0
# Calls the wrapper served with the plain version (CPU tensors).
plain_calls = 0


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
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_void_p]
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
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.cmgan_fused_layernorm_fwd(
            x.data_ptr(), scale32.data_ptr(), bias32.data_ptr(), y.data_ptr(),
            x.numel() // c, c, eps, int(x.dtype == torch.bfloat16), stream,
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
    return _FusedLayerNorm.apply(x, scale, bias, float(eps))
