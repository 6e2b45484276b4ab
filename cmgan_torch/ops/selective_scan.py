"""Mamba-1's selective scan and its causal depthwise convolution, forward.

`selective_scan(u, dt, dt_weight, dt_bias, A, B, C, D, z, reverse)` takes
one direction of a Mamba-1 layer's scan over rows [rows, L, ...]:

    delta_t = softplus(dt_t @ dt_weight.T + dt_bias)          [rows, L, D]
    h_t     = exp(delta_t[:, None] * A) * h_{t-1} + (delta_t * u_t)[:, None] * B_t[None]
    y_t     = (h_t @ C_t + D * u_t) * silu(z_t)

with h of [D, N] a row, zero before the first step. reverse=True scans
from the last step to the first and writes each y_t in place: the scan of
the flipped rows, flipped back. `causal_conv1d_silu(x, weight, bias,
reverse)` is the depthwise convolution with d_conv - 1 steps of zeros before
each row (after it, reverse), then SiLU. Both return contiguous [rows, L, D]
float32 and read their operands in place: any [rows, L, X] layout with unit
stride along X (the in-projection's halves, the x-projection's thirds).

For CUDA tensors both are the hand-written kernels of
`csrc/selective_scan.cu` (built at first use): a warp walks each row and
group of 32 channels in chunks of 32 steps, the state in registers. For
CPU tensors the plain versions below, sequential over the length. There is
no fallback: on CUDA a shape the kernel does not take raises.
Inference only: no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from cmgan_torch.ops import _build

KERNEL = "selective_scan"
# the scan kernel's name in a profiler's trace (scan_roofline.enhance reads it)
SCAN_KERNELS = ("selective_scan_fwd",)

# Launches of the scan and of the convolution; the wrappers add one per
# launch. Callers reset to 0.
launches = 0
conv_launches = 0

D_STATE = 16     # the states a channel the kernel holds in registers
MAX_RANK = 8     # the widest dt_rank it takes
D_BLOCK = 128    # d_inner must be a multiple of it (4 groups of 32 channels a block)
D_CONV = 4       # the convolution's width it takes


def _scan_plain(u, dt, dt_weight, dt_bias, A, B, C, D, z, reverse):
    delta = F.softplus(F.linear(dt, dt_weight, dt_bias))
    rows, length, d = u.shape
    h = u.new_zeros(rows, d, A.shape[1])
    y = torch.empty_like(u)
    for t in (range(length - 1, -1, -1) if reverse else range(length)):
        h = torch.exp(delta[:, t, :, None] * A) * h \
            + (delta[:, t] * u[:, t])[:, :, None] * B[:, t, None, :]
        y[:, t] = (h * C[:, t, None, :]).sum(-1) + D * u[:, t]
    return y * F.silu(z)


def _conv_plain(x, weight, bias, reverse):
    k = weight.shape[-1]
    xt = x.transpose(1, 2)
    if reverse:
        xt = xt.flip(-1)
    y = F.conv1d(F.pad(xt, (k - 1, 0)), weight.reshape(-1, 1, k), bias, groups=xt.shape[1])
    if reverse:
        y = y.flip(-1)
    return F.silu(y).transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load(KERNEL)
    lib.cmgan_selective_scan_fwd.argtypes = (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 5
        + [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.cmgan_selective_scan_fwd.restype = ctypes.c_int
    lib.cmgan_causal_conv1d_silu.argtypes = (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_void_p] * 3
        + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.cmgan_causal_conv1d_silu.restype = ctypes.c_int
    lib.cmgan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cmgan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _operand(name, t, rows, length, device):
    """(pointer, row stride, step stride) of a [rows, L, X] float32 operand."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}; the kernels take float32")
    if t.device != device or t.dim() != 3 or t.shape[:2] != (rows, length):
        raise ValueError(f"{name}: {tuple(t.shape)} on {t.device}; expected [{rows}, {length}, "
                         f"...] on {device}")
    if t.stride(2) != 1:
        raise ValueError(f"{name} needs unit stride along its last axis; strides {t.stride()}")
    return [t.data_ptr(), t.stride(0), t.stride(1)]


def _raise_on(rc, lib, what):
    if rc != 0:
        msg = lib.cmgan_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def selective_scan(u, dt, dt_weight, dt_bias, A, B, C, D, z, reverse: bool = False):
    """One direction of Mamba-1's scan (module docstring). u, z [rows, L,
    d_inner]; dt [rows, L, R]; B, C [rows, L, N]; dt_weight [d_inner, R];
    dt_bias, D [d_inner]; A [d_inner, N] (negative: -exp(A_log)). Returns y
    [rows, L, d_inner], contiguous float32."""
    global launches
    rows, length, d = u.shape
    n, r = A.shape[1], dt.shape[-1]
    if u.device.type == "cpu":
        return _scan_plain(u, dt, dt_weight, dt_bias, A, B, C, D, z, reverse)
    if u.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {u.device}")
    if n != D_STATE or not 1 <= r <= MAX_RANK or d % D_BLOCK:
        raise ValueError(f"the kernel takes d_state {D_STATE}, dt_rank 1..{MAX_RANK} and d_inner "
                         f"a multiple of {D_BLOCK}; got {n}, {r}, {d}")
    dev = u.device
    ops = [_operand(name, t, rows, length, dev) for name, t in
           (("u", u), ("dt", dt), ("B", B), ("C", C), ("z", z))]
    params = [t.detach().float().contiguous() for t in (dt_weight, dt_bias, A, D)]
    for name, t, shape in zip(("dt_weight", "dt_bias", "A", "D"), params,
                              ((d, r), (d,), (d, n), (d,))):
        if t.shape != shape or t.device != dev:
            raise ValueError(f"{name}: {tuple(t.shape)} on {t.device}; expected {shape} on {dev}")
    y = torch.empty(rows, length, d, device=dev)
    lib = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cmgan_selective_scan_fwd(
            *[v for op in ops for v in op], *(t.data_ptr() for t in params), y.data_ptr(),
            rows, length, d, n, r, int(reverse), stream)
    _raise_on(rc, lib, "selective_scan")
    launches += 1
    return y


def causal_conv1d_silu(x, weight, bias, reverse: bool = False):
    """silu(causal depthwise conv1d(x) + bias) along L: x [rows, L, D],
    weight [D, d_conv] (or nn.Conv1d's [D, 1, d_conv]), bias [D]. Returns
    [rows, L, D], contiguous float32."""
    global conv_launches
    weight = weight.reshape(weight.shape[0], -1)
    if x.device.type == "cpu":
        return _conv_plain(x, weight, bias, reverse)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    rows, length, d = x.shape
    if weight.shape != (d, D_CONV) or bias.shape != (d,):
        raise ValueError(f"weight {tuple(weight.shape)}, bias {tuple(bias.shape)}; the kernel "
                         f"takes [{d}, {D_CONV}] and [{d}]")
    op = _operand("x", x, rows, length, x.device)
    w, b = weight.detach().float().contiguous(), bias.detach().float().contiguous()
    y = torch.empty(rows, length, d, device=x.device)
    lib = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.cmgan_causal_conv1d_silu(*op, w.data_ptr(), b.data_ptr(), y.data_ptr(), rows,
                                          length, d, D_CONV, int(reverse), stream)
    _raise_on(rc, lib, "causal_conv1d_silu")
    conv_launches += 1
    return y
