"""Fused attention with Shaw relative positions.

The conformer's attention adds a data-dependent relative-position term
  pos[i, j] = q_i . E[clip(i - j, +-max_pos) + max_pos]
to the content logits. Dense, that needs [G, T, T] logits; at a 16 s
segment (G = 404, T = 2561) that is 10.6 GB in fp32. The CUDA kernel in
`csrc/flash_rel_attention.cu` computes the same function in O(T) memory
with an online softmax.

`flash_rel_attention_at` is the wrapper. For CPU tensors it runs the
plain version (`reference_attention`); for CUDA tensors it launches the
kernel or raises. This slice is forward only: with autograd recording,
inputs that require grad are refused until the backward kernel is ported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cmgan_torch.ops import _build

HEAD_DIM = 16
KERNEL = "flash_rel_attention"

# Kernel launches; the wrapper adds one per launch. Callers reset to 0.
launches = 0
# Calls the wrapper served with the plain version (CPU tensors).
plain_calls = 0


def make_rel_band(rel_table: torch.Tensor, t: int, max_pos: int) -> torch.Tensor:
    """band[s] = table[clip(s - (t-1), +-max_pos) + max_pos], s in [0, 2t-1)."""
    s = torch.arange(2 * t - 1, device=rel_table.device) - (t - 1)
    return rel_table[s.clamp(-max_pos, max_pos) + max_pos]


def reference_attention(q, k, v, rel_band, t_valid: int, q_offset: int = 0):
    """The plain version. q [G, Tq, D]; k, v [G, Tk, D]; rel_band
    [2*Tk-1, D] from `make_rel_band(table, Tk, max_pos)`. Query i sits at
    global position i + q_offset (q_offset + Tq <= Tk); keys >= t_valid
    are masked. Math in fp32; the output has q's dtype.
    """
    tq, tk = q.shape[1], k.shape[1]
    qf, kf, vf, band = q.float(), k.float(), v.float(), rel_band.float()
    logits = torch.einsum("gid,gjd->gij", qf, kf)
    i = torch.arange(tq, device=q.device) + q_offset
    j = torch.arange(tk, device=q.device)
    rel = band[i[:, None] - j[None, :] + tk - 1]  # [Tq, Tk, D]
    logits = logits + torch.einsum("gid,ijd->gij", qf, rel)
    if t_valid < tk:
        logits[..., t_valid:] = float("-inf")
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("gij,gjd->gid", attn, vf).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load(KERNEL)
    fn = lib.cmgan_flash_rel_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.cmgan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cmgan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, rel_table, max_pos: int, t_valid: int, q_offset: int):
    tensors = {"q": q, "k": k, "v": v, "rel_table": rel_table}
    for name, t in tensors.items():
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: dtype {t.dtype}; the kernel takes float32 or bfloat16")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype} differs from q's {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                f"{name} requires grad: the backward kernel is not ported yet"
            )
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"expected q [G,Tq,D], k/v [G,Tk,D]; got {q.shape}, {k.shape}, {v.shape}")
    g, tq, d = q.shape
    tk = k.shape[1]
    if d != HEAD_DIM or k.shape[0] != g or k.shape[2] != d:
        raise ValueError(f"the kernel takes D = {HEAD_DIM} and matching groups; got q {q.shape}, k {k.shape}")
    if rel_table.shape != (2 * max_pos + 1, d):
        raise ValueError(f"rel_table {tuple(rel_table.shape)}, expected {(2 * max_pos + 1, d)}")
    if not 1 <= t_valid <= tk:
        raise ValueError(f"t_valid {t_valid} outside [1, {tk}]")
    if q_offset < 0 or q_offset + tq > tk:
        raise ValueError(f"q_offset {q_offset}: need 0 <= q_offset and q_offset + Tq <= Tk ({tq}, {tk})")


def flash_rel_attention_at(q, k, v, rel_table, max_pos: int,
                           t_valid: int | None = None, q_offset: int = 0):
    """Fused attention with Shaw relative positions at a query offset.

    q: [G, Tq, D]; k, v: [G, Tk, D]; rel_table: [2*max_pos+1, D], D = 16.
    q carries the softmax scale, the table is unscaled. Query i sits at
    global position i + q_offset (q_offset + Tq <= Tk). Keys at or past
    t_valid (default Tk) are masked. Returns [G, Tq, D] in q's dtype.
    """
    global launches, plain_calls
    tk = k.shape[1]
    t_valid = tk if t_valid is None else min(int(t_valid), tk)
    q_offset = int(q_offset)
    _check(q, k, v, rel_table, max_pos, t_valid, q_offset)

    if q.device.type == "cpu":
        plain_calls += 1
        return reference_attention(
            q, k, v, make_rel_band(rel_table, tk, max_pos), t_valid, q_offset
        )
    if q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {q.device}")

    lib = _kernel()
    g, tq, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.cmgan_flash_rel_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_table.data_ptr(),
            out.data_ptr(), g, tq, tk, d, max_pos, t_valid, q_offset,
            int(q.dtype == torch.bfloat16), stream,
        )
    if rc != 0:
        msg = lib.cmgan_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_rel_attention launch failed: CUDA error {rc} ({msg})")
    launches += 1
    return out


def flash_rel_attention(q, k, v, rel_table, max_pos: int):
    """Fused attention with Shaw relative positions (q and k/v aligned).

    Equal to `reference_attention(q, k, v, make_rel_band(rel_table, T,
    max_pos), T)`.
    """
    return flash_rel_attention_at(q, k, v, rel_table, max_pos)
