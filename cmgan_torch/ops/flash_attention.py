"""Fused attention with Shaw relative positions, forward and backward.

The conformer's attention adds a data-dependent relative-position term
  pos[i, j] = q_i . E[clip(i - j, +-max_pos) + max_pos]
to the content logits. Dense, that needs [G, T, T] logits; at a 16 s
segment (G = 404, T = 2561) that is 10.6 GB in fp32. The CUDA kernels in
`csrc/flash_rel_attention.cu` (forward) and
`csrc/flash_rel_attention_bwd.cu` (backward) compute the function and
its gradients in O(T) memory: the forward keeps an online softmax and
writes the row log-sum-exp, the backward recomputes the weights from it.

Both kernels run their products on the tensor cores, tile pair by tile
pair, with the position term read through a skew and whole clipped tile
pairs served by two scalars a query (`csrc/flash_rel_common.cuh`).
`tiled_attention` and `tiled_attention_grads` are that arithmetic in plain
PyTorch: the CPU tests check the index work there, where no kernel runs.

`flash_rel_attention_at` is the wrapper, differentiable in q, k, v and
the table. For CPU tensors it runs the plain version
(`reference_attention`, any head dim) under ordinary autograd; for CUDA
tensors it launches the kernels, through a `torch.autograd.Function`
when a gradient is wanted, or raises. `reference_attention_grads` is the
backward's plain version.

The tensor-core kernels are built for head dims of 16, 32 and 64
(`KERNEL_HEAD_DIMS`). A narrower head is zero-padded on its last axis up
to the next of them: zero columns add nothing to q.k or q.E, q carries
the softmax scale of the true head dim, and the padded columns of the
output and of every gradient are sliced away, so the result is exact.
A head of 65 to `MAX_HEAD_DIM` (256) takes the wide kernels
(`csrc/flash_rel_attention_wide.cu`, the same C entries): they walk the
head dim in chunks of 32 columns staged as fp32 and zero-fill the last
chunk in shared memory, so any such width runs unpadded. A wider head
raises on CUDA.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from cmgan_torch.ops import _build

# head dims the tensor-core kernels are instantiated for (csrc/flash_rel_common.cuh)
KERNEL_HEAD_DIMS = (16, 32, 64)
# the widest head the wide kernels take (csrc/flash_rel_attention_wide.cu)
MAX_HEAD_DIM = 256
KERNEL = "flash_rel_attention"
BWD_KERNEL = "flash_rel_attention_bwd"
WIDE_KERNEL = "flash_rel_attention_wide"

# Kernel launches; the wrapper adds one per launch. Callers reset to 0.
launches = 0
# Backward launches (one call runs the dq/dE and the dk/dv kernel).
backward_launches = 0
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


def reference_attention_grads(q, k, v, rel_table, max_pos: int, t_valid: int,
                              q_offset: int, g):
    """The backward's plain version: autograd through `reference_attention`.

    Returns (dq, dk, dv, dtable) for the output cotangent g [G, Tq, D],
    each in its input's dtype.
    """
    leaves = [t.detach().requires_grad_() for t in (q, k, v, rel_table)]
    with torch.enable_grad():
        band = make_rel_band(leaves[3], k.shape[1], max_pos)
        out = reference_attention(*leaves[:3], band, t_valid, q_offset)
    return torch.autograd.grad(out, leaves, g)


def _tile_pairs(tq: int, t_valid: int, q_offset: int, max_pos: int, tile: int):
    """The kernels' walk: (i0, nq, j0, nk, base, kind) for every tile pair.

    Query a of the tile meets key b at distance base + c, c = a - b +
    tile - 1. kind is 'high' when every distance of the pair is >=
    max_pos, 'low' when every one is <= -max_pos, else 'mixed'.
    """
    for i0 in range(0, tq, tile):
        for j0 in range(0, t_valid, tile):
            base = i0 + q_offset - j0 - (tile - 1)
            if base >= max_pos:
                kind = "high"
            elif base + 2 * tile - 2 <= -max_pos:
                kind = "low"
            else:
                kind = "mixed"
            yield i0, min(tile, tq - i0), j0, min(tile, t_valid - j0), base, kind


def _window(table, base: int, max_pos: int, tile: int):
    """Rows clip(base + c, +-max_pos) + max_pos of the table, c in [0, 2*tile-1)."""
    dist = torch.arange(2 * tile - 1, device=table.device) + base
    return dist.clamp(-max_pos, max_pos) + max_pos


def _skew_index(nq: int, nk: int, tile: int, device):
    """c[a, b] = a - b + tile - 1: where R holds the position logit of (a, b)."""
    a = torch.arange(nq, device=device)[:, None]
    b = torch.arange(nk, device=device)[None, :]
    return a - b + tile - 1


def _tile_logits(qt, kt, table, max_pos, base, kind, tile):
    """Logits [G, nq, nk] of one tile pair the kernels' way: the content
    product plus, for a mixed pair, R = Q . E_window^T read through the
    skew, or, for a clipped pair, one scalar a query."""
    s = qt @ kt.transpose(1, 2)
    if kind == "mixed":
        r = qt @ table[_window(table, base, max_pos, tile)].T  # [G, nq, 2*tile-1]
        c = _skew_index(qt.shape[1], kt.shape[1], tile, qt.device)
        return s + r.gather(2, c.expand(qt.shape[0], -1, -1))
    row = 2 * max_pos if kind == "high" else 0
    return s + (qt @ table[row])[:, :, None]


def tiled_attention(q, k, v, rel_table, max_pos: int, t_valid: int, q_offset: int = 0,
                    tile: int = 64, return_lse: bool = False):
    """The forward kernel's arithmetic in plain PyTorch, tile pair by tile
    pair: the window of 2*tile-1 rows of E, R and its skew, the clipped
    pairs' two scalars, the online softmax. Same function as
    `reference_attention`; for tests and checks, on no model's path.
    Returns out (q's dtype), and the fp32 row log-sum-exp when asked.
    """
    qf, kf, vf, table = q.float(), k.float(), v.float(), rel_table.float()
    g, tq, d = q.shape
    out = torch.zeros(g, tq, d, device=q.device)
    m = torch.full((g, tq), float("-inf"), device=q.device)
    l = torch.zeros(g, tq, device=q.device)
    for i0, nq, j0, nk, base, kind in _tile_pairs(tq, t_valid, q_offset, max_pos, tile):
        rows, keys = slice(i0, i0 + nq), slice(j0, j0 + nk)
        s = _tile_logits(qf[:, rows], kf[:, keys], table, max_pos, base, kind, tile)
        m_new = torch.maximum(m[:, rows], s.amax(dim=2))
        corr = torch.exp(m[:, rows] - m_new)
        p = torch.exp(s - m_new[:, :, None])
        l[:, rows] = l[:, rows] * corr + p.sum(dim=2)
        out[:, rows] = out[:, rows] * corr[:, :, None] + p @ vf[:, keys]
        m[:, rows] = m_new
    out = (out / l[:, :, None]).to(q.dtype)
    return (out, m + torch.log(l)) if return_lse else out


def tiled_attention_grads(q, k, v, rel_table, max_pos: int, t_valid: int, q_offset: int, g,
                          tile: int = 64):
    """The backward kernel's arithmetic in plain PyTorch: weights recomputed
    per tile pair from the row log-sum-exp, ds written skewed into dR, the
    table's gradient as dE_window = dR^T . Q added to its rows, the clipped
    pairs (of clipped and of mixed tile pairs) by two sums a query. Returns
    (dq, dk, dv, dtable) like `reference_attention_grads`; for tests and
    checks only.
    """
    out, lse = tiled_attention(q, k, v, rel_table, max_pos, t_valid, q_offset, tile, True)
    qf, kf, vf, table, gf = q.float(), k.float(), v.float(), rel_table.float(), g.float()
    groups, tq, _ = q.shape
    delta = (gf * out.float()).sum(dim=2)
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    dtable = torch.zeros_like(table)
    # ds summed over the pairs clipped to row 2*max_pos / row 0, per query
    c_hi = torch.zeros(groups, tq, device=q.device)
    c_lo = torch.zeros(groups, tq, device=q.device)
    for i0, nq, j0, nk, base, kind in _tile_pairs(tq, t_valid, q_offset, max_pos, tile):
        rows, keys = slice(i0, i0 + nq), slice(j0, j0 + nk)
        qt, kt = qf[:, rows], kf[:, keys]
        s = _tile_logits(qt, kt, table, max_pos, base, kind, tile)
        p = torch.exp(s - lse[:, rows, None])
        ds = p * (gf[:, rows] @ vf[:, keys].transpose(1, 2) - delta[:, rows, None])
        dv[:, keys] += p.transpose(1, 2) @ gf[:, rows]
        dk[:, keys] += ds.transpose(1, 2) @ qt
        dq[:, rows] += ds @ kt
        if kind == "mixed":
            window = _window(table, base, max_pos, tile)
            c = _skew_index(nq, nk, tile, q.device)
            # a pair that is itself clipped goes to its query's sum, as in a clipped pair of tiles
            dist = base + c
            c_hi[:, rows] += (ds * (dist >= max_pos)).sum(dim=2)
            c_lo[:, rows] += (ds * (dist <= -max_pos)).sum(dim=2)
            dr = torch.zeros(groups, nq, 2 * tile - 1, device=q.device)
            # zero outside the parallelogram and on the window's clipped rows
            dr.scatter_(2, c.expand(groups, -1, -1), ds * (dist.abs() < max_pos))
            dq[:, rows] += dr @ table[window]
            dtable.index_add_(0, window, torch.einsum("gac,gad->cd", dr, qt))
        elif kind == "high":
            c_hi[:, rows] += ds.sum(dim=2)
        else:
            c_lo[:, rows] += ds.sum(dim=2)
    dq += c_hi[:, :, None] * table[2 * max_pos] + c_lo[:, :, None] * table[0]
    dtable[2 * max_pos] += torch.einsum("ga,gad->d", c_hi, qf)
    dtable[0] += torch.einsum("ga,gad->d", c_lo, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dtable.to(rel_table.dtype)


_FWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _bind(name: str, forward: bool, backward: bool):
    lib = _build.load(name)
    if forward:
        lib.cmgan_flash_rel_attention_fwd.argtypes = _FWD_ARGS
        lib.cmgan_flash_rel_attention_fwd.restype = ctypes.c_int
    if backward:
        lib.cmgan_flash_rel_attention_bwd.argtypes = _BWD_ARGS
        lib.cmgan_flash_rel_attention_bwd.restype = ctypes.c_int
        rows = lib.cmgan_flash_rel_attention_bwd_partial_rows
        rows.argtypes, rows.restype = [ctypes.c_int] * 5, ctypes.c_int
    lib.cmgan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cmgan_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _kernel():
    return _bind(KERNEL, forward=True, backward=False)


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    return _bind(BWD_KERNEL, forward=False, backward=True)


@functools.lru_cache(maxsize=None)
def _wide_kernel():
    """The wide kernels' library: forward and backward, the same entries."""
    return _bind(WIDE_KERNEL, forward=True, backward=True)


def _fwd_lib(d: int):
    return _wide_kernel() if wide_head_dim(d) else _kernel()


def _bwd_lib(d: int):
    return _wide_kernel() if wide_head_dim(d) else _bwd_kernel()


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.cmgan_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _check_layout(name: str, t):
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} must start at a 16-byte boundary: the kernels load 16 bytes at a time")


def _check(q, k, v, rel_table, max_pos: int, t_valid: int, q_offset: int):
    tensors = {"q": q, "k": k, "v": v, "rel_table": rel_table}
    for name, t in tensors.items():
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: dtype {t.dtype}; the kernel takes float32 or bfloat16")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype} differs from q's {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        _check_layout(name, t)
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"expected q [G,Tq,D], k/v [G,Tk,D]; got {q.shape}, {k.shape}, {v.shape}")
    g, tq, d = q.shape
    tk = k.shape[1]
    if k.shape[0] != g or k.shape[2] != d:
        raise ValueError(f"q and k/v need matching groups and head dims; got q {q.shape}, k {k.shape}")
    if rel_table.shape != (2 * max_pos + 1, d):
        raise ValueError(f"rel_table {tuple(rel_table.shape)}, expected {(2 * max_pos + 1, d)}")
    if not 1 <= t_valid <= tk:
        raise ValueError(f"t_valid {t_valid} outside [1, {tk}]")
    if q_offset < 0 or q_offset + tq > tk:
        raise ValueError(f"q_offset {q_offset}: need 0 <= q_offset and q_offset + Tq <= Tk ({tq}, {tk})")


def _launch_forward(q, k, v, rel_table, max_pos, t_valid, q_offset, want_lse: bool):
    """One forward launch; returns (out, lse or None)."""
    global launches
    g, tq, d = q.shape
    lib = _fwd_lib(d)
    out = torch.empty_like(q)
    lse = torch.empty(g, tq, dtype=torch.float32, device=q.device) if want_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.cmgan_flash_rel_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_table.data_ptr(),
            out.data_ptr(), lse.data_ptr() if want_lse else None,
            g, tq, k.shape[1], d, max_pos, t_valid, q_offset,
            int(q.dtype == torch.bfloat16), stream,
        )
    _raise_on(lib, rc, "flash_rel_attention")
    launches += 1
    return out, lse


def _launch_backward(q, k, v, rel_table, out, lse, grad_out, max_pos, t_valid, q_offset):
    """One backward launch (delta, then the kernels); returns (dq, dk, dv, dtable)."""
    global backward_launches
    g, tq, d = q.shape
    lib = _bwd_lib(d)
    bf16 = int(q.dtype == torch.bfloat16)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(g, tq, dtype=torch.float32, device=q.device)
    dtable = torch.empty(rel_table.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        # the table's gradient arrives as rows of partial sums, one a block of the
        # kernel that sums it (or one in all for a table too long for a block's
        # shared memory; none for the wide kernels, which add into dtable by
        # atomics); the library says how many, and adds them into dtable
        rows = lib.cmgan_flash_rel_attention_bwd_partial_rows(bf16, d, g, tq, max_pos)
        if rows < 0:
            _raise_on(lib, -rows, "flash_rel_attention_bwd")
        partials = torch.empty(rows, rel_table.numel(), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.cmgan_flash_rel_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_table.data_ptr(),
            out.data_ptr(), grad_out.data_ptr(), lse.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            dtable.data_ptr(), partials.data_ptr(), g, tq, k.shape[1], d, max_pos, t_valid,
            q_offset, bf16, rows, stream,
        )
    _raise_on(lib, rc, "flash_rel_attention_bwd")
    backward_launches += 1
    return dq, dk, dv, dtable.to(rel_table.dtype)


class _FlashRelAttention(torch.autograd.Function):
    """The kernels as one differentiable op on CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, rel_table, max_pos, t_valid, q_offset):
        out, lse = _launch_forward(q, k, v, rel_table, max_pos, t_valid, q_offset, True)
        ctx.save_for_backward(q, k, v, rel_table, out, lse)
        ctx.args = (max_pos, t_valid, q_offset)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, rel_table, out, lse = ctx.saved_tensors
        grad_out = grad_out.to(q.dtype).contiguous()
        _check_layout("the output's gradient", grad_out)
        grads = _launch_backward(q, k, v, rel_table, out, lse, grad_out, *ctx.args)
        return (*grads, None, None, None)


def wide_head_dim(d: int) -> bool:
    """Whether a head of dim d takes the wide kernels (64 < d <= MAX_HEAD_DIM)."""
    return d > KERNEL_HEAD_DIMS[-1]


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run a head of dim d at: the least of
    KERNEL_HEAD_DIMS that holds it (the tensor-core kernels), or d itself
    from 65 to MAX_HEAD_DIM (the wide kernels take any width). Raises for a
    head wider than MAX_HEAD_DIM."""
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernels take a head dim of at most {MAX_HEAD_DIM}; got {d}")
    return next((width for width in KERNEL_HEAD_DIMS if d <= width), d)


def flash_rel_attention_at(q, k, v, rel_table, max_pos: int,
                           t_valid: int | None = None, q_offset: int = 0):
    """Fused attention with Shaw relative positions at a query offset.

    q: [G, Tq, D]; k, v: [G, Tk, D]; rel_table: [2*max_pos+1, D]; on CUDA
    D <= MAX_HEAD_DIM (`kernel_head_dim`).
    q carries the softmax scale, the table is unscaled. Query i sits at
    global position i + q_offset (q_offset + Tq <= Tk). Keys at or past
    t_valid (default Tk) are masked. Returns [G, Tq, D] in q's dtype,
    differentiable in q, k, v and rel_table.
    """
    global plain_calls
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
    d = q.shape[2]
    width = kernel_head_dim(d)
    if width != d:
        # zero columns up to the kernels' width; F.pad and the slice carry
        # the gradient, so the padded columns' gradients are dropped
        q, k, v, rel_table = (F.pad(t, (0, width - d)) for t in (q, k, v, rel_table))
        return flash_rel_attention_at(q, k, v, rel_table, max_pos, t_valid, q_offset)[..., :d]

    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, rel_table)):
        return _FlashRelAttention.apply(q, k, v, rel_table, max_pos, t_valid, q_offset)
    return _launch_forward(q, k, v, rel_table, max_pos, t_valid, q_offset, False)[0]


def flash_rel_attention(q, k, v, rel_table, max_pos: int):
    """Fused attention with Shaw relative positions (q and k/v aligned).

    Equal to `reference_attention(q, k, v, make_rel_band(rel_table, T,
    max_pos), T)`.
    """
    return flash_rel_attention_at(q, k, v, rel_table, max_pos)
