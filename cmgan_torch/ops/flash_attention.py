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
when a gradient is wanted, or raises; for meta tensors it gives the
output's shape alone. `attention_work` counts the function's operations
and bytes from its shapes. `reference_attention_grads` is the
backward's plain version.

The tensor-core kernels are built for head dims of 16, 32 and 64
(`KERNEL_HEAD_DIMS`). A narrower head is zero-padded on its last axis up
to the next of them: zero columns add nothing to q.k or q.E, q carries
the softmax scale of the true head dim, and the padded columns of the
output and of every gradient are sliced away, so the result is exact.
A head wider than 64, of any width, takes the wide kernels
(`csrc/flash_rel_attention_wide.cu`, the same C entries), unpadded. They
run the same tensor-core tile products, but walk the head dim in chunks
staged into shared memory (zero past the head dim, at most 15 padded
columns computed) and split the output's columns into slabs of at most
`WIDE_SLABS` columns, one block each, that recompute the logits: so
nothing on the card grows with the head dim. `plan` says how a head of
dim d runs; `wide_attention` and `wide_attention_grads` are the wide
kernels' walk (chunks, slabs, logits recomputed per slab, the table's
gradient added once a tile pair, window row and slab column) in plain
PyTorch.

Every backward path sums the table's gradient in one fixed order, with no
atomics, so two runs on the same inputs give the same bits: the kernel
that owns the query tiles runs persistent blocks, each adding into rows of
its own, and the rows are summed in block order (`_BlockRows` is that
order in plain PyTorch).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from cmgan_torch.ops import _build

# head dims the tensor-core kernels are instantiated for (csrc/flash_rel_common.cuh)
KERNEL_HEAD_DIMS = (16, 32, 64)
# the wide kernels' widest slab of output columns (csrc/flash_rel_attention_wide.cu):
# the forward's (128 up to D 128), dq's, and dk's and dv's (two accumulators a thread)
WIDE_SLABS = {"fwd": 256, "bwd_q": 128, "bwd_k": 64}
# head-dim columns the wide kernels stage a chunk, by type
WIDE_CHUNK = {torch.float32: 16, torch.bfloat16: 32}
# persistent blocks of the backward kernel that sums the table's gradient in
# the walks (`tiled_attention_grads`, `wide_attention_grads`; a slab's blocks in
# the wide one); on the card, as many as it holds at once
WALK_BLOCKS = 8
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
    each in its input's dtype. The band is gathered from the table in fp32,
    so that the table's gradient is summed in fp32 and rounded once (a
    bf16 gather's gradient would sum rows 0 and 2*max_pos, which collect
    every distant pair, in bf16).
    """
    leaves = [t.detach().requires_grad_() for t in (q, k, v, rel_table)]
    with torch.enable_grad():
        band = make_rel_band(leaves[3].float(), k.shape[1], max_pos)
        out = reference_attention(*leaves[:3], band, t_valid, q_offset)
    return torch.autograd.grad(out, leaves, g)


def attention_work(g: int, tq: int, tk: int, t_valid: int, q_offset: int, max_pos: int,
                   d: int, elem_bytes: int, backward: bool = False) -> dict:
    """The work the attention function (or its gradient) needs on these
    shapes, counted by the algorithm and not by any implementation of it:
    the same for the kernels, the dense path and a library's.

    - flop: 2*d a product of a query-key pair. A pair whose distance is
      clipped (|i - j| >= max_pos) needs no position product: its position
      logit, and its share of dq and of the table's gradient, come from one
      scalar a query and table end. So the forward takes 3 products a near
      pair (content logit, position logit, P.V) and 2 a clipped one; the
      backward 8 and 5 (content logit, dp, dv, dk, dq).
    - bytes: every input read once and every output written once: q, k, v,
      the table and the output in the forward (elements of `elem_bytes`);
      the backward adds the output's gradient, dq, dk, dv, and the float32
      table gradient and row log-sum-exp.
    - exps: one exponential a query-key pair.
    d is the head dim the caller asks for (not the width the kernels pad
    it to); queries sit at q_offset + i, keys from t_valid on are masked.
    """
    # keys within max_pos of query position p: plain integers, no tensor op
    near = sum(max(0, min(t_valid - 1, p + max_pos - 1) - max(0, p - max_pos + 1) + 1)
               for p in range(q_offset, q_offset + tq))
    far = tq * t_valid - near
    rows = 2 * max_pos + 1
    if backward:
        flop = 2 * d * g * (8 * near + 5 * far)
        # q, the output's gradient, out, dq and k, v, dk, dv once each, the
        # table and its gradient, the lse
        nbytes = elem_bytes * d * (4 * g * tq + 4 * g * tk + rows) + 4 * (rows * d + g * tq)
    else:
        flop = 2 * d * g * (3 * near + 2 * far)
        nbytes = elem_bytes * d * (2 * g * tq + 2 * g * tk + rows)
    return {"flop": flop, "bytes": nbytes, "exps": g * tq * t_valid, "near": near, "far": far}


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


class _BlockRows:
    """The table's gradient [rows, d] summed as the backward kernels sum it.

    Item (group, query tile) i is taken by the persistent block i % blocks,
    which adds into rows of its own: each tile pair's window gradient, and
    once an item its clipped pairs, per group of `warp` queries (a warp;
    the wide kernel's whole tile) into that group's slot. After its items a
    block adds its slots in order into rows 2*max_pos and 0; then the
    blocks' rows are added in block order.
    """

    def __init__(self, blocks: int, tq: int, tile: int, warp: int, rows: int, d: int, device):
        self.blocks, self.tile, self.warp = blocks, tile, warp
        self.n_qtiles = -(-tq // tile)
        self.rows = torch.zeros(blocks, rows, d, device=device)
        self.hi = torch.zeros(blocks, tile // warp, d, device=device)
        self.lo = torch.zeros_like(self.hi)

    def _block(self, groups: int, qtile, device):
        return (torch.arange(groups, device=device)[:, None] * self.n_qtiles + qtile) % self.blocks

    def add_window(self, i0: int, window, dr, qt):
        """Each group's dE_window = dR^T . Q into its block's rows."""
        groups, _, d = qt.shape
        de = torch.einsum("gac,gad->gcd", dr, qt)
        index = self._block(groups, i0 // self.tile, qt.device) * self.rows.shape[1] + window
        self.rows.view(-1, d).index_add_(0, index.reshape(-1), de.reshape(-1, d))

    def add_clipped(self, c_hi, c_lo, qf):
        """Every item's per-query sums of its clipped pairs (c_hi, c_lo
        [G, Tq]) times its queries, into the slots of the item's block."""
        groups, tq, d = qf.shape
        items = self._block(groups, torch.arange(self.n_qtiles, device=qf.device), qf.device)
        for c, slots in ((c_hi, self.hi), (c_lo, self.lo)):
            x = F.pad(c[:, :, None] * qf, (0, 0, 0, self.n_qtiles * self.tile - tq))
            per_slot = x.reshape(groups * self.n_qtiles, self.tile // self.warp, self.warp, d).sum(2)
            slots.index_add_(0, items.reshape(-1), per_slot)

    def total(self):
        """Each block's slots in order into its rows, then the rows in block order."""
        rows = self.rows.clone()
        for k in range(self.hi.shape[1]):
            rows[:, -1] += self.hi[:, k]
            rows[:, 0] += self.lo[:, k]
        out = torch.zeros_like(rows[0])
        for b in range(self.blocks):
            out += rows[b]
        return out


def _tile_logits(qt, kt, table, max_pos, base, kind, tile, chunk: int | None = None):
    """Logits [G, nq, nk] of one tile pair the kernels' way: the content
    product plus, for a mixed pair, R = Q . E_window^T read through the
    skew, or, for a clipped pair, one scalar a query. With `chunk`, both
    products are summed over head-dim chunks of that many columns (R of
    each chunk through the skew), as the wide kernels do."""
    d = qt.shape[2]
    chunk = chunk or d
    s = 0
    for d0 in range(0, d, chunk):
        cols = slice(d0, d0 + chunk)
        s = s + qt[..., cols] @ kt[..., cols].transpose(1, 2)
        if kind == "mixed":
            r = qt[..., cols] @ table[_window(table, base, max_pos, tile)][:, cols].T
            c = _skew_index(qt.shape[1], kt.shape[1], tile, qt.device)
            s = s + r.gather(2, c.expand(qt.shape[0], -1, -1))
    if kind != "mixed":
        row = 2 * max_pos if kind == "high" else 0
        s = s + (qt @ table[row])[:, :, None]
    return s


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
                          tile: int = 64, blocks: int = WALK_BLOCKS):
    """The backward kernel's arithmetic in plain PyTorch: weights recomputed
    per tile pair from the row log-sum-exp, ds written skewed into dR, the
    table's gradient as dE_window = dR^T . Q added to its block's rows, the
    clipped pairs (of clipped and of mixed tile pairs) by two sums a query,
    added once an item per warp of 16 queries; the rows of `blocks`
    persistent blocks summed in block order (`_BlockRows`). Returns (dq, dk,
    dv, dtable) like `reference_attention_grads`; for tests and checks only.
    """
    out, lse = tiled_attention(q, k, v, rel_table, max_pos, t_valid, q_offset, tile, True)
    qf, kf, vf, table, gf = q.float(), k.float(), v.float(), rel_table.float(), g.float()
    groups, tq, _ = q.shape
    delta = (gf * out.float()).sum(dim=2)
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    de_rows = _BlockRows(blocks, tq, tile, min(16, tile), *table.shape, q.device)
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
            de_rows.add_window(i0, window, dr, qt)
        elif kind == "high":
            c_hi[:, rows] += ds.sum(dim=2)
        else:
            c_lo[:, rows] += ds.sum(dim=2)
    dq += c_hi[:, :, None] * table[2 * max_pos] + c_lo[:, :, None] * table[0]
    de_rows.add_clipped(c_hi, c_lo, qf)
    dtable = de_rows.total()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dtable.to(rel_table.dtype)


def widest_slab(d: int, kernel: str) -> int:
    """The widest slab of a wide kernel ('fwd', 'bwd_q', 'bwd_k') at head dim d."""
    return 128 if kernel == "fwd" and d <= 128 else WIDE_SLABS[kernel]


def _slabs(d: int, kernel: str):
    """The column ranges of a wide kernel's slabs at head dim d."""
    width = slab_width(d, widest_slab(d, kernel))
    return [slice(s0, min(d, s0 + width)) for s0 in range(0, d, width)]


def wide_attention(q, k, v, rel_table, max_pos: int, t_valid: int, q_offset: int = 0,
                   return_lse: bool = False):
    """The wide forward kernel's walk in plain PyTorch: for each slab of
    output columns, every tile pair's logits over the whole head dim (in
    chunks), the online softmax, and P . V in the slab's columns. Same
    function as `reference_attention`; for tests and checks."""
    qf, kf, vf, table = q.float(), k.float(), v.float(), rel_table.float()
    g, tq, d = q.shape
    out = torch.zeros(g, tq, d, device=q.device)
    for cols in _slabs(d, "fwd"):
        m = torch.full((g, tq), float("-inf"), device=q.device)
        l = torch.zeros(g, tq, device=q.device)
        for i0, nq, j0, nk, base, kind in _tile_pairs(tq, t_valid, q_offset, max_pos, 64):
            rows, keys = slice(i0, i0 + nq), slice(j0, j0 + nk)
            s = _tile_logits(qf[:, rows], kf[:, keys], table, max_pos, base, kind, 64,
                             WIDE_CHUNK.get(q.dtype, 16))
            m_new = torch.maximum(m[:, rows], s.amax(dim=2))
            corr = torch.exp(m[:, rows] - m_new)
            p = torch.exp(s - m_new[:, :, None])
            l[:, rows] = l[:, rows] * corr + p.sum(dim=2)
            out[:, rows, cols] = out[:, rows, cols] * corr[:, :, None] + p @ vf[:, keys, cols]
            m[:, rows] = m_new
        out[:, :, cols] /= l[:, :, None]
    out = out.to(q.dtype)
    return (out, m + torch.log(l)) if return_lse else out


def wide_attention_grads(q, k, v, rel_table, max_pos: int, t_valid: int, q_offset: int, g,
                         blocks: int = WALK_BLOCKS):
    """The wide backward kernels' walk in plain PyTorch: the dq kernel's
    slabs (dq and the table's gradient in the slab's columns; per tile pair
    the weights recomputed over the whole head dim, ds written skewed into
    dR, dE_window = dR^T . Q added to the window's rows of the item's block,
    and the clipped pairs by two sums a query, added once an item; each
    slab's `blocks` blocks' rows summed in block order), then the dk/dv
    kernel's slabs. Returns (dq, dk, dv, dtable) like
    `reference_attention_grads`; for tests and checks."""
    out, lse = wide_attention(q, k, v, rel_table, max_pos, t_valid, q_offset, True)
    qf, kf, vf, table, gf = q.float(), k.float(), v.float(), rel_table.float(), g.float()
    groups, tq, d = q.shape
    chunk = WIDE_CHUNK.get(q.dtype, 16)
    delta = (gf * out.float()).sum(dim=2)
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    dtable = torch.zeros_like(table)
    pairs = list(_tile_pairs(tq, t_valid, q_offset, max_pos, 64))

    def weights(i0, nq, j0, nk, base, kind):
        rows, keys = slice(i0, i0 + nq), slice(j0, j0 + nk)
        s = _tile_logits(qf[:, rows], kf[:, keys], table, max_pos, base, kind, 64, chunk)
        p = torch.exp(s - lse[:, rows, None])
        return p, p * (gf[:, rows] @ vf[:, keys].transpose(1, 2) - delta[:, rows, None])

    for cols in _slabs(d, "bwd_q"):
        de_rows = _BlockRows(blocks, tq, 64, 64, table.shape[0], cols.stop - cols.start, q.device)
        c_hi = torch.zeros(groups, tq, device=q.device)
        c_lo = torch.zeros(groups, tq, device=q.device)
        for i0, nq, j0, nk, base, kind in pairs:
            rows, keys = slice(i0, i0 + nq), slice(j0, j0 + nk)
            _, ds = weights(i0, nq, j0, nk, base, kind)
            dq[:, rows, cols] += ds @ kf[:, keys, cols]
            if kind == "mixed":
                window = _window(table, base, max_pos, 64)
                c = _skew_index(nq, nk, 64, q.device)
                dist = base + c
                c_hi[:, rows] += (ds * (dist >= max_pos)).sum(dim=2)
                c_lo[:, rows] += (ds * (dist <= -max_pos)).sum(dim=2)
                dr = torch.zeros(groups, nq, 127, device=q.device)
                dr.scatter_(2, c.expand(groups, -1, -1), ds * (dist.abs() < max_pos))
                dq[:, rows, cols] += dr @ table[window][:, cols]
                # one add a window row and column of the slab
                de_rows.add_window(i0, window, dr, qf[:, rows, cols])
            elif kind == "high":
                c_hi[:, rows] += ds.sum(dim=2)
            else:
                c_lo[:, rows] += ds.sum(dim=2)
        dq[:, :, cols] += (c_hi[:, :, None] * table[2 * max_pos, cols]
                           + c_lo[:, :, None] * table[0, cols])
        de_rows.add_clipped(c_hi, c_lo, qf[:, :, cols])
        dtable[:, cols] = de_rows.total()
    for cols in _slabs(d, "bwd_k"):
        for i0, nq, j0, nk, base, kind in pairs:
            rows, keys = slice(i0, i0 + nq), slice(j0, j0 + nk)
            p, ds = weights(i0, nq, j0, nk, base, kind)
            dv[:, keys, cols] += p.transpose(1, 2) @ gf[:, rows, cols]
            dk[:, keys, cols] += ds.transpose(1, 2) @ qf[:, rows, cols]
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
        # the table's gradient arrives as rows of partial sums, one a persistent
        # block of the kernel that sums it (the wide kernels' blocks fill a
        # slab's width of a row each), which the library adds into dtable in
        # block order: no atomics, the same bits on every run
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
    """Whether a head of dim d takes the wide kernels (d > 64)."""
    return d > KERNEL_HEAD_DIMS[-1]


def slab_width(d: int, widest: int) -> int:
    """The wide kernels' slab width at head dim d: the fewest slabs of at
    most `widest` columns, of equal widths rounded up to 8
    (`slab_width` in csrc/flash_rel_attention_wide.cu)."""
    n = -(-d // widest)
    return -(-(-(-d // n)) // 8) * 8


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    d: int                 # the head dim asked for
    path: str              # 'tensor_core' (d <= 64) or 'wide'
    width: int             # the head dim the kernels run at (zero-padded up to it)
    logit_columns: int     # head-dim columns a logit's products compute
    slabs: dict            # wide: kernel -> (number of slabs, slab width); else {}

    @property
    def padded_columns(self) -> int:
        """Columns of zeros the logits compute beyond the head dim."""
        return self.logit_columns - self.d


def plan(d: int) -> HeadPlan:
    """How the CUDA kernels run a head of dim d (any d >= 1): the
    tensor-core kernels at the least of KERNEL_HEAD_DIMS that holds it,
    zero-padded; or the wide kernels unpadded, the logits over 16-column
    depth steps and the output's columns in slabs (`WIDE_SLABS`)."""
    if d < 1:
        raise ValueError(f"a head dim is at least 1; got {d}")
    if not wide_head_dim(d):
        width = next(w for w in KERNEL_HEAD_DIMS if d <= w)
        return HeadPlan(d, "tensor_core", width, width, {})
    slabs = {}
    for name in WIDE_SLABS:
        width = slab_width(d, widest_slab(d, name))
        slabs[name] = (-(-d // width), width)
    return HeadPlan(d, "wide", d, -(-d // 16) * 16, slabs)


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run a head of dim d at: the least of
    KERNEL_HEAD_DIMS that holds it (the tensor-core kernels), or d itself
    above 64 (the wide kernels take any width)."""
    return plan(d).width


def flash_rel_attention_at(q, k, v, rel_table, max_pos: int,
                           t_valid: int | None = None, q_offset: int = 0):
    """Fused attention with Shaw relative positions at a query offset.

    q: [G, Tq, D]; k, v: [G, Tk, D]; rel_table: [2*max_pos+1, D]; any D
    (on CUDA as `plan` says).
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
    if q.device.type == "meta":
        # shapes only, as PyTorch's own meta kernels: a model on the meta
        # device is walked for its work (`attention_work`, `bench.call_work`)
        return torch.empty_like(q)
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
