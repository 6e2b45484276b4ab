"""Sequence-parallel (time-axis sharded) rel-pos attention.

The JAX package's `ops/seq_attention.py` over torch.distributed. The
seq group's ranks hold the same q, k, v [G, T, D] (the layers around the
attention run replicated over `seq`); each computes the queries of its
own block through the flash kernels, at a query offset, so Shaw
relative positions keep their global distances and the numbers are the
unsharded kernel's:
  - T is padded to n * t_loc, t_loc = ceil(T / n) rounded up to 128 (the
    JAX kernel's query block), with keys past T masked (t_valid = T);
  - rank r runs `flash_rel_attention_at` on queries [r * t_loc, (r+1) *
    t_loc) against all n * t_loc keys (q_offset = r * t_loc): kernels #1
    and #2 on CUDA, their plain versions on the CPU;
  - the blocks are all-gathered over `seq` into [G, T, D] on every rank.
Gradients: each rank's backward gives dq for its own block and its
share of dk, dv and the table's gradient; one all-reduce over `seq`
sums them (`collectives.sum_gradients`), so every rank holds the
gradients of the unsharded op, the table's included, before any average
over `data`. In JAX the all-gather transposes to a psum_scatter and the
replicated table's gradient is psummed; the sums are the same.
"""

from __future__ import annotations

import torch.nn.functional as F

from cmgan_torch.ops import flash_attention
from cmgan_torch.parallel import collectives

BLOCK = 128   # t_loc is a multiple of the JAX kernel's query block


def local_block(t: int, n: int) -> int:
    """Queries a rank holds of a sequence of t over n ranks."""
    per_rank = -(-t // n)
    return -(-per_rank // BLOCK) * BLOCK


def local_attention(q, k, v, rel_table, max_pos: int, rank: int, n: int):
    """Rank `rank` of `n`'s block: q, k, v [G, T, D] whole in, the
    attention of queries [rank * t_loc, (rank + 1) * t_loc) of the
    zero-padded sequence out, [G, t_loc, D] (rows at or past T are
    padding). The JAX package's inner `local` with the rank passed in."""
    t = q.shape[1]
    t_loc = local_block(t, n)
    pad = (0, 0, 0, n * t_loc - t)
    q, k, v = (F.pad(x, pad) for x in (q, k, v))
    lo = rank * t_loc
    q_loc = q[:, lo:lo + t_loc].contiguous()
    return flash_attention.flash_rel_attention_at(q_loc, k, v, rel_table, max_pos, t, lo)


def seq_rel_attention(q, k, v, rel_table, max_pos: int, mesh=None):
    """Time-sharded attention over the mesh's `seq` group: q, k, v
    [G, T, D] (the same on every rank of the group) -> [G, T, D], equal
    to `flash_rel_attention(q, k, v, rel_table, max_pos)`. q carries the
    softmax scale, the table is unscaled. Differentiable in all four."""
    if mesh is None:
        raise ValueError(
            "seq_rel_attention needs a mesh with a seq group: build one with "
            "cmgan_torch.parallel.make_mesh and pass it (Enhancer(mesh=...), "
            "Trainer(mesh=...), or parallel.attach(model, mesh))"
        )
    t = q.shape[1]
    q, k, v, rel_table = collectives.sum_gradients((q, k, v, rel_table), mesh.seq_group)
    out = local_attention(q, k, v, rel_table, max_pos, mesh.seq_rank, mesh.seq_size)
    return collectives.gather_blocks(out, mesh.seq_group, dim=1)[:, :t]
