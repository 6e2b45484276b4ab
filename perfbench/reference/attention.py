"""The relative-position attention core in plain PyTorch, float32, and
the hook through which the work counter records it.

`dense_rel_attention` computes the attention densely, in blocks of query
groups where the [G, T, T] logits would not fit. Inside
`count_attention(fn)` it computes no products: it returns a stand-in of
the same shape and wiring and calls fn(g, t, d, backward) once a call,
so that the work counter (perfbench/work.py) counts attention by its
formula instead. A reference that computes no attention records nothing.
"""

from __future__ import annotations

import contextlib

import torch

# bytes of one block's [rows, T, T] float32 logits
ATTENTION_BLOCK_BYTES = 2 << 30

_attention_counter = None


@contextlib.contextmanager
def count_attention(fn):
    global _attention_counter
    before, _attention_counter = _attention_counter, fn
    try:
        yield
    finally:
        _attention_counter = before


def dense_rel_attention(q, k, v, table, max_pos: int):
    """softmax((q.k + q.E[clip(i - j) + max_pos]) / sqrt(d)) . v over
    [G, T, d] tensors, the logits in blocks of groups."""
    g, t, d = q.shape
    if _attention_counter is not None:
        _attention_counter(g, t, d, torch.is_grad_enabled() and q.requires_grad)
        return v + 0.0 * (q + k) + 0.0 * table.sum()
    pos = torch.arange(t, device=q.device)
    dist = (pos[:, None] - pos[None, :]).clamp(-max_pos, max_pos) + max_pos
    scale = d ** -0.5
    rows = max(1, ATTENTION_BLOCK_BYTES // (4 * t * t))
    outs = []
    for g0 in range(0, g, rows):
        qb, kb, vb = q[g0:g0 + rows], k[g0:g0 + rows], v[g0:g0 + rows]
        logits = qb @ kb.transpose(1, 2)
        logits = logits + torch.gather(qb @ table.t(), 2, dist.expand(qb.shape[0], t, t))
        outs.append(torch.softmax(logits * scale, dim=-1) @ vb)
    return outs[0] if len(outs) == 1 else torch.cat(outs)
