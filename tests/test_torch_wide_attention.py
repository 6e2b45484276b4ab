"""The wide kernels' walk (heads over 64) in plain PyTorch, on the CPU.

`wide_attention` and `wide_attention_grads` do what the wide CUDA kernels
do (csrc/flash_rel_attention_wide.cu): the head dim in chunks, the output's
columns in slabs that recompute the logits, the table's gradient added once
a tile pair, window row and slab column. Here they are held against the
dense plain versions, so the kernels' index work is checked without a card,
and `plan` is checked at the widths where slabs and padding change.

Tolerances as in test_torch_attention.py and test_torch_attention_grad.py:
atol 2e-5 / rtol 1e-4, the table's gradient 1e-5 of its largest entry
(fp32 sums in another order; ~1e-6 seen).
"""

import numpy as np
import pytest
import torch

from cmgan_torch.ops import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)

ATOL, RTOL = 2e-5, 1e-4


def _inputs(rng, g, tq, tk, d, max_pos):
    q = rng.standard_normal((g, tq, d)).astype(np.float32) * d ** -0.5
    k = rng.standard_normal((g, tk, d)).astype(np.float32) * 0.5
    v = rng.standard_normal((g, tk, d)).astype(np.float32)
    table = rng.standard_normal((2 * max_pos + 1, d)).astype(np.float32)
    cot = rng.standard_normal((g, tq, d)).astype(np.float32)
    return tuple(map(torch.from_numpy, (q, k, v, table, cot)))


# d, max_pos, tq, tk, t_valid, q_offset: every case has masked keys and an offset
CASES = [
    pytest.param(80, 48, 96, 200, 180, 64, id="D80-one-slab"),
    pytest.param(100, 32, 100, 160, 150, 40, id="D100-padded-depth-step"),
    pytest.param(320, 32, 70, 140, 130, 50, id="D320-slabs-in-every-kernel"),
]


@pytest.mark.parametrize("d,max_pos,tq,tk,t_valid,q_offset", CASES)
def test_wide_walk_matches_dense(rng, d, max_pos, tq, tk, t_valid, q_offset):
    q, k, v, table, cot = _inputs(rng, 2, tq, tk, d, max_pos)
    # mixed tile pairs (the window and its skew) and wholly clipped ones (one scalar a query)
    assert {kind for *_, kind in fa._tile_pairs(tq, t_valid, q_offset, max_pos, 64)} == {
        "mixed", "high"}
    ref = fa.reference_attention(q, k, v, fa.make_rel_band(table, tk, max_pos), t_valid, q_offset)
    out, lse = fa.wide_attention(q, k, v, table, max_pos, t_valid, q_offset, return_lse=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)
    assert lse.shape == (2, tq) and bool(torch.isfinite(lse).all())
    ref_grads = fa.reference_attention_grads(q, k, v, table, max_pos, t_valid, q_offset, cot)
    grads = fa.wide_attention_grads(q, k, v, table, max_pos, t_valid, q_offset, cot)
    for name, a, b in zip(("dq", "dk", "dv"), grads[:3], ref_grads[:3]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=RTOL, err_msg=name)
    np.testing.assert_allclose(grads[3].numpy(), ref_grads[3].numpy(),
                               atol=1e-5 * ref_grads[3].abs().max().item(), rtol=RTOL)


@pytest.mark.parametrize("blocks", [1, 5])
def test_wide_walk_blocks_move_only_the_table_sums_order(rng, blocks):
    """Each slab's persistent blocks change the order of the table's sums,
    and nothing else: dq, dk and dv are bitwise those of the default."""
    q, k, v, table, cot = _inputs(rng, 3, 70, 140, 320, 32)
    ref = fa.wide_attention_grads(q, k, v, table, 32, 130, 50, cot)
    ours = fa.wide_attention_grads(q, k, v, table, 32, 130, 50, cot, blocks=blocks)
    assert all(torch.equal(a, b) for a, b in zip(ours[:3], ref[:3]))
    np.testing.assert_allclose(ours[3].numpy(), ref[3].numpy(),
                               atol=1e-5 * ref[3].abs().max().item(), rtol=RTOL)


def test_wide_walk_keeps_the_input_type(rng):
    q, k, v, table, cot = (t.bfloat16() for t in _inputs(rng, 1, 40, 70, 72, 16))
    out = fa.wide_attention(q, k, v, table, 16, 70, 30)
    grads = fa.wide_attention_grads(q, k, v, table, 16, 70, 30, cot)
    assert out.dtype == torch.bfloat16 and all(x.dtype == torch.bfloat16 for x in grads)
    ref = fa.reference_attention(q, k, v, fa.make_rel_band(table, 70, 16), 70, 30)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(), atol=8e-3, rtol=8e-3)


@pytest.mark.parametrize("d", [65, 80, 100, 128, 200, 256, 257, 320, 512, 1000])
def test_slabs_cover_the_head_once(d):
    """Each kernel's slabs tile the head dim's columns exactly, none wider
    than its limit, and the logits compute fewer than 16 padded columns."""
    p = fa.plan(d)
    assert p.path == "wide" and p.width == d and 0 <= p.padded_columns < 16
    for name in fa.WIDE_SLABS:
        n, width = p.slabs[name]
        cols = fa._slabs(d, name)
        assert len(cols) == n and width % 8 == 0 and width <= fa.widest_slab(d, name)
        assert [c.start for c in cols] == list(range(0, d, width)) and cols[-1].stop == d
        assert all(0 < c.stop - c.start <= width for c in cols)
