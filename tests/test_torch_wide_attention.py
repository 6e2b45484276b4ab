"""The wide kernels' walks (heads over 64) in plain PyTorch, on the CPU.

`wide_attention` does what the wide forward does
(csrc/flash_rel_attention_wide.cu): the head dim in 64-column chunks, a tile
pair's logits computed once a pass, each pass's output columns in two
halves, one a consumer warpgroup, one pass up to D 320.
`wide_attention_grads` does what the wide backward does
(csrc/flash_rel_attention_wide_bwd.cu): passes of two 64-column chunks, one
a consumer warpgroup, each computing a tile pair's logits once over the
whole head dim; the table's gradient carried
from one key tile to the next and added into the rows of persistent
blocks. Here they are held against the dense plain versions, so the
kernels' index work is checked without a card, and `plan` is checked at the
widths where passes, halves and padding change.

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
    # one key tile valid: the dk/dv kernel's units of keys 64 .. are wholly masked
    pytest.param(128, 48, 96, 200, 50, 60, id="D128-key-tiles-wholly-masked"),
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
    """Each pass's persistent blocks change the order of the table's sums,
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
def test_backward_passes_cover_the_head_once(d):
    """The wide backward's passes: chunks of at most 64 columns, one for each
    of at most two consumer warpgroups a pass, tiling the head dim once in
    order; the passes, each computing a tile pair's logits once, are what
    `plan` reports for both backward kernels."""
    passes = fa._bwd_passes(d)
    chunks = [c for p in passes for c in p]
    assert all(1 <= len(p) <= fa.WIDE_GROUPS for p in passes)
    assert [c.start for c in chunks] == list(range(0, d, fa.WIDE_CHUNK))
    assert chunks[-1].stop == d and all(0 < c.stop - c.start <= fa.WIDE_CHUNK for c in chunks)
    assert len(passes) == -(-d // (fa.WIDE_CHUNK * fa.WIDE_GROUPS))
    p = fa.plan(d)
    assert p.slabs["bwd_q"] == p.slabs["bwd_k"] == (len(passes), fa.WIDE_SLABS["bwd_q"])


@pytest.mark.parametrize("d", [65, 80, 100, 128, 200, 256, 257, 320, 512, 1000])
def test_slabs_cover_the_head_once(d):
    """Each kernel's passes tile the head dim's columns exactly, none wider
    than its limit, and the logits compute fewer than 16 padded columns. The
    forward's passes are of equal widths (rounded up to 16), each in two
    halves, one a consumer warpgroup, of at most WIDE_FWD_HALF columns (the
    second narrower, or empty, at the head's end): `plan` reports the passes
    and a half's width."""
    p = fa.plan(d)
    assert p.path == "wide" and p.width == d and 0 <= p.padded_columns < 16
    n, half = p.slabs["fwd"]
    halves = [h for pair in fa._fwd_passes(d) for h in pair]
    assert len(halves) == fa.WIDE_GROUPS * n and half % 8 == 0 and half <= fa.WIDE_FWD_HALF
    assert n == -(-d // fa.WIDE_SLABS["fwd"])
    assert [h.start for h in halves] == [min(d, i * half) for i in range(len(halves))]
    assert halves[-1].stop == d and all(0 <= h.stop - h.start <= half for h in halves)
    assert all(h.stop > h.start for h in halves[:-1])
    cols = [slice(q[0].start, q[-1].stop) for q in fa._bwd_passes(d)]
    for name in ("bwd_q", "bwd_k"):
        n, width = p.slabs[name]
        assert len(cols) == n and width % 8 == 0 and width <= fa.WIDE_SLABS[name]
        assert [c.start for c in cols] == list(range(0, d, width)) and cols[-1].stop == d
        assert all(0 < c.stop - c.start <= width for c in cols)


@pytest.mark.parametrize("d,passes", [(80, 1), (100, 1), (128, 1), (256, 1), (320, 1), (321, 2),
                                      (512, 2), (1000, 4)])
def test_forward_computes_the_logits_once_a_pass(monkeypatch, d, passes):
    """The wide forward's walk computes each tile pair's logits once a pass,
    and one pass holds every head dim up to 320 (the two consumer
    warpgroups' halves of at most 160 columns): `plan` agrees at every D of
    80 .. 320."""
    assert all(fa.plan(x).slabs["fwd"][0] == 1 for x in range(80, 321))
    assert fa.plan(d).slabs["fwd"][0] == passes
    rng = np.random.default_rng(d)
    q, k, v, table, _ = _inputs(rng, 1, 70, 140, d, 32)
    calls = []
    tile_logits = fa._tile_logits
    monkeypatch.setattr(fa, "_tile_logits", lambda *a, **kw: calls.append(a[4]) or tile_logits(*a, **kw))
    out = fa.wide_attention(q, k, v, table, 32, 130, 50)
    pairs = list(fa._tile_pairs(70, 130, 50, 32, 64))
    assert len(calls) == passes * len(pairs)
    ref = fa.reference_attention(q, k, v, fa.make_rel_band(table, 140, 32), 130, 50)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)
