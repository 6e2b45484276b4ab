"""The tile-by-tile plain versions of the port's attention kernels
(`tiled_attention`, `tiled_attention_grads`: the window of E, R and its
skew, the clipped tile pairs' two scalars, the online softmax, dR and
dE_window = dR^T . Q) against the dense plain versions and against the
JAX package's Pallas kernels, run in interpret mode as its own tests run
them. This is where the kernels' index arithmetic is checked without a
card.

Tolerances. Forward: atol 2e-5 / rtol 1e-4, what the JAX package holds
its kernel to (fp32 sums in another order, ~1e-6 seen). Gradients: 1e-4
of the reference's largest entry: every entry sums up to G*T*T fp32
products in an order that differs between tile walks (rows 0 and
2*max_pos of the table collect every distant pair), ~1e-6 seen. The
table's gradient is summed as the kernels sum it: rows of partial sums,
one a persistent block, added in block order.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmgan_tpu.ops import flash_attention as jfa
from cmgan_torch.ops import _build
from cmgan_torch.ops import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)

ATOL, RTOL = 2e-5, 1e-4
GRAD_TOL = 1e-4

# g, tq, tk, max_pos, t_valid, q_offset, tile, kinds of tile pair that must occur
CASES = [
    pytest.param(2, 200, 200, 8, 200, 0, 16, {"mixed", "high", "low"}, id="small-max_pos-all-kinds"),
    pytest.param(2, 200, 200, 8, 187, 0, 16, {"mixed", "high", "low"}, id="t_valid-inside-a-tile"),
    pytest.param(3, 100, 100, 512, 100, 0, 64, {"mixed"}, id="T-not-a-multiple-of-the-tile"),
    pytest.param(2, 70, 256, 8, 256, 128, 16, {"mixed", "high", "low"}, id="q_offset-Tq-below-Tk"),
    pytest.param(2, 96, 256, 64, 200, 128, 64, {"mixed", "high"}, id="offset-valid-and-clipping"),
    pytest.param(1, 641, 641, 512, 641, 0, 64, {"mixed", "high", "low"}, id="max_pos-512-T-641"),
]
# the JAX kernel's q_offset contract asks Tk to be a multiple of 128; it takes these
JAX_CASES = [c for c in CASES if c.values[2] % 128 == 0 or c.values[5] == 0]


def _inputs(rng, g, tq, tk, max_pos, d=16):
    q = rng.standard_normal((g, tq, d)).astype(np.float32) * 0.5
    k = rng.standard_normal((g, tk, d)).astype(np.float32) * 0.5
    v = rng.standard_normal((g, tk, d)).astype(np.float32)
    table = rng.standard_normal((2 * max_pos + 1, d)).astype(np.float32)
    cot = rng.standard_normal((g, tq, d)).astype(np.float32)
    return q, k, v, table, cot


def _assert_grads(ours, ref):
    for name, a, b in zip(("dq", "dk", "dv", "dE"), ours, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= GRAD_TOL * np.abs(b).max(), name


@pytest.mark.parametrize("g,tq,tk,max_pos,t_valid,q_offset,tile,kinds", CASES)
def test_every_kind_of_tile_pair_occurs(g, tq, tk, max_pos, t_valid, q_offset, tile, kinds):
    seen = {kind for *_, kind in fa._tile_pairs(tq, t_valid, q_offset, max_pos, tile)}
    assert seen == kinds


@pytest.mark.parametrize("g,tq,tk,max_pos,t_valid,q_offset,tile,kinds", CASES)
def test_tiled_forward_matches_dense(rng, g, tq, tk, max_pos, t_valid, q_offset, tile, kinds):
    q, k, v, table, _ = map(torch.from_numpy, _inputs(rng, g, tq, tk, max_pos))
    ref = fa.reference_attention(q, k, v, fa.make_rel_band(table, tk, max_pos), t_valid, q_offset)
    out, lse = fa.tiled_attention(q, k, v, table, max_pos, t_valid, q_offset, tile, return_lse=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)
    assert lse.shape == (g, tq) and bool(torch.isfinite(lse).all())


@pytest.mark.parametrize("g,tq,tk,max_pos,t_valid,q_offset,tile,kinds", CASES)
def test_tiled_grads_match_dense(rng, g, tq, tk, max_pos, t_valid, q_offset, tile, kinds):
    q, k, v, table, cot = map(torch.from_numpy, _inputs(rng, g, tq, tk, max_pos))
    ref = fa.reference_attention_grads(q, k, v, table, max_pos, t_valid, q_offset, cot)
    ours = fa.tiled_attention_grads(q, k, v, table, max_pos, t_valid, q_offset, cot, tile)
    _assert_grads(ours, ref)
    assert bool((ours[1][:, t_valid:] == 0).all()) and bool((ours[2][:, t_valid:] == 0).all())


@pytest.mark.parametrize("g,tq,tk,max_pos,t_valid,q_offset,tile,kinds", JAX_CASES)
def test_tiled_matches_jax_kernels(rng, g, tq, tk, max_pos, t_valid, q_offset, tile, kinds):
    q, k, v, table, cot = _inputs(rng, g, tq, tk, max_pos)
    out_j, vjp = jax.vjp(
        lambda *a: jfa.flash_rel_attention_at(*a, max_pos, t_valid,
                                              jnp.asarray(q_offset, jnp.float32)),
        *map(jnp.asarray, (q, k, v, table)),
    )
    ref = vjp(jnp.asarray(cot))
    tensors = list(map(torch.from_numpy, (q, k, v, table)))
    out = fa.tiled_attention(*tensors, max_pos, t_valid, q_offset, tile)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATOL, rtol=RTOL)
    ours = fa.tiled_attention_grads(*tensors, max_pos, t_valid, q_offset, torch.from_numpy(cot), tile)
    _assert_grads([x.numpy() for x in ours], ref)


# kernel #2 keeps the table's gradient in global memory, a row of partial
# sums a consumer warpgroup, at every head dim and table length: head dim 32,
# and tables longer than the models' (max_pos 800, and 1536, the longest
# chip_smoke.py holds the kernel to)
GLOBAL_DE_CASES = [
    pytest.param(2, 256, 40, 32, id="D32"),
    pytest.param(1, 900, 800, 16, id="max_pos-800"),
    pytest.param(1, 1664, 1536, 16, id="max_pos-1536"),
]


@pytest.mark.parametrize("g,t,max_pos,d", GLOBAL_DE_CASES)
def test_tiled_matches_jax_kernels_where_the_table_gradient_is_global(rng, g, t, max_pos, d):
    q, k, v, table, cot = _inputs(rng, g, t, t, max_pos, d)
    assert {kind for *_, kind in fa._tile_pairs(t, t, 0, max_pos, 64)} == {"mixed", "high", "low"}
    _, vjp = jax.vjp(lambda *a: jfa.flash_rel_attention_at(*a, max_pos, t, jnp.asarray(0.0)),
                     *map(jnp.asarray, (q, k, v, table)))
    ref = vjp(jnp.asarray(cot))
    ours = fa.tiled_attention_grads(*map(torch.from_numpy, (q, k, v, table)), max_pos, t, 0,
                                    torch.from_numpy(cot), blocks=3)
    _assert_grads([x.numpy() for x in ours], ref)


@pytest.mark.parametrize("units", [1, 2, 3])
@pytest.mark.parametrize("blocks", [1, 3, 132])
def test_block_count_moves_only_the_table_sums_order(rng, blocks, units):
    """The persistent blocks' rows (one a row unit: `units` of them a block)
    change the order of the table's sums, and nothing else: dq, dk and dv
    are bitwise those of one block of one unit."""
    q, k, v, table, cot = map(torch.from_numpy, _inputs(rng, 3, 200, 200, 8))
    one = fa.tiled_attention_grads(q, k, v, table, 8, 187, 0, cot, tile=16, blocks=1, units=1)
    ours = fa.tiled_attention_grads(q, k, v, table, 8, 187, 0, cot, tile=16, blocks=blocks,
                                    units=units)
    assert all(torch.equal(a, b) for a, b in zip(ours[:3], one[:3]))
    _assert_grads(ours, one)


def test_backward_work_at_the_g_step_keeps_its_counts():
    """The yardstick of kernel #2's rows in PERF.md: the work the gradient
    needs at the G step's shape (G 1616, T 641, max_pos 512, D 16) is counted
    from the function, not from any kernel, so a redesign leaves it as it was."""
    fp32 = fa.attention_work(1616, 641, 641, 641, 0, 512, 16, 4, backward=True)
    bf16 = fa.attention_work(1616, 641, 641, 641, 0, 512, 16, 2, backward=True)
    assert fp32 == {"flop": 167378195456, "bytes": 534632896, "exps": 663983696,
                    "near": 394111, "far": 16770}
    assert bf16 == {**fp32, "bytes": 269420960}


def test_tile_width_does_not_change_the_function(rng):
    q, k, v, table, cot = map(torch.from_numpy, _inputs(rng, 2, 150, 150, 20))
    a = fa.tiled_attention_grads(q, k, v, table, 20, 140, 0, cot, tile=16)
    b = fa.tiled_attention_grads(q, k, v, table, 20, 140, 0, cot, tile=64)
    _assert_grads(a, b)


def test_tiled_versions_keep_the_input_type(rng):
    q, k, v, table, cot = (torch.from_numpy(a).bfloat16() for a in _inputs(rng, 2, 80, 80, 8))
    out = fa.tiled_attention(q, k, v, table, 8, 80, 0, tile=16)
    grads = fa.tiled_attention_grads(q, k, v, table, 8, 80, 0, cot, tile=16)
    assert out.dtype == torch.bfloat16 and all(x.dtype == torch.bfloat16 for x in grads)


def test_library_path_follows_an_included_header(tmp_path, monkeypatch):
    """The build is keyed by the source and by every header under csrc/ it
    includes: a change to the header alone gives another library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    header = csrc / "flash_rel_common.cuh"
    assert str(header) in _build.source_files(fa.KERNEL)
    assert str(header) in _build.source_files(fa.BWD_KERNEL)
    before = {name: _build.library_path(name)
              for name in (fa.KERNEL, fa.BWD_KERNEL, "fused_layernorm")}
    assert before[fa.KERNEL] == _build.library_path(fa.KERNEL)
    with open(header, "a") as f:
        f.write("// changed\n")
    assert _build.library_path(fa.KERNEL) != before[fa.KERNEL]
    assert _build.library_path(fa.BWD_KERNEL) != before[fa.BWD_KERNEL]
    # a source that does not include the header keeps its library
    assert _build.library_path("fused_layernorm") == before["fused_layernorm"]
    assert os.path.dirname(before[fa.KERNEL]).startswith(_build.BUILD_ROOT)


# queries a block of the forward kernel owns: 64 a consumer warpgroup, three
# warpgroups (bf16 at head dim 16) or two (`Cfg::NCW`, csrc/flash_rel_attention.cu)
BLOCK_QUERIES = [pytest.param(128, id="block-128"), pytest.param(192, id="block-192")]
# rows a block of each backward kernel owns (`consumer_warpgroups`,
# csrc/flash_rel_attention_bwd.cu): consumer warpgroups of 64 rows, three
# for bf16 up to head dim 32, two otherwise, one for fp32 at head dim 64
BWD_BLOCK_ROWS = [pytest.param(64, id="block-64"), pytest.param(128, id="block-128"),
                  pytest.param(192, id="block-192")]


@pytest.mark.parametrize("block", BLOCK_QUERIES)
@pytest.mark.parametrize("g,tq,tk,max_pos,t_valid,q_offset,tile,kinds", CASES)
def test_every_mixed_window_is_a_slice_of_its_blocks_window(g, tq, tk, max_pos, t_valid,
                                                            q_offset, tile, kinds, block):
    """The forward kernel stages one window of block + 63 table rows a block
    and key tile, row c being E[clip(base + c, +-max_pos) + max_pos]: each
    mixed pair's window (64 queries, 127 rows) is its rows from 64 *
    warpgroup on, equal to `_window`'s; and where none of the block's rows
    is clipped, the window is one contiguous slice of the table (the TMA
    box from row base + max_pos)."""
    table = torch.arange((2 * max_pos + 1) * 4, dtype=torch.float32).reshape(-1, 4) + 1
    pairs = {(i0, j0): (base, kind) for i0, _, j0, _, base, kind
             in fa._tile_pairs(tq, t_valid, q_offset, max_pos, 64)}
    seen = boxes = 0
    for b0 in range(0, tq, block):
        for j0 in range(0, t_valid, 64):
            base = b0 + q_offset - j0 - 63
            rows = (torch.arange(block + 64) + base).clamp(-max_pos, max_pos) + max_pos
            window = table[rows]
            if base >= -max_pos and base + block + 63 <= max_pos:
                start = base + max_pos
                assert torch.equal(window, table[start:start + block + 64])
                boxes += 1
            for i0 in range(b0, min(b0 + block, tq), 64):
                base_w, kind = pairs[(i0, j0)]
                if kind == "mixed":
                    mine = window[i0 - b0:i0 - b0 + 127]
                    assert torch.equal(mine, table[fa._window(table, base_w, max_pos, 64)])
                    seen += 1
    assert seen > 0 and (boxes > 0 or max_pos < block)


@pytest.mark.parametrize("owner", ["queries", "keys"])
@pytest.mark.parametrize("block", BWD_BLOCK_ROWS)
@pytest.mark.parametrize("g,tq,tk,max_pos,t_valid,q_offset,tile,kinds", CASES)
def test_every_backward_window_is_a_slice_of_its_blocks_window(g, tq, tk, max_pos, t_valid,
                                                                q_offset, tile, kinds, block, owner):
    """The backward kernels stage one window of block + 64 table rows a block
    and tile of the walk, row c being E[clip(row0 + c, +-max_pos) + max_pos].
    The dq kernel's block owns `block` queries from b0 and walks key tiles
    j0: its window starts at the distance of its first queries, and
    warpgroup wg's (64 queries from b0 + 64 wg) at row 64 wg. The dk/dv
    kernel's owns `block` keys from b0 and walks query tiles i0: its window
    starts at the distance of its last keys, and warpgroup wg's (64 keys from
    b0 + 64 wg) at row block - 64 - 64 wg. Each mixed pair's window (127
    rows) is `_window`'s; where none of a block's rows is clipped, the window
    is one slice of the table (the TMA box)."""
    table = torch.arange((2 * max_pos + 1) * 4, dtype=torch.float32).reshape(-1, 4) + 1
    pairs = {(i0, j0): (base, kind) for i0, _, j0, _, base, kind
             in fa._tile_pairs(tq, t_valid, q_offset, max_pos, 64)}
    seen = boxes = 0
    for b0 in range(0, tq if owner == "queries" else t_valid, block):
        for w0 in range(0, t_valid if owner == "queries" else tq, 64):
            i0, j0 = (b0, w0) if owner == "queries" else (w0, b0)
            base = i0 + q_offset - j0 - 63
            row0 = base if owner == "queries" else base - (block - 64)
            window = table[(torch.arange(block + 64) + row0).clamp(-max_pos, max_pos) + max_pos]
            if row0 >= -max_pos and row0 + block + 63 <= max_pos:
                start = row0 + max_pos
                assert torch.equal(window, table[start:start + block + 64])
                boxes += 1
            for wg in range(block // 64):
                i0w, j0w = (i0 + 64 * wg, j0) if owner == "queries" else (i0, j0 + 64 * wg)
                if (i0w, j0w) not in pairs or pairs[(i0w, j0w)][1] != "mixed":
                    continue
                off = 64 * wg if owner == "queries" else block - 64 - 64 * wg
                mine = window[off:off + 127]
                assert torch.equal(mine, table[fa._window(table, pairs[(i0w, j0w)][0], max_pos, 64)])
                seen += 1
    assert seen > 0 and (boxes > 0 or max_pos < block)
