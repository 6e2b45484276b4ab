"""The port's sequence-parallel attention (`ops/seq_attention.py`) against
the JAX package's, on the CPU.

- The per-rank function for every rank in one process, against the
  unsharded plain version: forward and the gradients in q, k, v and the
  table, at the JAX tests' cases (T 1024 / 4 ranks, 777 / 4, 512 / 2).
- `seq_rel_attention` over 2 and 4 gloo ranks (spawned processes, one
  pool for the file) against JAX's `seq_rel_attention` on the virtual
  CPU mesh, same numpy-seeded inputs: output and gradients on every rank.
- `RelPosAttention('seq')` on a 2 x 2 data x seq grid against 'xla'.

Tolerances are the JAX tests' (tests/test_seq_parallel.py): outputs atol
3e-5 rtol 1e-4, gradients atol 2e-4 rtol 1e-3, the module 5e-5 / 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_workers as workers
from cmgan_tpu.ops import seq_attention as jseq
from cmgan_torch.models.conformer import RelPosAttention
from cmgan_torch.ops import flash_attention as fa
from cmgan_torch.ops import seq_attention as sa

MAX_POS = 512
CASES = [(1024, 4), (777, 4), (512, 2)]   # (T, ranks)
OUT_TOL = dict(atol=3e-5, rtol=1e-4)
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)
MODULE_TOL = dict(atol=5e-5, rtol=1e-4)
DIM, ROWS, FRAMES = 64, 2, 300   # the module case: 4 heads of 16, 300 frames


def _inputs(t, g=4, d=16):
    rng = np.random.default_rng(t)
    q = (rng.standard_normal((g, t, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((g, t, d)) * 0.5).astype(np.float32)
    v = rng.standard_normal((g, t, d)).astype(np.float32)
    table = rng.standard_normal((2 * MAX_POS + 1, d)).astype(np.float32)
    return q, k, v, table


def _module_case():
    torch.manual_seed(3)
    module = RelPosAttention(DIM, attention_impl="xla")
    x = (np.random.default_rng(4).standard_normal((ROWS, FRAMES, DIM)) * 0.5).astype(np.float32)
    return module, x


@pytest.fixture(scope="module")
def ranked():
    """Every multi-rank case of this file in one pool of 4 processes."""
    cases = [(f"seq_{t}_{n}", tuple(range(n)), "seq_attention",
              dict(zip(("q", "k", "v", "table"), _inputs(t)), max_pos=MAX_POS))
             for t, n in CASES]
    module, x = _module_case()
    cases.append(("module", (0, 1, 2, 3), "relpos_attention",
                  dict(state_dict=module.state_dict(), dim=DIM, x=x)))
    return workers.run(cases)


def _jax_seq(t, n):
    """JAX's output and gradients of sum(sin(out)) over an n-device seq mesh."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    args = [jnp.asarray(a) for a in _inputs(t)]

    def loss(q, k, v, table):
        out = jseq.seq_rel_attention(q, k, v, table, MAX_POS, mesh)
        return jnp.sum(jnp.sin(out)), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def test_local_block_pads_as_jax_does():
    for t, n in [*CASES, (4801, 4), (321, 4), (321, 1), (4801, 1)]:
        assert sa.local_block(t, n) == jseq._round_up(-(-t // n), jseq._BLOCK)
    assert sa.local_block(4801, 4) == 1280 and sa.local_block(321, 4) == 128


@pytest.mark.parametrize("t,n", CASES)
def test_per_rank_function_matches_unsharded(t, n):
    """All n ranks' blocks in one process: concatenated, the forward and
    the summed gradients are the unsharded plain version's."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in _inputs(t)]
    calls = fa.plain_calls
    blocks = [sa.local_attention(*leaves, MAX_POS, r, n) for r in range(n)]
    assert fa.plain_calls - calls == n
    t_loc = sa.local_block(t, n)
    assert all(b.shape == (4, t_loc, 16) for b in blocks)
    out = torch.cat(blocks, dim=1)[:, :t]
    grads = torch.autograd.grad(out.sin().sum(), leaves)

    ref_leaves = [torch.from_numpy(a).requires_grad_() for a in _inputs(t)]
    ref = fa.flash_rel_attention(*ref_leaves, MAX_POS)
    ref_grads = torch.autograd.grad(ref.sin().sum(), ref_leaves)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), **OUT_TOL)
    for name, a, b in zip(("dq", "dk", "dv", "dtable"), grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("t,n", CASES)
def test_gloo_ranks_match_jax_seq_attention(ranked, t, n):
    ref, ref_grads = _jax_seq(t, n)
    results = ranked[f"seq_{t}_{n}"]
    assert len(results) == n
    for rank, res in enumerate(results):
        assert res["shape"] == {"data": 1, "seq": n} and res["calls"] == 1
        np.testing.assert_allclose(res["out"], ref, **OUT_TOL, err_msg=f"rank {rank}")
        for name, a, b in zip(("dq", "dk", "dv", "dtable"), res["grads"], ref_grads):
            np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=f"rank {rank} {name}")


def test_relpos_attention_seq_on_data_seq_grid_matches_xla(ranked):
    module, x = _module_case()
    rows = torch.from_numpy(x).requires_grad_()
    ref = module(rows)
    (ref_grad,) = torch.autograd.grad(ref.sin().sum(), rows)
    results = ranked["module"]
    assert {(r["data_rank"], r["seq_rank"]) for r in results} == {(0, 0), (0, 1), (1, 0), (1, 1)}
    for res in results:
        d = res["data_rank"]
        np.testing.assert_allclose(res["out"], ref[d:d + 1].detach().numpy(), **MODULE_TOL)
        np.testing.assert_allclose(res["grad"], ref_grad[d:d + 1].numpy(), **MODULE_TOL)


def test_seq_attention_without_a_mesh_raises():
    q, k, v, table = (torch.from_numpy(a) for a in _inputs(512))
    with pytest.raises(ValueError, match="mesh"):
        sa.seq_rel_attention(q, k, v, table, MAX_POS)
    with pytest.raises(ValueError, match="mesh"):
        RelPosAttention(DIM, attention_impl="seq")(torch.zeros(1, 40, DIM))
