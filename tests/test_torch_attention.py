"""The port's fused-attention wrapper (CPU: its plain version) against the
JAX package's Pallas kernel, run in interpret mode as its own tests run it.

Tolerance atol 2e-5 / rtol 1e-4, as the JAX package holds its kernel to
its dense reference (tests/test_flash_attention.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmgan_tpu.models.conformer import RelPosAttention as JaxRelPosAttention
from cmgan_tpu.ops import flash_attention as jfa
from cmgan_torch.convert import _linear
from cmgan_torch.models.conformer import RelPosAttention
from cmgan_torch.ops import flash_attention as fa

MAX_POS = 512
ATOL, RTOL = 2e-5, 1e-4


def _qkv(rng, g, tq, tk, d=16, max_pos=MAX_POS):
    q = rng.standard_normal((g, tq, d)).astype(np.float32) * 0.5
    k = rng.standard_normal((g, tk, d)).astype(np.float32) * 0.5
    v = rng.standard_normal((g, tk, d)).astype(np.float32)
    table = rng.standard_normal((2 * max_pos + 1, d)).astype(np.float32)
    return q, k, v, table


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("t", [64, 200, 321])
def test_matches_jax_kernel(rng, t):
    q, k, v, table = _qkv(rng, 6, t, t)
    ref = np.asarray(jfa.flash_rel_attention(*map(jnp.asarray, (q, k, v, table)), MAX_POS))
    ours = fa.flash_rel_attention(*_t(q, k, v, table), MAX_POS).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


def test_clipping_active(rng):
    # T > max_pos, so the distance clipping is in play
    max_pos = 64
    q, k, v, table = _qkv(rng, 2, 160, 160, max_pos=max_pos)
    ref = np.asarray(jfa.flash_rel_attention(*map(jnp.asarray, (q, k, v, table)), max_pos))
    ours = fa.flash_rel_attention(*_t(q, k, v, table), max_pos).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("t_valid,q_offset,tq", [(150, 0, 256), (256, 128, 128), (200, 128, 96)])
def test_at_valid_and_offset(rng, t_valid, q_offset, tq):
    # Tk a multiple of 128, as the JAX kernel's q_offset contract asks
    tk = 256
    q, k, v, table = _qkv(rng, 3, tq, tk)
    ref = np.asarray(jfa.flash_rel_attention_at(
        *map(jnp.asarray, (q, k, v, table)), MAX_POS, t_valid, jnp.asarray(q_offset, jnp.float32)
    ))
    ours = fa.flash_rel_attention_at(*_t(q, k, v, table), MAX_POS, t_valid, q_offset).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


def test_reference_attention_matches_jax(rng):
    q, k, v, table = _qkv(rng, 2, 100, 100)
    band_j = jfa.make_rel_band(table, 100, MAX_POS)
    band_t = fa.make_rel_band(torch.from_numpy(table), 100, MAX_POS)
    np.testing.assert_array_equal(band_t.numpy(), np.asarray(band_j))
    ref = np.asarray(jfa.reference_attention(*map(jnp.asarray, (q, k, v, band_j)), 60))
    ours = fa.reference_attention(*_t(q, k, v), band_t, 60).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


def test_wrapper_counts_plain_calls_not_launches(rng):
    q, k, v, table = _t(*_qkv(rng, 1, 64, 64))
    launches, plain = fa.launches, fa.plain_calls
    fa.flash_rel_attention(q, k, v, table, MAX_POS)
    assert (fa.launches, fa.plain_calls) == (launches, plain + 1)


def test_wrapper_rejects_what_the_kernel_cannot_take(rng):
    q, k, v, table = _t(*_qkv(rng, 2, 64, 64))
    # any head dim on the CPU, against the JAX kernel at the same D; q and
    # k/v must agree on it; the CUDA kernels take any positive D
    narrow = [t[..., :8].contiguous() for t in (q, k, v, table)]
    ref = jfa.flash_rel_attention(*(jnp.asarray(t.numpy()) for t in narrow), MAX_POS)
    np.testing.assert_allclose(fa.flash_rel_attention(*narrow, MAX_POS).numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError):
        fa.flash_rel_attention(narrow[0], k, v, narrow[3], MAX_POS)
    assert fa.kernel_head_dim(257) == 257
    with pytest.raises(ValueError):
        fa.kernel_head_dim(0)
    with pytest.raises(TypeError):
        fa.flash_rel_attention(q.double(), k.double(), v.double(), table.double(), MAX_POS)
    with pytest.raises(TypeError):
        fa.flash_rel_attention(q.bfloat16(), k, v, table, MAX_POS)
    with pytest.raises(ValueError):
        fa.flash_rel_attention(q.transpose(0, 1), k, v, table, MAX_POS)
    with pytest.raises(ValueError):
        fa.flash_rel_attention_at(q, k, v, table, MAX_POS, t_valid=0)
    with pytest.raises(ValueError):
        fa.flash_rel_attention_at(q, k, v, table, MAX_POS, q_offset=32)
    # inputs that require grad are taken: the op is differentiable
    out = fa.flash_rel_attention(q.requires_grad_(), k, v, table, MAX_POS)
    assert out.requires_grad
    with torch.no_grad():
        assert not fa.flash_rel_attention(q, k, v, table, MAX_POS).requires_grad


def test_wrapper_bf16_plain_path(rng):
    q, k, v, table = _t(*_qkv(rng, 2, 100, 100))
    ours = fa.flash_rel_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                  table.bfloat16(), MAX_POS)
    assert ours.dtype == torch.bfloat16
    ref = fa.flash_rel_attention(q, k, v, table, MAX_POS)
    # bf16 inputs carry 8 significant bits: relative error ~2^-8 per input
    np.testing.assert_allclose(ours.float().numpy(), ref.numpy(), atol=3e-2)


def _port_attention(jax_params, dim, impl):
    mod = RelPosAttention(dim, attention_impl=impl)
    p = jax_params["params"]
    sd = {
        "to_q.weight": _linear(np.asarray(p["to_q"]["dense"]["kernel"])),
        "to_kv.weight": _linear(np.asarray(p["to_kv"]["dense"]["kernel"])),
        "to_out.weight": _linear(np.asarray(p["to_out"]["dense"]["kernel"])),
        "to_out.bias": np.asarray(p["to_out"]["dense"]["bias"]),
        "rel_pos_emb.weight": np.asarray(p["rel_pos_emb"]),
    }
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return mod.eval()


def test_relpos_attention_flash_matches_xla_and_jax(rng):
    """The module pre-scales q once and passes the table unscaled; a
    double-applied scale would show here. n >= 512, where 'auto' takes
    the flash wrapper."""
    b, n, dim = 1, 544, 64
    x = rng.standard_normal((b, n, dim)).astype(np.float32) * 0.5
    jmod = JaxRelPosAttention(dim, attention_impl="xla")
    variables = jmod.init({"params": jax.random.key(0)}, jnp.asarray(x))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))

    outs = {}
    for impl in ("flash", "xla", "auto"):
        calls = fa.plain_calls
        with torch.no_grad():
            outs[impl] = _port_attention(variables, dim, impl)(torch.from_numpy(x)).numpy()
        assert fa.plain_calls - calls == (0 if impl == "xla" else 1), impl
    np.testing.assert_allclose(outs["flash"], outs["xla"], atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(outs["auto"], outs["flash"], atol=0, rtol=0)
    np.testing.assert_allclose(outs["xla"], ref, atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(outs["flash"], ref, atol=5e-5, rtol=1e-4)


def test_seq_attention_not_ported():
    """'seq' is ported (ops/seq_attention.py): the module builds, and without
    a mesh it raises a clear error, as the JAX package's does."""
    module = RelPosAttention(64, attention_impl="seq")
    with pytest.raises(ValueError, match="mesh"):
        module(torch.zeros(1, 40, 64))
