"""The batched torch PESQ (`metrics/pesq_torch.py`) against the JAX
package's `pesq_mos_jax` / `pesq_labels_jax`, on the CPU in float32.

Tolerances: scores atol 1e-3 MOS (both compute in float32 with FFTs of
different libraries; 1.2e-6 seen). The gradient with respect to `deg`:
relative L2 <= 1e-3 (3.2e-6 seen). It is compared on pairs where every
frame carries some disturbance: where a frame has none, its disturbance
is sqrt(0) and JAX's gradient through `maximum` multiplies the infinite
slope by a zero mask into NaN for the whole row, while torch's `clamp`
masks it to 0. Against the host C++ scorer (time alignment, lfilter,
float64): 5e-3 MOS, the band the JAX package documents for its version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmgan_tpu.metrics.pesq_jax import pesq_labels_jax, pesq_mos_jax
from cmgan_torch.metrics import pesq_torch as pt
from cmgan_torch.metrics.pesq_native import pesq_batch
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)

SR = 16000


def _speech(n, rng):
    t = np.arange(n) / SR
    f0 = rng.uniform(100, 220)
    x = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.3)) / h for h in range(1, 6))
    return 0.05 * x * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t)) + 0.02 * rng.standard_normal(n)


def _pairs(noise, n, seed=0):
    """[B, n] float32 clean and degraded, one row a noise level."""
    rng = np.random.default_rng(seed)
    clean = np.stack([_speech(n, rng) for _ in noise])
    deg = clean + np.asarray(noise)[:, None] * rng.standard_normal(clean.shape)
    return clean.astype(np.float32), deg.astype(np.float32)


@pytest.mark.parametrize("n", [48000, 4000])   # 186 frames, and 14 (< one 20-frame burst)
def test_scores_match_jax_and_the_host_scorer(n):
    clean, deg = _pairs((0.005, 0.01, 0.03), n)
    ours = pt.pesq_mos_torch(torch.from_numpy(clean), torch.from_numpy(deg))
    assert ours.dtype == torch.float32 and ours.shape == (3,)
    ours = ours.numpy()
    np.testing.assert_allclose(ours, np.asarray(pesq_mos_jax(clean, deg)), atol=1e-3, rtol=0)
    np.testing.assert_allclose(ours, pesq_batch(clean, deg), atol=5e-3, rtol=0)
    assert ours[0] > ours[1] > ours[2]
    # float64 inputs are computed in float32, as JAX computes them without x64
    wide = pt.pesq_mos_torch(torch.from_numpy(clean).double(), torch.from_numpy(deg).double())
    np.testing.assert_array_equal(wide.numpy(), ours)


def test_labels_match_jax():
    clean, est = _pairs((0.005, 0.01, 0.02, 0.03), 16000, seed=1)
    clean[1] = 0.0        # a silent reference
    est[2] = 0.0          # a silent estimate
    est[3, 100] = np.nan  # a non-finite score
    ours = pt.pesq_labels_torch(torch.from_numpy(clean), torch.from_numpy(est)).numpy()
    theirs = np.asarray(pesq_labels_jax(clean, est))
    assert ours[1:].tolist() == theirs[1:].tolist() == [-1.0, -1.0, -1.0]
    assert ours[0] == pytest.approx(theirs[0], abs=1e-3) and ours[0] > 1.0


def test_gradient_matches_jax():
    clean, deg = _pairs((0.02, 0.03, 0.05), 48000, seed=5)
    want = np.asarray(jax.grad(lambda d: jnp.sum(pesq_mos_jax(jnp.asarray(clean), d)))(
        jnp.asarray(deg)))
    assert np.all(np.isfinite(want))
    leaf = torch.from_numpy(deg).requires_grad_()
    (got,) = torch.autograd.grad(pt.pesq_mos_torch(torch.from_numpy(clean), leaf).sum(), leaf)
    got = got.numpy()
    assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)


def test_smoother_matrix_is_the_recursion():
    """h_t = 0.8 h_{t-1} + 0.2 g_t from h_{-1} = 1, as one product."""
    g = np.random.default_rng(0).uniform(0.1, 3.0, (2, 249))
    want = np.empty_like(g)
    state = np.ones(2)
    for t in range(g.shape[1]):
        state = 0.8 * state + 0.2 * g[:, t]
        want[:, t] = state
    decay, h0 = pt._smoother(g.shape[1], torch.device("cpu"))
    got = (torch.from_numpy(g).float() @ decay + h0).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6)


def test_constants_are_cached_and_shapes_checked():
    cpu = torch.device("cpu")
    assert pt._constants(cpu) is pt._constants(cpu)
    assert pt._filters(64000, cpu) is pt._filters(64000, cpu)
    hp, bp = pt._filters(64000, cpu)
    assert hp.dtype == torch.complex64 and hp.shape == (2**16 + 1,)   # 2^17 >= 64000 + 4096
    assert bp.dtype == torch.float32 and bp.shape == (2**15 + 1,)     # 2^16 >= 64000
    with pytest.raises(ValueError):
        pt.pesq_mos_torch(torch.zeros(2, 4000), torch.zeros(2, 3000))
    with pytest.raises(ValueError):
        pt.pesq_mos_torch(torch.zeros(2, 400), torch.zeros(2, 400))
