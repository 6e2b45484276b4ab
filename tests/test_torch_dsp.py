"""The port's DSP front/back end against the JAX package's, on the CPU.

Same numpy-seeded signals through both; atol 2e-4 is the DSP parity
tolerance the JAX package holds itself to against torch (PARITY.md).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)

# the packages re-export the function `stft`, which hides the module
jstft = importlib.import_module("cmgan_tpu.dsp.stft")
tstft = importlib.import_module("cmgan_torch.dsp.stft")

ATOL = 2e-4
N_FFT, HOP = 400, 100


def _signal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32) * 0.1


def _complex_np(x):
    return np.asarray(x).astype(np.complex64)


def test_hamming_window():
    np.testing.assert_allclose(
        tstft.hamming_window(N_FFT).numpy(), np.asarray(jstft.hamming_window(N_FFT)), atol=1e-7
    )
    np.testing.assert_allclose(
        tstft.hamming_window(N_FFT).numpy(), torch.hamming_window(N_FFT).numpy(), atol=1e-6
    )


def test_window_is_built_once_and_serves_autograd_after_inference_mode(rng):
    """The window is cached per (size, type, device); one first made under
    inference mode (as Enhancer makes it) must still take part in autograd
    (as the training step uses it)."""
    with torch.inference_mode():
        tstft.stft(torch.from_numpy(_signal(rng, 2, 1600)), N_FFT, HOP)
    assert tstft.hamming_window(N_FFT) is tstft.hamming_window(N_FFT)
    x = torch.from_numpy(_signal(rng, 2, 1600)).requires_grad_()
    tstft.istft(tstft.stft(x, N_FFT, HOP), N_FFT, HOP).square().sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


@pytest.mark.parametrize("length", [16000, 16050, 32000])
def test_frame_signal(rng, length):
    x = _signal(rng, 2, length)
    ours = tstft.frame_signal(torch.from_numpy(x), N_FFT, HOP).numpy()
    ref = np.asarray(jstft.frame_signal(jnp.asarray(x), N_FFT, HOP))
    assert ours.shape == ref.shape == (2, length // HOP + 1, N_FFT)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("length", [16000, 16050, 32000])
def test_stft(rng, length):
    x = _signal(rng, 2, length)
    ours = tstft.stft(torch.from_numpy(x), N_FFT, HOP).numpy()
    ref = _complex_np(jstft.stft(jnp.asarray(x), N_FFT, HOP))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=ATOL)


@pytest.mark.parametrize("length", [None, 16000])
def test_istft(rng, length):
    x = _signal(rng, 2, 16000)
    spec = np.array(jstft.stft(jnp.asarray(x), N_FFT, HOP))
    ours = tstft.istft(torch.from_numpy(spec), N_FFT, HOP, length=length).numpy()
    ref = np.asarray(jstft.istft(jnp.asarray(spec), N_FFT, HOP, length=length))
    assert ours.shape == ref.shape == (2, 16000)
    np.testing.assert_allclose(ours, ref, atol=ATOL)
    # and the round trip gives the signal back
    np.testing.assert_allclose(ours, x, atol=ATOL)


def test_power_compress(rng):
    spec = (_signal(rng, 2, 41, 201) + 1j * _signal(rng, 2, 41, 201)).astype(np.complex64)
    ours = tstft.power_compress(torch.from_numpy(spec), 0.3).numpy()
    ref = np.asarray(jstft.power_compress(jnp.asarray(spec), exponent=0.3))
    assert ours.shape == ref.shape == (2, 41, 201, 2)
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_power_uncompress(rng):
    re, im = _signal(rng, 2, 41, 201), _signal(rng, 2, 41, 201)
    ours = tstft.power_uncompress(torch.from_numpy(re), torch.from_numpy(im), 0.3).numpy()
    ref = _complex_np(jstft.power_uncompress(jnp.asarray(re), jnp.asarray(im), exponent=0.3))
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_rms_normalize(rng):
    noisy, clean = _signal(rng, 3, 8000), _signal(rng, 3, 8000)
    n_t, c_t, s_t = tstft.rms_normalize(torch.from_numpy(noisy), torch.from_numpy(clean))
    n_j, c_j, s_j = jstft.rms_normalize(jnp.asarray(noisy), jnp.asarray(clean))
    for a, b in ((n_t, n_j), (c_t, c_j), (s_t, s_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=1e-6)
    only_n, only_s = tstft.rms_normalize(torch.from_numpy(noisy))
    np.testing.assert_allclose(only_n.numpy(), n_t.numpy())
    np.testing.assert_allclose(only_s.numpy(), s_t.numpy())


def test_matmul_dft_not_ported(rng):
    """The matmul DFT, once refused, is ported: `stft` / `istft` with
    dft_impl='matmul' against the JAX package's at n_fft 400, and an unknown
    dft_impl still raises."""
    x = _signal(rng, 1, 1600)
    ours = tstft.stft(torch.from_numpy(x), N_FFT, HOP, dft_impl="matmul")
    ref = jstft.stft(jnp.asarray(x), N_FFT, HOP, dft_impl="matmul")
    np.testing.assert_allclose(ours.numpy(), _complex_np(ref), atol=1e-5)
    back = tstft.istft(ours, N_FFT, HOP, dft_impl="matmul")
    ref_back = jstft.istft(ref, N_FFT, HOP, dft_impl="matmul")
    np.testing.assert_allclose(back.numpy(), np.asarray(ref_back), atol=1e-5)
    with pytest.raises(ValueError):
        tstft.stft(torch.from_numpy(x), N_FFT, HOP, dft_impl="dct")


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("n_fft,hop", [(400, 100), (1200, 300)])
def test_matmul_dft_matches_jax_and_the_fft(rng, n_fft, hop):
    """rdft_matmul / irdft_matmul against the JAX package's (the same float32
    matrices, products summed in another order: 1e-5 absolute), and the 'matmul' STFT round trip against the
    port's 'fft' (<= 1e-5 relative L2: float32 sums of n_fft products)."""
    frames = _signal(rng, 3, 7, n_fft)
    spec = tstft.rdft_matmul(torch.from_numpy(frames), n_fft)
    np.testing.assert_allclose(spec.numpy(), _complex_np(jstft.rdft_matmul(jnp.asarray(frames), n_fft)),
                               atol=1e-5)
    back = tstft.irdft_matmul(spec, n_fft)
    np.testing.assert_allclose(back.numpy(), np.asarray(jstft.irdft_matmul(jnp.asarray(spec.numpy()), n_fft)),
                               atol=1e-5)
    assert _rel(back.numpy(), frames) <= 1e-5

    x = _signal(rng, 2, 12 * hop + 37)
    by_mm = tstft.stft(torch.from_numpy(x), n_fft, hop, dft_impl="matmul")
    by_fft = tstft.stft(torch.from_numpy(x), n_fft, hop)
    assert _rel(by_mm.numpy(), by_fft.numpy()) <= 1e-5
    y_mm = tstft.istft(by_fft, n_fft, hop, length=x.shape[-1], dft_impl="matmul")
    y_fft = tstft.istft(by_fft, n_fft, hop, length=x.shape[-1])
    assert _rel(y_mm.numpy(), y_fft.numpy()) <= 1e-5


def test_dft_matrices_are_built_once_and_serve_autograd_after_inference_mode(rng):
    """Like the window: cached per (size, type, device), made outside
    inference mode, so a first use under `torch.inference_mode` (streaming)
    leaves them usable by a training step's autograd."""
    with torch.inference_mode():
        tstft.istft(tstft.stft(torch.from_numpy(_signal(rng, 1, 1200)), 1200, 300,
                               dft_impl="matmul"), 1200, 300, dft_impl="matmul")
    cpu = torch.device("cpu")
    assert tstft._rdft_matrices(1200, torch.float32, cpu) is tstft._rdft_matrices(1200, torch.float32, cpu)
    x = torch.from_numpy(_signal(rng, 2, 1200)).requires_grad_()
    spec = tstft.stft(x, 1200, 300, dft_impl="matmul")
    tstft.istft(spec, 1200, 300, dft_impl="matmul").square().sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


def test_gradients_through_the_dsp_chain_match_jax(rng):
    """Training differentiates waveform -> STFT -> compress, and compressed
    spectrum -> uncompress -> iSTFT -> waveform. Both chains against
    jax.grad; rtol 1e-3 plus 1e-4 of the largest entry (fp32 FFTs)."""
    import jax

    x = _signal(rng, 2, 1600)
    cot = rng.standard_normal((2, 17, 201, 2)).astype(np.float32)

    def jfront(xx):
        return jnp.sum(jstft.power_compress(jstft.stft(xx, N_FFT, HOP)) * cot)

    xt = torch.from_numpy(x).requires_grad_()
    (tstft.power_compress(tstft.stft(xt, N_FFT, HOP)) * torch.from_numpy(cot)).sum().backward()
    ref = np.asarray(jax.grad(jfront)(jnp.asarray(x)))
    np.testing.assert_allclose(xt.grad.numpy(), ref, atol=1e-4 * np.abs(ref).max(), rtol=1e-3)

    re = rng.standard_normal((2, 17, 201)).astype(np.float32)
    im = rng.standard_normal((2, 17, 201)).astype(np.float32)
    wcot = rng.standard_normal((2, 1600)).astype(np.float32)

    def jback(r, i):
        return jnp.sum(jstft.istft(jstft.power_uncompress(r, i), N_FFT, HOP) * wcot)

    rt, it = torch.from_numpy(re).requires_grad_(), torch.from_numpy(im).requires_grad_()
    (tstft.istft(tstft.power_uncompress(rt, it), N_FFT, HOP) * torch.from_numpy(wcot)).sum().backward()
    for got, want in zip((rt.grad, it.grad), jax.grad(jback, argnums=(0, 1))(jnp.asarray(re), jnp.asarray(im))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=1e-3)


def test_zero_bin_gradient_is_nan_in_both_packages():
    """sqrt and arctan2 at an exactly zero bin: neither package adds an epsilon."""
    import jax

    z = np.zeros((1, 1, 3), np.float32)
    jg = jax.grad(lambda r, i: jnp.sum(jnp.abs(jstft.power_uncompress(r, i))))(
        jnp.asarray(z), jnp.asarray(z))
    rt, it = torch.from_numpy(z.copy()).requires_grad_(), torch.from_numpy(z.copy())
    tstft.power_uncompress(rt, it).abs().sum().backward()
    assert np.isnan(np.asarray(jg)).all() and torch.isnan(rt.grad).all()
