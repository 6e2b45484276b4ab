"""The port's DSP front/back end against the JAX package's, on the CPU.

Same numpy-seeded signals through both; atol 2e-4 is the DSP parity
tolerance the JAX package holds itself to against torch (PARITY.md).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    x = torch.from_numpy(_signal(rng, 1, 1600))
    with pytest.raises(NotImplementedError):
        tstft.stft(x, N_FFT, HOP, dft_impl="matmul")
    with pytest.raises(NotImplementedError):
        tstft.istft(tstft.stft(x, N_FFT, HOP), N_FFT, HOP, dft_impl="matmul")
