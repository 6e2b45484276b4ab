"""The port's own build of the C++ wideband PESQ against the JAX package's
(the same source: agreement to 1e-9), and the host labeler's failure paths."""

import numpy as np
import pytest

from cmgan_tpu.metrics import pesq_native as jpn
from cmgan_torch.metrics import pesq_native as pn
from cmgan_torch.train.steps import pesq_labels_host
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)


def _pairs(rng, b=3, n=16000):
    t = np.arange(n) / 16000
    clean = rng.standard_normal((b, n)) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) * 0.1
    noise = rng.standard_normal((b, n)) * np.array([0.005, 0.03, 0.15])[:b, None]
    return clean, clean + noise


def test_batch_matches_the_jax_packages_build(rng):
    clean, deg = _pairs(rng)
    assert jpn.native_available()
    ours = pn.pesq_batch(clean, deg)
    np.testing.assert_allclose(ours, jpn.pesq_batch(clean, deg), atol=1e-9, rtol=0)
    assert ours[0] > ours[1] > ours[2]  # more noise, lower score
    assert np.all((ours >= 1.0) & (ours <= 4.65))


def test_single_matches_batch_and_the_jax_packages_build(rng):
    clean, deg = _pairs(rng, b=2, n=12000)
    for i in range(2):
        one = pn.pesq(16000, clean[i], deg[i])
        assert abs(one - jpn.pesq(16000, clean[i], deg[i])) <= 1e-9
        assert abs(one - pn.pesq_batch(clean, deg)[i]) <= 1e-9
    # float32 inputs and unequal lengths are taken as the wheel takes them
    assert np.isfinite(pn.pesq(16000, clean[0].astype(np.float32), deg[0][:11000]))


def test_arguments_are_checked(rng):
    clean, deg = _pairs(rng, b=2, n=8000)
    with pytest.raises(ValueError):
        pn.pesq(8000, clean[0], deg[0])
    with pytest.raises(ValueError):
        pn.pesq(16000, clean[0], deg[0], mode="nb")
    with pytest.raises(ValueError):
        pn.pesq_batch(clean, deg, sample_rate=8000)
    with pytest.raises(ValueError):
        pn.pesq_batch(clean, deg[:, :100])


def test_labels_host_failure_paths(rng, monkeypatch):
    clean, deg = _pairs(rng, b=2, n=8000)
    ok = pesq_labels_host(clean, deg)
    assert ok.dtype == np.float32 and np.all(ok >= 1.0)
    # a silent estimate or a silent reference is a failed utterance
    silent = deg.copy()
    silent[1] = 0.0
    assert pesq_labels_host(clean, silent)[1] == -1.0 and pesq_labels_host(clean, silent)[0] > 0
    assert pesq_labels_host(np.zeros_like(clean), deg).tolist() == [-1.0, -1.0]
    # a non-finite score is a failure
    nan = deg.copy()
    nan[0, 10] = np.nan
    assert pesq_labels_host(clean, nan)[0] == -1.0
    # a scorer that raises fails the whole batch
    def boom(*a, **k):
        raise RuntimeError("scorer down")
    monkeypatch.setattr(pn, "pesq_batch", boom)
    assert pesq_labels_host(clean, deg).tolist() == [-1.0, -1.0]


def test_labels_host_matches_jax_package(rng):
    from cmgan_tpu.train.steps import pesq_labels_host as jax_labels

    clean, deg = _pairs(rng, b=3, n=8000)
    deg[2] = 0.0
    np.testing.assert_array_equal(pesq_labels_host(clean, deg), jax_labels(clean, deg))


def test_missing_compiler_raises(monkeypatch, tmp_path):
    """No quiet fall-back: without a compiler the build raises."""
    monkeypatch.setattr(pn, "BUILD_ROOT", str(tmp_path))  # nothing built here yet
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="compiler"):
        pn.build()
    monkeypatch.delenv("CXX")
    path = pn.build()  # and with one it builds, keyed by the source's hash
    assert path.startswith(str(tmp_path)) and path.endswith("libcmgan_pesq.so")
    assert pn.build() == path
