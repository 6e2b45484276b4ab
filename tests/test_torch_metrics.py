"""The port's evaluation metrics against the JAX package's, on the CPU.

Both are numpy float64 (the port keeps its own copies of `composite.py`,
`stoi.py` and `pesq_ref.py`) and both packages' `pesq_wb` call a build of
the same C++ scorer, so every comparison is at rtol 1e-9 (LLR with
`equal_nan`: frames without energy give NaN in both). The inputs are
seeded speech-like pairs (amplitude-modulated harmonics over a noise
floor) at several SNRs, one 3 s pair per SNR.
"""

import numpy as np
import pytest

import cmgan_tpu.metrics as jm
from cmgan_tpu.metrics import pesq_ref as jref
from cmgan_torch import metrics as tm
from cmgan_torch.metrics import pesq_ref as tref
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)

SR = 16000
RTOL = 1e-9
NOISE = (0.003, 0.01, 0.03, 0.1)   # white noise std over a ~0.05 signal


def _speech(n, rng):
    t = np.arange(n) / SR
    f0 = rng.uniform(100, 220)
    x = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.3)) / h for h in range(1, 6))
    return 0.05 * x * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t)) + 0.02 * rng.standard_normal(n)


def _pair(noise, n=3 * SR, seed=0):
    rng = np.random.default_rng(seed)
    clean = _speech(n, rng)
    return clean, clean + noise * rng.standard_normal(n)


@pytest.mark.parametrize("noise", NOISE)
@pytest.mark.parametrize("name", ["wss", "llr", "stoi", "pesq_wb_np"])
def test_frame_measures_match_jax(name, noise):
    clean, deg = _pair(noise)
    if name == "pesq_wb_np":
        ours, theirs = tref.pesq_wb_np(clean, deg), jref.pesq_wb_np(clean, deg)
    else:
        ours, theirs = getattr(tm, name)(clean, deg, SR), getattr(jm, name)(clean, deg, SR)
    assert np.all(np.isfinite(ours)) or name == "llr"
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, equal_nan=True)


@pytest.mark.parametrize("noise", NOISE)
def test_snr_and_compute_metrics_match_jax(noise):
    clean, deg = _pair(noise)
    overall, seg = tm.snr(clean, deg, SR)
    j_overall, j_seg = jm.snr(clean, deg, SR)
    assert overall == pytest.approx(j_overall, rel=RTOL)
    np.testing.assert_allclose(seg, j_seg, rtol=RTOL)
    ours = tm.compute_metrics(clean, deg, SR)
    np.testing.assert_allclose(ours, jm.compute_metrics(clean, deg, SR), rtol=RTOL)
    assert len(ours) == 6 and all(np.isfinite(ours))
    # unequal lengths are trimmed to the shorter, as the reference does
    np.testing.assert_allclose(tm.compute_metrics(clean, deg[:-77], SR),
                               jm.compute_metrics(clean, deg[:-77], SR), rtol=RTOL)


def test_scores_fall_with_noise():
    scores = np.array([tm.compute_metrics(*_pair(noise), SR) for noise in NOISE])
    # pesq, ssnr and stoi fall as the noise grows; the composites fall or
    # stay at their clamp of 5
    assert np.all(np.diff(scores[:, [0, 4, 5]], axis=0) < 0), scores
    assert np.all(np.diff(scores, axis=0) <= 0), scores


def test_clean_against_clean():
    clean, _ = _pair(0.0)
    pesq, csig, cbak, covl, ssnr, stoi = tm.compute_metrics(clean, clean, SR)
    assert pesq == pytest.approx(4.64, abs=0.01)
    assert stoi == pytest.approx(1.0, abs=1e-6)
    assert ssnr == pytest.approx(35.0)   # the segmental SNR's upper clamp
    assert np.nanmax(np.abs(tm.wss(clean, clean, SR))) < 1e-12
    assert (csig, cbak, covl) == jm.compute_metrics(clean, clean, SR)[1:4]


@pytest.mark.parametrize("args, want", [
    ((10.0, 0.0, 0.0, 35.0), (5.0, 5.0, 5.0)),
    ((-10.0, 10.0, 1000.0, -10.0), (1.0, 1.0, 1.0)),
    ((3.0, 0.5, 30.0, 10.0), None),
])
def test_composite_scores_and_clamps(args, want):
    ours = tm.composite_scores(*args)
    assert ours == jm.composite_scores(*args)
    if want is not None:
        assert ours == want
    assert all(1.0 <= v <= 5.0 for v in ours)


def test_the_port_keeps_the_jax_packages_public_names():
    assert tm.__all__ == jm.__all__
    assert tref._HP_B == jref._HP_B and tref._BP_A == jref._BP_A
    with pytest.raises(ValueError):
        tm.wss(np.zeros(800), np.zeros(900), SR)
