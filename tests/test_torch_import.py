"""Generator parity: reference torch TSCNet vs our flax TSCNet with
imported weights — the end-to-end numerical check that the released
reference checkpoint will evaluate faithfully.

The torch reference model is imported from the read-only mount (not
copied); skipped when the mount or its deps are absent.
"""

import os
import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)

REF_SRC = "/root/reference/src"


@pytest.fixture(scope="module")
def torch_ref():
    if not os.path.isdir(REF_SRC):
        pytest.skip("reference mount absent")
    sys.path.insert(0, REF_SRC)
    try:
        import torch  # noqa: F401
        from models.generator import TSCNet as TorchTSCNet
    except ImportError as e:
        pytest.skip(f"torch reference deps unavailable: {e}")
    finally:
        sys.path.remove(REF_SRC)
    return TorchTSCNet


def test_generator_forward_parity(torch_ref):
    import jax
    import jax.numpy as jnp
    import torch

    from cmgan_tpu.checkpoint.torch_import import import_generator_state_dict
    from cmgan_tpu.config import ModelConfig
    from cmgan_tpu.models import TSCNet

    torch.manual_seed(0)
    tmodel = torch_ref(num_channel=64, num_features=201)
    tmodel.eval()

    T, F = 41, 201
    rng = np.random.default_rng(0)
    packed = rng.standard_normal((2, T, F, 2)).astype(np.float32) * 0.3

    # torch consumes [B, 2, T, F]
    x_t = torch.from_numpy(packed.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        real_t, imag_t = tmodel(x_t)
    real_t = real_t.numpy()[:, 0]  # [B, T, F]
    imag_t = imag_t.numpy()[:, 0]

    model = TSCNet(ModelConfig())
    variables = model.init({"params": jax.random.key(0)}, jnp.zeros((1, T, F, 2)))
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    variables = import_generator_state_dict(sd, variables)

    real_j, imag_j = model.apply(variables, jnp.asarray(packed), train=False)
    real_j, imag_j = np.asarray(real_j), np.asarray(imag_j)

    assert real_j.shape == real_t.shape
    np.testing.assert_allclose(real_j, real_t, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(imag_j, imag_t, atol=2e-4, rtol=1e-3)


def test_import_rejects_mismatched_dict(torch_ref):
    import jax
    import jax.numpy as jnp

    from cmgan_tpu.checkpoint.torch_import import import_generator_state_dict
    from cmgan_tpu.config import ModelConfig
    from cmgan_tpu.models import TSCNet

    model = TSCNet(ModelConfig())
    variables = model.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 11, 201, 2))
    )
    with pytest.raises(ValueError):
        import_generator_state_dict({"bogus": np.zeros(3)}, variables)


def test_export_import_roundtrip():
    """export -> import must reproduce the exact parameter tree."""
    import jax
    import jax.numpy as jnp

    from cmgan_tpu.checkpoint.torch_import import (
        export_generator_state_dict,
        import_generator_state_dict,
    )
    from cmgan_tpu.config import ModelConfig
    from cmgan_tpu.models import TSCNet

    model = TSCNet(ModelConfig())
    variables = model.init({"params": jax.random.key(3)}, jnp.zeros((1, 11, 201, 2)))
    import flax

    sd = export_generator_state_dict(variables)
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    restored = import_generator_state_dict(sd, variables)
    a_flat = flax.traverse_util.flatten_dict(variables, sep="/")
    b_flat = flax.traverse_util.flatten_dict(restored, sep="/")
    assert set(a_flat) == set(b_flat)
    for key in a_flat:
        np.testing.assert_array_equal(
            np.asarray(a_flat[key]), np.asarray(b_flat[key]), err_msg=key
        )


def test_export_matches_torch_reference_evaluation(torch_ref):
    """A model exported from here must produce identical outputs when run
    through the reference torch code."""
    import jax
    import jax.numpy as jnp
    import torch

    from cmgan_tpu.checkpoint.torch_import import export_generator_state_dict
    from cmgan_tpu.config import ModelConfig
    from cmgan_tpu.models import TSCNet

    model = TSCNet(ModelConfig())
    variables = model.init({"params": jax.random.key(4)}, jnp.zeros((1, 11, 201, 2)))

    tmodel = torch_ref(num_channel=64, num_features=201)
    sd = {
        k: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in export_generator_state_dict(variables).items()
    }
    tmodel.load_state_dict(sd)
    tmodel.eval()

    T, F = 31, 201
    packed = np.random.default_rng(5).standard_normal((1, T, F, 2)).astype(np.float32) * 0.3
    real_j, imag_j = model.apply(variables, jnp.asarray(packed), train=False)
    with torch.no_grad():
        real_t, imag_t = tmodel(torch.from_numpy(packed.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(
        np.asarray(real_j), real_t.numpy()[:, 0], atol=2e-4, rtol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(imag_j), imag_t.numpy()[:, 0], atol=2e-4, rtol=1e-3
    )


def test_trained_artifact_exports_to_torch_faithfully(torch_ref):
    """The committed round-2 TRAINED generator (reports/) must export to
    the reference state_dict layout and reproduce our outputs through
    the reference's own torch code on a real noisy crop — a CMGAN user
    can carry a model trained here back to the reference stack."""
    import jax.numpy as jnp
    import torch

    from cmgan_tpu.checkpoint import restore_variables
    from cmgan_tpu.checkpoint.torch_import import export_generator_state_dict
    from cmgan_tpu.config import CMGANConfig
    from cmgan_tpu.data import read_wav
    from cmgan_tpu.dsp import power_compress, stft
    from cmgan_tpu.models import TSCNet

    art = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "reports", "trained_generator_r02")
    if not os.path.isdir(art):
        pytest.skip("trained artifact absent")

    cfg = CMGANConfig()
    variables = restore_variables(art)
    model = TSCNet(cfg.model)

    wav, _ = read_wav("/root/reference/AudioSamples/noisy/p232_005.wav")
    x = wav[0, : 16000].astype(np.float32)[None]
    c = np.sqrt(x.size / float(np.sum(x * x)))
    packed = np.asarray(
        power_compress(stft(jnp.asarray(x * c), cfg.dsp.n_fft, cfg.dsp.hop))
    )

    real_j, imag_j = model.apply(variables, jnp.asarray(packed), train=False)

    tmodel = torch_ref(num_channel=64, num_features=201)
    sd = {
        k: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in export_generator_state_dict(variables).items()
    }
    tmodel.load_state_dict(sd)
    tmodel.eval()
    with torch.no_grad():
        real_t, imag_t = tmodel(
            torch.from_numpy(packed.transpose(0, 3, 1, 2).copy())
        )
    np.testing.assert_allclose(
        np.asarray(real_j), real_t.numpy()[:, 0], atol=2e-4, rtol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(imag_j), imag_t.numpy()[:, 0], atol=2e-4, rtol=1e-3
    )
