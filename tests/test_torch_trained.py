"""The port against the JAX package with trained weights, and the files
that carry those weights to a host without JAX.

tests/torch_data/r05_fold1_ema/ holds:
- generator.pt: the committed fold-1 EMA generator
  (reports/trained_generator_r05_fold1_ema), written by the JAX package's
  save_torch_generator in the CMGAN reference layout, which the port loads
  with strict=True;
- golden_4s.npz: `noisy`, a seeded 4 s synthetic track, and the JAX
  package's Enhancer output for it in bucket mode (641 frames) with
  attention_impl='xla', `enhanced_fp32` and `enhanced_bf16`.

chip_smoke.py [20] reads both on the GPU, where there is no JAX. Rebuild
them (JAX needed, on the CPU) with

    python tests/test_torch_trained.py --write

Tolerances, relative L2: a fresh JAX run 1e-5 of the stored output (the
same program on the same CPU; float32 sums whose order the thread count
may change); the port's CPU Enhancer 2e-4, the generator parity
test_torch_models.py holds (fp32 sums of two libraries in another order,
through 4 conformer blocks and both decoders).
"""

import os
import sys

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CKPT = os.path.join(ROOT, "reports", "trained_generator_r05_fold1_ema")
DATA = os.path.join(HERE, "torch_data", "r05_fold1_ema")
GENERATOR = os.path.join(DATA, "generator.pt")
GOLDEN = os.path.join(DATA, "golden_4s.npz")
SR, SECONDS, SEED = 16000, 4, 20
JAX_RERUN_REL = 1e-5
PORT_REL = 2e-4


def synthetic_track(n: int, seed: int, sr: int = SR):
    """A seeded sum of amplitude-modulated harmonics plus noise (chip_smoke.py's recipe)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = rng.uniform(100, 220)
    x = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.3)) / h for h in range(1, 6))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t))
    return (0.05 * x + 0.02 * rng.standard_normal(n)).astype(np.float32)


def jax_enhance(variables, noisy, dtype=None):
    """The JAX package's Enhancer in bucket mode, attention_impl='xla'."""
    from cmgan_tpu.config import CMGANConfig, ModelConfig
    from cmgan_tpu.inference import Enhancer

    cfg = CMGANConfig(model=ModelConfig(attention_impl="xla"))
    return Enhancer(cfg, variables, dtype=dtype).enhance(noisy, mode="bucket")


def write():
    """Write generator.pt and golden_4s.npz from the committed checkpoint."""
    import jax.numpy as jnp

    from cmgan_tpu.checkpoint import restore_variables
    from cmgan_tpu.checkpoint.torch_import import save_torch_generator

    variables = restore_variables(CKPT)
    os.makedirs(DATA, exist_ok=True)
    save_torch_generator(GENERATOR, variables)
    noisy = synthetic_track(SECONDS * SR, SEED)
    np.savez(GOLDEN, noisy=noisy, enhanced_fp32=jax_enhance(variables, noisy),
             enhanced_bf16=jax_enhance(variables, noisy, jnp.bfloat16))


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def variables():
    from cmgan_tpu.checkpoint import restore_variables

    return restore_variables(CKPT)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def test_generator_file_is_the_checkpoint(variables, tmp_path):
    """generator.pt is save_torch_generator of the checkpoint, tensor by
    tensor and bitwise, and loads into the port with strict=True."""
    from cmgan_tpu.checkpoint.torch_import import save_torch_generator
    from cmgan_torch.config import ModelConfig
    from cmgan_torch.models import TSCNet

    fresh = tmp_path / "generator.pt"
    save_torch_generator(str(fresh), variables)
    want = torch.load(fresh, weights_only=True)
    got = torch.load(GENERATOR, weights_only=True)
    assert list(got) == list(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
    TSCNet(ModelConfig()).load_state_dict(got, strict=True)


def test_golden_is_the_jax_package_output(variables, golden):
    noisy = golden["noisy"]
    np.testing.assert_array_equal(noisy, synthetic_track(SECONDS * SR, SEED))
    out = jax_enhance(variables, noisy)
    assert out.shape == noisy.shape and golden["enhanced_bf16"].shape == noisy.shape
    assert rel_l2(out, golden["enhanced_fp32"]) <= JAX_RERUN_REL


def test_port_matches_the_jax_package_with_trained_weights(golden):
    """The port's Enhancer on the CPU (the kernels' plain versions) from
    generator.pt against the JAX package's output."""
    from cmgan_torch.config import CMGANConfig
    from cmgan_torch.inference import Enhancer

    sd = torch.load(GENERATOR, weights_only=True)
    out = Enhancer(CMGANConfig(), sd, device="cpu").enhance(golden["noisy"], mode="bucket")
    assert out.shape == golden["noisy"].shape and np.all(np.isfinite(out))
    assert rel_l2(out, golden["enhanced_fp32"]) <= PORT_REL


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit(f"usage: python {os.path.relpath(__file__)} --write")
    sys.path.insert(0, ROOT)
    write()
    print(f"wrote {os.path.relpath(GENERATOR, ROOT)} and {os.path.relpath(GOLDEN, ROOT)}")
