"""The port's metric discriminator against the JAX package's, through the
weight bridge, on the CPU in float32: eval, train mode (the spectral-norm
state after one update), and gradients.

Tolerance 1e-5 / 1e-4: the two run the same few small convs; sums differ
in order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmgan_tpu.config import ModelConfig as JaxModelConfig
from cmgan_tpu.models import MetricDiscriminator as JaxDisc
from cmgan_torch.config import ModelConfig
from cmgan_torch.convert import DISC_SN_LAYERS, disc_state_dict_from_flax
from cmgan_torch.models import MetricDiscriminator
from cmgan_torch.models.discriminator import SpectralNorm
from cmgan_torch.models.layers import Linear, torch_default_init_
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)

ATOL, RTOL = 1e-5, 1e-4
SMALL = dict(ndf=4, disc_dropout=0.0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """JAX variables moved off their init, the port loaded from them, inputs."""
    rng = np.random.default_rng(0)
    jmod = JaxDisc(JaxModelConfig(**SMALL))
    clean = np.abs(rng.standard_normal((3, 33, 201))).astype(np.float32)
    est = np.abs(rng.standard_normal((3, 33, 201))).astype(np.float32)
    variables = _np(jmod.init({"params": jax.random.key(0)}, jnp.asarray(clean), jnp.asarray(est)))
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), variables["params"])
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    return jmod, variables, clean, est


def _port(variables):
    mod = MetricDiscriminator(ModelConfig(**SMALL))
    mod.load_state_dict(disc_state_dict_from_flax(variables["params"], variables["batch_stats"]),
                        strict=True)
    return mod


def test_eval_forward_matches_jax(pair):
    jmod, variables, clean, est = pair
    ref = np.asarray(jmod.apply(variables, jnp.asarray(clean), jnp.asarray(est), train=False))
    mod = _port(variables).eval()
    before = {k: v.clone() for k, v in mod.state_dict().items()}
    with torch.no_grad():
        ours = mod(torch.from_numpy(clean), torch.from_numpy(est)).numpy()
    assert ours.shape == ref.shape == (3, 1)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)
    for k, v in mod.state_dict().items():  # eval stores nothing
        assert torch.equal(v, before[k]), k


def test_train_forward_advances_the_spectral_norm_state_as_flax_does(pair):
    jmod, variables, clean, est = pair
    ref, updates = jmod.apply(variables, jnp.asarray(clean), jnp.asarray(est), train=True,
                              rngs={"dropout": jax.random.key(1)}, mutable=["batch_stats"])
    mod = _port(variables).train()
    ours = mod(torch.from_numpy(clean), torch.from_numpy(est)).detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), atol=ATOL, rtol=RTOL)
    want = disc_state_dict_from_flax(variables["params"], _np(updates["batch_stats"]))
    got = mod.state_dict()
    for name in DISC_SN_LAYERS:
        for leaf in ("u", "sigma"):
            key = f"{name}.{leaf}"
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=ATOL, rtol=RTOL,
                                       err_msg=key)
        assert not torch.equal(got[f"{name}.sigma"], torch.ones(()))  # it did move
    # a second call starts from the stored u: the two stay together
    ref2, _ = jmod.apply({"params": variables["params"], "batch_stats": updates["batch_stats"]},
                         jnp.asarray(clean), jnp.asarray(est), train=True,
                         rngs={"dropout": jax.random.key(2)}, mutable=["batch_stats"])
    ours2 = mod(torch.from_numpy(clean), torch.from_numpy(est)).detach().numpy()
    np.testing.assert_allclose(ours2, np.asarray(ref2), atol=ATOL, rtol=RTOL)


def test_gradients_match_jax(pair):
    """Of every parameter and of est_mag (what the generator's GAN loss
    needs), in train mode: sigma carries a gradient, u and v do not."""
    jmod, variables, clean, est = pair

    def jloss(params, est_mag):
        score, _ = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(clean), est_mag, train=True,
                              rngs={"dropout": jax.random.key(1)}, mutable=["batch_stats"])
        return jnp.sum((score - 1.0) ** 2)

    gp, ge = jax.grad(jloss, argnums=(0, 1))(variables["params"], jnp.asarray(est))
    want = disc_state_dict_from_flax(_np(gp), variables["batch_stats"])

    mod = _port(variables).train()
    est_t = torch.from_numpy(est).requires_grad_()
    ((mod(torch.from_numpy(clean), est_t) - 1.0) ** 2).sum().backward()
    np.testing.assert_allclose(est_t.grad.numpy(), np.asarray(ge), atol=ATOL, rtol=1e-3)
    for name, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=ATOL, rtol=1e-3,
                                   err_msg=name)


def test_bridge_covers_every_key_and_init_is_seeded(pair):
    _, variables, _, _ = pair
    sd = disc_state_dict_from_flax(variables["params"], variables["batch_stats"])
    mod = MetricDiscriminator(ModelConfig(**SMALL))
    assert set(sd) == set(mod.state_dict())
    a = torch_default_init_(MetricDiscriminator(ModelConfig(**SMALL)), torch.Generator().manual_seed(5))
    b = torch_default_init_(MetricDiscriminator(ModelConfig(**SMALL)), torch.Generator().manual_seed(5))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    assert a.conv1.u.abs().sum() > 0 and a.conv1.sigma == 1


def test_spectral_norm_converges_to_the_largest_singular_value():
    # a seeded weight with singular values 3, 1.5, 1.4, ...: the gap of a
    # half makes 200 power steps far more than enough
    rng = np.random.default_rng(3)
    left, _ = np.linalg.qr(rng.standard_normal((7, 7)))
    right, _ = np.linalg.qr(rng.standard_normal((12, 7)))
    values = np.array([3.0, 1.5, 1.4, 1.0, 0.7, 0.3, 0.1])
    lin = Linear(12, 7)
    sn = SpectralNorm(lin).train()
    sn.reset_state(torch.Generator().manual_seed(3))
    x = torch.zeros(1, 12)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy((left * values) @ right.T).float())
        for _ in range(200):
            sn(x)
    top = torch.linalg.svdvals(lin.weight)[0]
    torch.testing.assert_close(sn.sigma, top, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(torch.linalg.svdvals(sn.normalized_weight())[0],
                               torch.ones(()), atol=1e-3, rtol=1e-3)


def test_bf16_compute_stays_close_to_fp32(pair):
    _, variables, clean, est = pair
    sd = disc_state_dict_from_flax(variables["params"], variables["batch_stats"])
    lo = MetricDiscriminator(ModelConfig(**SMALL), dtype=torch.bfloat16).eval()
    lo.load_state_dict(sd, strict=True)
    with torch.no_grad():
        a = lo(torch.from_numpy(clean), torch.from_numpy(est)).float()
        b = _port(variables).eval()(torch.from_numpy(clean), torch.from_numpy(est))
    assert (a - b).abs().max() < 3e-2  # a sigmoid output in (0, 1); bf16 keeps 8 bits
