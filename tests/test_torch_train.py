"""The port's GAN training against the JAX package's, on the CPU in float32:
one G step and one D step from the same weights and batch (losses, every
parameter's gradient, updated parameters, BatchNorm running stats, the
discriminator's spectral-norm state), then the trainer's own machinery.

A narrow model (16 channels, one head of 16 so the flash wrapper takes it,
2 TSCBs, ndf 4) with `attention_impl='flash'`: the JAX side runs its Pallas
forward and backward kernels in interpret mode, the port their plain
versions. All three dropout rates are 0 where the two are compared: the
packages' dropout streams cannot match.

Tolerances. Losses: rtol 1e-5. Gradients: 1e-4 of the tensor's largest
entry plus rtol 1e-3 (a few hundred fp32 ops deep, summed in another
order). After one AdamW step a parameter has moved by lr * g / (|g| + eps),
that is by +-lr wherever |g| >> 1e-8, so entries with a real gradient agree
to 1e-6; entries whose gradient is rounding noise around 0 (a conv bias in
front of an InstanceNorm has none by construction) may step the other way
and differ by 2 * lr. BatchNorm running stats and u / sigma: 1e-5 / 1e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmgan_tpu.config import CMGANConfig as JaxConfig
from cmgan_tpu.config import ModelConfig as JaxModelConfig
from cmgan_tpu.config import TrainConfig as JaxTrainConfig
from cmgan_tpu.metrics.pesq_jax import pesq_labels_jax
from cmgan_tpu.models import MetricDiscriminator as JaxDisc
from cmgan_tpu.models import TSCNet as JaxTSCNet
from cmgan_tpu.train import init_train_state as jax_init_train_state
from cmgan_tpu.train import make_train_steps as jax_make_train_steps
from cmgan_tpu.train import state as jstate
from cmgan_tpu.train import steps as jsteps
from cmgan_torch.checkpoint import restore_train_state, restore_variables, save_train_state
from cmgan_torch.cli import train as cli_train
from cmgan_torch.config import CMGANConfig, MeshConfig, ModelConfig, TrainConfig
from cmgan_torch.convert import disc_state_dict_from_flax, state_dict_from_flax
from cmgan_torch.data import write_wav
from cmgan_torch.data.dataset import load_data
from cmgan_torch.metrics.pesq_torch import pesq_labels_torch
from cmgan_torch.models.conformer import BatchNorm
from cmgan_torch.ops import flash_attention as fa
from cmgan_torch.train import (
    Trainer, init_train_state, make_disc_lr_schedule, make_lr_schedule, make_train_steps,
)
from cmgan_torch.train import steps as tsteps
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)

MODEL = dict(num_channels=16, num_tscb_blocks=2, dense_depth=2, attn_heads=1, ndf=4,
             attn_dropout=0.0, ff_dropout=0.0, disc_dropout=0.0, attention_impl="flash")
CUT, BATCH, SPE = 3200, 2, 10  # 33 frames; steps per epoch for the schedules
LR = TrainConfig().init_lr


def _cfgs(model=None, **train):
    model = dict(MODEL, **(model or {}))
    train = dict(dict(batch_size=BATCH, cut_len=CUT), **train)
    return (JaxConfig(model=JaxModelConfig(**model),
                      train=dataclasses.replace(JaxTrainConfig(), **train)),
            CMGANConfig(model=ModelConfig(**model),
                        train=dataclasses.replace(TrainConfig(), **train)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed=0, b=BATCH, n=CUT):
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((b, n)) * 0.1).astype(np.float32)
    return clean, clean + (rng.standard_normal((b, n)) * 0.05).astype(np.float32)


def _load_from_jax(state, js):
    state.gen.load_state_dict(
        state_dict_from_flax(_np(js.gen_params), _np(js.gen_stats), num_tscb=2, depth=2),
        strict=True)
    state.disc.load_state_dict(
        disc_state_dict_from_flax(_np(js.disc_params), _np(js.disc_stats)), strict=True)
    return state


def _gen_sd(js):
    return state_dict_from_flax(_np(js.gen_params), _np(js.gen_stats), num_tscb=2, depth=2)


def _disc_sd(js):
    return disc_state_dict_from_flax(_np(js.disc_params), _np(js.disc_stats))


@pytest.fixture(scope="module")
def stepped():
    """One G step and one D step in both packages from the same start."""
    jcfg, cfg = _cfgs()
    js0 = jax_init_train_state(jcfg, 0, SPE)
    state = _load_from_jax(init_train_state(cfg, 0, SPE, device="cpu"), js0)
    clean, noisy = _batch()

    # JAX's gradient of the G loss, composed from its own step's pieces
    gen, disc = JaxTSCNet(jcfg.model), JaxDisc(jcfg.model)
    key = jax.random.key(0)

    def jloss(gen_params):
        out = jsteps._generator_forward(
            gen, {"params": gen_params, "batch_stats": js0.gen_stats}, jnp.asarray(clean),
            jnp.asarray(noisy), jcfg, train=True, dropout_rng=key)
        total, _, _, _ = jsteps._generator_loss(
            disc, {"params": js0.disc_params, "batch_stats": js0.disc_stats}, out,
            jnp.asarray(clean), jcfg.train.loss_weights, train=True, dropout_rng=key)
        return total

    jgrads = state_dict_from_flax(_np(jax.jit(jax.grad(jloss))(js0.gen_params)),
                                  _np(js0.gen_stats), num_tscb=2, depth=2)

    # the port's gradient, by the same composition as its g_step
    state.gen.train(), state.disc.train()
    disc_before = {k: v.clone() for k, v in state.disc.state_dict().items()}
    gen_before = {k: v.clone() for k, v in state.gen.state_dict().items()}
    ct, nt = torch.from_numpy(clean), torch.from_numpy(noisy)
    out = tsteps._generator_forward(state.gen, ct, nt, cfg)
    loss, _, _ = tsteps._generator_loss(state.disc, out, ct, cfg.train.loss_weights)
    names = [n for n, _ in state.gen.named_parameters()]
    tgrads = dict(zip(names, torch.autograd.grad(loss, list(state.gen.parameters()))))
    state.gen.load_state_dict(gen_before)   # that forward moved the BN and SN state
    state.disc.load_state_dict(disc_before)

    jg, jd, _, _, _ = jax_make_train_steps(jcfg, SPE)
    tg, td, _, _, _ = make_train_steps(cfg, SPE)
    js1, jm, jh = jg(js0, jnp.asarray(clean), jnp.asarray(noisy))
    js1 = jax.device_get(js1)
    tm, th = tg(state, clean, noisy)
    after_g = (_gen_sd(js1), _disc_sd(js1),
               {k: v.clone() for k, v in state.gen.state_dict().items()},
               {k: v.clone() for k, v in state.disc.state_dict().items()})
    scores = np.array([2.1, 3.3], np.float32)
    js2, jl = jd(jax.device_put(js1), jh["clean_mag"], jh["est_mag"], jnp.asarray(scores))
    tl = td(state, th["clean_mag"], th["est_mag"], scores)
    return dict(cfg=cfg, jm=_np(jm), tm=tm, jh=_np(jh), th=th, jgrads=jgrads, tgrads=tgrads,
                after_g=after_g, js2=jax.device_get(js2), state=state, jl=float(jl), tl=float(tl))


def test_g_step_loss_parts_match_jax(stepped):
    for k in ("gen_loss", "loss_ri", "loss_mag", "loss_time", "loss_gan"):
        np.testing.assert_allclose(float(stepped["tm"][k]), float(stepped["jm"][k]), rtol=1e-5,
                                   err_msg=k)
    # the compressed magnitude m**0.3 of a nearly cancelled STFT bin magnifies
    # fp32 rounding (d m**0.3 = 0.3 m**-0.7 dm), so single bins may differ in
    # the third digit: hold the tensors in relative L2 and bound the outliers
    for k in ("clean_mag", "est_mag", "est_audio"):
        got, ref = stepped["th"][k].numpy(), stepped["jh"][k]
        assert np.linalg.norm(got - ref) <= 1e-4 * np.linalg.norm(ref), k
        assert np.abs(got - ref).max() <= 1e-2, k
        assert not stepped["th"][k].requires_grad


def test_g_step_gradients_match_jax(stepped):
    assert set(stepped["tgrads"]) <= set(stepped["jgrads"])
    for name, g in stepped["tgrads"].items():
        ref = stepped["jgrads"][name].numpy()
        # a gradient that is 0 by construction comes out as rounding noise ~1e-6
        np.testing.assert_allclose(g.numpy(), ref, atol=max(1e-4 * np.abs(ref).max(), 2e-6),
                                   rtol=1e-3, err_msg=name)


def test_g_step_updates_match_jax(stepped):
    """Parameters after AdamW, and BatchNorm's running stats (flax moves the
    running variance with the biased batch variance; torch's own BatchNorm1d
    would not)."""
    jgen, _, tgen, _ = stepped["after_g"]
    for name, ref in jgen.items():
        if name.endswith("num_batches_tracked"):
            continue
        got, ref = tgen[name].numpy(), ref.numpy()
        if "running_" in name:
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4, err_msg=name)
            continue
        assert np.abs(got - ref).max() <= 2 * LR * 1.01, name
        real = np.abs(stepped["jgrads"][name].numpy()) > 1e-6
        np.testing.assert_allclose(got[real], ref[real], atol=1e-6, rtol=0, err_msg=name)
    moved = [n for n in tgen if "running_var" in n]
    assert len(moved) == 4 and all(not torch.equal(tgen[n], torch.ones_like(tgen[n])) for n in moved)


def test_g_step_advances_the_discriminators_state_but_not_its_weights(stepped):
    _, jdisc, _, tdisc = stepped["after_g"]
    for name, ref in jdisc.items():
        np.testing.assert_allclose(tdisc[name].numpy(), ref.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    assert not torch.equal(tdisc["conv1.sigma"], torch.ones(()))
    assert all(p.grad is None for p in stepped["state"].disc.parameters())


def test_d_step_matches_jax(stepped):
    np.testing.assert_allclose(stepped["tl"], stepped["jl"], rtol=1e-5)
    want, got = _disc_sd(stepped["js2"]), stepped["state"].disc.state_dict()
    for name, ref in want.items():
        # D's AdamW step is 2 * lr a parameter; same reasoning as for G
        assert (got[name] - ref).abs().max() <= 4 * LR * 1.01, name
        if name.endswith((".u", ".sigma")):
            np.testing.assert_allclose(got[name].numpy(), ref.numpy(), atol=1e-5, rtol=1e-4,
                                       err_msg=name)
    close = sum(int(((got[n] - r).abs() <= 1e-6).sum()) for n, r in want.items())
    assert close >= 0.98 * sum(r.numel() for r in want.values())
    assert stepped["state"].step == int(stepped["js2"].step) == 1


@pytest.fixture(scope="module")
def fused():
    """One fused G + label + D step (pesq_label_mode='device') in both
    packages from the same start."""
    jcfg, cfg = _cfgs(pesq_label_mode="device")
    js0 = jax_init_train_state(jcfg, 0, SPE)
    state = _load_from_jax(init_train_state(cfg, 0, SPE, device="cpu"), js0)
    clean, noisy = _batch()
    js1, jm, jl = jax_make_train_steps(jcfg, SPE)[4](js0, jnp.asarray(clean), jnp.asarray(noisy))
    tm, tl = make_train_steps(cfg, SPE)[4](state, clean, noisy)
    return dict(js1=jax.device_get(js1), jm=_np(jm), jl=float(jl), state=state, tm=tm, tl=float(tl))


def test_fused_step_labels_match_jax(stepped):
    """The labels the fused step computes from the G phase's est_audio."""
    clean, _ = _batch()
    ours = pesq_labels_torch(torch.from_numpy(clean), stepped["th"]["est_audio"]).numpy()
    theirs = np.asarray(pesq_labels_jax(jnp.asarray(clean), jnp.asarray(stepped["jh"]["est_audio"])))
    assert np.all(ours >= 1.0)
    np.testing.assert_allclose(ours, theirs, atol=1e-3, rtol=0)


def test_fused_step_matches_jax(fused):
    for k in ("gen_loss", "loss_ri", "loss_mag", "loss_time", "loss_gan"):
        np.testing.assert_allclose(float(fused["tm"][k]), float(fused["jm"][k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(fused["tl"], fused["jl"], rtol=1e-4)
    assert fused["tl"] > 0
    state = fused["state"]
    assert state.step == int(fused["js1"].step) == 1
    want, got = _disc_sd(fused["js1"]), state.disc.state_dict()
    for name, ref in want.items():  # as in test_d_step_matches_jax
        assert (got[name] - ref).abs().max() <= 4 * LR * 1.01, name
        if name.endswith((".u", ".sigma")):
            np.testing.assert_allclose(got[name].numpy(), ref.numpy(), atol=1e-5, rtol=1e-4,
                                       err_msg=name)
    close = sum(int(((got[n] - r).abs() <= 1e-6).sum()) for n, r in want.items())
    assert close >= 0.98 * sum(r.numel() for r in want.values())
    assert int(state.disc_opt.state_dict()["state"][0]["step"]) == 1


def test_fused_step_undoes_the_d_update_of_a_failed_label(monkeypatch):
    """A silent clean row fails its label: the G update stands, and the
    discriminator's parameters, spectral-norm buffers and AdamW state are
    bitwise those before the D phase; the loss is 0."""
    _, cfg = _cfgs(pesq_label_mode="device")
    state = init_train_state(cfg, 0, SPE, device="cpu")
    fused_step = make_train_steps(cfg, SPE)[4]
    _, loss = fused_step(state, *_batch(1))   # a valid batch: Adam's state is not zero
    assert float(loss) > 0 and int(state.disc_opt.state_dict()["state"][0]["step"]) == 1

    seen = {}

    def labels_spy(clean, est):   # the D phase starts where the labels are computed
        seen["disc"] = {k: v.clone() for k, v in state.disc.state_dict().items()}
        seen["opt"] = [t.clone() for s in state.disc_opt.state.values() for t in s.values()]
        seen["labels"] = pesq_labels_torch(clean, est)
        return seen["labels"]

    monkeypatch.setattr(tsteps, "pesq_labels_torch", labels_spy)
    clean, noisy = _batch(2)
    clean[1] = 0.0
    gen_before = {k: v.clone() for k, v in state.gen.state_dict().items()}
    metrics, loss = fused_step(state, clean, noisy)
    assert seen["labels"][1] == -1.0 and seen["labels"][0] > 0
    assert float(loss) == 0.0 and np.isfinite(float(metrics["gen_loss"])) and state.step == 2
    for k, v in state.disc.state_dict().items():
        assert torch.equal(v, seen["disc"][k]), k
    now = [t for s in state.disc_opt.state.values() for t in s.values()]
    assert len(now) == 3 * len(list(state.disc.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(now, seen["opt"]))
    moved = [k for k, v in state.gen.state_dict().items() if not torch.equal(v, gen_before[k])]
    assert len(moved) >= len(gen_before) // 2


def test_restore_keeps_the_optimizers_capturable_flag(tmp_path):
    """A checkpoint from a device-mode run on the GPU (a capturable
    discriminator optimizer) restores into an optimizer that is not
    capturable, with Adam's step count on the CPU."""
    _, cfg = _cfgs()
    state = init_train_state(cfg, 0, SPE, device="cpu")
    g_step, d_step, _, _, _ = make_train_steps(cfg, SPE)
    _, h = g_step(state, *_batch())
    d_step(state, h["clean_mag"], h["est_mag"], np.array([2.0, 3.0]))
    state.disc_opt.param_groups[0]["capturable"] = True   # as the saving run had it
    save_train_state(str(tmp_path / "ckpt"), state)
    fresh = init_train_state(cfg, 1, SPE, device="cpu")
    restore_train_state(str(tmp_path / "ckpt"), fresh)
    assert fresh.disc_opt.param_groups[0]["capturable"] is False
    steps = [s["step"] for s in fresh.disc_opt.state.values()]
    assert all(t.device.type == "cpu" and t.dtype == torch.float32 and float(t) == 1.0
               for t in steps)
    for a, b in zip(fresh.disc_opt.state.values(), state.disc_opt.state.values()):
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])


def test_flash_backward_is_on_the_cpu_training_path():
    _, cfg = _cfgs()
    state = init_train_state(cfg, 0, SPE, device="cpu")
    g_step, _, _, _, _ = make_train_steps(cfg, SPE)
    plain = fa.plain_calls
    g_step(state, *_batch())
    assert fa.plain_calls - plain == 4  # 'flash' forces it: time and frequency conformer of 2 TSCBs
    _, dense = _cfgs(model=dict(attention_impl="auto"))
    state = init_train_state(dense, 0, SPE, device="cpu")
    plain = fa.plain_calls
    make_train_steps(dense, SPE)[0](state, *_batch())
    assert fa.plain_calls == plain  # 33 frames: 'auto' stays dense


def test_lr_schedules_at_epoch_boundaries():
    jcfg, cfg = _cfgs(decay_epochs=2, init_lr=1e-3)
    ours, theirs = make_lr_schedule(cfg, SPE, 1e-3), jstate.make_lr_schedule(jcfg, SPE, 1e-3)
    d_ours, d_theirs = make_disc_lr_schedule(cfg, SPE), jstate.make_disc_lr_schedule(jcfg, SPE)
    for step in (0, 1, 19, 20, 21, 39, 40, 79, 80):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-12)
        assert d_ours(step) == pytest.approx(float(d_theirs(step)), rel=1e-12)
    assert ours(19) == 1e-3 and ours(20) == 5e-4 and ours(40) == 2.5e-4
    assert d_ours(0) == 2e-3 and d_ours(20) == 1e-3


def test_steps_set_the_scheduled_lr():
    _, cfg = _cfgs(decay_epochs=1)
    state = init_train_state(cfg, 0, 1, device="cpu")  # one step an epoch: decay every step
    g_step, d_step, _, _, _ = make_train_steps(cfg, 1)
    for want in (LR, LR / 2):
        _, h = g_step(state, *_batch())
        assert state.gen_opt.param_groups[0]["lr"] == want
        d_step(state, h["clean_mag"], h["est_mag"], np.array([2.0, 2.0]))
        assert state.disc_opt.param_groups[0]["lr"] == 2 * want  # disc_lr(step_now - 1)


def test_d_step_skips_an_invalid_batch_entirely():
    _, cfg = _cfgs()
    state = init_train_state(cfg, 0, SPE, device="cpu")
    g_step, d_step, _, _, _ = make_train_steps(cfg, SPE)
    _, h = g_step(state, *_batch())
    d_step(state, h["clean_mag"], h["est_mag"], np.array([2.0, 3.0]))  # Adam state exists now
    before = {k: v.clone() for k, v in state.disc.state_dict().items()}
    opt_before = {i: {k: torch.as_tensor(v).clone() for k, v in s.items()}
                  for i, s in state.disc_opt.state_dict()["state"].items()}
    rng_before = state.rng_state.clone()
    loss = d_step(state, h["clean_mag"], h["est_mag"], np.array([2.0, -1.0]))
    assert float(loss) == 0.0
    for k, v in state.disc.state_dict().items():
        assert torch.equal(v, before[k]), k
    for i, s in state.disc_opt.state_dict()["state"].items():
        for k, v in s.items():  # moments and Adam's own step count
            assert torch.equal(torch.as_tensor(v), opt_before[i][k]), (i, k)
    assert torch.equal(state.rng_state, rng_before)
    assert float(d_step(state, h["clean_mag"], h["est_mag"], np.array([2.0, 3.0]))) > 0


def test_unported_modes_raise():
    _, cfg = _cfgs(pesq_label_mode="device")   # ported: builds
    state = init_train_state(cfg, 0, SPE, device="cpu")
    assert len(make_train_steps(cfg, SPE)) == 5
    assert not state.disc_opt.param_groups[0]["capturable"]   # capturable only on the GPU
    with pytest.raises(ValueError):
        make_train_steps(_cfgs(pesq_label_mode="bogus")[1], SPE)
    # a mesh of more than one rank needs a process group (tests/test_torch_parallel.py runs one)
    two = dataclasses.replace(_cfgs()[1], mesh=MeshConfig(data_parallel=2))
    with pytest.raises(RuntimeError, match="process group"):
        init_train_state(two, 0, SPE, device="cpu")
    seq = dataclasses.replace(_cfgs()[1], mesh=MeshConfig(seq_parallel=2))
    with pytest.raises(RuntimeError, match="process group"):
        make_train_steps(seq, SPE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            init_train_state(_cfgs()[1], 0, SPE)  # the default device is the GPU
    assert cli_train.parse_args(["--data_dir", "x", "--pesq_label_mode", "device"]
                                ).pesq_label_mode == "device"
    with pytest.raises(SystemExit):
        cli_train.parse_args(["--data_dir", "x", "--pesq_label_mode", "bogus"])


def test_time_loss_domain_and_loss_region_match_jax():
    """test_fwd (eval mode) under each option against the JAX package's."""
    clean, noisy = _batch(3)
    js0 = None
    for train in (dict(), dict(time_loss_domain="normalized"), dict(loss_region=(800, 2400))):
        jcfg, cfg = _cfgs(**train)
        if js0 is None:
            js0 = jax_init_train_state(jcfg, 0, SPE)
        state = _load_from_jax(init_train_state(cfg, 0, SPE, device="cpu"), js0)
        jm, _ = jax_make_train_steps(jcfg, SPE)[2](js0, jnp.asarray(clean), jnp.asarray(noisy))
        tm, _ = make_train_steps(cfg, SPE)[2](state, clean, noisy)
        for k in ("gen_loss", "loss_ri", "loss_mag", "loss_time", "loss_gan"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5, err_msg=(train, k))
        np.testing.assert_allclose(tm["gen_loss_per_ex"].numpy(), np.asarray(jm["gen_loss_per_ex"]),
                                   rtol=2e-5)
        assert not state.gen.training and not state.disc.training
    assert tsteps.loss_region_frames(cfg) == jsteps.loss_region_frames(jcfg) == (800, 2400, 8, 24)
    with pytest.raises(ValueError):
        tsteps.loss_region_frames(_cfgs(loss_region=(0, CUT + 1))[1])


def test_test_disc_loss_matches_jax():
    jcfg, cfg = _cfgs()
    js0 = jax_init_train_state(jcfg, 0, SPE)
    state = _load_from_jax(init_train_state(cfg, 0, SPE, device="cpu"), js0)
    rng = np.random.default_rng(0)
    cm = np.abs(rng.standard_normal((2, 33, 201))).astype(np.float32)
    em = np.abs(rng.standard_normal((2, 33, 201))).astype(np.float32)
    scores = np.array([1.5, 4.0], np.float32)
    ref = jax_make_train_steps(jcfg, SPE)[3](js0, jnp.asarray(cm), jnp.asarray(em), jnp.asarray(scores))
    fn = make_train_steps(cfg, SPE)[3]
    ours = fn(state, torch.from_numpy(cm), torch.from_numpy(em), scores)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-4)
    assert fn(state, torch.from_numpy(cm), torch.from_numpy(em), np.array([-1.0, 4.0])).tolist() == [0, 0]


def test_remat_gives_the_same_step_and_moves_batchnorm_once():
    _, cfg = _cfgs(model=dict(ff_dropout=0.2, attn_dropout=0.2))  # same masks when recomputed
    _, rcfg = _cfgs(model=dict(ff_dropout=0.2, attn_dropout=0.2, remat=True))
    a = init_train_state(cfg, 0, SPE, device="cpu")
    b = init_train_state(rcfg, 0, SPE, device="cpu")
    ma, _ = make_train_steps(cfg, SPE)[0](a, *_batch())
    mb, _ = make_train_steps(rcfg, SPE)[0](b, *_batch())
    assert float(ma["gen_loss"]) == pytest.approx(float(mb["gen_loss"]), rel=1e-6)
    for (k, x), y in zip(a.gen.state_dict().items(), b.gen.state_dict().values()):
        torch.testing.assert_close(x, y, atol=2e-6, rtol=1e-5, msg=k)
    bn = [m for m in b.gen.modules() if isinstance(m, BatchNorm)]
    assert len(bn) == 4 and all(int(m.num_batches_tracked) == 1 for m in bn)
    assert BatchNorm.track_running_stats_now


# ---------------------------------------------------------------- the trainer

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("demand")
    rng = np.random.default_rng(0)
    for split, count in (("train", 5), ("test", 3)):
        for kind in ("clean", "noisy"):
            os.makedirs(root / split / kind)
        for i in range(count):
            clean = (0.1 * rng.standard_normal(5000)).astype(np.float32)
            noisy = clean + (0.03 * rng.standard_normal(5000)).astype(np.float32)
            write_wav(str(root / split / "clean" / f"p{i}.wav"), clean, 16000)
            write_wav(str(root / split / "noisy" / f"p{i}.wav"), noisy, 16000)
    return str(root)


def _trainer(data_dir, model=None, **train):
    _, cfg = _cfgs(model=model, **train)
    loaders = load_data(data_dir, cfg.train.batch_size, cfg.train.cut_len, cfg.train.seed)
    return Trainer(cfg, *loaders, device="cpu")


def test_host_async_defers_the_d_update_by_one_step(data_dir):
    sync = _trainer(data_dir)
    lazy = _trainer(data_dir, pesq_label_mode="host_async")
    b1, b2 = _batch(1), _batch(2)
    d0 = {k: v.clone() for k, v in lazy.state.disc.state_dict().items()}
    _, sync_d1 = sync.train_step(*b1)
    g1, none = lazy.train_step(*b1)
    assert none is None and lazy._pending_d is not None and lazy._pending_d[2] == 1
    for name, p in lazy.state.disc.named_parameters():  # D's weights have not moved yet
        assert torch.equal(p, d0[name]), name
    # the deferred update sees batch 1's tensors and labels, but the
    # spectral-norm state as batch 2's G phase left it: near the synchronous
    # loss, not equal to it
    _, lazy_d1 = lazy.train_step(*b2)
    assert float(lazy_d1) == pytest.approx(float(sync_d1), rel=5e-2)
    assert float(lazy_d1) != float(sync_d1)
    assert lazy.state.step == 2 and lazy._pending_d[2] == 2
    assert float(lazy.drain_pending_d()) > 0 and lazy.drain_pending_d() is None


def test_deferred_d_step_uses_the_stashed_step_for_its_lr(data_dir):
    t = _trainer(data_dir, decay_epochs=1)  # 2 steps an epoch
    _, h = t.g_step(t.state, *_batch(1))
    t.g_step(t.state, *_batch(2))
    t.g_step(t.state, *_batch(3))           # state.step is 3: epoch 1
    t.d_step(t.state, h["clean_mag"], h["est_mag"], np.array([2.0, 2.0]), 1)
    assert t.state.disc_opt.param_groups[0]["lr"] == 2 * LR       # batch 0: epoch 0
    t.d_step(t.state, h["clean_mag"], h["est_mag"], np.array([2.0, 2.0]))
    assert t.state.disc_opt.param_groups[0]["lr"] == LR           # step 2: epoch 1


def test_ema_tracks_the_parameter_history(data_dir):
    t = _trainer(data_dir, gen_ema_decay=0.5)
    name = "dense_encoder.conv_1.0.weight"
    p0 = t.state.gen.state_dict()[name].clone()
    t.train_step(*_batch(1))
    p1 = t.state.gen.state_dict()[name].clone()
    t.train_step(*_batch(2))
    p2 = t.state.gen.state_dict()[name].clone()
    want = 0.5 * (0.5 * p0 + 0.5 * p1) + 0.5 * p2
    torch.testing.assert_close(t.ema_params[name], want, atol=1e-7, rtol=1e-6)
    variables = t.ema_variables()
    assert set(variables) == set(t.state.gen.state_dict())
    torch.testing.assert_close(variables[name], want, atol=1e-7, rtol=1e-6)
    bn = next(k for k in variables if k.endswith("running_var"))
    assert torch.equal(variables[bn], t.state.gen.state_dict()[bn])  # current stats ride along
    with pytest.raises(ValueError):
        _trainer(data_dir).ema_variables()


def test_checkpoint_round_trip_resumes_the_run(data_dir, tmp_path):
    """Two steps in one run equal one step, a checkpoint, a restore into a
    fresh trainer and one more step: weights, optimizer moments, the step
    and the dropout stream all carry over (dropout is on here). Two runs of
    one step differ by rounding (threaded sums), and an entry whose gradient
    is rounding noise may step the other way (2 * lr); another dropout
    stream would move most entries by about lr."""
    drop = dict(ff_dropout=0.2, attn_dropout=0.2, disc_dropout=0.3, attention_impl="xla")
    b1, b2 = _batch(1), _batch(2)
    whole = _trainer(data_dir, model=drop, gen_ema_decay=0.9)
    whole.train_step(*b1)
    whole.train_step(*b2)

    first = _trainer(data_dir, model=drop, gen_ema_decay=0.9)
    first.train_step(*b1)
    path = first.save_checkpoint(str(tmp_path), 0, 1.23456)
    assert os.path.basename(path) == "CMGAN_epoch_0_1.234" and os.path.exists(path + "_ema")

    second = _trainer(data_dir, model=drop, gen_ema_decay=0.9, seed=7)  # another init
    second.restore_checkpoint(path)
    assert second.state.step == 1
    torch.testing.assert_close(second.ema_params["dense_encoder.conv_1.0.weight"],
                               first.ema_params["dense_encoder.conv_1.0.weight"])
    second.train_step(*b2)
    assert second.state.step == whole.state.step == 2
    for mod in ("gen", "disc"):
        a, b = getattr(whole.state, mod).state_dict(), getattr(second.state, mod).state_dict()
        diffs = torch.cat([(a[k].float() - b[k].float()).abs().reshape(-1) for k in a])
        assert diffs.max() <= 4 * LR * 1.01, mod
        assert (diffs <= 1e-6).float().mean() >= 0.99, mod
    for k, v in whole.ema_params.items():
        torch.testing.assert_close(second.ema_params[k], v, atol=4 * LR * 0.1 * 1.01, rtol=0, msg=k)
    # the EMA sibling is a generator state_dict the enhance CLI can load
    ema = restore_variables(path + "_ema")
    assert set(ema) == set(first.state.gen.state_dict())
    # without the sibling the EMA restarts from the restored weights
    os.remove(path + "_ema")
    third = _trainer(data_dir, model=drop, gen_ema_decay=0.9, seed=7)
    third.restore_checkpoint(path)
    torch.testing.assert_close(third.ema_params["dense_encoder.conv_1.0.weight"],
                               first.state.gen.state_dict()["dense_encoder.conv_1.0.weight"])


def test_restore_resumes_the_loaders_at_the_next_epoch(data_dir, tmp_path):
    """A checkpoint after two epochs restores into a trainer whose loaders
    go on at epoch 2: the shuffle and the crops of the run without the
    restart."""
    first = _trainer(data_dir, cut_len=1600)   # 5 files, batch 2: 2 steps an epoch
    assert first.steps_per_epoch == 2 and not first.local_rows
    first.state.step = 2 * first.steps_per_epoch
    path = first.save_checkpoint(str(tmp_path), 1, 1.0)
    second = _trainer(data_dir, cut_len=1600)
    second.restore_checkpoint(path)
    assert second.train_loader.epoch == second.test_loader.epoch == 2
    ref_train, ref_test = load_data(data_dir, BATCH, 1600, TrainConfig().seed)
    for loader in (ref_train, ref_test):
        list(loader), list(loader)   # epochs 0 and 1
    for got, want in ((second.train_loader, ref_train), (second.test_loader, ref_test)):
        got, want = list(got), list(want)
        assert len(got) == len(want) > 0
        for (c1, n1), (c2, n2) in zip(got, want):
            np.testing.assert_array_equal(c1, c2)
            np.testing.assert_array_equal(n1, n2)


def test_a_sharded_loader_without_a_mesh_raises(data_dir):
    _, cfg = _cfgs()
    train, test = load_data(data_dir, BATCH, CUT, num_processes=2, process_index=0)
    with pytest.raises(ValueError, match="process 0 of 2.*no mesh"):
        Trainer(cfg, train, test, device="cpu")


def test_test_pass_weights_a_partial_last_batch_by_real_rows(data_dir):
    t = _trainer(data_dir)  # 3 test files, batch 2: the last batch has one row
    got = t.test()
    t_one = _trainer(data_dir, batch_size=1)
    t_one.state.gen.load_state_dict(t.state.gen.state_dict())
    t_one.state.disc.load_state_dict(t.state.disc.state_dict())
    assert got == pytest.approx(t_one.test(), rel=1e-5)
    no_test = Trainer(t.cfg, t.train_loader, None, device="cpu", state=t.state)
    assert np.isnan(no_test.test())


def test_train_epoch_runs_every_batch_in_both_label_modes(data_dir):
    for mode in ("host", "host_async"):
        t = _trainer(data_dir, pesq_label_mode=mode, log_interval=1)
        before = t.state.disc.conv1.layer.weight.clone()
        t.train_epoch(0)
        assert t.state.step == 2 and t._pending_d is None  # 5 files, batch 2, drop_last
        assert not torch.equal(t.state.disc.conv1.layer.weight, before)
        assert int(t.state.disc_opt.state_dict()["state"][0]["step"]) == 2


def test_train_epoch_and_cli_in_device_mode(data_dir, tmp_path):
    """pesq_label_mode='device' through the Trainer and the CLI: every batch
    takes the fused step, the returned losses stay on the device until the
    loop fetches them, and the discriminator moves."""
    t = _trainer(data_dir, pesq_label_mode="device", log_interval=1)
    before = t.state.disc.conv1.layer.weight.clone()
    gen_loss, disc_loss = t.train_step(*_batch(1))
    assert isinstance(gen_loss, torch.Tensor) and isinstance(disc_loss, torch.Tensor)
    assert float(disc_loss) > 0 and t._pending_d is None
    t.train_epoch(0)
    assert t.state.step == 3
    assert not torch.equal(t.state.disc.conv1.layer.weight, before)
    assert int(t.state.disc_opt.state_dict()["state"][0]["step"]) == 3
    assert np.isfinite(t.test())   # host labels, as in the other modes

    args = ["--data_dir", data_dir, "--save_model_dir", str(tmp_path), "--epochs", "1",
            "--batch_size", "2", "--cut_len", "1600", "--log_interval", "1", "--device", "cpu",
            "--pesq_label_mode", "device"]
    trainer = cli_train.main(args)
    assert trainer.cfg.train.pesq_label_mode == "device" and trainer.state.step == 2
    assert int(trainer.state.disc_opt.state_dict()["state"][0]["step"]) == 2
    assert any(n.startswith("CMGAN_epoch_0_") for n in os.listdir(tmp_path))


def test_cli_trains_checkpoints_and_resumes_on_the_cpu(data_dir, tmp_path):
    """The CLI at the full published width on a tiny directory."""
    args = ["--data_dir", data_dir, "--save_model_dir", str(tmp_path), "--epochs", "1",
            "--batch_size", "2", "--cut_len", "1600", "--log_interval", "1", "--device", "cpu",
            "--ema_decay", "0.9"]
    trainer = cli_train.main(args)
    assert trainer.cfg.model == ModelConfig() and trainer.state.step == 2
    ckpts = sorted(n for n in os.listdir(tmp_path) if not n.endswith("_ema"))
    assert len(ckpts) == 1 and ckpts[0].startswith("CMGAN_epoch_0_")
    resumed = cli_train.main(args + ["--resume", str(tmp_path / ckpts[0]), "--bf16"])
    assert resumed.state.step == 4
    assert all(torch.isfinite(p).all() for p in resumed.state.gen.parameters())


def test_cli_flags_are_the_jax_packages():
    from cmgan_tpu.cli import train as jax_cli

    ours = vars(cli_train.parse_args(["--data_dir", "x"]))
    theirs = vars(jax_cli.parse_args(["--data_dir", "x"]))
    assert ours.pop("device") == "cuda"
    assert ours == theirs
