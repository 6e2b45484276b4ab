"""GAN train and test steps.

One optimization step is two device phases bridged by the host PESQ
labeler (the only host round trip, as in the CMGAN reference's
synchronous CPU labeling):

  phase G (device): RMS-norm -> STFT -> compress -> generator forward
    (train mode: dropout on, BatchNorm on batch statistics) -> losses
    (RI + magnitude + time + metric-GAN through the discriminator) ->
    gradients of the generator's parameters -> AdamW update.
  host: wideband PESQ labels for (clean, est_audio) from the native
    library; any failed utterance invalidates the batch.
  phase D (device): the discriminator on [clean, clean] and
    [clean, est] as one batch of 2B, MSE to (1, pesq_label) targets,
    gradients, update; skipped entirely when the labels are invalid.

With `pesq_label_mode='device'` the three run as one step with no host
round trip (`fused_step`): the labels come from the batched torch PESQ
on the device (metrics/pesq_torch.py), and a batch with a failed label
is undone by a device-side select instead of being skipped on the host.

The steps update the `TrainState` they are given in place.

Under a mesh (`cmgan_torch.parallel`) each data rank steps on its own rows
of the global batch: the parameter gradients of G and of D are averaged
over `data` (one flat buffer a model; over `seq` they are equal already),
BatchNorm's statistics are the global batch's, the returned losses are
global means, and a batch is skipped when a label failed on any rank (the
JAX package tests the global batch's minimum label).

Reference quirks kept on purpose, as in the JAX package: the time-domain
L1 loss and the PESQ labels compare the *normalized-domain* est_audio
with the *unnormalized* clean waveform. The time-loss side suppresses
output gain; `TrainConfig.time_loss_domain='normalized'` targets
clean * c instead. The label side is harmless (PESQ level-aligns).
"""

from __future__ import annotations

import numpy as np
import torch

from cmgan_torch.config import CMGANConfig
from cmgan_torch.dsp import istft, power_compress, power_uncompress, stft
from cmgan_torch.metrics.pesq_torch import pesq_labels_torch
from cmgan_torch.parallel import collectives
from cmgan_torch.train.state import (
    TrainState,
    check_supported,
    init_adam_state,
    make_disc_lr_schedule,
    make_lr_schedule,
    rng_scope,
)
from cmgan_torch.utils.profiling import span


def pesq_labels_host(clean: np.ndarray, est: np.ndarray) -> np.ndarray:
    """Batch PESQ on the host; -1 marks failures (silent utterances)."""
    from cmgan_torch.metrics.pesq_native import pesq_batch

    clean = np.asarray(clean, np.float64)
    est = np.asarray(est, np.float64)
    try:
        scores = pesq_batch(clean, est)
    except Exception:
        return np.full(clean.shape[0], -1.0, np.float32)
    # degenerate (all-zero / non-finite) utterances are failures
    bad = ~np.isfinite(scores)
    energy = np.sum(clean * clean, axis=-1) * np.sum(est * est, axis=-1)
    bad |= energy <= 0.0
    return np.where(bad, -1.0, scores).astype(np.float32)


def _generator_forward(gen, clean, noisy, cfg: CMGANConfig):
    """Shared forward pass in the generator's current mode: spectra and
    est audio. clean, noisy: [B, L] float32 on the generator's device."""
    dsp = cfg.dsp
    length = noisy.shape[-1]
    c = torch.sqrt(length / torch.sum(noisy * noisy, dim=-1, keepdim=True))
    noisy_n = noisy * c
    clean_n = clean * c

    noisy_spec = power_compress(stft(noisy_n, dsp.n_fft, dsp.hop, dft_impl=dsp.dft_impl),
                                dsp.compress_exponent)
    clean_spec = power_compress(stft(clean_n, dsp.n_fft, dsp.hop, dft_impl=dsp.dft_impl),
                                dsp.compress_exponent)
    clean_real = clean_spec[..., 0]
    clean_imag = clean_spec[..., 1]
    clean_mag = torch.sqrt(clean_real**2 + clean_imag**2)

    est_real, est_imag = gen(noisy_spec)
    est_mag = torch.sqrt(est_real**2 + est_imag**2)
    est_audio = istft(power_uncompress(est_real, est_imag, dsp.compress_exponent),
                      dsp.n_fft, dsp.hop, dft_impl=dsp.dft_impl)
    return {
        "est_real": est_real,
        "est_imag": est_imag,
        "est_mag": est_mag,
        "clean_real": clean_real,
        "clean_imag": clean_imag,
        "clean_mag": clean_mag,
        "est_audio": est_audio,
        "clean_audio_n": clean_n,
    }


def loss_region_frames(cfg: CMGANConfig):
    """Static (s0, s1, f0, f1) for TrainConfig.loss_region, or None.

    Samples [s0, s1) of the cut_len window; STFT frames [f0, f1) are the
    frames whose centers (t * hop, center-padded STFT) fall inside the
    sample range.
    """
    if cfg.train.loss_region is None:
        return None
    s0, s1 = cfg.train.loss_region
    L, hop = cfg.train.cut_len, cfg.dsp.hop
    if not (0 <= s0 < s1 <= L):
        raise ValueError(f"loss_region {cfg.train.loss_region} outside [0, {L}]")
    f0 = -(-s0 // hop)
    f1 = (s1 - 1) // hop + 1
    return (s0, s1, f0, f1)


def _generator_loss(disc, out, time_target, weights, region=None):
    """The generator's loss, with the discriminator in its current mode:
    in train mode its dropout is on and its spectral-norm state advances
    (and is kept), as in the reference, where D is in .train() during the
    G step.

    Losses are reduced per example first (mean over non-batch axes) so
    eval can weight partial batches by real rows; the batch means equal
    the whole-batch means exactly (equal-sized rows).

    `region` = (s0, s1, f0, f1) from loss_region_frames(): the RI /
    magnitude / time losses reduce over only samples [s0, s1) / frames
    [f0, f1); the GAN term stays whole-window.

    Returns (mean total, per-example totals [B], parts).
    """
    w_ri, w_mag, w_time, w_gan = weights
    score = disc(out["clean_mag"], out["est_mag"])

    def per_ex(x):
        return x.reshape(x.shape[0], -1).mean(dim=-1)

    if region is None:
        fsl = tsl = slice(None)
    else:
        s0, s1, f0, f1 = region
        fsl, tsl = slice(f0, f1), slice(s0, s1)

    gan_loss = (score.reshape(-1).float() - 1.0) ** 2
    loss_mag = per_ex((out["est_mag"][:, fsl] - out["clean_mag"][:, fsl]) ** 2)
    loss_ri = per_ex((out["est_real"][:, fsl] - out["clean_real"][:, fsl]) ** 2) + per_ex(
        (out["est_imag"][:, fsl] - out["clean_imag"][:, fsl]) ** 2
    )
    time_loss = per_ex(torch.abs(out["est_audio"][:, tsl] - time_target[:, tsl]))
    total = w_ri * loss_ri + w_mag * loss_mag + w_time * time_loss + w_gan * gan_loss
    parts = {
        "loss_ri": loss_ri.mean(),
        "loss_mag": loss_mag.mean(),
        "loss_time": time_loss.mean(),
        "loss_gan": gan_loss.mean(),
    }
    return total.mean(), total, parts


def _disc_pairs(disc, clean_mag, est_mag):
    """Scores of [clean, clean] and [clean, est] from one batch of 2B."""
    x = torch.cat([clean_mag, clean_mag], dim=0)
    y = torch.cat([clean_mag, est_mag], dim=0)
    scores = disc(x, y).reshape(-1).float()
    b = clean_mag.shape[0]
    return scores[:b], scores[b:]


def _set_lr(opt: torch.optim.Optimizer, lr: float):
    for group in opt.param_groups:
        group["lr"] = lr


def _disc_state_tensors(state: TrainState):
    """Everything a discriminator update changes: its parameters, its
    buffers (spectral-norm u and sigma) and AdamW's state of each parameter
    (step count and both moments)."""
    params = list(state.disc.parameters())
    opt_state = [t for p in params for t in state.disc_opt.state[p].values()]
    return params + list(state.disc.buffers()) + opt_state


def make_train_steps(cfg: CMGANConfig, steps_per_epoch: int, mesh=None):
    """Returns (g_step, d_step, test_fwd, test_disc_loss, fused_step); with
    a mesh, steps of this rank's share of a data-parallel step."""
    check_supported(cfg)
    gen_lr = make_lr_schedule(cfg, steps_per_epoch, cfg.train.init_lr)
    disc_lr = make_disc_lr_schedule(cfg, steps_per_epoch)
    weights = cfg.train.loss_weights
    time_norm = cfg.train.time_loss_domain == "normalized"
    region = loss_region_frames(cfg)
    offset, scale = cfg.train.pesq_norm_offset, cfg.train.pesq_norm_scale

    def _time_target(out, clean):
        # see TrainConfig.time_loss_domain: raw clean reproduces the
        # reference's gain-suppressing quirk; clean_audio_n fixes it
        return out["clean_audio_n"] if time_norm else clean

    def _on_device(state, *arrays):
        return [torch.as_tensor(a, dtype=torch.float32, device=state.device) for a in arrays]

    def _global_mean(values):
        if mesh is not None:
            collectives.average_(values, mesh.data_group)
        return values

    def _any_label_failed(state, pesq_scores) -> bool:
        """Whether a label of the batch failed, on any data rank."""
        low = float(np.min(pesq_scores))
        if mesh is not None:
            low = collectives.minimum(torch.tensor(low, device=state.device),
                                      mesh.data_group).item()
        return low < 0.0

    def g_step(state: TrainState, clean, noisy):
        """One generator update. Returns (metrics, handoff): loss parts as
        0-d device tensors, and the detached tensors the host labeler and
        the discriminator phase take."""
        with span("cmgan.train.g"):
            clean, noisy = _on_device(state, clean, noisy)
            state.gen.train()
            state.disc.train()
            params = list(state.gen.parameters())
            with rng_scope(state):
                out = _generator_forward(state.gen, clean, noisy, cfg)
                loss, _, parts = _generator_loss(
                    state.disc, out, _time_target(out, clean), weights, region=region
                )
                # only the generator's parameters get gradients; the
                # discriminator's spectral-norm state has advanced and stays
                grads = _global_mean(list(torch.autograd.grad(loss, params)))
            for p, g in zip(params, grads):
                p.grad = g
            _set_lr(state.gen_opt, gen_lr(state.step))
            state.gen_opt.step()
            state.gen_opt.zero_grad(set_to_none=True)
            state.step += 1
            metrics = {k: v.detach().clone() for k, v in parts.items()}
            metrics["gen_loss"] = loss.detach().clone()
            _global_mean(list(metrics.values()))
            handoff = {
                "clean_mag": out["clean_mag"].detach(),
                "est_mag": out["est_mag"].detach(),
                "est_audio": out["est_audio"].detach(),
            }
            return metrics, handoff

    def _d_update(state: TrainState, clean_mag, est_mag, labels, step_now: int):
        """The discriminator's loss, gradients and AdamW update; labels are
        the normalized PESQ targets on the device."""
        state.disc.train()
        with rng_scope(state):
            pred_max, pred_enh = _disc_pairs(state.disc, clean_mag, est_mag)
            loss = ((pred_max - 1.0) ** 2).mean() + ((pred_enh - labels) ** 2).mean()
            state.disc_opt.zero_grad(set_to_none=True)
            loss.backward()
        _global_mean([p.grad for p in state.disc.parameters()])
        # step_now is the post-G value, so this batch's step is step_now - 1:
        # the decay follows the shared global step, not D's own update count
        _set_lr(state.disc_opt, disc_lr(step_now - 1))
        state.disc_opt.step()
        state.disc_opt.zero_grad(set_to_none=True)
        return _global_mean([loss.detach().clone()])[0]

    def d_step(state: TrainState, clean_mag, est_mag, pesq_scores, at_step=None):
        """One discriminator update; returns its loss (0 when skipped).

        at_step: the value state.step had right after THIS batch's G
        phase. Defaults to state.step (synchronous call order); the
        host_async mode applies this update after the NEXT batch's G
        phase has advanced state.step, and passes the stashed value so
        the StepLR epoch matches the synchronous schedule.

        A batch with a failed label (any score < 0) is skipped: neither
        the parameters, nor Adam's moments and step count, nor the
        spectral-norm state move.
        """
        step_now = state.step if at_step is None else at_step
        pesq_scores = np.asarray(pesq_scores, np.float32)
        with span("cmgan.train.d"):
            if _any_label_failed(state, pesq_scores):
                return torch.zeros((), device=state.device)
            (labels,) = _on_device(state, (pesq_scores - offset) / scale)
            return _d_update(state, clean_mag, est_mag, labels, step_now)

    def fused_step(state: TrainState, clean, noisy):
        """The G update, PESQ labels of (clean, est_audio) on the device and
        the D update, with no host round trip (pesq_label_mode='device').
        Returns (metrics, disc_loss) as in g_step and d_step.

        A batch with a failed label (a silent row or a non-finite score) is
        undone as d_step skips it, but decided on the device: the update
        runs, then every discriminator tensor it changed (parameters,
        spectral-norm buffers, AdamW's moments and step count) is selected
        back to its value before, and the loss is 0. The dropout stream
        still advances. On a CUDA state this needs the capturable
        discriminator optimizer that init_train_state builds for this mode
        (torch keeps Adam's step count on the CPU otherwise).
        """
        if state.device.type == "cuda" and not all(
                g["capturable"] for g in state.disc_opt.param_groups):
            raise ValueError("fused_step needs a capturable discriminator optimizer on the GPU: "
                             "build the state with pesq_label_mode='device'")
        clean, noisy = _on_device(state, clean, noisy)
        metrics, handoff = g_step(state, clean, noisy)
        with torch.no_grad(), span("cmgan.train.labels"):
            scores = pesq_labels_torch(clean, handoff["est_audio"])
            low = scores.min()
            if mesh is not None:
                low = collectives.minimum(low, mesh.data_group)
            valid = low >= 0.0
        with span("cmgan.train.d"):
            with torch.no_grad():
                init_adam_state(state.disc_opt)
                kept = _disc_state_tensors(state)
                before = [t.clone() for t in kept]
            loss = _d_update(state, handoff["clean_mag"], handoff["est_mag"],
                             (scores - offset) / scale, state.step)
            with torch.no_grad():
                for t, old in zip(kept, before):
                    t.copy_(torch.where(valid, t, old))
            return metrics, torch.where(valid, loss, 0.0)

    @torch.no_grad()
    def test_fwd(state: TrainState, clean, noisy):
        """Eval-mode forward: generator loss parts + handoff.

        metrics['gen_loss_per_ex'] carries per-example totals so the
        caller can weight partial (wrap-padded) batches by real rows.
        """
        clean, noisy = _on_device(state, clean, noisy)
        state.gen.eval()
        state.disc.eval()
        out = _generator_forward(state.gen, clean, noisy, cfg)
        total, per_ex, parts = _generator_loss(
            state.disc, out, _time_target(out, clean), weights, region=region
        )
        metrics = dict(parts, gen_loss=total, gen_loss_per_ex=per_ex)
        handoff = {k: out[k] for k in ("clean_mag", "est_mag", "est_audio")}
        return metrics, handoff

    @torch.no_grad()
    def test_disc_loss(state: TrainState, clean_mag, est_mag, pesq_scores):
        """Per-example D losses [B] (0 when any PESQ label failed)."""
        pesq_scores = np.asarray(pesq_scores, np.float32)
        if _any_label_failed(state, pesq_scores):
            return torch.zeros(clean_mag.shape[0], device=state.device)
        (labels,) = _on_device(state, (pesq_scores - offset) / scale)
        state.disc.eval()
        pred_max, pred_enh = _disc_pairs(state.disc, clean_mag, est_mag)
        return (pred_max - 1.0) ** 2 + (pred_enh - labels) ** 2

    return g_step, d_step, test_fwd, test_disc_loss, fused_step
