"""The published CMGAN training step in plain PyTorch, float32.

One step: RMS-normalise (from the noisy row), compress both spectra,
the generator in training mode, its loss (0.1 RI + 0.9 magnitude +
0.2 time + 0.05 metric-GAN, the time term against the raw clean row, as
the published code has it), its gradient and AdamW update; then PESQ
labels of (clean, enhanced) on the device, and the discriminator's loss
on [clean, clean] and [clean, enhanced] against 1 and the normalised
label, its gradient and AdamW update. Dropout is drawn from one stream
seeded with `dropout_seed`, in the order the step uses it.
"""

from __future__ import annotations

import torch

from perfbench.reference import dsp, pesq
from perfbench.reference.model import Discriminator, TSCNet


def _forward(gen, clean, noisy, cfg):
    n_fft, hop, e = cfg["n_fft"], cfg["hop"], cfg["compress_exponent"]
    c = torch.sqrt(noisy.shape[-1] / torch.sum(noisy * noisy, dim=-1, keepdim=True))
    noisy_spec = dsp.compress(dsp.stft(noisy * c, n_fft, hop), e)
    clean_spec = dsp.compress(dsp.stft(clean * c, n_fft, hop), e)
    cr, ci = clean_spec[..., 0], clean_spec[..., 1]
    er, ei = gen(noisy_spec)
    return {"clean_real": cr, "clean_imag": ci, "clean_mag": torch.sqrt(cr ** 2 + ci ** 2),
            "est_real": er, "est_imag": ei, "est_mag": torch.sqrt(er ** 2 + ei ** 2),
            "est_audio": dsp.istft(dsp.uncompress(er, ei, e), n_fft, hop)}


def _per_example(x):
    return x.reshape(x.shape[0], -1).mean(dim=-1)


def generator_loss(disc, out, clean, recipe):
    w_ri, w_mag, w_time, w_gan = recipe["loss_weights"]
    score = disc(out["clean_mag"], out["est_mag"])
    gan = (score.reshape(-1) - 1.0) ** 2
    mag = _per_example((out["est_mag"] - out["clean_mag"]) ** 2)
    ri = (_per_example((out["est_real"] - out["clean_real"]) ** 2)
          + _per_example((out["est_imag"] - out["clean_imag"]) ** 2))
    time = _per_example(torch.abs(out["est_audio"] - clean))
    return (w_ri * ri + w_mag * mag + w_time * time + w_gan * gan).mean()


def discriminator_loss(disc, clean_mag, est_mag, clean, est_audio, recipe):
    scores = pesq.labels(clean, est_audio)
    target = (scores - recipe["pesq_norm_offset"]) / recipe["pesq_norm_scale"]
    b = clean_mag.shape[0]
    pred = disc(torch.cat([clean_mag, clean_mag]), torch.cat([clean_mag, est_mag])).reshape(-1)
    return ((pred[:b] - 1.0) ** 2).mean() + ((pred[b:] - target) ** 2).mean()


def step(gen, disc, clean, noisy, cfg, recipe, opts=None):
    """One GAN step; with opts (AdamW of G, of D) the updates too.
    Returns (generator loss, discriminator loss, the generator's and the
    discriminator's gradients by name)."""
    gen.train()
    disc.train()
    out = _forward(gen, clean, noisy, cfg)
    g_loss = generator_loss(disc, out, clean, recipe)
    names = [n for n, _ in gen.named_parameters()]
    g_grads = torch.autograd.grad(g_loss, [p for _, p in gen.named_parameters()])
    if opts:
        for p, g in zip(gen.parameters(), g_grads):
            p.grad = g
        opts[0].step()
        opts[0].zero_grad(set_to_none=True)
    with torch.no_grad():
        est_audio = out["est_audio"].detach()
        clean_mag, est_mag = out["clean_mag"].detach(), out["est_mag"].detach()
    d_loss = discriminator_loss(disc, clean_mag, est_mag, clean, est_audio, recipe)
    d_names = [n for n, _ in disc.named_parameters()]
    d_grads = torch.autograd.grad(d_loss, list(disc.parameters()))
    if opts:
        for p, g in zip(disc.parameters(), d_grads):
            p.grad = g
        opts[1].step()
        opts[1].zero_grad(set_to_none=True)
    grads = {**{"gen." + n: g for n, g in zip(names, g_grads)},
             **{"disc." + n: g for n, g in zip(d_names, d_grads)}}
    return g_loss.detach(), d_loss.detach(), grads


def models(cfg: dict, gen_state: dict, disc_state: dict, device):
    gen, disc = TSCNet(cfg).to(device), Discriminator(cfg).to(device)
    gen.load_state_dict(gen_state, strict=True)
    disc.load_state_dict(disc_state, strict=True)
    return gen, disc


def run_steps(cfg: dict, recipe: dict, gen_state: dict, disc_state: dict, batches,
              dropout_seed: int, device) -> dict:
    """len(batches) steps from the given states: each step's losses, the
    first step's gradients by leaf, and every leaf after the last step."""
    device = torch.device(device)
    gen, disc = models(cfg, gen_state, disc_state, device)

    def adamw(module, lr):
        return torch.optim.AdamW(module.parameters(), lr=lr, betas=tuple(recipe["betas"]),
                                 eps=recipe["eps"], weight_decay=recipe["weight_decay"],
                                 foreach=False)

    opts = (adamw(gen, recipe["init_lr"]), adamw(disc, recipe["init_lr"] * recipe["disc_lr_mult"]))
    losses, first = [], None
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        if device.type == "cuda":
            torch.cuda.manual_seed(dropout_seed)
        else:
            torch.default_generator.manual_seed(dropout_seed)
        for clean, noisy in batches:
            g_loss, d_loss, grads = step(gen, disc, clean, noisy, cfg, recipe, opts)
            losses.append((float(g_loss), float(d_loss)))
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
    params = {**{"gen." + n: p.detach().clone() for n, p in gen.named_parameters()},
              **{"disc." + n: p.detach().clone() for n, p in disc.named_parameters()}}
    return {"losses": losses, "grad1": first, "params": params}
