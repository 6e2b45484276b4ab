"""GAN training on the published recipe: `Trainer.train_step`. CMGAN's
alone (its discriminator, losses and labels): set-up raises ValueError
for a configuration of another architecture.

Parameters: `batch` rows of `cut_len` samples; a `pool` of distinct
(clean, noisy) batches drawn from the seed at set-up, every row distinct,
cycled through the window; `label_mode` (the trainer's
pesq_label_mode); `epoch_steps`, the loader's length that the learning
rate's schedule reads; `checked_steps`, the steps set-up takes from the
seed, which the reference follows; `limits` of the check's numbers.

Set-up builds one Trainer, loads the benchmark's weights into its state,
seeds its dropout stream, and drives it through the checked steps with
the window's own call and feed; the same trainer then runs the window.
What the check compares is read from it on the way: each step's losses,
the first step's gradient from AdamW's first moment (1 - beta1 of it
after one step from zero), and the parameters after the last checked
step.
"""

from __future__ import annotations

import torch

from perfbench import archs
from perfbench.archs import cmgan
from perfbench.reference.model import Discriminator, TSCNet, seeded_state
from perfbench.reference.train import run_steps
from perfbench.trace import span
from perfbench.traffic import timed_loop, worst


def _leaves(state):
    return {**{"gen." + n: p for n, p in state.gen.named_parameters()},
            **{"disc." + n: p for n, p in state.disc.named_parameters()}}


def setup(ctx):
    archs.require(ctx.cfg, "cmgan", "the train kind")
    from cmgan_torch.train import Trainer

    p, cfg = ctx.params, ctx.cfg
    pcfg = cmgan.port_config(cfg, batch_size=p["batch"], cut_len=p["cut_len"],
                             pesq_label_mode=p["label_mode"], seed=ctx.derive(9) % 2 ** 31)
    # a template of names and shapes, built on the host: on the meta device
    # nn.Embedding's normal_ imports torch._dynamo, seconds of set-up
    gen_shapes, disc_shapes = TSCNet(cfg), Discriminator(cfg)
    gen_state = seeded_state(gen_shapes, ctx.derive(0), ctx.device)
    disc_state = seeded_state(disc_shapes, ctx.derive(1), ctx.device)
    dropout_seed = ctx.derive(2)
    trainer = Trainer(pcfg, [None] * p["epoch_steps"], None, device=ctx.device)
    trainer.state.gen.load_state_dict(gen_state, strict=True)
    trainer.state.disc.load_state_dict(disc_state, strict=True)
    trainer.state.rng_state = torch.Generator(device=ctx.device).manual_seed(
        dropout_seed).get_state()

    gen = torch.Generator(device=ctx.device).manual_seed(ctx.derive(3))
    shape = (p["pool"], p["batch"], p["cut_len"])
    clean = 0.1 * torch.randn(shape, generator=gen, device=ctx.device)
    noisy = clean + 0.03 * torch.randn(shape, generator=gen, device=ctx.device)

    step = trainer.train_step
    beta1 = cfg["recipe"]["betas"][0]
    losses, grad1 = [], None
    for i in range(p["checked_steps"]):
        losses.append([t.detach().clone() for t in step(clean[i], noisy[i])])
        if i == 0:
            opt = {**{"gen." + n: trainer.state.gen_opt for n, _ in
                      trainer.state.gen.named_parameters()},
                   **{"disc." + n: trainer.state.disc_opt for n, _ in
                      trainer.state.disc.named_parameters()}}
            grad1 = {n: opt[n].state[t]["exp_avg"].detach().clone() / (1.0 - beta1)
                     for n, t in _leaves(trainer.state).items() if opt[n].state.get(t)}
    after = {n: t.detach().clone() for n, t in _leaves(trainer.state).items()}
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return {"trainer": trainer, "step": step, "clean": clean, "noisy": noisy,
            "gen_state": gen_state, "disc_state": disc_state, "dropout_seed": dropout_seed,
            "losses": losses, "grad1": grad1, "after": after}


def window(ctx, st, seconds):
    clean, noisy, step = st["clean"], st["noisy"], st["step"]
    first = ctx.params["checked_steps"]

    def unit(i):
        j = (first + i) % len(clean)
        with span("perfbench.train_step"):
            step(clean[j], noisy[j])

    measured = timed_loop(ctx.device, seconds, unit)
    return {**measured, "unit": {"kind": "train", "batch": clean.shape[1],
                                 "samples": clean.shape[2]}}


def answers(ctx, st, measured):
    n = ctx.params["checked_steps"]
    return {k: st[k] for k in ("gen_state", "disc_state", "dropout_seed", "grad1", "after")} | {
        "losses": [[float(t) for t in pair] for pair in st["losses"]],
        "batches": [(st["clean"][i].clone(), st["noisy"][i].clone()) for i in range(n)]}


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def check(ctx, ans):
    """The reference's steps from the same weights, inputs and dropout
    stream. Readings: the relative gap of each step's generator and
    discriminator loss (the widest, and the first step's); a leaf's gap
    between the program's and the reference's norm of the first step's
    gradient (the worst leaf's and the median leaf's); the same of the
    parameters' change over the checked steps, leaving out leaves whose
    reference gradient is under a thousandth of the median leaf's (they
    move by round-off alone). A leaf's gap is measured against the larger
    of its reference norm and the median leaf's. The readings with a limit
    in `limits` are compared; the others are reported."""
    limits = ctx.params["limits"]
    ref = run_steps(ctx.cfg, ctx.cfg["recipe"], ans["gen_state"], ans["disc_state"],
                    ans["batches"], ans["dropout_seed"], ctx.device)
    gaps = [abs(a - b) / abs(b) for pa, pr in zip(ans["losses"], ref["losses"])
            for a, b in zip(pa, pr)]
    g_ref = _norms(ref["grad1"])
    g_med = _median(g_ref.values())
    g_prog = _norms({k: ans["grad1"].get(k, torch.zeros(())) for k in g_ref})
    g_gaps = [abs(g_prog[k] - g_ref[k]) / max(g_ref[k], g_med) for k in g_ref]
    start = {**{"gen." + k: v for k, v in ans["gen_state"].items()},
             **{"disc." + k: v for k, v in ans["disc_state"].items()}}
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    d_ref = _norms({k: ref["params"][k] - start[k] for k in moved})
    d_prog = _norms({k: ans["after"][k] - start[k] for k in moved})
    d_med = _median(d_ref.values())
    d_gaps = [abs(d_prog[k] - d_ref[k]) / max(d_ref[k], d_med) for k in moved]
    readings = {"loss_rel": worst(gaps), "loss_rel_step1": worst(gaps[:2]),
                "grad_norm_gap": worst(g_gaps), "grad_norm_gap_median": _median(g_gaps),
                "change_norm_gap": worst(d_gaps), "change_norm_gap_median": _median(d_gaps)}
    return {k: {"value": v, "limit": limits.get(k)} for k, v in readings.items()}


def _median(values):
    values = sorted(values)
    return values[len(values) // 2]


def end_to_end(ctx, measured):
    return {"train_utt_per_s": measured["units"] * measured["unit"]["batch"]
            / measured["window_s"]}
