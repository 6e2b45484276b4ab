"""Offline enhancement: `inference.enhance_tensor` on batches of segments.

Parameters: `batch` rows of `seconds` each; a `pool` of distinct batches
drawn from the seed at set-up and cycled through the window; `check_calls`
calls of the window drawn from the seed, every row of which is compared
with the reference; `limits` of the check's numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import archs
from perfbench.trace import span
from perfbench.traffic import timed_loop, worst


def setup(ctx):
    from cmgan_torch import inference

    p, cfg = ctx.params, ctx.cfg
    arch = archs.load(cfg)
    pcfg = arch.port_config(cfg)
    # a template of names and shapes, built on the host: on the meta device
    # nn.Embedding's normal_ imports torch._dynamo, seconds of set-up
    shapes = arch.generator(cfg)
    weights = arch.seeded_state(shapes, ctx.derive(0), ctx.device)
    model = inference.load_generator(pcfg, weights, None, ctx.device)
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.derive(1))
    samples = int(p["seconds"] * cfg["sample_rate"])
    pool = 0.1 * torch.randn(p["pool"], p["batch"], samples, generator=gen, device=ctx.device)
    call = inference.enhance_tensor
    with torch.inference_mode():
        for i in range(2):
            call(model, pcfg.dsp, pool[i % p["pool"]])
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return {"model": model, "dsp": pcfg.dsp, "weights": weights, "pool": pool, "call": call}


def window(ctx, st, seconds):
    outs = []
    pool, model, dsp_cfg, call = st["pool"], st["model"], st["dsp"], st["call"]

    def unit(i):
        with span("perfbench.enhance_call"):
            outs.append(call(model, dsp_cfg, pool[i % len(pool)]))

    with torch.inference_mode():
        measured = timed_loop(ctx.device, seconds, unit)
    b, samples = pool.shape[1:]
    return {**measured, "outputs": outs,
            "unit": {"kind": "call", "batch": b, "samples": samples}}


def answers(ctx, st, measured):
    outs = measured.pop("outputs")
    rng = np.random.default_rng(ctx.derive(3))
    picks = sorted(rng.choice(len(outs), size=min(ctx.params["check_calls"], len(outs)),
                              replace=False).tolist())
    pool = st["pool"]
    return {"weights": st["weights"],
            "cases": [(pool[i % len(pool)], outs[i]) for i in picks]}


def check(ctx, ans):
    """Every row of the sampled calls against the reference: the widest
    relative L2 distance of a row."""
    limit = ctx.params["limits"]["worst_row_rel_l2"]
    arch = archs.load(ctx.cfg)
    ref = arch.generator(ctx.cfg).to(ctx.device).eval()
    ref.load_state_dict(ans["weights"], strict=True)
    rels = []
    with torch.no_grad():
        for x, y in ans["cases"]:
            r = arch.enhance(ref, x, ctx.cfg).double()
            if y.shape != r.shape:
                return {"worst_row_rel_l2": {"value": float("inf"), "limit": limit}}
            y = y.double()
            rel = torch.linalg.vector_norm(y - r, dim=-1) / torch.linalg.vector_norm(r, dim=-1)
            rels += rel.tolist()
    return {"worst_row_rel_l2": {"value": worst(rels), "limit": limit}}


def end_to_end(ctx, measured):
    audio_s = measured["unit"]["samples"] / ctx.cfg["sample_rate"] * measured["unit"]["batch"]
    return {"enhance_rtf": measured["units"] * audio_s / measured["window_s"]}
