"""Streaming enhancement as a loaded server runs it: `StreamBatcher.step`
with every slot open, in a closed loop of back-to-back ticks.

Parameters: `slots` streams; the window layout (`chunk`, `left_context`,
`lookahead`, `rms_decay`; the emission is the server's weighted
overlap-add); a `pool` of distinct chunks a stream,
drawn from the seed at set-up (host memory, as a server receives them)
and fed in turn; `warm_ticks` ticks of set-up; `check_per_slot` ticks of
each stream drawn from the seed, whose emitted samples are compared with
the reference; `limits` of the check's numbers.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import archs
from perfbench.reference import stream as ref_stream
from perfbench.trace import WINDOW, span
from perfbench.traffic import worst


def setup(ctx):
    from cmgan_torch import inference, streaming

    p, cfg = ctx.params, ctx.cfg
    arch = archs.load(cfg)
    pcfg = arch.port_config(cfg)
    # a template of names and shapes, built on the host: on the meta device
    # nn.Embedding's normal_ imports torch._dynamo, seconds of set-up
    shapes = arch.generator(cfg)
    weights = arch.seeded_state(shapes, ctx.derive(0), ctx.device)
    model = inference.load_generator(pcfg, weights, None, ctx.device)
    batcher = streaming.StreamBatcher(
        pcfg, model, num_slots=p["slots"], chunk=p["chunk"], left_context=p["left_context"],
        lookahead=p["lookahead"], rms_decay=p["rms_decay"], emit="wola", device=ctx.device)
    slots = [batcher.open() for _ in range(p["slots"])]
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.derive(1))
    pool = (0.1 * torch.randn(p["slots"], p["pool"], p["chunk"], generator=gen,
                              device=ctx.device)).cpu().numpy()
    st = {"weights": weights, "batcher": batcher, "slots": slots, "pool": pool, "outputs": []}
    for _ in range(p["warm_ticks"]):
        _tick(st)
    return st


def _tick(st):
    k = len(st["outputs"])
    pool = st["pool"]
    out = st["batcher"].step({s: pool[i, k % pool.shape[1]] for i, s in enumerate(st["slots"])})
    st["outputs"].append([out[s] for s in st["slots"]])


def window(ctx, st, seconds):
    ticks = []
    with span(WINDOW):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with span("perfbench.tick"):
                a = time.perf_counter()
                _tick(st)
                ticks.append(time.perf_counter() - a)
        t1 = time.perf_counter()
    p = ctx.params
    return {"t0": t0, "window_s": t1 - t0, "units": len(ticks), "tick_s": ticks,
            "unit": {"kind": "call", "batch": p["slots"],
                     "samples": p["left_context"] + p["chunk"] + p["lookahead"]}}


def answers(ctx, st, measured):
    total = len(st["outputs"])
    rng = np.random.default_rng(ctx.derive(3))
    samples = [(i, int(k)) for i in range(ctx.params["slots"])
               for k in rng.choice(np.arange(1, total), ctx.params["check_per_slot"],
                                   replace=False)]
    return {"weights": st["weights"], "pool": st["pool"],
            "samples": samples, "emitted": [st["outputs"][k][i] for i, k in samples]}


def check(ctx, ans):
    """The sampled ticks' emitted samples against the reference's stream
    of the same chunks: the widest relative L2 distance of one."""
    p = ctx.params
    arch = archs.load(ctx.cfg)
    ref = arch.generator(ctx.cfg).to(ctx.device).eval()
    ref.load_state_dict(ans["weights"], strict=True)
    pool = ans["pool"]

    def feeds(stream, ticks):
        return pool[stream, np.arange(ticks) % pool.shape[1]]

    expected = ref_stream.emitted(ref, arch.enhance, {**ctx.cfg, **p}, feeds, ans["samples"],
                                  ctx.device)
    rels = [np.linalg.norm(np.asarray(y, np.float64) - r) / np.linalg.norm(r)
            if np.shape(y) == r.shape else np.inf for y, r in zip(ans["emitted"], expected)]
    return {"worst_chunk_rel_l2": {"value": worst(rels),
                                   "limit": p["limits"]["worst_chunk_rel_l2"]}}


def end_to_end(ctx, measured):
    return {"stream_tick_p95_ms": 1e3 * float(np.percentile(measured["tick_s"], 95))}
