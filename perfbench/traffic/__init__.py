"""Traffic drivers, one a kind of traffic, found by name: `perfbench.traffic.<kind>`.

Each module has
- setup(ctx) -> state: the program's objects, weights and inputs drawn from
  ctx.seed, every shape of the cell warmed;
- window(ctx, state, seconds) -> measured: `t0` (the host clock when the
  window opened), `window_s`, `units` (calls, steps or ticks completed),
  `unit` (what one unit computes, for the work counts) and its own keys;
- answers(ctx, state, measured): what the check needs, so that the
  program's state can be freed before the reference runs;
- check(ctx, answers) -> {name: {"value", "limit"}}: the comparison with
  the plain reference;
- end_to_end(ctx, measured) -> {metric: value}.
"""

from __future__ import annotations

import math
import time

import torch

from perfbench.trace import WINDOW, span


def timed_loop(device, seconds: float, unit, ahead: int = 2) -> dict:
    """Run unit(i) for i = 0, 1, ... until `seconds` have passed on the
    host clock. The host waits for the unit `ahead` back before it queues
    the next, so the window holds the work it times; the window closes
    when the last unit has finished on the card."""
    cuda = device.type == "cuda"
    queued = []
    if cuda:
        torch.cuda.synchronize(device)
    with span(WINDOW):
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            unit(n)
            n += 1
            if cuda:
                queued.append(torch.cuda.Event())
                queued[-1].record()
                if len(queued) > ahead:
                    with span("perfbench.wait"):
                        queued.pop(0).synchronize()
        with span("perfbench.sync"):
            if cuda:
                torch.cuda.synchronize(device)
        t1 = time.perf_counter()
    return {"t0": t0, "window_s": t1 - t0, "units": n}


def worst(values) -> float:
    """The largest of the values; inf when one is not finite."""
    values = [float(v) for v in values]
    return max(values) if all(math.isfinite(v) for v in values) else math.inf
