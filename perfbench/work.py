"""The frozen yardstick of work: operations and bytes counted from shapes,
never from the program under test.

- `attention_work`: what the relative-position attention needs on given
  shapes, counted by its algorithm, the same for any implementation of
  it (dense, fused kernel or a library's).
- `call_flops`, `train_step_flops`: a whole call's or training step's
  floating-point operations, counted once on the meta device by running
  the benchmark's plain reference under `torch.utils.flop_counter`
  (convolutions and matrix products, forward and backward), with every
  attention core the reference records (perfbench/reference/attention.py)
  counted by `attention_work` in place of the ops that compute it. FFTs
  and elementwise work are not counted, so a share of a peak read from
  these counts is a lower bound. `call_flops` runs the configuration's
  architecture (perfbench/archs/); `train_step_flops` is CMGAN's recipe.

Published peaks of one NVIDIA H100 SXM (the data sheet's dense rates):
989 TFLOP/s in bf16, which bounds every precision, and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import archs

H100_PEAK_FLOPS = 989e12
H100_PEAK_BYTES = 3.35e12


def attention_work(g: int, tq: int, tk: int, t_valid: int, q_offset: int, max_pos: int,
                   d: int, elem_bytes: int, backward: bool = False) -> dict:
    """The work the attention function (or its gradient) needs on these
    shapes.

    - flop: 2*d a product of a query-key pair. A pair whose distance is
      clipped (|i - j| >= max_pos) needs no position product: its position
      logit, and its share of dq and of the table's gradient, come from one
      scalar a query and table end. So the forward takes 3 products a near
      pair (content logit, position logit, P.V) and 2 a clipped one; the
      backward 8 and 5 (content logit, dp, dv, dk, dq).
    - bytes: every input read once and every output written once: q, k, v,
      the table and the output in the forward (elements of `elem_bytes`);
      the backward adds the output's gradient, dq, dk, dv, and the float32
      table gradient and row log-sum-exp.
    - exps: one exponential a query-key pair.
    """
    near = sum(max(0, min(t_valid - 1, p + max_pos - 1) - max(0, p - max_pos + 1) + 1)
               for p in range(q_offset, q_offset + tq))
    far = tq * t_valid - near
    rows = 2 * max_pos + 1
    if backward:
        flop = 2 * d * g * (8 * near + 5 * far)
        nbytes = elem_bytes * d * (4 * g * tq + 4 * g * tk + rows) + 4 * (rows * d + g * tq)
    else:
        flop = 2 * d * g * (3 * near + 2 * far)
        nbytes = elem_bytes * d * (2 * g * tq + 2 * g * tk + rows)
    return {"flop": flop, "bytes": nbytes, "exps": g * tq * t_valid, "near": near, "far": far}


def roofline_seconds(work: dict) -> float:
    """The least time one H100 could take for `work`: its operations at
    the bf16 peak or its bytes at the HBM peak, whichever is longer."""
    return max(work["flop"] / H100_PEAK_FLOPS, work["bytes"] / H100_PEAK_BYTES)


class _Count:
    """FLOPs of a reference run on the meta device, with the attention
    cores' calls recorded as (g, t, d, backward); `max_pos` is the
    configuration's `max_rel_pos` where one was recorded, else None."""

    def __init__(self):
        self.max_pos = None
        self.attention = []
        self.flop = 0

    def __call__(self, g, t, d, backward):
        self.attention.append((g, t, d, backward))

    def attention_flop(self) -> int:
        total = 0
        for g, t, d, backward in self.attention:
            total += attention_work(g, t, t, t, 0, self.max_pos, d, 4)["flop"]
            if backward:
                total += attention_work(g, t, t, t, 0, self.max_pos, d, 4, backward=True)["flop"]
        return total


def _counted(cfg: dict, fn) -> _Count:
    from perfbench.reference.attention import count_attention

    count = _Count()
    counter = FlopCounterMode(display=False)
    with count_attention(count), counter:
        fn()
    if count.attention:
        count.max_pos = cfg["max_rel_pos"]
    count.flop = counter.get_total_flops() + count.attention_flop()
    return count


def call_flops(cfg: dict, batch: int, samples: int) -> _Count:
    """One enhancement call on [batch, samples] (eval mode) through the
    configuration's architecture."""
    arch = archs.load(cfg)
    meta = torch.device("meta")
    with meta:
        model = arch.generator(cfg).eval()
    x = torch.empty(batch, samples, device=meta)

    def run():
        with torch.no_grad():
            arch.enhance(model, x, cfg)

    return _counted(cfg, run)


def train_step_flops(cfg: dict, recipe: dict, batch: int, samples: int) -> _Count:
    """One training step on [batch, samples] pairs: the generator's forward
    and backward, the labels, the discriminator's forward and backward.
    CMGAN's recipe alone: raises ValueError for another architecture."""
    from perfbench.reference.model import Discriminator, TSCNet
    from perfbench.reference.train import step

    archs.require(cfg, "cmgan", "the training step's count")
    meta = torch.device("meta")
    with meta:
        gen, disc = TSCNet(cfg), Discriminator(cfg)
    clean = torch.empty(batch, samples, device=meta)
    return _counted(cfg, lambda: step(gen, disc, clean, clean, cfg, recipe))
