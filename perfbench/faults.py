"""Faults planted under the timed path, to see the check come out false:
each a context manager that patches the program under test while it is
open. The CPU tests plant every fault a cell can have
(perfbench/tests/test_perfbench_faults.py); `perfbench.calibrate --fault`
reads one on the card at a cell's own size."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def _patched(obj, name, make):
    original = getattr(obj, name)
    setattr(obj, name, make(original))
    try:
        yield
    finally:
        setattr(obj, name, original)


def enhance_answer_altered():
    """The last row of every enhancement call scaled by 1.001."""
    from cmgan_torch import inference

    def make(real):
        def call(model, dsp, x, *args, **kw):
            out = real(model, dsp, x, *args, **kw)
            return torch.cat([out[:-1], out[-1:] * 1.001])
        return call

    return _patched(inference, "enhance_tensor", make)


def enhance_half_batch():
    """Only the first half of a call's rows enhanced; the rest copies them."""
    from cmgan_torch import inference

    def make(real):
        def call(model, dsp, x, *args, **kw):
            half = real(model, dsp, x[: max(1, x.shape[0] // 2)], *args, **kw)
            return torch.cat([half] * -(-x.shape[0] // half.shape[0]))[: x.shape[0]]
        return call

    return _patched(inference, "enhance_tensor", make)


def train_state_unchanged():
    """Each training step runs, then puts every parameter back."""
    from cmgan_torch.train import Trainer

    def make(real):
        def step(self, clean, noisy, *args, **kw):
            params = [p for m in (self.state.gen, self.state.disc) for p in m.parameters()]
            kept = [p.detach().clone() for p in params]
            out = real(self, clean, noisy, *args, **kw)
            with torch.no_grad():
                for p, k in zip(params, kept):
                    p.copy_(k)
            return out
        return step

    return _patched(Trainer, "train_step", make)


def train_half_batch():
    """Each training step takes the first half of its rows, the means over them."""
    from cmgan_torch.train import Trainer

    def make(real):
        def step(self, clean, noisy, *args, **kw):
            half = max(1, clean.shape[0] // 2)
            return real(self, clean[:half], noisy[:half], *args, **kw)
        return step

    return _patched(Trainer, "train_step", make)


def stream_answer_altered():
    """The first slot's emitted samples scaled by 1.001 at every tick."""
    from cmgan_torch.streaming import StreamBatcher

    def make(real):
        def step(self, blocks):
            out = real(self, blocks)
            first = min(out)
            out[first] = out[first] * 1.001
            return out
        return step

    return _patched(StreamBatcher, "step", make)


def stream_half_batch():
    """Each tick enhances the first half of the slots' windows; the other
    slots get copies of those."""
    from cmgan_torch import streaming

    def make(real):
        def windows(model, dsp, device, w, c):
            half = max(1, w.shape[0] // 2)
            est = real(model, dsp, device, w[:half], c[:half])
            return np.concatenate([est] * -(-w.shape[0] // half))[: w.shape[0]]
        return windows

    return _patched(streaming, "_enhance_windows", make)


FAULTS = {
    "enhance": {"answer_altered": enhance_answer_altered, "half_batch": enhance_half_batch},
    "train": {"state_unchanged": train_state_unchanged, "half_batch": train_half_batch},
    "stream": {"answer_altered": stream_answer_altered, "half_batch": stream_half_batch},
}
