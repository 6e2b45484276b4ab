"""The port's spans (`cmgan_torch.utils.span`), on the CPU: a shared no-op
while no profiler records; under one, records of name, host stamps on the
profiler's clock, parent and root, per thread; and the span tree that a
training step, a streaming tick and an enhancement call leave."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from cmgan_torch import inference
from cmgan_torch.config import CMGANConfig, ModelConfig, TrainConfig
from cmgan_torch.streaming import StreamBatcher
from cmgan_torch.train import Trainer
from cmgan_torch.utils import profiling, recorded, span, trace
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)

MODEL = dict(num_channels=16, num_tscb_blocks=2, dense_depth=2, attn_heads=2, ndf=4)
CUT, BATCH = 3200, 2

GEN = [("cmgan.model.encoder", [])] + [
    (f"cmgan.model.{part}_conformer", []) for _ in range(2) for part in ("time", "freq")] + [
    ("cmgan.model.mask_decoder", []), ("cmgan.model.complex_decoder", [])]


def _tree(spans):
    """The spans as (name, [children]) from each root, in entry order."""
    kids = {s.id: [] for s in spans}
    roots = []
    for s in spans:
        (kids[s.parent] if s.parent is not None else roots).append(s)

    def node(s):
        return (s.name, [node(k) for k in kids[s.id]])

    return [node(s) for s in roots]


def test_span_is_a_shared_noop_while_no_profiler_records(tmp_path):
    with trace(str(tmp_path)):
        pass
    before = len(recorded())
    assert span("cmgan.a") is span("cmgan.b")
    with span("cmgan.a"), span("cmgan.b"):
        torch.ones(4).sum()
    assert len(recorded()) == before == 0


def test_records_nest_per_thread_with_parent_and_root(tmp_path):
    def worker():
        with span("t.outer"):
            with span("t.inner"):
                torch.ones(8).sum()

    with trace(str(tmp_path)):
        with span("m.outer"):
            with span("m.mid"):
                with span("m.inner"):
                    thread = threading.Thread(target=worker)
                    thread.start()
                    thread.join(timeout=60)
            with span("m.second"):
                pass
    assert not thread.is_alive()
    by = {s.name: s for s in recorded()}
    assert set(by) == {"m.outer", "m.mid", "m.inner", "m.second", "t.outer", "t.inner"}
    m, t = by["m.outer"], by["t.outer"]
    assert m.parent is None and m.root == m.id and t.parent is None and t.root == t.id
    assert by["m.mid"].parent == m.id and by["m.second"].parent == m.id
    assert by["m.inner"].parent == by["m.mid"].id and by["t.inner"].parent == t.id
    assert {by[n].root for n in ("m.mid", "m.inner", "m.second")} == {m.id}
    assert by["t.inner"].root == t.id
    for s in by.values():
        assert s.start_ns <= s.end_ns and s.device_ms is None
        if s.parent is not None:
            p = next(x for x in by.values() if x.id == s.parent)
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert by["m.inner"].start_ns <= t.start_ns and t.end_ns <= by["m.inner"].end_ns


def test_host_stamps_agree_with_the_profilers_events(tmp_path):
    names = [f"cmgan.clock{i}" for i in range(5)]
    with trace(str(tmp_path)) as prof:
        for n in names:
            with span(n):
                torch.ones(256, 256) @ torch.ones(256, 256)
    ours = {s.name: s for s in recorded()}
    theirs = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name() in ours}
    assert set(theirs) == set(names)
    for n in names:
        e = theirs[n]
        assert abs(ours[n].start_ns - e.start_ns()) < 1_000_000
        assert abs(ours[n].end_ns - (e.start_ns() + e.duration_ns())) < 1_000_000


def test_an_overflowing_log_reads_none_until_the_next_trace(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "LOG_CAP", 3)
    monkeypatch.setattr(profiling, "_LOG", profiling._Log())
    with trace(str(tmp_path)):
        for _ in range(3):
            with span("cmgan.x"):
                pass
    assert len(recorded()) == 3
    with trace(str(tmp_path)):
        for _ in range(4):
            with span("cmgan.x"):
                pass
    assert recorded() is None
    with trace(str(tmp_path)):
        with span("cmgan.x"):
            pass
    assert len(recorded()) == 1


def _batch(seed):
    rng = np.random.default_rng(seed)
    clean = (0.1 * rng.standard_normal((BATCH, CUT))).astype(np.float32)
    return clean, clean + (0.03 * rng.standard_normal(clean.shape)).astype(np.float32)


@pytest.mark.parametrize("mode", ["device", "host", "host_async"])
def test_train_step_leaves_the_phase_tree(tmp_path, mode):
    """device: fused_step's G, labels and D; host: G, the scorer, d_step;
    host_async: G alone, then the previous batch's D inside the next step."""
    cfg = CMGANConfig(model=ModelConfig(**MODEL), train=dataclasses.replace(
        TrainConfig(), batch_size=BATCH, cut_len=CUT, pesq_label_mode=mode))
    trainer = Trainer(cfg, [None] * 4, None, device="cpu")
    steps = 2 if mode == "host_async" else 1
    with trace(str(tmp_path)):
        for i in range(steps):
            trainer.train_step(*_batch(i))
    g = ("cmgan.train.g", GEN)
    if mode == "host_async":
        want = [("cmgan.train.step", [g]), ("cmgan.train.step", [g, ("cmgan.train.d", [])])]
    else:
        want = [("cmgan.train.step", [g, ("cmgan.train.labels", []), ("cmgan.train.d", [])])]
    assert _tree(recorded()) == want
    trainer.drain_pending_d()


def test_stream_tick_and_enhance_call_leave_their_trees(tmp_path):
    cfg = CMGANConfig(model=ModelConfig(**MODEL))
    model = inference.load_generator(cfg, None, None, "cpu")
    batcher = StreamBatcher(cfg, model, num_slots=2, chunk=2000, left_context=6000,
                            lookahead=1000, device="cpu")
    slots = [batcher.open() for _ in range(2)]
    rng = np.random.default_rng(0)
    with trace(str(tmp_path)):
        batcher.step({s: (0.1 * rng.standard_normal(2000)).astype(np.float32) for s in slots})
    call = ("cmgan.enhance.call", GEN)
    assert _tree(recorded()) == [("cmgan.stream.tick", [
        ("cmgan.stream.prep", []), ("cmgan.stream.device", [call]), ("cmgan.stream.emit", [])])]
    with trace(str(tmp_path)), torch.inference_mode():
        inference.enhance_tensor(model, cfg.dsp, torch.zeros(2, 3200))
    assert _tree(recorded()) == [call]
