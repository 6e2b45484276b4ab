"""The readers of the program's spans (perfbench/spans.py and the metrics
that read it) on hand-made spans and device operations, and, on the card,
the spans against the profiler's own timeline."""

import dataclasses

import pytest
import torch

from perfbench import run, spans
from perfbench.trace import WINDOW, Trace

S = 1_000_000_000  # ns a second


@dataclasses.dataclass
class Rec:
    """A span as the program's log gives it."""
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    root: int
    device_ms: float | None = None


def _spans(root_name, units):
    """units: [(start_s, end_s, [(name, start_s, end_s, device_ms), ...])]"""
    out, ids = [], iter(range(10_000))
    for start, end, parts in units:
        rid = next(ids)
        out.append(Rec(rid, root_name, int(start * S), int(end * S), None, rid,
                       1e3 * (end - start)))
        for name, a, b, dev in parts:
            out.append(Rec(next(ids), name, int(a * S), int(b * S), rid, rid, dev))
    return out


def _reading(ops, window=(10.0, 20.0)):
    return run.Reading(cell=None, measured={}, counters={},
                       trace=Trace(ops, [(*window, WINDOW)]))


def _read(metric, reading):
    return run.reader(metric)(reading)


STEPS = _spans("cmgan.train.step", [
    (9.0, 10.9, [("cmgan.train.g", 9.0, 10.0, 99.0)]),             # opens before the window
    (11.0, 13.0, [("cmgan.train.g", 11.0, 12.0, 30.0), ("cmgan.train.labels", 12.0, 12.4, 5.0),
                  ("cmgan.train.d", 12.4, 12.9, 10.0)]),
    (13.0, 14.8, [("cmgan.train.g", 13.0, 14.0, 50.0), ("cmgan.train.labels", 14.0, 14.3, 7.0),
                  ("cmgan.train.d", 14.3, 14.7, 12.0)]),
])
# gaps: [10, 11.5) before the steps' phases (outside), [11.8, 12.0) in g, [12.1, 12.2) in
# labels, [12.6, 12.8) in d, [12.95, 13.1) at the step's end (outside), then g, [14.9, 20)
TRAIN_OPS = [(11.5, 11.8, "k"), (12.0, 12.1, "k"), (12.2, 12.6, "k"), (12.8, 12.95, "k"),
             (13.1, 13.5, "k"), (13.6, 14.9, "k")]


def test_train_readers(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: STEPS)
    r = _reading(TRAIN_OPS)
    assert _read("g_ms.train", r) == pytest.approx(40.0)
    assert _read("labels_ms.train", r) == pytest.approx(6.0)
    assert _read("d_ms.train", r) == pytest.approx(11.0)
    assert _read("host_step_ms.train", r) == pytest.approx(1900.0)
    # g: 0.2 + 0.1 (13.5 to 13.6); labels and d: 0.1 + 0.2; the window is 10 s
    assert _read("idle_g_share.train", r) == pytest.approx(100 * 0.3 / 10)
    assert _read("idle_d_share.train", r) == pytest.approx(100 * 0.3 / 10)


TICKS = _spans("cmgan.stream.tick", [
    (10.0 + k, 10.5 + k, [("cmgan.stream.prep", 10.0 + k, 10.1 + k, None),
                          ("cmgan.stream.device", 10.1 + k, 10.4 + k, 290.0 + k),
                          ("cmgan.stream.emit", 10.4 + k, 10.45 + k + 0.01 * k, None)])
    for k in range(3)])


def test_stream_readers(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: TICKS)
    r = _reading([(10.1, 10.4, "k")])
    assert _read("tick_host_ms.stream", r) == pytest.approx(160.0)   # 150, 160, 170
    assert _read("tick_device_ms.stream", r) == pytest.approx(291.0)


CALLS = _spans("cmgan.enhance.call", [
    (10.0 + k, 10.9 + k, [("cmgan.model.encoder", 10.0 + k, 10.1 + k, 100.0),
                          ("cmgan.model.time_conformer", 10.1 + k, 10.2 + k, 80.0 + k),
                          ("cmgan.model.freq_conformer", 10.2 + k, 10.3 + k, 60.0),
                          ("cmgan.model.time_conformer", 10.3 + k, 10.4 + k, 80.0),
                          ("cmgan.model.freq_conformer", 10.4 + k, 10.5 + k, 60.0),
                          ("cmgan.model.mask_decoder", 10.5 + k, 10.6 + k, 40.0),
                          ("cmgan.model.complex_decoder", 10.6 + k, 10.7 + k, 45.0)])
    for k in (0, 2, 4)])


def test_enhance_readers(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: CALLS)
    r = _reading([(10.0, 11.0, "k")])
    assert _read("time_conformer_ms.enhance", r) == pytest.approx(162.0)
    assert _read("freq_conformer_ms.enhance", r) == pytest.approx(120.0)
    assert _read("codec_ms.enhance", r) == pytest.approx(185.0)
    assert _read("tick_device_ms.stream", r) is None      # no tick in this window


NEW = ["g_ms.train", "labels_ms.train", "d_ms.train", "host_step_ms.train",
       "idle_g_share.train", "idle_d_share.train", "tick_host_ms.stream",
       "tick_device_ms.stream", "time_conformer_ms.enhance", "freq_conformer_ms.enhance",
       "codec_ms.enhance"]


@pytest.mark.parametrize("metric", NEW)
def test_readers_read_none_without_spans(monkeypatch, metric):
    """Untraced, on a program that keeps no span log, or whose log overflowed."""
    everything = STEPS + TICKS + CALLS
    monkeypatch.setattr(spans, "program_spans", lambda: everything)
    assert _read(metric, run.Reading(None, {}, {}, None)) is None
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    assert _read(metric, _reading(TRAIN_OPS)) is None


@pytest.mark.parametrize("metric", NEW)
def test_readers_read_none_without_a_device(monkeypatch, metric):
    """On the CPU a span has no device extent and the trace no device
    operation; the host's time is then the work itself, not its part beside
    the card."""
    cpu = [dataclasses.replace(s, device_ms=None) for s in STEPS + TICKS + CALLS]
    monkeypatch.setattr(spans, "program_spans", lambda: cpu)
    assert _read(metric, _reading([])) is None


def test_a_program_without_the_span_log_gives_none(monkeypatch):
    import cmgan_torch.utils

    monkeypatch.delattr(cmgan_torch.utils, "recorded")
    assert spans.program_spans() is None


@pytest.mark.card
def test_spans_bracket_their_kernels_on_the_profilers_clock(card):
    """A span around a launched kernel and a sync brackets the kernel's
    interval in the trace; no span of the program shows among the trace's
    device operations; the spans' device extents are read."""
    from cmgan_torch import inference
    from cmgan_torch.config import CMGANConfig, ModelConfig
    from cmgan_torch.utils import recorded
    from cmgan_torch.utils import span as program_span

    from perfbench.trace import profiled
    from perfbench.trace import span as bench_span

    gen = torch.Generator(card).manual_seed(0)
    x = torch.randn(4096, 4096, device=card, generator=gen)
    audio = 0.1 * torch.randn(2, 32000, device=card, generator=gen)
    cfg = CMGANConfig(model=ModelConfig(num_channels=16, num_tscb_blocks=2, dense_depth=2,
                                        attn_heads=1))
    model = inference.load_generator(cfg, None, None, card)
    with torch.inference_mode():
        inference.enhance_tensor(model, cfg.dsp, audio)
        torch.cuda.synchronize()
        with profiled() as prof:
            with bench_span(WINDOW):
                with program_span("cmgan.test.matmul"):
                    x @ x
                    torch.cuda.synchronize()
                with program_span("cmgan.test.calls"):
                    for _ in range(2):
                        inference.enhance_tensor(model, cfg.dsp, audio)
                    torch.cuda.synchronize()
    tr = Trace.from_profile(prof)
    log = recorded()
    mm = [s for s in log if s.name == "cmgan.test.matmul"][-1]
    lo, hi = mm.start_ns * 1e-9, mm.end_ns * 1e-9
    inside = [(s, e) for s, e, _ in tr.ops if lo <= s and e <= hi]
    assert inside and not [1 for s, e, _ in tr.ops if s < hi and e > lo and (s, e) not in inside]
    assert mm.device_ms >= 1e3 * max(e - s for s, e in inside)
    assert not [n for _, _, n in tr.ops if n.startswith("cmgan.")]
    calls = [s for s in log if s.name == "cmgan.test.calls"][-1]
    stages = [s for s in log if s.root == calls.root and s.name.startswith("cmgan.model.")]
    assert len(stages) == 2 * 7 and all(s.device_ms and s.device_ms > 0 for s in stages)
