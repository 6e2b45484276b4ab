"""The `semamba` architecture's pieces of the harness: its size checks, the
scan's work by formula against a hand count, the scans of a call, the
roofline reader's refusals, the span readers of the cell on hand-made
spans, and the reference's work count on the meta device (no attention
recorded)."""

import types

import pytest

from perfbench import archs, run, spans, work
from perfbench.archs import semamba

CELL = "sem16k_eval_16s_b8_fp32"


def _cfg():
    return run.load_json(run.HERE, "configs", "semamba_16k.json")


def test_check_rejects_mismatched_sizes():
    cfg = _cfg()
    semamba.check(cfg)
    assert archs.load(cfg) is semamba
    with pytest.raises(ValueError, match="d_inner"):
        semamba.check({**cfg, "d_inner": 128})
    with pytest.raises(ValueError, match="d_inner"):
        semamba.port_config({**cfg, "expand": 2})
    with pytest.raises(ValueError, match="n_fft"):
        semamba.check({**cfg, "freq_bins": 200})
    with pytest.raises(ValueError, match="n_fft"):
        semamba.check({**cfg, "win_size": 320})


def test_port_config_is_the_published_model():
    pcfg = semamba.port_config(_cfg())
    assert pcfg.dsp.window == "hann" and pcfg.dsp.compress_exponent == 0.3
    m = pcfg.model
    assert (m.hid_feature, m.d_inner, m.d_state, m.rank, m.num_tfmamba, m.beta) == \
        (64, 256, 16, 4, 4, 2.0)


def test_scan_work_by_hand():
    # 2 rows of 3 steps, d_inner 4, d_state 2, float32: 6 tokens of u, delta,
    # z and y (4 each) and B, C (2 each); A (4 x 2), D and the bias (4 each)
    w = semamba.scan_work(2, 3, 4, 2, 4)
    assert w["bytes"] == 4 * (6 * (16 + 4) + 4 * (2 + 2)) == 544
    assert w["flop"] == 6 * 4 * (6 * 2 + 8) == 480


def test_a_calls_scans():
    cfg = _cfg()
    calls = semamba.scan_calls(cfg, 8, 256000)
    assert len(calls) == 16
    assert calls.count((800, 2561)) == 8 and calls.count((20488, 100)) == 8
    w = semamba.scan_work(800, 2561, 256, 16, 4)
    assert 4.2e3 < w["bytes"] / (800 * 2561) < 4.3e3  # about 4.2 kB a step
    bound = semamba.scan_bound_seconds(cfg, 8, 256000)
    assert bound == pytest.approx(16 * w["bytes"] / work.H100_PEAK_BYTES, rel=1e-3)


def test_call_flops_at_the_cpu_sizes_records_no_attention():
    cfg = _cfg()
    sizes = run.load_json(run.HERE, "workloads", f"{CELL}.json")["cpu"]
    count = work.call_flops(cfg, sizes["batch"], int(sizes["seconds"] * cfg["sample_rate"]))
    assert count.attention == [] and count.max_pos is None
    assert count.flop == 49954420452


def _reading(counters, units=4, trace=True):
    cell = types.SimpleNamespace(cfg=_cfg(), params={})
    tr = types.SimpleNamespace(op_seconds=lambda match: 0.2 if match(
        "(anonymous namespace)::selective_scan_fwd((anonymous namespace)::ScanArgs)") else 0.0)
    measured = {"units": units, "window_s": 2.0,
                "unit": {"kind": "call", "batch": 8, "samples": 256000}}
    return types.SimpleNamespace(cell=cell, measured=measured, counters=counters,
                                 trace=tr if trace else None)


def test_scan_roofline_reads_only_whole_calls():
    read = run.reader("scan_roofline.enhance")
    assert read(_reading({})) is None
    assert read(_reading({"scan": 0})) is None
    assert read(_reading({"scan": 63})) is None
    assert read(_reading({"scan": 64}, trace=False)) is None
    bound = semamba.scan_bound_seconds(_cfg(), 8, 256000)
    assert read(_reading({"scan": 64})) == pytest.approx(100.0 * 4 * bound / 0.2)


def _call_spans(phase_decoder=True):
    """Three calls' spans as SEMamba's program logs them (device ms each);
    a call of CMGAN's in the middle, which has no phase decoder."""
    out, ids = [], iter(range(1000))
    for k, dev in enumerate((10.0, 20.0, 30.0)):
        rid, t0 = next(ids), int((10 + k) * 1e9)
        out.append(types.SimpleNamespace(id=rid, root=rid, name="cmgan.enhance.call",
                                         start_ns=t0, end_ns=t0 + int(5e8), device_ms=500.0))
        names = ["cmgan.model.encoder"] + ["cmgan.model.time_mamba", "cmgan.model.freq_mamba"] * 4
        names += ["cmgan.model.mask_decoder", "cmgan.model.phase_decoder"]
        if k == 1:
            names = [n for n in names if "mamba" not in n and "phase" not in n]
            names.append("cmgan.model.complex_decoder")
        for n in names:
            out.append(types.SimpleNamespace(id=next(ids), root=rid, name=n, start_ns=t0,
                                             end_ns=t0 + 1, device_ms=dev))
    return out


@pytest.mark.parametrize("metric,want", [("time_mamba_ms.enhance", 4 * 20.0),
                                         ("freq_mamba_ms.enhance", 4 * 20.0),
                                         ("semamba_codec_ms.enhance", 3 * 20.0)])
def test_span_readers_read_semambas_calls(monkeypatch, metric, want):
    """The medians over SEMamba's calls of their spans' device extents; a
    call without the spans (CMGAN's) is left out, and a run without a trace
    or a span log reads None."""
    monkeypatch.setattr(spans, "program_spans", _call_spans)
    tr = types.SimpleNamespace(window=(9.0, 20.0))
    read = run.reader(metric)
    assert read(types.SimpleNamespace(trace=tr)) == pytest.approx(want)
    assert read(types.SimpleNamespace(trace=None)) is None
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    assert read(types.SimpleNamespace(trace=tr)) is None
