"""BENCHMARK.json and the files it names: every cell, configuration and
per-layer metric is found by name, and the file keeps to its contract."""

import json
import os
import re

import pytest

from perfbench import run

BENCH = run.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    with open(os.path.join(run.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_loads_with_its_config_driver_and_readers(entry):
    cell = run.load_cell(entry["name"], BENCH)
    assert cell.chips == 1 and len(entry["why"]) <= 200
    assert entry["config"] in {c["name"] for c in BENCH["configs"]}
    __import__(f"perfbench.traffic.{cell.kind}")
    assert "limits" in cell.params
    e2e = run.cell_metrics(BENCH, "end_to_end", entry["name"])
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = run.cell_metrics(BENCH, "per_layer", entry["name"])
    assert layer
    for m in layer:
        assert callable(run.reader(m["name"]))
        assert m["moves"] in {x["name"] for x in e2e}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    assert entry["file"].startswith("perfbench/configs/")
    with open(os.path.join(run.ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["num_channels"] == cfg["attn_heads"] * cfg["dim_head"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


def test_metrics_entries():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]} \
            if "workloads" in m else True
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s", "enhance_rtf",
                                                        "train_utt_per_s", "stream_tick_p95_ms"}
