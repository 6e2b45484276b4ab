"""BENCHMARK.json and the files it names: every cell, configuration,
architecture and per-layer metric is found by name, and the file keeps
to its contract. A configuration of an architecture that the benchmark
does not have yet needs only new files: a stand-in, planted as a module
of perfbench/archs/, passes the same contract and gets its work
counted."""

import json
import os
import re
import sys
import types

import pytest
import torch
import torch.nn as nn

from perfbench import archs, run, work
from perfbench.archs import cmgan
from perfbench.reference import dsp

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
    spec = run.load_json(run.HERE, "workloads", f"{entry['name']}.json")
    assert set(spec) == {"kind", "params", "cpu"} and set(spec["cpu"]) <= set(spec["params"])
    e2e = run.cell_metrics(BENCH, "end_to_end", entry["name"])
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = run.cell_metrics(BENCH, "per_layer", entry["name"])
    assert layer
    for m in layer:
        assert callable(run.reader(m["name"]))
        assert m["moves"] in {x["name"] for x in e2e}


def config_contract(entry: dict, cfg: dict):
    """A configuration file against its BENCHMARK.json entry: the same
    name, source and cuts, and an `arch` whose module has every function
    of perfbench/archs/ and accepts the file's sizes."""
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] and all(NAME.match(k) for k in cfg["reduced"])
    arch = archs.load(cfg)
    assert all(callable(getattr(arch, f, None)) for f in archs.FUNCTIONS)
    arch.check(cfg)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    assert entry["file"].startswith("perfbench/configs/")
    with open(os.path.join(run.ROOT, entry["file"])) as f:
        cfg = json.load(f)
    config_contract(entry, cfg)
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


def test_cmgan_check_takes_the_heads_equation():
    cfg = run.load_json(run.HERE, "configs", "cmgan_16k.json")
    cmgan.check(cfg)
    with pytest.raises(ValueError, match="heads"):
        cmgan.check({**cfg, "num_channels": 64, "attn_heads": 3})
    with pytest.raises(ValueError, match="heads"):
        cmgan.port_config({**cfg, "num_channels": 64, "attn_heads": 3})


class _OneByOne(nn.Module):
    """compressed spec [B, T, F, 2] -> (re, im): 1x1 convolutions."""

    def __init__(self, cfg):
        super().__init__()
        c = cfg["channels"]
        self.net = nn.Sequential(nn.Conv2d(2, c, 1), nn.PReLU(c), nn.Conv2d(c, c, 1),
                                 nn.PReLU(c), nn.Conv2d(c, 2, 1))

    def forward(self, spec):
        out = self.net(spec.permute(0, 3, 1, 2))
        return out[:, 0], out[:, 1]


def _standin_module(name: str):
    def check(cfg):
        if cfg["channels"] < 1:
            raise ValueError("channels must be positive")

    def seeded_state(module, seed, device):
        gen = torch.Generator(device=device).manual_seed(seed)
        return {k: torch.rand(v.shape, generator=gen, device=device)
                for k, v in module.state_dict().items()}

    module = types.ModuleType(f"perfbench.archs.{name}")
    module.__dict__.update(
        check=check, port_config=lambda cfg, **train: dict(cfg, **train),
        generator=_OneByOne, seeded_state=seeded_state, enhance=dsp.enhance,
        reset_launches=lambda: None, launches=dict)
    return module


def test_a_standin_architecture_needs_only_new_files(monkeypatch, tmp_path):
    name = "standin_1x1"
    monkeypatch.setitem(sys.modules, f"perfbench.archs.{name}", _standin_module(name))
    entry = {"name": "standin_16k", "source": "https://example.org/standin", "reduced": []}
    path = tmp_path / "standin_16k.json"
    path.write_text(json.dumps({**entry, "arch": name, "dtype": "float32",
                                "sample_rate": 16000, "n_fft": 400, "hop": 100,
                                "compress_exponent": 0.3, "channels": 8}))
    cfg = json.loads(path.read_text())
    assert not {"attn_heads", "dim_head", "max_rel_pos"} & set(cfg)
    config_contract(entry, cfg)
    with pytest.raises(ValueError):
        archs.load(cfg).check({**cfg, "channels": 0})
    count = work.call_flops(cfg, 2, 1600)
    frames, bins, c = 1600 // 100 + 1, 400 // 2 + 1, 8
    assert count.flop == 2 * 2 * frames * bins * (2 * c + c * c + c * 2)
    assert count.attention == [] and count.max_pos is None


def test_the_train_kind_is_cmgans_alone():
    from perfbench.traffic import train

    spec = run.load_json(run.HERE, "workloads", "c16k_train_2s_b4_fp32.json")
    cfg = {**run.load_json(run.HERE, "configs", "cmgan_16k.json"), "arch": "standin_1x1"}
    ctx = run.Ctx(run.Cell("standin_train", 1, "train", cfg, spec["params"]), 5,
                  torch.device("cpu"))
    with pytest.raises(ValueError, match="cmgan"):
        train.setup(ctx)
    with pytest.raises(ValueError, match="cmgan"):
        work.train_step_flops(cfg, cfg["recipe"], 1, 1600)


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
