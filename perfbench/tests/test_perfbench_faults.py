"""Runs of every cell of BENCHMARK.json on the CPU at the small sizes of
its workload file's `cpu` key, through the program's plain paths: a
sound run comes out correct, and every fault that a cell can have,
planted under the timed path, comes out not correct (on the first cell
of each pair of configuration and traffic kind). The process imports
nothing of JAX or of the JAX package."""

import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench import faults, run

SEED = 2 ** 31 + 4099  # past 32 signed bits, as a run's --seed may be
BENCH = run.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def cpu_sizes(cell: str) -> dict:
    """The cell's parameters for a CPU run (its workload file's `cpu`)."""
    return run.load_json(run.HERE, "workloads", f"{cell}.json")["cpu"]


def fault_cases() -> list:
    """(cell, fault) for every fault of the kind of the first cell of each
    pair of configuration and kind."""
    firsts = {}
    for w in BENCH["workloads"]:
        firsts.setdefault((w["config"], run.load_cell(w["name"], BENCH).kind), w["name"])
    return [(cell, fault) for (_, kind), cell in firsts.items()
            for fault in sorted(faults.FAULTS[kind])]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def small_run(cell, trace=False, seconds=0.2):
    return run.run_cell(cell, SEED, seconds, trace, device="cpu", overrides=cpu_sizes(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = small_run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in run.cell_metrics(BENCH, "end_to_end",
                                                                      cell)}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell,read", [
    ("c16k_eval_16s_b8_fp32", {"mfu.enhance"}),
    ("c16k_stream_8slot_fp32", {"mfu.stream", "tick_p50_ms.stream"})])
def test_traced_run_reads_its_metrics(cell, read):
    r = small_run(cell, trace=True)
    assert r["correct"]
    assert r["device"]["window_s"] > 0 and r["device"]["busy_s"] == 0.0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device operations: the readers of the trace report
    # nothing, and those of the host clock report
    assert set(r["metrics"]) == read


@pytest.mark.parametrize("cell,fault", fault_cases())
def test_fault_is_caught(cell, fault):
    kind = run.load_cell(cell, BENCH).kind
    with faults.FAULTS[kind][fault]():
        r = small_run(cell)
    assert not r["correct"], r["checks"]


def test_no_jax_after_a_run():
    code = ("import json, sys, torch; torch.set_num_threads(2)\n"
            "from perfbench import run\n"
            "r = run.run_cell('c16k_eval_16s_b8_fp32', 5, 0.1, False, device='cpu', "
            f"overrides={json.dumps(cpu_sizes('c16k_eval_16s_b8_fp32'))})\n"
            "print(json.dumps([r['correct'], run.forbidden_modules()]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": run.ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1]) == [True, []]


def test_no_result_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "c16k_eval_16s_b8_fp32", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
