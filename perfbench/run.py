"""One run of one benchmark cell of cmgan_torch on the cards of this machine.

    python3 -m perfbench.run --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. The cell is the `workloads` entry NAME
of BENCHMARK.json, which names its configuration,
perfbench/configs/<config>.json, whose `arch` names its architecture's
module (perfbench/archs/<arch>.py); perfbench/workloads/NAME.json holds
its traffic driver `kind` (perfbench/traffic/<kind>.py) and its
parameters. A run:

1. set-up: the driver builds the program's objects with weights and
   inputs drawn from --seed on the card, pins TF32 off, and warms every
   shape the cell uses (the kernels build at first use, into the
   program's cache inside the checkout);
2. the window: the driver drives the program for --seconds, with work
   dispatched ahead and one sync at the end, under torch.profiler with
   --trace 1;
3. the check: the program's state is freed, and what the window produced
   is compared with the plain reference (perfbench/reference/) on the
   same weights and inputs, each number against its limit;
4. the result: one JSON line, the last of standard output, with the
   cell's end-to-end metrics (--trace 0) or its per-layer ones (--trace
   1), each read by perfbench/metrics/<metric>.py.

Without CUDA, or with fewer cards than the cell asks for, it exits with
1 and prints no result; so it does when a module of JAX or of the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "perfbench")
CACHE = os.path.join(ROOT, ".perfbench_cache")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "cmgan_tpu"}


def fix_cache_dirs():
    """Every compiler cache at a fixed path inside the checkout (the
    program's kernels build into cmgan_torch/ops/_build/ by themselves)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"


fix_cache_dirs()

import torch  # noqa: E402

from perfbench import archs, program  # noqa: E402
from perfbench.trace import Trace, profiled  # noqa: E402


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    kind: str       # the traffic driver, perfbench/traffic/<kind>.py
    cfg: dict       # the configuration file
    params: dict    # the driver's parameters


def load_cell(name: str, bench: dict) -> Cell:
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    spec = load_json(HERE, "workloads", f"{name}.json")
    return Cell(name, entry["chips"], spec["kind"],
                load_json(HERE, "configs", f"{entry['config']}.json"), spec["params"])


def cell_metrics(bench: dict, section: str, cell: str) -> list:
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def reader(metric: str):
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + metric.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Ctx:
    """What a traffic driver is given: the cell, the seed and the device."""
    cell: Cell
    seed: int
    device: torch.device

    @property
    def cfg(self) -> dict:
        return self.cell.cfg

    @property
    def params(self) -> dict:
        return self.cell.params

    def derive(self, k: int) -> int:
        """The k-th seed drawn from the run's seed (weights, inputs, samples)."""
        return (self.seed * 1_000_003 + 7919 * k) % (2 ** 62)


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads: the cell, what the window measured
    (`window_s`, `units`, `unit`, the driver's own keys), the program's
    counters over the window and the trace."""
    cell: Cell
    measured: dict
    counters: dict
    trace: Trace | None


def free(device: torch.device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def card(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             tf32: bool = False, started: float | None = None, bench: dict | None = None,
             overrides: dict | None = None) -> dict:
    """One run; returns the result record. tf32=True runs the program with
    TF32 on, the lower-precision control (its reference is still float32).
    overrides replace parameters of the cell (the CPU tests' small sizes)."""
    started = time.perf_counter() if started is None else started
    bench = benchmark() if bench is None else bench
    cell = load_cell(name, bench)
    cell.params.update(overrides or {})
    device = torch.device(device)
    ctx = Ctx(cell, seed, device)
    driver = importlib.import_module(f"perfbench.traffic.{cell.kind}")
    arch = archs.load(cell.cfg)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    program.set_tf32(tf32)

    state = driver.setup(ctx)
    arch.reset_launches()
    if trace:
        with profiled() as prof:
            measured = driver.window(ctx, state, seconds)
    else:
        measured = driver.window(ctx, state, seconds)
    counters = arch.launches()
    setup_s = measured["t0"] - started
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    answers = driver.answers(ctx, state, measured)
    del state
    free(device)
    program.set_tf32(False)
    checks = driver.check(ctx, answers)
    del answers
    free(device)

    metrics = {}
    section = "per_layer" if trace else "end_to_end"
    tr = Trace.from_profile(prof) if trace else None
    if trace:
        reading = Reading(cell, measured, counters, tr)
        for m in cell_metrics(bench, section, name):
            value = reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, **driver.end_to_end(ctx, measured)}
        for m in cell_metrics(bench, section, name):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {**card(device), "memory_peak_bytes": peak}
    if trace:
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
    readings = {k: c["value"] for k, c in checks.items() if c["limit"] is None}
    checks = {k: c for k, c in checks.items() if c["limit"] is not None}
    for c in checks.values():
        c["value"] = c["value"] if c["value"] == c["value"] and abs(c["value"]) != float("inf") \
            else None
    failed = sum(1 for c in checks.values() if c["value"] is None or c["value"] > c["limit"])
    result = {"correct": failed == 0, "attempted": measured["units"], "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = tr.breakdown()
    result["extra"] = {"setup_s": setup_s, "window_s": measured["window_s"],
                       "units": measured["units"], "counters": counters,
                       "memory_peak_bytes": peak, "tf32": tf32, "seed": seed,
                       "readings": readings}
    result["checks"] = checks
    return result


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="One run of one benchmark cell of cmgan_torch")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = benchmark()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 1
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      started=_STARTED, bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}; nothing it measured counts", file=sys.stderr)
        return 1
    print(json.dumps({"run": args.workload, "seed": args.seed, "card": power_limit(),
                      **result.pop("extra")}), flush=True)
    print(json.dumps(result), flush=True)
    for check, c in result["checks"].items():
        print(f"check {check}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
