"""Tracing, profiling and metrics logging: the JAX package's
`utils/profiling.py` on `torch.profiler`.

- `trace(logdir)`: a context manager around `torch.profiler.profile`
  that writes a Chrome trace (chrome://tracing, Perfetto) into `logdir`;
  it records the GPU's kernels when CUDA is there, the CPU's ops always;
- `annotate(name)`: a named region in such a trace;
- `StepTimer`: wall-clock step timing with a rolling mean;
- `MetricsLogger`: an append-only JSONL metrics stream (host-side, cheap).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import deque
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Capture a trace: `with trace('/tmp/trace'): step()`. On leaving the
    block it waits for the GPU's queued work, then writes
    `logdir/trace_<pid>_<ns>.json`. Yields the profiler, whose
    `key_averages()` sum the recorded events by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region that shows up in profiler traces."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling step timing: call tick() once per step."""

    def __init__(self, window: int = 50):
        self._times: deque[float] = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> float:
        now = time.perf_counter()
        dt = 0.0
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
        self._last = now
        return dt

    @property
    def mean_step_seconds(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def steps_per_second(self) -> float:
        m = self.mean_step_seconds
        return 1.0 / m if m > 0 else 0.0


class MetricsLogger:
    """Append-only JSONL metrics log, one record per call."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "a", buffering=1)

    def log(self, step: int, **metrics):
        record = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            record[k] = float(v) if hasattr(v, "__float__") else v
        self._fh.write(json.dumps(record) + "\n")

    def close(self):
        self._fh.close()
