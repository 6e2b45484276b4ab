"""Tracing, spans and metrics logging: the JAX package's
`utils/profiling.py` on `torch.profiler`.

- `trace(logdir)`: a context manager around `torch.profiler.profile`
  that writes a Chrome trace (chrome://tracing, Perfetto) into `logdir`;
  it records the GPU's kernels when CUDA is there, the CPU's ops always;
- `span(name)`: the program's one way to mark a region (below);
- `recorded()`: the spans recorded so far;
- `MetricsLogger`: an append-only JSONL metrics stream (host-side, cheap).

A span does something only while a torch profiler records (`trace`, or
any `torch.profiler.profile`). Otherwise `span` returns one shared no-op
context: nothing is allocated, launched or synchronized. While one
records, a span enters `torch.profiler.record_function(name)`, so it
shows in the profiler's trace, and appends a `Span` to a bounded log in
memory: its name, its host interval in ns on the clock the profiler
stamps its events with (`time.time_ns()`), the ids of the enclosing span
(`parent`, per thread) and of the outermost one (`root`: every span of
one step, tick or call shares it), and, where CUDA is in use, its device
extent: the ms between two timing events recorded on the current stream
at entry and at exit (not while the stream is captured into a graph).
The events are read lazily by `recorded()`, once the caller has synced.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# a 32 s window of the benchmark's busiest cell records about 3,500 spans
LOG_CAP = 1 << 16


@dataclasses.dataclass
class Span:
    """One recorded span. Host stamps are ns of `time.time_ns()`;
    `device_ms` is None without CUDA, under graph capture, or until the
    span's exit event has completed on the device."""
    id: int
    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    root: int
    device_ms: Optional[float] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)


class _Log:
    def __init__(self):
        self.spans: deque[Span] = deque(maxlen=LOG_CAP)
        self.dropped = 0
        self.ids = itertools.count()
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def append(self, s: Span):
        with self.lock:
            if len(self.spans) == LOG_CAP:
                self.dropped += 1
            self.spans.append(s)

    def clear(self):
        with self.lock:
            self.spans.clear()
            self.dropped = 0


_LOG = _Log()
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def _recording(name: str):
    with torch.profiler.record_function(name):
        stack = _LOG.stack()
        sid = next(_LOG.ids)
        s = Span(sid, name, time.time_ns(), None, stack[-1].id if stack else None,
                 stack[0].root if stack else sid)
        if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            s.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            s.events[0].record()
        stack.append(s)
        _LOG.append(s)
        try:
            yield
        finally:
            stack.pop()
            if s.events is not None:
                s.events[1].record()
            s.end_ns = time.time_ns()


def span(name: str):
    """A named region of the program: `with span('cmgan.train.g'): ...`.
    The shared no-op unless a torch profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _recording(name)


def recorded() -> Optional[list]:
    """The spans recorded since the last `trace()` began (in the order
    they were entered), their device extents read from every event pair
    that has completed; None when the log overflowed and lost spans."""
    with _LOG.lock:
        if _LOG.dropped:
            return None
        spans = list(_LOG.spans)
    for s in spans:
        if s.events is not None and s.end_ns is not None and s.events[1].query():
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None
    return spans


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Capture a trace: `with trace('/tmp/trace'): step()`. On leaving the
    block it waits for the GPU's queued work, then writes
    `logdir/trace_<pid>_<ns>.json`. Yields the profiler, whose
    `key_averages()` sum the recorded events by name. The span log starts
    empty, so `recorded()` afterwards returns this trace's spans."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _LOG.clear()
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


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
